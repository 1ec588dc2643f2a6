"""The port's models against the JAX package on the CPU, tiny configs.

The same numpy images and the same flax parameters (converted with
`from_flax`) go through `setok_tpu` and `setok_tpu_torch`. Clustering on the
CPU takes the plain path on both sides, so the comparison is like for like.
Tolerance: 1e-4 max-abs in float32 (two frameworks' float32 matmuls and
reductions sum in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.detokenizer import SetokDeTokenizer as JDeTok
from setok_tpu.models.qformer import QFormer as JQFormer
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu.models.tokenizer import SetokTokenizer as JTok
from setok_tpu.models.vit import ViT as JViT
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
from setok_tpu_torch.models.qformer import QFormer
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.models.vit import ViT
from setok_tpu_torch.utils.from_flax import load_flax_params

TOL = 1e-4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def images(seed, b=2, size=32):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1.0, 1.0, (b, size, size, 3)).astype(np.float32)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_vit_matches_jax():
    cfg = jcfg.tiny_tokenizer().vit
    x = images(0)
    jm = JViT(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_flax_params(ViT(tcfg.tiny_tokenizer().vit, device="cpu"),
                          to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        got0 = tm(torch.from_numpy(x), select_layer=0).numpy()
    assert got.shape == want.shape
    assert max_abs(got, want) <= TOL
    # select_layer taps work as HF hidden_states do
    want0 = np.asarray(jm.apply(params, jnp.asarray(x), select_layer=0))
    assert max_abs(got0, want0) <= TOL


def test_vit_drops_the_ragged_edge_as_jax():
    """An image side that is not a multiple of the patch (so400m: 384 px
    in patches of 14) loses its last rows and columns, as the JAX ViT's
    VALID stride-p convolution drops them."""
    jvit = jcfg.replace(jcfg.tiny_tokenizer().vit, image_size=38)
    tvit = tcfg.replace(tcfg.tiny_tokenizer().vit, image_size=38)
    x = images(4, size=38)
    jm = JViT(jvit)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_flax_params(ViT(tvit, device="cpu"), to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, jvit.width)
    assert max_abs(got, want) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizer_matches_jax(seed):
    x = images(seed)
    jm = JTok(jcfg.tiny_tokenizer())
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(SetokTokenizer(tcfg.tiny_tokenizer(), device="cpu"),
                          to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    np.testing.assert_array_equal(got.token_valid.numpy(),
                                  np.asarray(want.token_valid))
    assert max_abs(got.tokens.numpy(), want.tokens) <= TOL
    assert max_abs(got.score.numpy(), want.score) <= TOL


def test_qformer_matches_jax():
    rs = np.random.RandomState(0)
    q = rs.randn(2, 16, 32).astype(np.float32)
    enc = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    jm = JQFormer(num_layers=3, num_heads=2, cross_attention_freq=2)
    params = jm.init(jax.random.PRNGKey(0), q, enc, mask)
    want = np.asarray(jm.apply(params, q, enc, mask))
    tm = load_flax_params(QFormer(32, num_layers=3, num_heads=2,
                                  cross_attention_freq=2, device="cpu"),
                          to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(enc),
                 torch.from_numpy(mask)).numpy()
    assert max_abs(got, want) <= TOL


def test_detokenizer_matches_jax():
    det = jcfg.tiny_detokenizer()
    rs = np.random.RandomState(1)
    tokens = rs.randn(2, 8, det.token_feat_dim).astype(np.float32)
    valid = np.ones((2, 8), bool)
    valid[0, 3:] = False
    jm = JDeTok(det)
    params = jm.init(jax.random.PRNGKey(1), tokens, valid)
    want = jm.apply(params, tokens, valid)
    tm = load_flax_params(SetokDeTokenizer(tcfg.tiny_detokenizer(),
                                           device="cpu"), to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), torch.from_numpy(valid))
    assert got.image.shape == want.image.shape == (2, 32, 32, 3)
    assert max_abs(got.image.numpy(), want.image) <= TOL
    assert max_abs(got.hidden.numpy(), want.hidden) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_setok_forward_matches_jax(seed):
    """The slice end to end: encode → cluster → decode."""
    x = images(seed)
    jm = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer())
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                                device="cpu"), to_np(params))
    got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    np.testing.assert_array_equal(got.token_valid.numpy(),
                                  np.asarray(want.token_valid))
    assert max_abs(got.tokens.numpy(), want.tokens) <= TOL
    assert max_abs(got.recon.numpy(), want.recon) <= TOL


def test_setok_bf16_runs_close_to_f32():
    """The bf16 policy runs and stays near the float32 forward."""
    x = torch.from_numpy(images(0))
    jm = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer())
    params = to_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy())))
    f32 = load_flax_params(SeTok(tcfg.tiny_tokenizer(),
                                 tcfg.tiny_detokenizer(), device="cpu"), params)
    bf16 = load_flax_params(SeTok(tcfg.tiny_tokenizer(),
                                  tcfg.tiny_detokenizer(),
                                  dtype=torch.bfloat16, device="cpu"), params)
    a, b = f32(x), bf16(x)
    assert b.recon.dtype == torch.bfloat16
    assert torch.isfinite(b.recon.float()).all()
    scale = float(a.recon.abs().max())
    assert float((b.recon.float() - a.recon).abs().max()) <= 0.1 * scale


@pytest.mark.parametrize("build", [
    lambda: SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer()),
    lambda: SetokTokenizer(tcfg.tiny_tokenizer()),
    lambda: SetokDeTokenizer(tcfg.tiny_detokenizer()),
    lambda: ViT(tcfg.tiny_tokenizer().vit),
    lambda: QFormer(32, num_layers=1, num_heads=2),
], ids=["setok", "tokenizer", "detokenizer", "vit", "qformer"])
def test_entry_points_default_to_the_card(build, monkeypatch):
    """device=None means CUDA; with no card it raises, never runs on the
    CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


# the merge_layer case (option0) went with the code that raised: the token
# merge is ported (tests/test_torch_token_merge.py)
@pytest.mark.parametrize("option", [{"use_class_token": True}],
                         ids=["option1"])
def test_unported_vit_options_raise(option):
    vit = tcfg.replace(tcfg.tiny_tokenizer().vit, **option)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        ViT(vit, device="cpu")
