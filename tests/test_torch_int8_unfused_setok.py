"""The int8 SeTok forward where the JAX package's gates take the unfused
route, against the JAX package on the CPU (the modules and kernels of the
route: tests/test_torch_int8_unfused.py).

  * `expected_calls` equals the calls of each int8 kernel in the JAX
    package's own int8 forward, traced under jax.eval_shape, at base @384,
    with the 4096-wide tokenizer MLP, at the fast stage-1 recipe
    (merge_layer 1, 64 tokens past the merge, decoder depth 8), and at 576
    px (N = 1296);
  * the JAX parameter trees at 384 px, at so400m and at 576 px name the
    port's parameters one to one, with their shapes;
  * a tiny forward whose real gates take the unfused route, two seeds:
    identical clusters, 5e-2 on `tokens` and `recon` (tests/test_torch_int8.py
    says why 5e-2).
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.models.setok import INT8_KERNELS, SeTok, expected_calls
from setok_tpu_torch.utils.from_flax import flax_state_key, load_flax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FORWARD_TOL = 5e-2


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------------
# the configurations


def _configs(name, pkg):
    """The slice's configurations, built as chip_smoke.py builds them."""
    if name == "so400m":
        return pkg.so400m_tokenizer(), pkg.so400m_detokenizer()
    tok, det = pkg.base_tokenizer(), pkg.base_detokenizer()
    if name in ("base384", "base576"):   # eval_recon --image-size 384 / 576
        size = int(name[4:])
        return (pkg.replace(tok, vit=pkg.replace(tok.vit, image_size=size)),
                pkg.replace(det, image_size=size))
    if name == "merged":    # train_setok --merge-layer 1 --detok-depth 8
        return (pkg.replace(tok, vit=pkg.replace(tok.vit, merge_layer=1),
                            k_max=64, min_cluster_num=64, knn=64),
                pkg.replace(det, decoder_depth=8))
    return pkg.replace(tok, dim_feedforward=4096), det


# each JAX kernel function and the module its callers read it from
JAX_KERNELS = {"attn_sublayer_int8": "fused_sublayer",
               "mlp_sublayer_int8": "fused_sublayer",
               "mlp_postnorm_int8": "fused_sublayer",
               "fused_bert_attention_int8": "fused_bert_attention_int8",
               "fused_mlp_int8": "fused_mlp",
               "fused_attention_int8": "fused_attention_int8",
               "quant_matmul": "quant_matmul"}


@pytest.mark.parametrize("name", ["base384", "ff4096", "merged",
                                  "base576"])
def test_expected_calls_match_jax_trace(name, monkeypatch):
    """The calls of each int8 kernel in one forward of the JAX package's
    int8 SeTok (`apply` traced under jax.eval_shape, each kernel function
    wrapped to count its calls) equal `expected_calls`."""
    jtok, jdet = _configs(name, jcfg)
    model = JSeTok(jtok, jdet, quant8=True, dtype=jnp.bfloat16)
    size = jtok.vit.image_size
    images = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), images)
    calls = dict.fromkeys(INT8_KERNELS, 0)
    for kernel, module in JAX_KERNELS.items():
        mod = importlib.import_module(f"setok_tpu.kernels.{module}")
        real = getattr(mod, kernel)

        def counted(*a, _real=real, _kernel=kernel, **k):
            calls[_kernel] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, kernel, counted)
    jax.eval_shape(model.apply, params, images)
    assert calls == expected_calls(*_configs(name, tcfg))
    assert (calls["fused_mlp_int8"], calls["fused_attention_int8"],
            calls["quant_matmul"]) == {"base384": (29, 0, 60),
                                       "ff4096": (0, 4, 4),
                                       "merged": (0, 0, 0),
                                       "base576": (29, 0, 60)}[name]


def _state_shape(path, shape):
    """The state-dict key and shape `from_flax` gives a flax leaf."""
    if path[-1] == "kernel":
        shape = (int(np.prod(shape[:-1])), shape[-1])[::-1]
    elif path[-1] in ("q", "p"):
        shape = shape[::-1]
    return flax_state_key(path), tuple(shape)


@pytest.mark.parametrize("name", ["base384", "so400m", "base576"])
def test_flax_tree_loads_strictly_at_scale(name):
    """Every leaf of the JAX parameter tree (shapes from jax.eval_shape)
    names one parameter of the port's model of the same shape, and every
    parameter is named: `load_flax_params` takes the tree strictly. Among
    them the 27-block SigLIP ViT, and the 576- and 324-token mask tokens
    and position embeddings."""
    jtok, jdet = _configs(name, jcfg)
    size = jtok.vit.image_size
    params = jax.eval_shape(JSeTok(jtok, jdet).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, size, size, 3),
                                                 jnp.float32))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    flax_shapes = dict(_state_shape([k.key for k in path], leaf.shape)
                       for path, leaf in leaves)
    assert len(flax_shapes) == len(leaves)
    model = SeTok(*_configs(name, tcfg), device="meta")
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert flax_shapes == own
    vit = "tokenizer.image_feature_encoder"
    if name == "so400m":
        assert f"{vit}.block_26.mlp.fc2.weight" in own
        assert own[f"{vit}.pos_embed"] == (1, 729, 1152)
        assert own["detokenizer.mask_tokens"] == (1, 324, 768)
    else:
        n = (size // 16) ** 2           # 576 at 384 px, 1296 at 576 px
        assert own[f"{vit}.pos_embed"] == (1, n, 768)
        assert own["detokenizer.mask_tokens"] == (1, n, 768)


def images(seed, b=2, size=256):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1.0, 1.0, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [2, 3])
def test_unfused_int8_setok_forward_matches_jax(seed, monkeypatch):
    """A tiny int8 SeTok whose real gates take the unfused route: at 256 px
    with 8-px patches the ViT, the inner Block and the decoder see N=1024
    tokens of width 32, where the attention gate fails. The ViT, the
    inner Block and the decoder then take int8 `Dense`s around the float
    attention, and `fused_mlp_int8`; the inter Block (8 tokens) and the
    Q-Former keep the whole-sublayer kernels (the Q-Former's 1024 queries:
    its float attention). Identical clusters; tokens and recon within
    5e-2."""
    jtok, jdet = jcfg.tiny_tokenizer(256, 8), jcfg.tiny_detokenizer(256, 8)
    tok, det = tcfg.tiny_tokenizer(256, 8), tcfg.tiny_detokenizer(256, 8)
    assert not fs.attn_fits_vmem(tok.vit.num_patches, tok.vit.width)
    x = images(seed)
    jm = JSeTok(jtok, jdet, quant8=True)
    params = JSeTok(jtok, jdet).init(jax.random.PRNGKey(seed),
                                     jnp.asarray(x[:1]))
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(SeTok(tok, det, device="cpu", quant8=True),
                          to_np(params))
    seen = set()
    for mod, kernel in ((fm, "fused_mlp_int8"), (fai, "fused_attention_int8"),
                        (qm, "quant_matmul"), (fs, "attn_sublayer_int8")):
        real = getattr(mod, kernel)

        def spy(*a, _real=real, _kernel=kernel, **k):
            seen.add(_kernel)
            return _real(*a, **k)
        monkeypatch.setattr(mod, kernel, spy)
    got = tm(torch.from_numpy(x))
    assert seen == {"fused_mlp_int8", "quant_matmul", "attn_sublayer_int8"}
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    assert int(got.num_clusters.max()) > 1
    np.testing.assert_array_equal(got.token_valid.numpy(),
                                  np.asarray(want.token_valid))
    assert max_rel(got.tokens.numpy(), want.tokens) <= FORWARD_TOL
    assert max_rel(got.recon.numpy(), want.recon) <= FORWARD_TOL
