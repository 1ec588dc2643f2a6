"""The port's int8 (`quant8=True`) path against the JAX package on the CPU.

Kernels: each plain version against its JAX kernel run with
`interpret=True` (as tests/test_fused_sublayer.py runs them), on numpy
inputs from a seed. Bars, max-rel = max|got - want| / max|want|:

  * MLP, post-norm MLP and BERT attention: 1e-5. The plain versions follow
    the kernels operation by operation; the int8 products are exact, so what
    remains is the order of float32 sums.
  * attn_sublayer_int8: 2e-3, with at least 99 % of the elements within
    1e-5 of max|want|. Its bf16 casts of q/k/v and P, and the int8
    quantisation of the attention output, turn a last-bit difference into a
    rare whole rounding step.

Modules: `Block`, `ViTBlock`, `ViTEncoderBlock` and `QFormer` with
`quant8=True` against the JAX modules on the same flax parameters, 2e-3
(the blocks at so400m's width: tests/test_torch_int8_so400m.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from setok_tpu import config as jcfg
from setok_tpu.kernels.fused_bert_attention_int8 import (
    fused_bert_attention_int8 as j_bert)
from setok_tpu.kernels.fused_sublayer import attn_sublayer_int8 as j_attn
from setok_tpu.kernels.fused_sublayer import mlp_postnorm_int8 as j_post
from setok_tpu.kernels.fused_sublayer import mlp_sublayer_int8 as j_mlp
from setok_tpu.models.qformer import QFormer as JQFormer
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu.models.tokenizer import SetokTokenizer as JTok
from setok_tpu.models.vit import ViTEncoderBlock as JViTEncoderBlock
from setok_tpu.ops import blocks as jblocks
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels.fused_bert_attention_int8 import (
    fused_bert_attention_int8)
from setok_tpu_torch.kernels.quant import quantize_weight
from setok_tpu_torch.models.qformer import QFormer
from setok_tpu_torch.models.setok import SeTok, expected_calls
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.models.vit import ViTEncoderBlock
from setok_tpu_torch.ops import blocks
from setok_tpu_torch.ops.clustering import same_cluster_mask
from setok_tpu_torch.utils.from_flax import load_flax_params
from setok_tpu_torch.utils.init import init_random_
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KERNEL_TOL = 1e-5
ATTN_TOL = 2e-3
ATTN_CLOSE_SHARE = 0.99
MODULE_TOL = 2e-3
FORWARD_TOL = 5e-2


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close_share(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) <= rel * np.abs(want).max()).mean())


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def qw(w_in_out):
    """A flax-layout (in, out) kernel → the port's int8 weight."""
    return quantize_weight(t(w_in_out.T))


def _dense(rs, fan_in, fan_out):
    return ((rs.randn(fan_in, fan_out) / np.sqrt(fan_in)).astype(np.float32),
            (rs.randn(fan_out) * 0.1).astype(np.float32))


def _ln_params(rs, c):
    return ((rs.rand(c) + 0.5).astype(np.float32),
            (rs.randn(c) * 0.1).astype(np.float32))


def _block_mask(b, n, rs, n_groups=3):
    labels = rs.randint(0, n_groups, size=(b, n))
    return labels[:, :, None] == labels[:, None, :]


def _valid_mask(b, n, n_valid):
    valid = np.zeros((b, n), bool)
    for i, k in enumerate(n_valid):
        valid[i, :k] = True
    return valid[:, None, :] & valid[:, :, None]


@pytest.mark.parametrize("b,n,c,heads,mask_kind", [
    (2, 16, 64, 4, None),            # ViT style
    (2, 16, 96, 2, None),            # head dim 48 (JAX pads it to 64)
    (2, 24, 128, 2, "block"),        # the inner Block: 2 wide heads, clusters
    (2, 12, 256, 2, "valid"),        # the inter Block: fully masked rows
], ids=["vit", "hd48", "inner", "inter"])
def test_attn_sublayer_matches_jax(b, n, c, heads, mask_kind):
    rs = np.random.RandomState(1000 + c + n)
    x = rs.randn(b, n, c).astype(np.float32)
    g, bb = _ln_params(rs, c)
    wqkv, bqkv = _dense(rs, c, 3 * c)
    wp, bp = _dense(rs, c, c)
    mask = {None: None, "block": _block_mask(b, n, rs),
            "valid": _valid_mask(b, n, [n - 3, 5])}[mask_kind]
    want = np.asarray(j_attn(
        *map(jnp.asarray, (x, g, bb, wqkv, bqkv, wp, bp)), heads,
        mask=None if mask is None else jnp.asarray(mask), ln_eps=1e-5,
        interpret=True))
    got = fs.attn_sublayer_int8(
        t(x), t(g), t(bb), qw(wqkv), t(bqkv), qw(wp), t(bp), heads,
        mask=None if mask is None else t(mask), ln_eps=1e-5).numpy()
    assert max_rel(got, want) <= ATTN_TOL
    assert close_share(got, want) >= ATTN_CLOSE_SHARE
    if mask_kind == "valid":
        # a fully masked query row attends to nothing: o = 0, out = x + b_proj
        rows = ~mask.any(-1)
        assert rows.any()
        np.testing.assert_array_equal(got[rows], (x + bp)[rows])


def _mlp_inputs(seed, lead=(3, 16), c=32, hidden=64):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    w1, b1 = _dense(rs, c, hidden)
    w2, b2 = _dense(rs, hidden, c)
    g, bb = _ln_params(rs, c)
    return x, w1, b1, w2, b2, g, bb


@pytest.mark.parametrize("seed,lead", [(0, (3, 16)), (1, (40,))])
def test_mlp_sublayer_matches_jax(seed, lead):
    x, w1, b1, w2, b2, g, bb = _mlp_inputs(seed, lead)
    want = np.asarray(j_mlp(*map(jnp.asarray, (x, g, bb, w1, b1, w2, b2)),
                            ln_eps=1e-5, block_m=16, interpret=True))
    got = fs.mlp_sublayer_int8(t(x), t(g), t(bb), qw(w1), t(b1), qw(w2),
                               t(b2), ln_eps=1e-5).numpy()
    assert max_rel(got, want) <= KERNEL_TOL


@pytest.mark.parametrize("seed", [2, 3])
def test_mlp_postnorm_matches_jax(seed):
    x, w1, b1, w2, b2, g, bb = _mlp_inputs(seed)
    want = np.asarray(j_post(*map(jnp.asarray, (x, w1, b1, w2, b2, g, bb)),
                             block_m=16, interpret=True))
    got = fs.mlp_postnorm_int8(t(x), qw(w1), t(b1), qw(w2), t(b2), t(g),
                               t(bb)).numpy()
    assert max_rel(got, want) <= KERNEL_TOL


def test_exact_erf_gelu_fails_the_mlp_bar(monkeypatch):
    """The int8 MLPs use the tanh GELU; the exact-erf form misses the bar."""
    x, w1, b1, w2, b2, g, bb = _mlp_inputs(0)
    want = np.asarray(j_mlp(*map(jnp.asarray, (x, g, bb, w1, b1, w2, b2)),
                            ln_eps=1e-5, block_m=16, interpret=True))
    monkeypatch.setattr(fs, "gelu_tanh", F.gelu)
    got = fs.mlp_sublayer_int8(t(x), t(g), t(bb), qw(w1), t(b1), qw(w2),
                               t(b2), ln_eps=1e-5).numpy()
    assert max_rel(got, want) > 10 * KERNEL_TOL


@pytest.mark.parametrize("m,masked", [(None, False), (8, True), (8, False)],
                         ids=["self", "cross-masked", "cross"])
def test_bert_attention_matches_jax(m, masked):
    rs = np.random.RandomState(7)
    b, n, c, heads = 2, 16, 64, 4
    x = rs.randn(b, n, c).astype(np.float32)
    kv = x if m is None else rs.randn(b, m, c).astype(np.float32)
    dense = [_dense(rs, c, c) for _ in range(4)]
    g, bb = _ln_params(rs, c)
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, 5:] = False
        mask[1, 2:] = False
    jargs = [jnp.asarray(a) for pair in dense for a in pair]
    want = np.asarray(j_bert(jnp.asarray(x), jnp.asarray(kv), *jargs,
                             jnp.asarray(g), jnp.asarray(bb), heads,
                             kv_mask=None if mask is None
                             else jnp.asarray(mask), interpret=True))
    targs = [a for w, bias in dense for a in (qw(w), t(bias))]
    tx = t(x)
    got = fused_bert_attention_int8(
        tx, tx if m is None else t(kv), *targs, t(g), t(bb), heads,
        kv_mask=None if mask is None else t(mask)).numpy()
    assert max_rel(got, want) <= KERNEL_TOL


# ----------------------------------------------------------------------------
# modules


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _blob_clusters(b, n, rs, n_groups=3):
    """A (B, N, N) same-cluster mask from `same_cluster_mask`."""
    idx = torch.from_numpy(rs.randint(0, n_groups, size=(b, n)))
    return same_cluster_mask(idx).numpy()


def _module_case(name):
    rs = np.random.RandomState(12)
    x = rs.randn(2, 16, 32).astype(np.float32)
    if name == "block":
        mask = _blob_clusters(2, 16, rs)
        return (jblocks.Block(num_heads=2, mlp_hidden_dim=64, depth=2,
                              quant8=True),
                blocks.Block(32, 2, 64, depth=2, norm_eps=1e-5, quant8=True),
                (x,), {"mask": mask})
    if name == "vitblock":
        return (jblocks.ViTBlock(num_heads=2, quant8=True),
                blocks.ViTBlock(32, 2, norm_eps=1e-5, quant8=True), (x,), {})
    if name == "vit_encoder_block":
        return (JViTEncoderBlock(num_heads=2, mlp_ratio=4.0, quant8=True),
                ViTEncoderBlock(32, 2, 4.0, quant8=True), (x,), {})
    enc = rs.randn(2, 8, 32).astype(np.float32)
    valid = np.ones((2, 8), bool)
    valid[1, 3:] = False
    return (JQFormer(num_layers=3, num_heads=2, cross_attention_freq=2,
                     quant8=True),
            QFormer(32, num_layers=3, num_heads=2, cross_attention_freq=2,
                    quant8=True, device="cpu"), (x, enc, valid), {})


@pytest.mark.parametrize("name", ["block", "vitblock", "vit_encoder_block",
                                  "qformer"])
def test_int8_module_matches_jax(name):
    jm, tm, args, kw = _module_case(name)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs, **jkw)
    want = np.asarray(jm.apply(params, *jargs, **jkw))
    load_flax_params(tm, to_np(params))
    with torch.inference_mode():
        got = tm(*map(t, args), **{k: t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32
    assert max_rel(got.numpy(), want) <= MODULE_TOL


def test_int8_weights_follow_load_state_dict():
    """The cached int8 weights are out of the state dict and are
    re-quantised after load_state_dict."""
    _, tm, (x,), kw = _module_case("block")
    _, fresh, _, _ = _module_case("block")
    init_random_(tm, 0)
    init_random_(fresh, 1)
    assert set(tm.state_dict()) == set(fresh.state_dict())
    x, mask = t(x), t(kw["mask"])
    with torch.inference_mode():
        before = tm(x, mask)
        tm.load_state_dict(fresh.state_dict())
        after, want = tm(x, mask), fresh(x, mask)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


# ----------------------------------------------------------------------------
# the slice


def images(seed, b=2, size=32):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1.0, 1.0, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [2, 3])
def test_int8_setok_forward_matches_jax(seed):
    """The int8 forward end to end, encode → cluster → decode.

    Bar 5e-2 max-rel on `tokens` and `recon`: the JAX package's own int8
    tiny forward moves by 1.8e-2 in `recon` and 5.0e-3 in `tokens` when
    its input is perturbed by 2e-7 relative noise (seed 0), because one
    flipped int8 step in a 32-wide row is a ~1 % change. The tight checks
    are the kernels' above. Seeds 2 and 3 give several clusters per image.
    """
    x = images(seed)
    jm = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer(), quant8=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                                device="cpu", quant8=True), to_np(params))
    got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    assert int(got.num_clusters.max()) > 1
    np.testing.assert_array_equal(got.token_valid.numpy(),
                                  np.asarray(want.token_valid))
    assert max_rel(got.tokens.numpy(), want.tokens) <= FORWARD_TOL
    assert max_rel(got.recon.numpy(), want.recon) <= FORWARD_TOL


def test_int8_group_encode_on_blobs_with_empty_clusters():
    """Clustering + group encoding of blob features: fewer clusters than
    k_max, so the inter Block sees fully masked rows."""
    cfg = jcfg.tiny_tokenizer()
    rs = np.random.RandomState(5)
    centers = rs.randn(3, cfg.hidden_dim) * 2
    feats = np.stack([centers[rs.randint(0, 3, 16)]
                      + rs.randn(16, cfg.hidden_dim) * 0.05
                      for _ in range(2)]).astype(np.float32)
    jm = JTok(cfg, quant8=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images(0)))
    want = jm.apply(params, jnp.asarray(feats), method=JTok.tokenize_features)
    tm = load_flax_params(SetokTokenizer(tcfg.tiny_tokenizer(), quant8=True,
                                         device="cpu"), to_np(params))
    with torch.no_grad():
        got = tm.tokenize_features(torch.from_numpy(feats))
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    valid = got.token_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.token_valid))
    assert 1 < valid.sum(-1).max() < cfg.k_max            # empty clusters
    assert max_rel(got.tokens.numpy(), want.tokens) <= MODULE_TOL


def test_int8_forward_calls_each_kernel(monkeypatch):
    """Calls per tiny forward: attention = ViT depth + inner + inter +
    decoder depth, MLP = ViT depth + 2 + decoder depth, BERT = mapper
    layers + cross layers, post-norm = mapper layers (32/30/9/6 at the
    base config)."""
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("attn_sublayer_int8", "mlp_sublayer_int8",
                 "mlp_postnorm_int8"):
        spy(fs, name)
    spy(fba, "fused_bert_attention_int8")
    tok, det = tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer()
    model = init_random_(SeTok(tok, det, device="cpu", quant8=True), 0)
    model(torch.from_numpy(images(2)))
    cross = len(range(0, det.mapper_layers, det.cross_attention_freq))
    assert calls == {
        "attn_sublayer_int8": (tok.vit.depth + tok.inner_cluster_layers
                               + tok.intra_cluster_layers
                               + det.decoder_depth),
        "mlp_sublayer_int8": tok.vit.depth + 2 + det.decoder_depth,
        "fused_bert_attention_int8": det.mapper_layers + cross,
        "mlp_postnorm_int8": det.mapper_layers}
    assert expected_calls(tcfg.base_tokenizer(), tcfg.base_detokenizer()) == {
        "attn_sublayer_int8": 32, "mlp_sublayer_int8": 30,
        "fused_bert_attention_int8": 9, "mlp_postnorm_int8": 6,
        "fused_mlp_int8": 0, "fused_attention_int8": 0, "quant_matmul": 0}
