"""The numerics of the int8 attentions of rows 4 and 7 on the card
(`csrc/attn_mma.cuh` inside `csrc/fused_bert_attention_int8.cu` and
`csrc/fused_attention_int8.cu`), modelled in plain PyTorch, against the
plain versions and the JAX kernels.

What the model holds:

  * f32 operands (row 7): the kernel sums each score's products in float64
    in its own order (D in slices of 32; lane t4 takes 16-byte chunk c0 +
    t4 of a slice, k step i its value i) and rounds once; P.V likewise in
    float64, key by key. Both round to the float64 product's float32 value
    (`attention_reference(exact_scores=True, exact_pv=True)`): every f32 x
    f32 product is exact in float64, and the sums' last bits do not reach
    float32.
  * the (B, M) key mask of row 4, read as a byte at b*M + 0*i + j, is its
    (B, N, M) broadcast, and the plain attention gives the same values
    under either.
  * row 4's q epilogue takes the softmax scale after the bias, as the JAX
    kernel does: bf16(((acc * xs) * s + b) * scale) equals the plain
    version's q for any head width. The kernel does not fold the scale into
    s and b; at d = 64 (scale 0.125, a power of two) folding would give the
    same bits, which the test shows too.
  * the whole chains (row pass, products, attention, the rows' |o| maxima
    posted by their bits, one-read quantisation of o, out product, row 4's
    residual and LayerNorm): each model equals its plain version to the bit
    (row 7's plain version takes P.V as a float64 product too) and meets
    the bars of tests/test_torch_int8.py (row 4, 1e-5) and
    tests/test_torch_int8_unfused.py (row 7, 2e-3 with >= 99 % within 1e-5
    of the largest) against the JAX kernel; row 7's also meets the card
    bar (chip_smoke.INT8_ATTN_TOL and INT8_ATTN_SHARE, the same numbers)
    against the plain steps with a float32 P.V, the JAX kernel's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.fused_attention_int8 import (
    fused_attention_int8 as j_unfused)
from setok_tpu.kernels.fused_bert_attention_int8 import (
    fused_bert_attention_int8 as j_bert)
from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels.quant import (int8_dense, int_dot, quant_rows,
                                           quantize_weight)

ATTN_TOL = 2e-3           # chip_smoke.INT8_ATTN_TOL
ATTN_SHARE = 0.99         # chip_smoke.INT8_ATTN_SHARE
BERT_JAX_TOL = 1e-5       # tests/test_torch_int8.py KERNEL_TOL
D_SLICE = 32              # attn_mma.cuh kDSlice


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def qw(w_in_out):
    return quantize_weight(t(w_in_out.T))


def _dense(rs, fan_in, fan_out):
    return ((rs.randn(fan_in, fan_out) / np.sqrt(fan_in)).astype(np.float32),
            (rs.randn(fan_out) * 0.1).astype(np.float32))


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close_share(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= rel * np.abs(want).max()).mean())


# ----------------------------------------------------------------------------
# the model


def f64_scores(q, k):
    """f32 q (..., N, D), k (..., M, D): the kernel's float64 sums, D slice
    by slice, 16-byte chunk c0 + t4 of 4 values a lane, k step i its value
    i (the four lanes' values of a k step in lane order), rounded once."""
    d = q.shape[-1]
    qd, kd = q.double(), k.double()
    acc = torch.zeros(q.shape[:-1] + k.shape[-2:-1], dtype=torch.float64)
    for j0 in range(0, d, D_SLICE):
        chunks = min(D_SLICE, d - j0) // 4
        for c0 in range(0, chunks, 4):
            for i in range(4):
                for t4 in range(4):
                    col = j0 + 4 * (c0 + t4) + i
                    acc += qd[..., col, None] * kd[..., None, :, col]
    return acc.float()


def f64_pv(p, v):
    """f32 p (..., N, M), v (..., M, D): float64 sums key by key (64-key
    tiles, k steps of 4 keys in lane order), rounded once."""
    pd, vd = p.double(), v.double()
    acc = torch.zeros(p.shape[:-1] + v.shape[-1:], dtype=torch.float64)
    for key in range(p.shape[-1]):
        acc += pd[..., key, None] * vd[..., key, None, :]
    return acc.float()


def softmax_parts(s, mask):
    if mask is not None:
        s = s + fs.NEG_INF * (1.0 - mask.float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lr = 1.0 / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return p, torch.where(m > 0.5 * fs.NEG_INF, lr, 0.0)


def bf16_attention(q, k, v, mask):
    """Row 4's attention: exact scores (any order: bf16 products and their
    sums are exact in float64), p in bf16, each 16-key slice of P.V from
    zero and the slices added in float32."""
    p, lr = softmax_parts(
        torch.matmul(q.double(), k.double().transpose(-1, -2)).float(), mask)
    p, vf = p.to(torch.bfloat16).float(), v.float()
    acc = None
    for j0 in range(0, p.shape[-1], 16):
        part = torch.matmul(p[..., j0:j0 + 16], vf[..., j0:j0 + 16, :])
        acc = part if acc is None else acc + part
    return acc * lr


def f32_attention(q, k, v, mask):
    """Row 7's attention: f64 scores and P.V in the kernel's order, p f32."""
    p, lr = softmax_parts(f64_scores(q, k), mask)
    return f64_pv(p, v) * lr


def row_max_bits_quant(o, heads, seed=0):
    """The rows' |o| maxima as the attention posts them (each head's
    maximum, one atomicMax on the bits a row and head, heads in a random
    order), then o quantised in one read with max(omax, 1e-8) / 127."""
    m, c = o.shape
    d = c // heads
    bits = torch.zeros(m, dtype=torch.int32)
    for h in np.random.RandomState(seed).permutation(heads):
        bits = torch.maximum(
            bits, o[:, h * d:(h + 1) * d].abs().amax(-1).view(torch.int32))
    s = torch.clamp_min(bits.view(torch.float32), 1e-8)[:, None] \
        / torch.tensor(127.0)
    return torch.round(o / s).clamp(-127, 127).to(torch.int8), s


def bias_epilogue(x8, xs, w, bias, post=None):
    """BiasEpi: ((acc * xs) * s + b) [* post] in float32."""
    y = int_dot(x8, w.values) * xs * w.scales + bias
    return y if post is None else y * torch.tensor(post, dtype=torch.float32)


def heads_of(t_, b, n, heads):
    return t_.reshape(b, n, heads, -1).transpose(1, 2)


def design_bert(x, kv, wq, bq, wk, bk, wv, bv, wo, bo, g, beta, heads,
                kv_mask=None, eps=1e-12):
    b, n, c = x.shape
    m = kv.shape[1]
    x8, xs = quant_rows(x.reshape(-1, c))
    kv8, kvs = quant_rows(kv.reshape(-1, c))
    scale = 1.0 / ((c // heads) ** 0.5)
    q = bias_epilogue(x8, xs, wq, bq, scale).to(torch.bfloat16)
    k = bias_epilogue(kv8, kvs, wk, bk).to(torch.bfloat16)
    v = bias_epilogue(kv8, kvs, wv, bv).to(torch.bfloat16)
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    o = bf16_attention(heads_of(q, b, n, heads), heads_of(k, b, m, heads),
                       heads_of(v, b, m, heads), mask)
    o8, os_ = row_max_bits_quant(o.transpose(1, 2).reshape(b * n, c), heads)
    y = x.reshape(-1, c) + int8_dense(o8, os_, wo.values, wo.scales, bo)
    return fs.layernorm(y, g, beta, eps).reshape(b, n, c)


def design_unfused(x, w_qkv, b_qkv, w_proj, b_proj, heads, mask=None):
    b, n, c = x.shape
    s_qkv, bq = fs.fold_sm_scale(w_qkv, b_qkv, c, (c // heads) ** -0.5)
    x8, xs = quant_rows(x.reshape(-1, c))
    qkv = int8_dense(x8, xs, w_qkv.values, s_qkv, bq)
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    o = f32_attention(q, k, v, None if mask is None else mask[:, None])
    o8, os_ = row_max_bits_quant(o.transpose(1, 2).reshape(b * n, c), heads)
    out = int8_dense(o8, os_, w_proj.values, w_proj.scales, b_proj)
    return out.reshape(b, n, c)


# ----------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("d", [384, 64, 48])
def test_f64_sums_of_f32_operands_round_to_the_float64_product(d):
    """Row 7's scores and P.V: the kernel's float64 order, rounded once,
    gives the float64 product's float32 values (head widths 384 on the
    path, 64, and 48: a slice of 16 after one of 32)."""
    rs = np.random.RandomState(d)
    q = t(rs.randn(2, 2, 64, d).astype(np.float32) * d ** -0.5)
    k = t(rs.randn(2, 2, 80, d).astype(np.float32))
    v = t(rs.randn(2, 2, 80, d).astype(np.float32))
    s = f64_scores(q, k)
    assert torch.equal(
        s, torch.matmul(q.double(), k.double().transpose(-1, -2)).float())
    p = torch.softmax(s, -1)
    assert torch.equal(f64_pv(p, v),
                       torch.matmul(p.double(), v.double()).float())
    want = fs.attention_reference(q, k, v, None, exact_scores=True,
                                  exact_pv=True)
    assert torch.equal(f32_attention(q, k, v, None), want)


def test_key_mask_equals_its_broadcast():
    """Row 4's (B, M) key mask, read at b*M + 0*i + j, is the (B, N, M)
    mask whose every query row is the image's key mask; the plain attention
    gives the same values under either form."""
    rs = np.random.RandomState(3)
    b, n, m = 3, 24, 80
    kv_mask = t(rs.rand(b, m) < 0.4)
    kv_mask[2] = False                       # an image with every key masked
    flat = kv_mask.reshape(-1).numpy()
    bi, ii, jj = np.meshgrid(np.arange(b), np.arange(n), np.arange(m),
                             indexing="ij")
    read = t(flat[bi * m + ii * 0 + jj])
    full = kv_mask[:, None, :].expand(b, n, m)
    assert torch.equal(read, full)
    q = t(rs.randn(b, 2, n, 64).astype(np.float32)).to(torch.bfloat16)
    k = t(rs.randn(b, 2, m, 64).astype(np.float32)).to(torch.bfloat16)
    v = t(rs.randn(b, 2, m, 64).astype(np.float32)).to(torch.bfloat16)
    got = fs.attention_reference(q, k, v, kv_mask[:, None, None, :],
                                 exact_scores=True)
    want = fs.attention_reference(q, k, v, full[:, None], exact_scores=True)
    assert torch.equal(got, want)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("d", [64, 48])
def test_q_epilogue_takes_the_scale_after_the_bias(d):
    """bf16(((acc * xs) * s + b) * scale) is the plain version's q, (q +
    bq) * scale, for any head width. At d = 64 the scale is 0.125 and
    folding it into s and b gives the same bits; the kernel takes it after
    the bias all the same."""
    rs = np.random.RandomState(d)
    c = 4 * d
    x8, xs = quant_rows(t(rs.randn(96, c).astype(np.float32)))
    w, bias = _dense(rs, c, c)
    wq, bq = qw(w), t(bias)
    scale = 1.0 / (d ** 0.5)
    plain = (int8_dense(x8, xs, wq.values, wq.scales, bq) * scale).to(
        torch.bfloat16)
    got = bias_epilogue(x8, xs, wq, bq, scale).to(torch.bfloat16)
    assert torch.equal(got, plain)
    if d == 64:
        folded = int8_dense(x8, xs, wq.values, wq.scales * scale,
                            bq * scale).to(torch.bfloat16)
        assert torch.equal(folded, plain)


# ----------------------------------------------------------------------------
# the chains


def _bert_case(rs, b, n, m, c):
    x = rs.randn(b, n, c).astype(np.float32)
    kv = x if m is None else rs.randn(b, m, c).astype(np.float32)
    dense = [_dense(rs, c, c) for _ in range(4)]
    g = (rs.rand(c) + 0.5).astype(np.float32)
    beta = (rs.randn(c) * 0.1).astype(np.float32)
    return x, kv, dense, g, beta


@pytest.mark.parametrize("m,masked", [(None, False), (8, True)],
                         ids=["self", "cross-masked"])
def test_bert_design_equals_plain_and_matches_jax(m, masked):
    rs = np.random.RandomState(7)
    b, n, c, heads = 2, 16, 64, 4
    x, kv, dense, g, beta = _bert_case(rs, b, n, m, c)
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, 5:] = False
        mask[1, :] = False                   # every key of image 1 masked
    targs = [a for w, bias in dense for a in (qw(w), t(bias))]
    tmask = None if mask is None else t(mask)
    got = design_bert(t(x), t(kv), *targs, t(g), t(beta), heads, tmask)
    plain = fba.fused_bert_attention_int8_reference(
        t(x), t(kv), *targs, t(g), t(beta), heads, tmask)
    assert torch.equal(got, plain)
    want = np.asarray(j_bert(
        jnp.asarray(x), jnp.asarray(kv),
        *[jnp.asarray(a) for pair in dense for a in pair], jnp.asarray(g),
        jnp.asarray(beta), heads,
        kv_mask=None if mask is None else jnp.asarray(mask), interpret=True))
    assert max_rel(got.numpy(), want) <= BERT_JAX_TOL
    if masked:
        # queries with every key masked: LN(bo + x)
        np.testing.assert_array_equal(
            got[1].numpy(),
            fs.layernorm(t(x[1]) + t(dense[3][1]), t(g), t(beta),
                         1e-12).numpy())


def _unfused_case(rs, b, n, c, mask_kind):
    x = rs.randn(b, n, c).astype(np.float32)
    wqkv, bqkv = _dense(rs, c, 3 * c)
    wp, bp = _dense(rs, c, c)
    if mask_kind == "block":
        labels = rs.randint(0, 3, size=(b, n))
        mask = labels[:, :, None] == labels[:, None, :]
    else:                                    # valid x valid, masked rows
        valid = np.zeros((b, n), bool)
        for i, k in enumerate([n - 7, 9][:b]):
            valid[i, :k] = True
        mask = valid[:, None, :] & valid[:, :, None]
    return x, wqkv, bqkv, wp, bp, mask


@pytest.mark.parametrize("b,n,c,heads,mask_kind", [
    (1, 8, 768, 2, "block"),          # head width 384, as on the path
    (2, 12, 256, 2, "valid"),         # the inter Block: fully masked rows
    (2, 24, 96, 2, "block"),          # head width 48: slices of 32 and 16
], ids=["hd384", "inter", "hd48"])
def test_unfused_design_within_the_bars(b, n, c, heads, mask_kind,
                                       monkeypatch):
    rs = np.random.RandomState(300 + c + n)
    x, wqkv, bqkv, wp, bp, mask = _unfused_case(rs, b, n, c, mask_kind)
    args = (t(x), qw(wqkv), t(bqkv), qw(wp), t(bp), heads)
    got = design_unfused(*args, t(mask))
    assert torch.equal(got, fai.fused_attention_int8_reference(*args,
                                                               t(mask)))
    # the plain steps with a float32 P.V in cuBLAS's order
    reference = fs.attention_reference
    monkeypatch.setattr(fai, "attention_reference",
                        lambda q, k, v, m, **kw: reference(
                            q, k, v, m, **{**kw, "exact_pv": False}))
    f32_pv = fai.fused_attention_int8_reference(*args, t(mask))
    assert max_rel(got.numpy(), f32_pv.numpy()) <= ATTN_TOL
    assert close_share(got.numpy(), f32_pv.numpy()) >= ATTN_SHARE
    want = np.asarray(j_unfused(
        *map(jnp.asarray, (x, wqkv, bqkv, wp, bp)), heads, jnp.asarray(mask),
        None, interpret=True))
    assert max_rel(got.numpy(), want) <= ATTN_TOL
    assert close_share(got.numpy(), want) >= ATTN_SHARE
    rows = ~mask.any(-1)
    if rows.any():
        np.testing.assert_array_equal(got.numpy()[rows],
                                      np.broadcast_to(bp, got[rows].shape))
