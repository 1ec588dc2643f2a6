"""The int8 whole-sublayer kernel chains' numerics (`csrc/fused_sublayer.cu`:
attn_sublayer_int8, mlp_sublayer_int8, mlp_postnorm_int8), modelled in
plain PyTorch, against the plain versions and the JAX kernels.

`design_mlp` computes what the MLP chain computes: the LayerNorm and the
row quantisation in one pass over x (the row's f64 statistics rounded
once, then s = max|y| / 127 of the normalised row); fc1 on the wgmma GEMM
with gelu_tanh((acc * xs) * s1 + b1), whose |h| row maxima are reduced as
the epilogue reduces them (each consumer thread's fragment columns c0 + 8j
+ e, c0 = 2 * t4, of each 256-column tile, over the row's 4 lanes, then one
atomicMax on the float's bits a row and tile, in any order); the hidden
rows quantised in one read with hs = max(hmax, 1e-8) / 127; fc2 with x +
((acc * hs) * s2 + b2), the residual last. The post-norm form quantises x
without the LayerNorm, writes z = x + fc2(...) and normalises it.

`design_attn` computes what the attention chain computes: the same row
pass; qkv = bf16((acc * xs) * s + b) with sm_scale folded into the q
columns; each head's scores summed in float64 in the kernel's order (lane
t4 takes 16-byte chunk c0 + t4 of D, k step i its value i) and rounded once
to float32 (any order gives the exact value); the mask bias, the row max,
p = exp(s - m) and l in float32, p in bf16; P.V with each 16-key slice
summed from zero and the slices added in float32; o = PV * (1/l); each
row's |o| maximum over the heads posted by its bits in a random head
order; o quantised in one read; proj with the residual.

Bars: the MLP designs equal `mlp_sublayer_int8_reference` and
`mlp_postnorm_int8_reference` bit for bit, at the path's head widths and
at ragged row counts, and the JAX kernels (interpret mode) within 1e-5
max-rel at the cases of tests/test_torch_int8.py; the attention design is
within the card bar of its plain version (chip_smoke.INT8_ATTN_TOL, max-rel
2e-3, and INT8_ATTN_SHARE, >= 99 % of the elements within 1e-5 of the
largest) at head widths 64, 48 and 384 (masked, a fully masked row) and at
N = 80 with the inter Block's mask, within 2e-3 max-rel of the JAX kernel
there, and within both bars of the JAX kernel at the cases of
tests/test_torch_int8.py::test_attn_sublayer_matches_jax. (At C = 768 the
plain version, the float32-score one of earlier versions too, falls under
the share bar against the JAX kernel: JAX takes the LayerNorm statistics in
float32, the port in float64 rounded once, and a last-bit difference of the
normalised row flips an int8 step of x in some rows.)
The bit-pattern maximum equals `o.abs().amax(-1)` and the single-read
quantisation equals `quant_rows(o)`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.fused_sublayer import attn_sublayer_int8 as j_attn
from setok_tpu.kernels.fused_sublayer import mlp_postnorm_int8 as j_post
from setok_tpu.kernels.fused_sublayer import mlp_sublayer_int8 as j_mlp
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels.quant import (QuantizedWeight, int8_dense,
                                           quant_rows, quantize_weight)

ATTN_TOL = 2e-3           # chip_smoke.INT8_ATTN_TOL
ATTN_SHARE = 0.99         # chip_smoke.INT8_ATTN_SHARE
MLP_JAX_TOL = 1e-5        # tests/test_torch_int8.py KERNEL_TOL
TILE_N = 256              # columns of a GEMM tile


def ln_quant_rows(x, g, b, eps):
    """The one-pass LayerNorm and row quantisation of `quant_rows_kernel`:
    mean and variance as float64 sums of the row rounded once, the
    normalised row in float32, its int8 row and scale."""
    xd = x.double()
    mu = (xd.sum(-1, keepdim=True) / x.shape[-1]).float()
    d = x - mu
    var = ((d.double() ** 2).sum(-1, keepdim=True) / x.shape[-1]).float()
    r = torch.rsqrt((var + eps).double()).float()
    return quant_rows(d * r * g + b)


def fragment_row_max_bits(h: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The rows' |h| maxima as the GEMM epilogue posts them: per tile of
    256 columns, each lane t4 of the 4 that share a row takes columns
    8 j + 2 t4 + e, the 4 lanes reduce by shuffles, and each tile's row
    maximum is atomicMax'd on its bit pattern (int32 order) into a buffer
    that starts at +0.0, the tiles in a random order."""
    m, n = h.shape
    bits = torch.zeros(m, dtype=torch.int32)
    tiles = list(range(0, n, TILE_N))
    np.random.RandomState(seed).shuffle(tiles)
    cols = torch.arange(n)
    for n0 in tiles:
        tile = (cols >= n0) & (cols < n0 + TILE_N)
        lanes = []
        for t4 in range(4):
            mine = tile & (((cols - n0) % 8) // 2 == t4)
            lanes.append(h[:, mine].abs().amax(-1) if bool(mine.any())
                         else torch.zeros(m))
        tile_max = torch.stack(lanes, -1).amax(-1)
        bits = torch.maximum(bits, tile_max.view(torch.int32))
    return bits.view(torch.float32)


def head_row_max_bits(o: torch.Tensor, heads: int, seed: int = 0):
    """The rows' |o| maxima as the attention kernel posts them: each head's
    block reduces its row over the head's columns, then one atomicMax on
    the bits a row and head, the heads in a random order."""
    m, c = o.shape
    d = c // heads
    bits = torch.zeros(m, dtype=torch.int32)
    order = np.random.RandomState(seed).permutation(heads)
    for h in order:
        head_max = o[:, h * d:(h + 1) * d].abs().amax(-1)
        bits = torch.maximum(bits, head_max.view(torch.int32))
    return bits.view(torch.float32)


def single_read_quant(h: torch.Tensor, amax: torch.Tensor):
    """`hidden_quant_kernel`: one read of the rows, the scale from the
    posted maxima."""
    s = torch.clamp_min(amax, 1e-8)[:, None] / torch.tensor(127.0)
    return torch.round(h / s).clamp(-127, 127).to(torch.int8), s


def design_mlp(x, ln_g, ln_b, w1: QuantizedWeight, b1, w2: QuantizedWeight,
               b2, ln_eps=1e-6, post_g=None, post_b=None, post_eps=1e-12):
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c).float()
    if ln_g is None:
        x8, xs = quant_rows(x2)
    else:
        x8, xs = ln_quant_rows(x2, ln_g, ln_b, ln_eps)
    h = fs.gelu_tanh(int8_dense(x8, xs, w1.values, w1.scales, b1))
    h8, hs = single_read_quant(h, fragment_row_max_bits(h))
    z = x2 + int8_dense(h8, hs, w2.values, w2.scales, b2)
    if post_g is not None:
        z = fs.layernorm(z, post_g, post_b, post_eps)
    return z.reshape(*lead, c)


def exact_scores(q, k):
    """float64 sums of q.k in the kernel's order (lane t4 takes chunk c0 +
    t4 of 8 values of D, k step i its value i), rounded once to float32."""
    d = q.shape[-1]
    acc = torch.zeros(q.shape[:-1] + k.shape[-2:-1], dtype=torch.float64)
    qd, kd = q.double(), k.double()
    for c0 in range(0, d // 8, 4):
        for i in range(8):
            for t4 in range(4):
                c = c0 + t4
                if c < d // 8:
                    j = 8 * c + i
                    acc += qd[..., j, None] * kd[..., None, :, j]
    return acc.float()


def design_attention(q, k, v, mask):
    """q, k, v: (B, H, N, D) bf16; mask (B, 1, N, N) bool or None."""
    s = exact_scores(q, k)
    if mask is not None:
        s = s + fs.NEG_INF * (1.0 - mask.float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lr = 1.0 / p.sum(-1, keepdim=True).clamp_min(1e-30)
    lr = torch.where(m > 0.5 * fs.NEG_INF, lr, 0.0)
    p = p.to(torch.bfloat16).float()
    vf = v.float()
    n = p.shape[-1]
    acc = None
    for j0 in range(0, n, 16):
        part = torch.matmul(p[..., j0:j0 + 16], vf[..., j0:j0 + 16, :])
        acc = part if acc is None else acc + part
    return acc * lr


def design_attn(x, ln_g, ln_b, w_qkv: QuantizedWeight, b_qkv,
                w_proj: QuantizedWeight, b_proj, heads, mask=None,
                ln_eps=1e-6, seed=0):
    b, n, c = x.shape
    hd = c // heads
    s_qkv, bq = fs.fold_sm_scale(w_qkv, b_qkv, c, hd ** -0.5)
    x8, xs = ln_quant_rows(x.reshape(-1, c), ln_g, ln_b, ln_eps)
    qkv = int8_dense(x8, xs, w_qkv.values, s_qkv, bq).to(torch.bfloat16)
    q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    o = design_attention(q, k, v, None if mask is None else mask[:, None])
    o = o.transpose(1, 2).reshape(b * n, c)
    o8, os_ = single_read_quant(o, head_row_max_bits(o, heads, seed))
    out = x.reshape(-1, c) + int8_dense(o8, os_, w_proj.values,
                                        w_proj.scales, b_proj)
    return out.reshape(b, n, c)


# ----------------------------------------------------------------------------
# inputs


def _dense(rs, fan_in, fan_out):
    return ((rs.randn(fan_in, fan_out) / np.sqrt(fan_in)).astype(np.float32),
            (rs.randn(fan_out) * 0.1).astype(np.float32))


def _ln(rs, c):
    return ((rs.rand(c) + 0.5).astype(np.float32),
            (rs.randn(c) * 0.1).astype(np.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def qw(w_in_out):
    return quantize_weight(t(w_in_out.T))


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close_share(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= rel * np.abs(want).max()).mean())


def _mask(kind, rs, b, n):
    if kind is None:
        return None
    if kind == "block":
        labels = rs.randint(0, 3, size=(b, n))
        mask = labels[:, :, None] == labels[:, None, :]
        mask[0, 5, :] = False            # a fully masked query row
        return mask
    valid = np.zeros((b, n), bool)       # "valid": valid x valid clusters
    for i, k in enumerate([n - 7, 9][:b]):
        valid[i, :k] = True
    return valid[:, None, :] & valid[:, :, None]


# ----------------------------------------------------------------------------
# the MLPs, bit for bit


@pytest.mark.parametrize("seed,lead,c,hid", [
    (0, (3, 16), 64, 256),
    (1, (37,), 32, 600),       # hidden wider than two tiles, ragged
    (2, (3, 80), 768, 3072),   # the path's widths, 240 rows
])
def test_mlp_design_equals_plain(seed, lead, c, hid):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    g, bb = _ln(rs, c)
    w1, b1 = _dense(rs, c, hid)
    w2, b2 = _dense(rs, hid, c)
    args = (qw(w1), t(b1), qw(w2), t(b2))
    got = design_mlp(t(x), t(g), t(bb), *args, ln_eps=1e-5)
    want = fs.mlp_sublayer_int8_reference(t(x), t(g), t(bb), *args,
                                          ln_eps=1e-5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,lead,c,hid", [
    (3, (4, 20), 64, 256),
    (4, (2, 80), 768, 3072),   # the mapper's widths, ragged rows
])
def test_postnorm_design_equals_plain(seed, lead, c, hid):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    w1, b1 = _dense(rs, c, hid)
    w2, b2 = _dense(rs, hid, c)
    g, bb = _ln(rs, c)
    args = (qw(w1), t(b1), qw(w2), t(b2))
    got = design_mlp(t(x), None, None, *args, post_g=t(g), post_b=t(bb))
    want = fs.mlp_postnorm_int8_reference(t(x), *args, t(g), t(bb))
    assert torch.equal(got, want)


def _mlp_jax_inputs(seed, lead=(3, 16), c=32, hidden=64):
    """tests/test_torch_int8.py's `_mlp_inputs`."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    w1, b1 = _dense(rs, c, hidden)
    w2, b2 = _dense(rs, hidden, c)
    g, bb = _ln(rs, c)
    return x, w1, b1, w2, b2, g, bb


@pytest.mark.parametrize("seed,lead", [(0, (3, 16)), (1, (40,))])
def test_mlp_designs_match_jax(seed, lead):
    """Both MLP designs against the JAX kernels at the cases of
    tests/test_torch_int8.py (test_mlp_sublayer_matches_jax, and
    test_mlp_postnorm_matches_jax's inputs at these seeds)."""
    x, w1, b1, w2, b2, g, bb = _mlp_jax_inputs(seed, lead)
    args = (qw(w1), t(b1), qw(w2), t(b2))
    got = design_mlp(t(x), t(g), t(bb), *args, ln_eps=1e-5)
    want = np.asarray(j_mlp(*map(jnp.asarray, (x, g, bb, w1, b1, w2, b2)),
                            ln_eps=1e-5, block_m=16, interpret=True))
    assert max_rel(got.numpy(), want) <= MLP_JAX_TOL
    got = design_mlp(t(x), None, None, *args, post_g=t(g), post_b=t(bb))
    want = np.asarray(j_post(*map(jnp.asarray, (x, w1, b1, w2, b2, g, bb)),
                             block_m=16, interpret=True))
    assert max_rel(got.numpy(), want) <= MLP_JAX_TOL


def test_one_pass_layernorm_quant_equals_the_plain_steps():
    """The row pass's LayerNorm (f64 sums of the row, rounded once) and
    quantisation give `quant_rows(layernorm(x))` to the bit, rows of a
    constant and of large offsets included."""
    rs = np.random.RandomState(5)
    x = t(rs.randn(12, 768).astype(np.float32) * 3)
    x[1] = 2.5                              # a constant row: y = b
    x[2] += 1e4                             # a large offset
    g, b = map(t, _ln(rs, 768))
    q8, qs = ln_quant_rows(x, g, b, 1e-6)
    p8, ps = quant_rows(fs.layernorm(x, g, b, 1e-6))
    assert torch.equal(q8, p8) and torch.equal(qs, ps)


# ----------------------------------------------------------------------------
# the attention, within the row's bars


ATTN_CASES = [
    # (seed, B, N, C, heads, mask): head widths 64, 48 and 384; N = 80 with
    # the inter Block's valid x valid mask
    (10, 2, 40, 128, 2, None),             # D = 64
    (11, 2, 36, 96, 2, None),              # D = 48: three k16 slices
    (12, 2, 24, 768, 2, "block"),          # D = 384, a fully masked row
    (13, 3, 80, 768, 2, "valid"),          # N = 80, fully masked rows
]


def _jax_attn(x, g, bb, wqkv, bqkv, wp, bp, heads, mask):
    return np.asarray(j_attn(
        *map(jnp.asarray, (x, g, bb, wqkv, bqkv, wp, bp)), heads,
        mask=None if mask is None else jnp.asarray(mask), ln_eps=1e-5,
        interpret=True))


@pytest.mark.parametrize("seed,b,n,c,heads,mask_kind", ATTN_CASES,
                         ids=["d64", "d48", "d384-masked", "n80-inter"])
def test_attn_design_within_the_bars(seed, b, n, c, heads, mask_kind):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, c).astype(np.float32)
    g, bb = _ln(rs, c)
    wqkv, bqkv = _dense(rs, c, 3 * c)
    wp, bp = _dense(rs, c, c)
    mask = _mask(mask_kind, rs, b, n)
    tm = None if mask is None else t(mask)
    args = (t(x), t(g), t(bb), qw(wqkv), t(bqkv), qw(wp), t(bp), heads)
    got = design_attn(*args, mask=tm, ln_eps=1e-5).numpy()
    want = fs.attn_sublayer_int8_reference(*args, mask=tm,
                                           ln_eps=1e-5).numpy()
    assert max_rel(got, want) <= ATTN_TOL
    assert close_share(got, want) >= ATTN_SHARE
    jax_out = _jax_attn(x, g, bb, wqkv, bqkv, wp, bp, heads, mask)
    assert max_rel(got, jax_out) <= ATTN_TOL
    if mask is not None:
        # a fully masked query row attends to nothing: out = x + b_proj
        rows = ~mask.any(-1)
        assert rows.any()
        np.testing.assert_array_equal(got[rows], (x + bp)[rows])


@pytest.mark.parametrize("b,n,c,heads,mask_kind", [
    (2, 16, 64, 4, None),
    (2, 16, 96, 2, None),
    (2, 24, 128, 2, "block"),
    (2, 12, 256, 2, "valid"),
], ids=["vit", "hd48", "inner", "inter"])
def test_attn_design_matches_jax(b, n, c, heads, mask_kind):
    """The attention design against the JAX kernel at the inputs and bars
    of tests/test_torch_int8.py::test_attn_sublayer_matches_jax."""
    rs = np.random.RandomState(1000 + c + n)
    x = rs.randn(b, n, c).astype(np.float32)
    g, bb = _ln(rs, c)
    wqkv, bqkv = _dense(rs, c, 3 * c)
    wp, bp = _dense(rs, c, c)
    if mask_kind == "block":
        labels = rs.randint(0, 3, size=(b, n))
        mask = labels[:, :, None] == labels[:, None, :]
    elif mask_kind == "valid":
        valid = np.zeros((b, n), bool)
        for i, k in enumerate([n - 3, 5]):
            valid[i, :k] = True
        mask = valid[:, None, :] & valid[:, :, None]
    else:
        mask = None
    got = design_attn(t(x), t(g), t(bb), qw(wqkv), t(bqkv), qw(wp), t(bp),
                      heads, mask=None if mask is None else t(mask),
                      ln_eps=1e-5).numpy()
    want = _jax_attn(x, g, bb, wqkv, bqkv, wp, bp, heads, mask)
    assert max_rel(got, want) <= ATTN_TOL
    assert close_share(got, want) >= ATTN_SHARE


def test_exact_scores_are_order_free():
    """The kernel's order of the f64 score sums, the plain version's
    float64 product and a reversed order round to the same float32 scores:
    bf16 x bf16 products and their sums are exact in float64."""
    rs = np.random.RandomState(14)
    q = t(rs.randn(2, 3, 24, 48).astype(np.float32)).to(torch.bfloat16)
    k = t(rs.randn(2, 3, 40, 48).astype(np.float32) * 4).to(torch.bfloat16)
    got = exact_scores(q, k)
    want = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    rev = exact_scores(q.flip(-1), k.flip(-1))
    assert torch.equal(got, want) and torch.equal(rev, want)


def test_head_row_max_bits_is_the_abs_max():
    """Rows of zeros, of negative values only, and mixed signs; the heads
    in several orders."""
    rs = np.random.RandomState(15)
    o = t(rs.randn(7, 768).astype(np.float32))
    o[1] = 0.0
    o[2] = -o[2].abs()
    o[3, 700] = -1e4                        # the largest magnitude, negative
    o[4] = -0.0
    want = o.abs().amax(-1)
    for seed in range(3):
        assert torch.equal(head_row_max_bits(o, 2, seed), want)
        assert torch.equal(head_row_max_bits(o, 12, seed), want)
        assert torch.equal(fragment_row_max_bits(o, seed), want)


def test_single_read_quantisation_equals_quant_rows():
    rs = np.random.RandomState(16)
    o = t(rs.randn(9, 768).astype(np.float32) * 3)
    o[0] = 0.0
    o8, os_ = single_read_quant(o, head_row_max_bits(o, 12))
    q8, qs = quant_rows(o)
    assert torch.equal(o8, q8) and torch.equal(os_, qs)


def test_plain_attention_scores_are_exact():
    """The plain version's attention takes each score as its exact value
    rounded once (`exact_scores=True`), which a float32 product reaches
    only up to its rounding order."""
    rs = np.random.RandomState(17)
    q = t(rs.randn(1, 2, 16, 64).astype(np.float32)).to(torch.bfloat16)
    k = t(rs.randn(1, 2, 16, 64).astype(np.float32)).to(torch.bfloat16)
    v = t(rs.randn(1, 2, 16, 64).astype(np.float32)).to(torch.bfloat16)
    got = fs.attention_reference(q, k, v, None, exact_scores=True)
    s = exact_scores(q, k)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    lr = 1.0 / p.sum(-1, keepdim=True)
    want = torch.matmul(p.to(torch.bfloat16).float(), v.float()) * lr
    assert torch.equal(got, want)
