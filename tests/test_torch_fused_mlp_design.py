"""The int8 `fused_mlp_int8` kernel chain's numerics, modelled in plain
PyTorch, against the plain version and the JAX kernel.

`design_mlp` computes what `csrc/fused_mlp.cu` computes: x row-quantised
(x read in its own type, float32 or bfloat16, widened exactly); fc1 on the
wgmma GEMM with the epilogue h = gelu_tanh((acc * xs) * s1 + b1), whose
|h| row maxima are reduced as the kernel reduces them: each consumer
thread's fragment (columns c0 + 8 j + e of its two rows, c0 = 2 * t4 in
each 128 x 256 tile), then over the 4 lanes that share a row, then one
atomicMax on the float's bit pattern a row and tile, in any order; the
hidden row quantised in one read with hs = max(hmax, 1e-8) / 127; fc2 on
the GEMM with (acc * hs) * s2 + b2, float32 out.

Bars: the design equals the plain version `fused_mlp_int8_reference` bit
for bit, the bit-pattern maximum equals `h.abs().amax(-1)` (rows of zeros
and of negative values included), the single-read quantisation equals
`quant_rows(h)`, a bfloat16 x gives what its float32 widening gives, and
the design matches the JAX kernel (`fused_mlp.fused_mlp_int8`, interpret
mode) within its bar in tests/test_torch_int8_unfused.py, 1e-5 max-rel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.fused_mlp import fused_mlp_int8 as j_mlp
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels.fused_sublayer import gelu_tanh
from setok_tpu_torch.kernels.quant import (QuantizedWeight, int8_dense,
                                           quant_rows, quantize_weight)

JAX_TOL = 1e-5
TILE_N = 256          # columns of a GEMM tile


def fragment_row_max_bits(h: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The rows' |h| maxima as the fc1 epilogue posts them: per tile of
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


def hidden_quant(h: torch.Tensor, hmax: torch.Tensor):
    """The single-read quantisation of the hidden rows."""
    hs = torch.clamp_min(hmax, 1e-8)[:, None]
    hs = hs / torch.tensor(127.0)
    return torch.round(h / hs).clamp(-127, 127).to(torch.int8), hs


def design_mlp(x, w1: QuantizedWeight, b1, w2: QuantizedWeight, b2):
    lead, c = x.shape[:-1], x.shape[-1]
    x8, xs = quant_rows(x.reshape(-1, c).float())
    h = gelu_tanh(int8_dense(x8, xs, w1.values, w1.scales, b1))
    h8, hs = hidden_quant(h, fragment_row_max_bits(h))
    y = int8_dense(h8, hs, w2.values, w2.scales, b2)
    return y.reshape(*lead, -1)


def _weights(rs, c, hid, c_out):
    w1 = (rs.randn(c, hid) / np.sqrt(c)).astype(np.float32)
    w2 = (rs.randn(hid, c_out) / np.sqrt(hid)).astype(np.float32)
    b1 = (rs.randn(hid) * 0.1).astype(np.float32)
    b2 = (rs.randn(c_out) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _port(w1, b1, w2, b2):
    t = torch.from_numpy
    return (quantize_weight(t(w1.T.copy())), t(b1), quantize_weight(
        t(w2.T.copy())), t(b2))


@pytest.mark.parametrize("seed,lead,c,hid,c_out", [
    (0, (3, 16), 32, 64, 32),
    (1, (37,), 32, 600, 32),          # hidden wider than two tiles, ragged
    (2, (2, 5, 7), 64, 128, 48),
])
def test_design_equals_plain_and_jax(seed, lead, c, hid, c_out):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    w1, b1, w2, b2 = _weights(rs, c, hid, c_out)
    args = _port(w1, b1, w2, b2)
    got = design_mlp(torch.from_numpy(x), *args)
    want = fm.fused_mlp_int8_reference(torch.from_numpy(x), *args)
    assert torch.equal(got, want)
    jax_out = np.asarray(j_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                               block_m=16, interpret=True))
    err = np.abs(got.numpy().astype(np.float64) - jax_out).max()
    assert err / np.abs(jax_out).max() <= JAX_TOL


def test_bit_pattern_row_max_is_the_abs_max():
    """Rows of zeros, of negative values only, and mixed signs; the tiles
    in several orders."""
    rs = np.random.RandomState(4)
    h = torch.from_numpy(rs.randn(6, 700).astype(np.float32))
    h[1] = 0.0
    h[2] = -h[2].abs()
    h[3, 5] = -1e4                     # the largest magnitude is negative
    h[4] = -0.0
    want = h.abs().amax(-1)
    for seed in range(3):
        got = fragment_row_max_bits(h, seed)
        assert torch.equal(got, want)


def test_single_read_quantisation_equals_quant_rows():
    rs = np.random.RandomState(5)
    h = torch.from_numpy(rs.randn(9, 3072).astype(np.float32) * 3)
    h[0] = 0.0
    h8, hs = hidden_quant(h, fragment_row_max_bits(h))
    q8, qs = quant_rows(h)
    assert torch.equal(h8, q8) and torch.equal(hs, qs)


def test_bf16_input_is_its_float32_widening():
    """x in bfloat16, read natively by the kernel, is the same function as
    x.float() first: the design on bf16 x equals the plain version on the
    widened x, and the wrapper's plain route takes bf16."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 24, 64).astype(np.float32)).to(
        torch.bfloat16)
    args = _port(*_weights(rs, 64, 256, 64))
    got = design_mlp(x, *args)
    assert torch.equal(got, fm.fused_mlp_int8_reference(x.float(), *args))
    assert torch.equal(fm.fused_mlp_int8(x, *args), got)
    assert got.dtype == torch.float32


def test_wrapper_takes_float32_and_bfloat16_only():
    rs = np.random.RandomState(7)
    args = _port(*_weights(rs, 32, 64, 32))
    x = torch.from_numpy(rs.randn(4, 32).astype(np.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fm.fused_mlp_int8(x.half(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp_int8(x.t(), *args)
