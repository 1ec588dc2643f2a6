"""Symmetric int8 and int4 quantisation, as the JAX package's kernels do it.

The counterpart of `setok_tpu/kernels/quant_matmul.py::quantize_weight`,
`quantize_weight_int4` and `unpack_nibbles`, of the `_quant_rows` helper of
`setok_tpu/kernels/fused_sublayer.py`, and the plain versions of the w8a8
and w4a8 kernels (`quant_matmul_plain`, `quant4_matmul_plain`; their CUDA
kernels are in kernels/quant_matmul.py). Weights are in the torch (out, in)
layout.

Note the two orders of max and divide:

    weights  s = max(absmax / 127, 1e-8)     per output channel
    rows     s = max(absmax, 1e-8) / 127     per activation row
    int4     s = max(absmax, 1e-8) / 7       per output channel or group

Each divides as a true division, as the JAX kernels and the CUDA kernels
do: PyTorch on the card turns `tensor / 127.0` into a product with the
reciprocal, which can differ in the last bit, so the divisor here is a
tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class QuantizedWeight(NamedTuple):
    values: torch.Tensor   # (out, in) int8
    scales: torch.Tensor   # (out,) float32, one per output channel


class Quant4Weight(NamedTuple):
    """Half-packed int4: byte i of output channel n holds logical input row
    i in its low nibble and row i + in/2 in its high nibble (the JAX
    package's layout, transposed to (out, in/2))."""
    packed: torch.Tensor   # (out, in/2) int8
    scales: torch.Tensor   # (groups or 1, out) float32; group g scales
    #                        logical input rows [g·G, (g+1)·G)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    return t / torch.full_like(t, d)


def _div127(t: torch.Tensor) -> torch.Tensor:
    return _div(t, 127.0)


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel symmetric int8 of a (out, in) weight."""
    w = w.float()
    scale = _div127(w.abs().amax(dim=1)).clamp_min(1e-8)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(values=q, scales=scale)


def quantize_weight_int4(w: torch.Tensor, group_size: Optional[int] = None,
                         clip_search: int = 0,
                         row_weight=None) -> Quant4Weight:
    """Symmetric int4 ([-7, 7]) of a (out, in) weight, packed.

    `group_size=None`: one scale per output channel; `G`: one per G input
    rows. `clip_search=R` tries R clip ratios in [1.0, 0.5]·absmax and keeps,
    per scale, the one of least squared reconstruction error, in the JAX
    package's order, so that the bytes and scales are the same.
    `row_weight` (in,), the calibration's E[x_k²] per input row
    (serve/calibrate.py), weights each row's squared error in that search,
    so that it minimises the output's error rather than the weight's; the
    weighted error is summed in float32, as the JAX package sums it."""
    wt = w.float().t()                                   # (K, N), as JAX
    k = wt.shape[0]
    if k % 2:
        raise ValueError(f"int4 packing needs an even input width, got {k}")
    if group_size is None:
        wg = wt.reshape(1, k, -1)
    else:
        if k % group_size or (k // 2) % group_size:
            raise ValueError(f"group {group_size} must divide {k} and {k // 2}")
        wg = wt.reshape(k // group_size, group_size, -1)
    scale = _div(wg.abs().amax(dim=1).clamp_min(1e-8), 7.0)       # (g, N)
    if clip_search:
        dw = None if row_weight is None else torch.as_tensor(
            row_weight, dtype=torch.float32, device=wg.device).reshape(
            wg.shape[0], wg.shape[1], 1)
        best_err = torch.full_like(scale, float("inf"))
        best_scale = scale
        for r in np.linspace(1.0, 0.5, clip_search):
            s = scale * float(r)
            q = torch.round(wg / s[:, None, :]).clamp(-7, 7)
            sq = (wg - q * s[:, None, :]) ** 2
            err = (sq if dw is None else dw * sq).sum(dim=1)
            best_scale = torch.where(err < best_err, s, best_scale)
            best_err = torch.minimum(err, best_err)
        scale = best_scale
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    q = q.reshape(k, -1).to(torch.int32)
    packed = (q[: k // 2] & 0xF) | ((q[k // 2:] & 0xF) << 4)
    return Quant4Weight(packed=packed.to(torch.int8).t().contiguous(),
                        scales=scale.contiguous())


def unpack_nibbles(p: torch.Tensor):
    """int8 bytes → two sign-extended int8 planes (low, high)."""
    p32 = p.to(torch.int32)
    lo = p32 & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    return lo.to(torch.int8), (p32 >> 4).to(torch.int8)


def quant_rows(x: torch.Tensor):
    """int8 rows of f32 x and their (…, 1) scales; round half to even."""
    s = _div127(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.round(x / s).clamp(-127, 127).to(torch.int8), s


def int_dot(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """a8 · b8ᵀ of two int8 matrices, the exact integer product rounded
    once to float32. It is taken in float64, where every partial sum of
    int8 products (|acc| < 2^31 < 2^53) is exact, so it is the int32
    product on any device, and its cast rounds as int32 → float32 does."""
    return torch.matmul(a8.double(), b8.double().t()).float()


def int8_dense(x8: torch.Tensor, xs: torch.Tensor, values: torch.Tensor,
               scales: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """acc·x_scale·w_scale + bias, in that order, acc = x8 · valuesᵀ."""
    return int_dot(x8, values) * xs * scales + bias


def quant_matmul_plain(x: torch.Tensor, w: QuantizedWeight,
                       out_dtype=None) -> torch.Tensor:
    """Plain version of the w8a8 `quant_matmul`: x (..., K) → (..., N),
    (acc·x_scale)·w_scale with dynamic per-row int8 activations."""
    *lead, k = x.shape
    x8, xs = quant_rows(x.reshape(-1, k).float())
    out = int_dot(x8, w.values) * xs * w.scales.reshape(-1)
    return out.to(out_dtype or x.dtype).reshape(*lead, -1)


def quant4_matmul_plain(x: torch.Tensor, w: Quant4Weight,
                        out_dtype=None) -> torch.Tensor:
    """Plain version of the w4a8 `quant4_matmul`. One scale per channel:
    (acc_lo + acc_hi)·x_scale·w_scale. Grouped: one int32 dot per group,
    scaled into a float32 accumulator, the low plane's groups first, then
    the high plane's, then ·x_scale (the JAX kernel's order)."""
    *lead, k = x.shape
    kh = k // 2
    x8, xs = quant_rows(x.reshape(-1, k).float())
    lo, hi = unpack_nibbles(w.packed)
    n_scales = w.scales.shape[0]
    if n_scales == 1:
        acc = torch.matmul(x8[:, :kh].double(), lo.double().t()) \
            + torch.matmul(x8[:, kh:].double(), hi.double().t())
        out = acc.float() * xs * w.scales[0]
    else:
        n_half = n_scales // 2
        g = kh // n_half
        out = torch.zeros(x8.shape[0], lo.shape[0], dtype=torch.float32,
                          device=x.device)
        for plane, offset, base in ((lo, 0, 0), (hi, kh, n_half)):
            for i in range(n_half):
                cols = slice(i * g, (i + 1) * g)
                a = int_dot(x8[:, offset + i * g:offset + (i + 1) * g],
                            plane[:, cols])
                out = out + a * w.scales[base + i]
        out = out * xs
    return out.to(out_dtype or x.dtype).reshape(*lead, -1)
