"""Symmetric int8 quantisation, as the JAX package's int8 kernels do it.

The counterpart of `setok_tpu/kernels/quant_matmul.py::quantize_weight` and
of the `_quant_rows` helper of `setok_tpu/kernels/fused_sublayer.py`, in the
torch (out, in) weight layout. Only these helpers are ported: the w8a8
`quant_matmul` kernel is still to port (ROADMAP.md, Queue B row 8).

Note the two orders of max and divide:

    weights  s = max(absmax / 127, 1e-8)     per output channel
    rows     s = max(absmax, 1e-8) / 127     per activation row

Both divide by 127 as a true division, as the JAX kernels and the CUDA
kernels do: PyTorch on the card turns `tensor / 127.0` into a product with
the reciprocal, which can differ in the last bit, so the divisor here is a
tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedWeight(NamedTuple):
    values: torch.Tensor   # (out, in) int8
    scales: torch.Tensor   # (out,) float32, one per output channel


def _div127(t: torch.Tensor) -> torch.Tensor:
    return t / torch.full_like(t, 127.0)


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel symmetric int8 of a (out, in) weight."""
    w = w.float()
    scale = _div127(w.abs().amax(dim=1)).clamp_min(1e-8)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(values=q, scales=scale)


def quant_rows(x: torch.Tensor):
    """int8 rows of f32 x and their (…, 1) scales; round half to even."""
    s = _div127(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    return torch.round(x / s).clamp(-127, 127).to(torch.int8), s


def int8_dense(x8: torch.Tensor, xs: torch.Tensor, values: torch.Tensor,
               scales: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """acc·x_scale·w_scale + bias, in that order, with acc the exact int32
    product x8 · values^T. The product is taken in float64, where every
    partial sum of int8 products (|acc| < 2^31 < 2^53) is exact, so it is
    the integer product on any device; its cast to float32 rounds as the
    int32 → float32 cast does."""
    acc = torch.matmul(x8.double(), values.double().transpose(0, 1)).float()
    return acc * xs * scales + bias
