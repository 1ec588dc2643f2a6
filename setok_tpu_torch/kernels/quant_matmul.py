"""w8a8 and w4a8 products of the serving trunk: the CUDA kernels' wrappers.

The counterparts of `setok_tpu/kernels/quant_matmul.py::quant_matmul` (int8
weights, per-output-channel scales) and `quant4_matmul` (half-packed int4
nibbles, per-channel or per-group scales). Activations are quantised per
row inside the call (dynamic scale, no calibration), the int products are
exact, and the scales apply in the JAX kernel's order (kernels/quant.py,
whose `quant_matmul_plain` / `quant4_matmul_plain` are the plain versions).

A CPU tensor runs the plain version; a CUDA tensor launches
`csrc/quant_matmul.cu` or raises. x is read in its own type (float32,
bfloat16 or float16) and the output type is written by the kernel. M <= 8
rows (decode): one launch, a weight-streaming GEMV that quantises the rows
itself, and one allocation, the output. Above: a row-quantisation pass into
one scratch buffer (the int8 rows, their scales and, for int4, their sums
over each group), then the wgmma GEMM, int8 weights as they are or int4
nibbles unpacked into its B tile. Nothing is cast.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from setok_tpu_torch.kernels.quant import (Quant4Weight, QuantizedWeight,
                                           quant4_matmul_plain,
                                           quant_matmul_plain)

FUNCTIONS = ("quant_matmul", "quant4_matmul")
# CUDA kernel launches on the card, and wrapper calls that launched, per
# function, since import or since reset_counts()
LAUNCHES = dict.fromkeys(FUNCTIONS, 0)
CALLS = dict.fromkeys(FUNCTIONS, 0)


def reset_counts() -> None:
    for name in FUNCTIONS:
        LAUNCHES[name] = CALLS[name] = 0


def _check(name: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
           n: int, w_cols: int, n_scales: int) -> None:
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name} takes a float input, got {x.dtype}")
    if w.dtype != torch.int8 or tuple(w.shape) != (n, w_cols):
        raise ValueError(f"{name}: int8 ({n}, {w_cols}) weight expected, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (n_scales, n):
        raise ValueError(f"{name}: float32 ({n_scales}, {n}) scales expected,"
                         f" got {s.dtype} {tuple(s.shape)}")
    for t in (w, s):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: weight and scales must be contiguous "
                             f"on {dev}")


# the C entry's type codes
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scratch_bytes(m: int, k: int, bits: int, n_scales: int) -> int:
    """The scratch of a call of m > 8 rows (the C entry's layout, each part
    at a multiple of 16 bytes): the (m, k) int8 rows, their m float32
    scales and, at bits 4, their (m, n_scales) int32 sums over each group
    (or all of k). At m <= 8 the GEMV quantises the rows in shared
    memory."""
    def up(n):
        return (n + 15) // 16 * 16
    return up(m * k) + up(4 * m) + (4 * m * n_scales if bits == 4 else 0)


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
            bits: int, out_dtype) -> torch.Tensor:
    *lead, k = x.shape
    n = w.shape[0]
    dev = x.device
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _TYPES:
        raise TypeError(f"{name} writes float32, bfloat16 or float16, got "
                        f"{out_dtype}")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        # the row pass reads 16 bytes a load
        x2 = x2.clone(memory_format=torch.contiguous_format)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    scratch = None
    if m > 8:
        scratch = torch.empty((_scratch_bytes(m, k, bits, s.shape[0]),),
                              dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    err = _entry()(x2.data_ptr(), _TYPES[x2.dtype], w.data_ptr(),
                   s.data_ptr(), s.shape[0], bits, out.data_ptr(),
                   _TYPES[out_dtype],
                   0 if scratch is None else scratch.data_ptr(), m, n, k,
                   dev.index, _stream_of(dev.index), ctypes.byref(launched))
    LAUNCHES[name] += launched.value
    if launched.value:
        CALLS[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} "
                           f"(M={m}, N={n}, K={k})")
    return out.reshape(*lead, n)


def quant_matmul(x: torch.Tensor, w: QuantizedWeight,
                 out_dtype=None) -> torch.Tensor:
    """x: (..., K) float → (..., N) in out_dtype (default x.dtype);
    w.values (N, K) int8, w.scales N float32 per output channel."""
    n, k = w.values.shape
    scales = w.scales.reshape(1, n)
    _check("quant_matmul", x, w.values, scales, n, k, 1)
    if x.shape[-1] != k:
        raise ValueError(f"quant_matmul: input width {x.shape[-1]} != {k}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, QuantizedWeight(w.values, scales[0]),
                                  out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, got {x.device}")
    return _launch("quant_matmul", x, w.values, scales, 8, out_dtype)


def quant4_matmul(x: torch.Tensor, w: Quant4Weight,
                  out_dtype=None) -> torch.Tensor:
    """x: (..., K) float → (..., N); w.packed (N, K/2) int8 nibbles,
    w.scales (1 or K/G, N) float32."""
    n, kh = w.packed.shape
    k = 2 * kh
    n_scales = w.scales.shape[0]
    if n_scales != 1 and (n_scales % 2 or kh % (n_scales // 2)):
        raise ValueError(f"quant4_matmul: {n_scales} scale rows are neither "
                         f"one per channel nor whole groups of {k} rows")
    _check("quant4_matmul", x, w.packed, w.scales, n, kh, n_scales)
    if x.shape[-1] != k:
        raise ValueError(f"quant4_matmul: input width {x.shape[-1]} != {k}")
    if x.device.type == "cpu":
        return quant4_matmul_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant4_matmul runs on cuda or cpu, got {x.device}")
    return _launch("quant4_matmul", x, w.packed, w.scales, 4, out_dtype)


def _stream_of(index: int) -> int:
    """The handle of the device's current stream: the raw query, which
    builds no Stream object (a decode step makes 224 of these calls)."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.cache
def _entry():
    """The C entry of csrc/quant_matmul.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = load_library("quant_matmul").quant_matmul
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, i, p, i, p, i, i, i, i, p,
                   ctypes.POINTER(i)]
    return fn
