"""The unfused route's int8 MLP: the CUDA kernel and its plain version.

The counterpart of `setok_tpu/kernels/fused_mlp.py`:

    fused_mlp_int8   fc2(gelu_tanh(fc1(x))), int8, no LayerNorm, no residual

the MLP that `Mlp(quant8=True)` takes where the whole-sublayer kernel's
gate fails but `mlp_fits_vmem` passes (the ViT, the inner Block and the
pixel decoder at 384 px). `fused_mlp_int8` launches `csrc/fused_mlp.cu` for
tensors on the card and runs `fused_mlp_int8_reference` for tensors on the
CPU. Both follow the JAX kernel: x is row-quantised, fc1 dequantises as
acc·x_scale·w_scale + b1, the GELU is the tanh form whatever the module's
`gelu_exact` says, the hidden row is quantised over its whole width, and
fc2 dequantises as acc·h_scale·w_scale + b2. The input is float32 or
bfloat16 (the kernel widens bf16 exactly, so it is the same function as
`x.float()` first); the output is float32, as the JAX kernel writes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from setok_tpu_torch.kernels.fused_sublayer import (aligned16,
                                                    check_vectors,
                                                    check_weight, count,
                                                    mlp_int8_core, scratch)
from setok_tpu_torch.kernels.quant import QuantizedWeight

NAME = "fused_mlp_int8"
# CUDA kernel launches on the card, and wrapper calls that launched
LAUNCHES = {NAME: 0}
CALLS = {NAME: 0}


def reset_counts() -> None:
    LAUNCHES[NAME] = CALLS[NAME] = 0


def fused_mlp_int8_reference(x, w1: QuantizedWeight, b1,
                             w2: QuantizedWeight, b2):
    """Plain version of `fused_mlp_int8`."""
    return mlp_int8_core(x.float(), w1, b1, w2, b2)


# the C entry's type codes of x
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_input(x: torch.Tensor) -> None:
    if x.dtype not in _TYPES:
        raise TypeError(f"{NAME} takes float32 or bfloat16 input, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{NAME} takes a contiguous input")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME} runs on cuda or cpu, got {x.device}")


def fused_mlp_int8(x, w1: QuantizedWeight, b1, w2: QuantizedWeight, b2):
    """x: (..., C) f32 or bf16 → fc2(gelu_tanh(fc1 x)): (..., C_out) f32,
    int8; w1 (H, C), w2 (C_out, H) quantised per output channel.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input(x)
    if x.device.type == "cpu":
        return fused_mlp_int8_reference(x, w1, b1, w2, b2)
    x = aligned16(x)           # the row pass reads 16 bytes a load
    c = x.shape[-1]
    hd, c_out = w1.values.shape[0], w2.values.shape[0]
    dev = x.device
    check_weight("w1", w1, hd, c, dev)
    check_weight("w2", w2, c_out, hd, dev)
    check_vectors(dev, b1=(b1, hd), b2=(b2, c_out))
    m = x.numel() // c
    out = torch.empty((*x.shape[:-1], c_out), dtype=torch.float32,
                      device=dev)
    # x8, xs, h (f32), h8, hmax
    buf, *parts = scratch(dev, m * c, 4 * m, 4 * m * hd, m * hd, 4 * m)
    launched = ctypes.c_int(0)
    err = _entry()(
        x.data_ptr(), _TYPES[x.dtype], w1.values.data_ptr(),
        w1.scales.data_ptr(), b1.data_ptr(), w2.values.data_ptr(),
        w2.scales.data_ptr(), b2.data_ptr(), out.data_ptr(),
        *parts, m, c, hd, c_out, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    count(NAME, launched, err, LAUNCHES, CALLS)
    return out


@functools.cache
def _entry():
    """The C entry of csrc/fused_mlp.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = load_library("fused_mlp").fused_mlp_int8
    fn.restype = i
    fn.argtypes = [p, i] + [p] * 12 + [i] * 5 + [p, ctypes.POINTER(i)]
    return fn
