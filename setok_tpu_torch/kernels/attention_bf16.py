"""Unmasked bf16 softmax attention: the CUDA kernel and its plain version.

The float `Attention` route's core (`ops/blocks.py`) in one launch of
`csrc/attention_bf16.cu`, which keeps the (B, H, N, N) scores in registers.
It replaces no Pallas kernel: the JAX package's attention is einsum ->
softmax -> einsum, which XLA fuses on the TPU.

`attention_bf16(q, k, v, scale)` takes q, k, v of shape (B, N, H, D) in
bfloat16 through their strides (the last axis contiguous; the views that
`unbind` makes of the qkv projection's (B, N, 3, H, D) output are taken as
they stand) and returns o: (B, N, H, D) bfloat16, contiguous. A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version,
`attention_bf16_plain`, which spells out the arithmetic both hold to:

    s = (q . k^T) * scale      bf16 products summed in float32, scale in float32
    m = rowmax(s),  p = exp(s - m),  l = rowsum(p)       (float32, unrounded)
    o = (bf16(p) . v) / l      float32 sums, one division, bf16 out

The kernel takes m and l over 64-key tiles (online, rescaling as the max
grows), so its p rounds to bf16 against a running max: it differs from the
plain version by rounding only.

`takes_kernel` is the gate `Attention.forward` applies: a CUDA bf16 qkv, no
mask, no dropout drawn, no autograd graph being built, a head width that is
a multiple of 8 up to 128, and a positive scale (the kernel takes each
tile's row max over the unscaled scores, which is the max of the scaled
ones only for scale > 0; the wrapper raises on any other).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_D = 128

# Kernel launches on the card since import (or since a caller reset it):
# one a call.
LAUNCHES = 0


def takes_kernel(device_type: str, dtype: torch.dtype, head_dim: int, *,
                 masked: bool, dropout: bool, builds_graph: bool,
                 scale: float) -> bool:
    """Whether an attention with these properties runs the kernel."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and not masked and not dropout and not builds_graph
            and head_dim % 8 == 0 and 8 <= head_dim <= MAX_D and scale > 0)


def attention_bf16_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, (B, N, H, D) bf16 in and
    out (two passes: the exact row max first)."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(), vf) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).to(torch.bfloat16).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> None:
    if not scale > 0:
        raise ValueError(f"attention_bf16 takes a positive scale, got {scale}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention_bf16 takes bfloat16, got {name} "
                            f"{t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("attention_bf16 takes q, k and v of one shape on "
                             f"one device, got {tuple(q.shape)} {q.device}, "
                             f"{name} {tuple(t.shape)} {t.device}")
    if q.dim() != 4:
        raise ValueError(f"attention_bf16 takes (B, N, H, D), got "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    if d % 8 or not 8 <= d <= MAX_D or b > 65535 or h > 65535:
        raise ValueError(f"attention_bf16 takes D a multiple of 8 up to "
                         f"{MAX_D}, B and H up to 65535; got {tuple(q.shape)}")


def attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """softmax(q.k^T * scale).v over the N axis of (B, N, H, D) bf16 q, k, v:
    (B, N, H, D) bf16, contiguous."""
    global LAUNCHES
    _check(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_bf16_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bf16 runs on cuda or cpu, got {q.device}")
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    if q.numel() == 0:
        return out
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"attention_bf16 reads 16-byte rows: {name} needs "
                             "a contiguous last axis, strides that are "
                             "multiples of 8 and a 16-byte aligned start; got "
                             f"strides {t.stride()}")
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                         for i in range(3)))
    b, n, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, n, h, d, strides, float(scale), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention_bf16 launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


@functools.cache
def _entry():
    """The C entry of csrc/attention_bf16.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = load_library("attention_bf16").attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    return fn
