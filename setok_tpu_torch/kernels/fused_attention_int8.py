"""The unfused route's int8 self-attention: the CUDA kernel and its plain
version.

The counterpart of `setok_tpu/kernels/fused_attention_int8.py`:

    fused_attention_int8   proj(attn(qkv(x))), int8 products, f32 attention,
                           no LayerNorm, no residual

the attention that `Attention(quant8=True)` takes where the
whole-sublayer kernel's gate fails but `attn_fits_vmem` passes (the
tokenizer Blocks when their MLP is 4096 wide). `fused_attention_int8`
launches `csrc/fused_attention_int8.cu` for tensors on the card and runs
`fused_attention_int8_reference` for tensors on the CPU. Both follow the
JAX kernel:

  * sm_scale is folded into the q columns of the qkv scales and bias;
  * x is row-quantised and the qkv product dequantised to float32 (not
    bf16, as `attn_sublayer_int8` does);
  * the scores, the softmax and PV are float32: the mask is a -1e30·(1-m)
    bias, the row max and sum are exact, 1/max(l, 1e-30) applies after PV,
    and a fully masked row gives 0 (not the uniform average of the float
    `Attention`). The scores and P.V are float64 products rounded once
    (`exact_scores=True, exact_pv=True`): the kernel takes both on the FP64
    tensor cores, where every f32 product is exact, and sums in float64.
    Against a float32 P.V in cuBLAS's order the kernel's share within 1e-5
    reads 0.99657, against the float64 one 0.99909 (B=64, the inner Block's
    mask; chip_kernel_times.py, NVIDIA H100 80GB HBM3, 700.00 W);
  * the attention output is row-quantised over the whole C, then the int8
    projection, + bias. Input and output are float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from setok_tpu_torch.kernels.fused_sublayer import (aligned16,
                                                    attention_reference,
                                                    check_input,
                                                    check_vectors,
                                                    check_weight, count,
                                                    fold_sm_scale,
                                                    ptr_or_null,
                                                    sm_scale_or_default)
from setok_tpu_torch.kernels.quant import (QuantizedWeight, int8_dense,
                                           quant_rows)

NAME = "fused_attention_int8"
# CUDA kernel launches on the card, and wrapper calls that launched
LAUNCHES = {NAME: 0}
CALLS = {NAME: 0}


def reset_counts() -> None:
    LAUNCHES[NAME] = CALLS[NAME] = 0


def fused_attention_int8_reference(x, w_qkv: QuantizedWeight, b_qkv,
                                   w_proj: QuantizedWeight, b_proj,
                                   num_heads: int,
                                   mask: Optional[torch.Tensor] = None,
                                   sm_scale: Optional[float] = None):
    """Plain version of `fused_attention_int8`."""
    x = x.float()
    b, n, c = x.shape
    hd = c // num_heads
    s_qkv, b_qkv = fold_sm_scale(
        w_qkv, b_qkv, c, sm_scale_or_default(c, num_heads, sm_scale))
    x8, xs = quant_rows(x)
    qkv = int8_dense(x8, xs, w_qkv.values, s_qkv, b_qkv)
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = attention_reference(q, k, v, None if mask is None else mask[:, None],
                            exact_scores=True, exact_pv=True)
    o8, os_ = quant_rows(o.transpose(1, 2).reshape(b, n, c))
    return int8_dense(o8, os_, w_proj.values, w_proj.scales, b_proj)


def fused_attention_int8(x, w_qkv: QuantizedWeight, b_qkv,
                         w_proj: QuantizedWeight, b_proj, num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None):
    """x: (B, N, C) f32 → proj(attn(qkv x)): (B, N, C) f32. mask: (B, N, N)
    bool (True = attend) or None; sm_scale: None is head_dim^-0.5.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input(NAME, x, 3)
    b, n, c = x.shape
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (b, n, n)):
        raise ValueError(f"mask must be bool ({b}, {n}, {n})")
    if x.device.type == "cpu":
        return fused_attention_int8_reference(x, w_qkv, b_qkv, w_proj, b_proj,
                                              num_heads, mask, sm_scale)
    dev = x.device
    check_weight("w_qkv", w_qkv, 3 * c, c, dev)
    check_weight("w_proj", w_proj, c, c, dev)
    check_vectors(dev, b_qkv=(b_qkv, 3 * c), b_proj=(b_proj, c))
    s_qkv, bq = fold_sm_scale(
        w_qkv, b_qkv, c, sm_scale_or_default(c, num_heads, sm_scale))
    m8 = None
    if mask is not None:
        if mask.device != dev:
            raise ValueError(f"mask must lie on {dev}")
        m8 = mask.contiguous().view(torch.uint8)
    x = aligned16(x)
    f32 = torch.float32
    out = torch.empty_like(x)
    x8 = torch.empty((b * n, c), dtype=torch.int8, device=dev)
    xs = torch.empty((b * n,), dtype=f32, device=dev)
    qkv = torch.empty((b * n, 3 * c), dtype=f32, device=dev)
    o = torch.empty((b * n, c), dtype=f32, device=dev)
    omax = torch.empty((b * n,), dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    err = _entry()(
        x.data_ptr(), w_qkv.values.data_ptr(), s_qkv.data_ptr(),
        bq.data_ptr(), w_proj.values.data_ptr(), w_proj.scales.data_ptr(),
        b_proj.data_ptr(), ptr_or_null(m8), out.data_ptr(), x8.data_ptr(),
        xs.data_ptr(), qkv.data_ptr(), o.data_ptr(), omax.data_ptr(), b, n,
        c, num_heads, dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(launched))
    count(NAME, launched, err, LAUNCHES, CALLS)
    return out


@functools.cache
def _entry():
    """The C entry of csrc/fused_attention_int8.cu, built, loaded and bound
    once."""
    from setok_tpu_torch.kernels._build import load_library

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = load_library("fused_attention_int8").fused_attention_int8_f32
    fn.restype = i
    fn.argtypes = [p] * 14 + [i] * 5 + [p, ctypes.POINTER(i)]
    return fn
