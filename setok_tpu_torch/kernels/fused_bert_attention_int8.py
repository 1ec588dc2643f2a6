"""The Q-Former's int8 BERT attention sublayer: CUDA kernel and plain version.

The counterpart of `setok_tpu/kernels/fused_bert_attention_int8.py`:

    out = LN(Wo·MHA(q = Wq·x, k = Wk·kv, v = Wv·kv) + bo + x),  eps 1e-12

for self-attention (kv is x) and cross-attention with a (B, M) key mask.
`fused_bert_attention_int8` launches `csrc/fused_bert_attention_int8.cu` for
tensors on the card and runs `fused_bert_attention_int8_reference` for
tensors on the CPU. Both follow the JAX kernel: x and kv are row-quantised
separately; q is `(q_dequant + bq)·(1/√d)` cast to bf16, k and v are cast
to bf16; the softmax is `fused_sublayer.attention_reference`'s, with the
fully-masked guard always on. The scores are exact (`exact_scores=True`):
the kernel takes them on the FP64 tensor cores, where every sum of bf16
products is exact, as `attn_sublayer_int8` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from setok_tpu_torch.kernels.fused_sublayer import (aligned16,
                                                    attention_reference,
                                                    check_input, check_vectors,
                                                    check_weight, count,
                                                    layernorm, ptr_or_null)
from setok_tpu_torch.kernels.quant import (QuantizedWeight, int8_dense,
                                           quant_rows)

NAME = "fused_bert_attention_int8"
# CUDA kernel launches on the card, and wrapper calls that launched
LAUNCHES = {NAME: 0}
CALLS = {NAME: 0}


def reset_counts() -> None:
    LAUNCHES[NAME] = CALLS[NAME] = 0


def fused_bert_attention_int8_reference(
        x, kv, wq: QuantizedWeight, bq, wk: QuantizedWeight, bk,
        wv: QuantizedWeight, bv, wo: QuantizedWeight, bo, ln_scale, ln_bias,
        num_heads: int, kv_mask: Optional[torch.Tensor] = None,
        eps: float = 1e-12):
    """Plain version of `fused_bert_attention_int8`."""
    x, kv = x.float(), kv.float()
    b, n, c = x.shape
    m = kv.shape[1]
    hd = c // num_heads
    scale = 1.0 / (hd ** 0.5)
    x8, xs = quant_rows(x)
    kv8, kvs = quant_rows(kv)
    q = int8_dense(x8, xs, wq.values, wq.scales, bq)
    k = int8_dense(kv8, kvs, wk.values, wk.scales, bk)
    v = int8_dense(kv8, kvs, wv.values, wv.scales, bv)

    def heads(t, length):
        return (t.to(torch.bfloat16).reshape(b, length, num_heads, hd)
                .transpose(1, 2))

    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    o = attention_reference(heads(q * scale, n), heads(k, m), heads(v, m),
                            mask, exact_scores=True)
    o8, os_ = quant_rows(o.transpose(1, 2).reshape(b, n, c))
    y = int8_dense(o8, os_, wo.values, wo.scales, bo) + x
    return layernorm(y, ln_scale, ln_bias, eps)


def fused_bert_attention_int8(x, kv, wq: QuantizedWeight, bq,
                              wk: QuantizedWeight, bk, wv: QuantizedWeight,
                              bv, wo: QuantizedWeight, bo, ln_scale, ln_bias,
                              num_heads: int,
                              kv_mask: Optional[torch.Tensor] = None,
                              eps: float = 1e-12):
    """x: (B, N, C) f32 queries; kv: (B, M, C) f32 (pass x itself for
    self-attention); kv_mask: (B, M) bool or None. Returns LN(attn + x).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input(NAME, x, 3)
    check_input(NAME, kv, 3)
    b, n, c = x.shape
    m = kv.shape[1]
    if kv.shape[0] != b or kv.shape[2] != c or kv.device != x.device:
        raise ValueError(f"kv must be ({b}, M, {c}) on {x.device}, got "
                         f"{tuple(kv.shape)} on {kv.device}")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or tuple(kv_mask.shape) != (b, m)):
        raise ValueError(f"kv_mask must be bool ({b}, {m})")
    if x.device.type == "cpu":
        return fused_bert_attention_int8_reference(
            x, kv, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias,
            num_heads, kv_mask, eps)
    dev = x.device
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        check_weight(name, w, c, c, dev)
    check_vectors(dev, bq=(bq, c), bk=(bk, c), bv=(bv, c), bo=(bo, c),
                  ln_scale=(ln_scale, c), ln_bias=(ln_bias, c))
    m8 = None
    if kv_mask is not None:
        if kv_mask.device != dev:
            raise ValueError(f"kv_mask must lie on {dev}")
        m8 = kv_mask.contiguous().view(torch.uint8)
    self_attn = kv.data_ptr() == x.data_ptr() and m == n
    x = aligned16(x)
    kv = x if self_attn else aligned16(kv)
    f32, i8 = torch.float32, torch.int8
    out = torch.empty_like(x)
    x8 = torch.empty((b * n, c), dtype=i8, device=dev)
    xs = torch.empty((b * n,), dtype=f32, device=dev)
    kv8 = None if self_attn else torch.empty((b * m, c), dtype=i8, device=dev)
    kvs = None if self_attn else torch.empty((b * m,), dtype=f32, device=dev)
    q16 = torch.empty((b * n, c), dtype=torch.bfloat16, device=dev)
    kv16 = torch.empty((b * m, 2 * c), dtype=torch.bfloat16, device=dev)
    o = torch.empty((b * n, c), dtype=f32, device=dev)
    omax = torch.empty((b * n,), dtype=torch.int32, device=dev)
    y = torch.empty((b * n, c), dtype=f32, device=dev)
    launched = ctypes.c_int(0)
    err = _entry()(
        x.data_ptr(), kv.data_ptr(),
        wq.values.data_ptr(), wq.scales.data_ptr(), bq.data_ptr(),
        wk.values.data_ptr(), wk.scales.data_ptr(), bk.data_ptr(),
        wv.values.data_ptr(), wv.scales.data_ptr(), bv.data_ptr(),
        wo.values.data_ptr(), wo.scales.data_ptr(), bo.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), eps, ptr_or_null(m8),
        out.data_ptr(), x8.data_ptr(), xs.data_ptr(), ptr_or_null(kv8),
        ptr_or_null(kvs), q16.data_ptr(), kv16.data_ptr(), o.data_ptr(),
        omax.data_ptr(), y.data_ptr(), b, n, m, c, num_heads,
        1.0 / (c // num_heads) ** 0.5, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    count(NAME, launched, err, LAUNCHES, CALLS)
    return out


@functools.cache
def _entry():
    """The C entry of csrc/fused_bert_attention_int8.cu, built, loaded and
    bound once."""
    from setok_tpu_torch.kernels._build import load_library

    _P = ctypes.c_void_p
    fn = load_library("fused_bert_attention_int8").fused_bert_attention_int8_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P] * 16 + [ctypes.c_float] + [_P] * 11
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, _P,
                                           ctypes.POINTER(ctypes.c_int)])
    return fn
