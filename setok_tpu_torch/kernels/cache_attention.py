"""Decode attention over an int8 KV cache, dequantised in the kernel.

The counterpart of `setok_tpu/kernels/cache_attention.py`. One query per
row (a decode step), GQA folded as G = heads / kv_heads query rows per kv
head. The scale algebra keeps the dequantisation out of the (S, D) slabs:

    scores = (q · Kᵀ) · (k_scale · sm_scale)
    out    = (p · v_scale) · V

with the mask applied as `where(valid, s, -1e30)`, so that a fully masked
row is the uniform average over all S keys. `int8_cache_decode_attention`
launches `csrc/cache_attention.cu` for tensors on the card (one launch: q
read and the output written in q's type, a thread-block cluster per batch
row and kv head, key tiles of 32 that are wholly masked skipped) and runs
`int8_cache_decode_attention_plain` for tensors on the CPU.

The steps are the JAX kernel's, on float32 values, but each sum (the q·K
dots, the softmax sum, the PV sums) and the exp is taken in float64 and
rounded to float32 once, in the kernel and in its plain version alike: the
results of exact sums, the same whatever the order. Summed in float32 in
two orders, a last-bit difference flips the int8 rounding of a cached K or
V entry now and then, and every later decode step reads it.

`fits_vmem` and `MAX_CACHE_TOKENS` are copies of the JAX package's gate:
`models/llama.py` routes the kernel where the JAX package does in interpret
mode (the layout rule of the TPU's compiler does not apply to the card).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

NEG_INF = -1e30
# the JAX gate's slab budget (K/V int8 slabs + f32 conversions ≈ S·D·10 B)
MAX_CACHE_TOKENS = 8192

# keys a tile of the kernel: a wholly masked tile is skipped
TILE = 32
# q (and output) types the kernel reads, and their codes in its C entry
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# CUDA kernel launches on the card since import or since reset_counts(), and
# the CTAs of a cluster of the last launch
LAUNCHES = 0
CLUSTER = 0


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def fits_vmem(max_len: int, head_dim: int = 128, kv_heads: int = 1,
              interpret: bool = False) -> bool:
    """The JAX package's gate (`cache_attention.py:112`)."""
    return (max_len <= MAX_CACHE_TOKENS
            and (interpret or head_dim % 128 == 0 or kv_heads == 1))


def int8_cache_decode_attention_plain(q, k_cache, k_scale, v_cache, v_scale,
                                      key_valid, sm_scale: float):
    """Plain version: the JAX kernel's steps in float32, each sum and the
    exp in float64 rounded once."""
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    qg = q.float().reshape(b, kvh, h // kvh, d).double()
    k = k_cache.double().permute(0, 2, 1, 3)                # (B, KVH, S, D)
    v = v_cache.double().permute(0, 2, 1, 3)
    sc = torch.matmul(qg, k.transpose(-1, -2)).float()      # (B, KVH, G, S)
    sc = sc * (k_scale.permute(0, 2, 1) * sm_scale)[:, :, None, :]
    sc = torch.where(key_valid[:, None, None, :], sc, NEG_INF)
    sc = sc - sc.amax(-1, keepdim=True)
    p = torch.exp(sc.double()).float()
    p = p / p.double().sum(-1, keepdim=True).float()
    pv = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.matmul(pv.double(), v).float()
    return out.reshape(b, h, d).to(q.dtype)


def masked_tiles(key_valid: torch.Tensor, kv_heads: int) -> int:
    """The key tiles the kernel skips: per batch row that has a valid key,
    its tiles of TILE keys with none valid, once per kv head."""
    b, s = key_valid.shape
    pad = (-s) % TILE
    tiles = torch.nn.functional.pad(key_valid, (0, pad)).reshape(b, -1, TILE)
    dead = (~tiles.any(-1)).sum(-1)
    return int((dead * key_valid.any(-1)).sum()) * kv_heads


def int8_cache_decode_attention(q, k_cache, k_scale, v_cache, v_scale,
                                key_valid, sm_scale: Optional[float] = None,
                                skipped: Optional[torch.Tensor] = None):
    """q: (B, H, D) post-RoPE queries of one decode step (on the card:
    float32, bfloat16 or float16); k_cache/v_cache: (B, S, KVH, D) int8;
    k_scale/v_scale: (B, S, KVH) float32; key_valid: (B, S) bool. Returns
    (B, H, D) in q.dtype. `skipped`, an int32 tensor of one element on q's device,
    gains the key tiles skipped as wholly masked (`masked_tiles`)."""
    b, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"k_cache (B, S, KVH, D) expected, got "
                         f"{tuple(k_cache.shape)} for q {tuple(q.shape)}")
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if h % kvh:
        raise ValueError(f"{h} heads do not fold over {kvh} kv heads")
    for name, t, shape, dtype in (
            ("k_cache", k_cache, (b, s, kvh, d), torch.int8),
            ("v_cache", v_cache, (b, s, kvh, d), torch.int8),
            ("k_scale", k_scale, (b, s, kvh), torch.float32),
            ("v_scale", v_scale, (b, s, kvh), torch.float32),
            ("key_valid", key_valid, (b, s), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q.device:
            raise ValueError(f"{name}: {dtype} {shape} on {q.device} "
                             f"expected, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        if skipped is not None:
            skipped += masked_tiles(key_valid, kvh)
        return int8_cache_decode_attention_plain(
            q, k_cache, k_scale, v_cache, v_scale, key_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"int8_cache_decode_attention runs on cuda or cpu, "
                         f"got {q.device}")
    if q.dtype not in Q_TYPES:
        raise TypeError(f"int8_cache_decode_attention takes q in "
                        f"{tuple(Q_TYPES)} on the card, got {q.dtype}")
    if skipped is not None and (skipped.dtype != torch.int32
                                or skipped.device != q.device):
        raise ValueError("skipped: one int32 element on q's device expected")
    dev = q.device
    q = q.contiguous()
    if key_valid.stride(1) != 1:
        key_valid = key_valid.contiguous()
    out = torch.empty_like(q)
    launched, cluster = ctypes.c_int(0), ctypes.c_int(0)
    err = _entry()(q.data_ptr(), Q_TYPES[q.dtype],
                   k_cache.contiguous().data_ptr(),
                   k_scale.contiguous().data_ptr(),
                   v_cache.contiguous().data_ptr(),
                   v_scale.contiguous().data_ptr(), key_valid.data_ptr(),
                   key_valid.stride(0), out.data_ptr(),
                   None if skipped is None else skipped.data_ptr(),
                   float(sm_scale), b, s, kvh, h // kvh, d, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream,
                   ctypes.byref(launched), ctypes.byref(cluster))
    global LAUNCHES, CLUSTER
    LAUNCHES += launched.value
    CLUSTER = cluster.value
    if err != 0:
        raise RuntimeError(f"int8_cache_decode_attention launch failed with "
                           f"CUDA error {err} (B={b}, S={s}, KVH={kvh}, "
                           f"G={h // kvh}, D={d})")
    return out


@functools.cache
def _entry():
    """The C entry of csrc/cache_attention.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = load_library("cache_attention").int8_cache_decode_attention
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p, i] + [p] * 5 + [ctypes.c_longlong, p, p,
                                       ctypes.c_float] + [i] * 6
                   + [p, ctypes.POINTER(i), ctypes.POINTER(i)])
    return fn
