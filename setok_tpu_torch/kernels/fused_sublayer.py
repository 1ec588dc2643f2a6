"""Fused int8 transformer sublayers: the CUDA kernels and their plain versions.

The counterpart of `setok_tpu/kernels/fused_sublayer.py`:

    attn_sublayer_int8   x + proj(attn(qkv(LN x)))        ViT, Blocks, decoder
    mlp_sublayer_int8    x + fc2(gelu_tanh(fc1(LN x)))    their MLPs
    mlp_postnorm_int8    LN(x + fc2(gelu_tanh(fc1 x)))    the Q-Former FFN

Each wrapper launches `csrc/fused_sublayer.cu` for tensors on the card and
runs its plain PyTorch version (`*_reference`) for tensors on the CPU. On the
card each is a chain of launches (LN and row quantisation in one pass, the
int8 products on the wgmma GEMM, the attention on the tensor cores); a shape
the chain does not take (C or the head width not a multiple of 16, C over
1024 with the LN in front, more than 768 keys) raises. Both follow the JAX
kernels operation by operation:

  * kernel input and output are float32; LayerNorm statistics are f64 sums
    rounded to f32 (`layernorm`), where the JAX kernels sum in f32;
  * activations are row-quantised (`quant.quant_rows`), weights per output
    channel (`quant.quantize_weight`, done by the caller and passed in as a
    `QuantizedWeight`); int8 products accumulate exactly, and dequantise as
    acc·x_scale·w_scale + bias;
  * the GELU is the tanh form (`jax.nn.gelu`'s default), also where the
    float modules use exact erf;
  * attention: sm_scale is folded into the q columns of the qkv scales and
    bias, q/k/v are cast to bf16, each score is the exact sum of its bf16
    products rounded once to f32 (the JAX kernel sums them in f32: the
    kernel and this version agree on every score whatever their order),
    the mask is a -1e30·(1-m) bias, the softmax max and sum are f32, P is
    cast to bf16 for PV and 1/l applies after PV; a fully masked row gives
    0.

`attn_fits_vmem` and `mlp_fits_vmem` are copies of the JAX package's gates:
they decide where the JAX modules take these kernels, and so where the
port's modules do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from setok_tpu_torch.kernels.quant import (QuantizedWeight, int8_dense,
                                           quant_rows)

NEG_INF = -1e30
SQRT_2_OVER_PI = 0.7978845608028654

# the JAX gates' budget: ~16 MB of TPU VMEM less Mosaic's own buffers
_VMEM_BUDGET = 11 * 1024 * 1024
_SPLIT_GROUP = 4

FUNCTIONS = ("attn_sublayer_int8", "mlp_sublayer_int8", "mlp_postnorm_int8")
# CUDA kernel launches on the card, and wrapper calls that launched, per
# function, since import or since reset_counts()
LAUNCHES = dict.fromkeys(FUNCTIONS, 0)
CALLS = dict.fromkeys(FUNCTIONS, 0)


def reset_counts() -> None:
    for name in FUNCTIONS:
        LAUNCHES[name] = CALLS[name] = 0


def attn_fits_vmem(n: int, c: int) -> bool:
    """The JAX attention sublayer's gate (`fused_sublayer.py:45`)."""
    qkv = n * 3 * c * 4
    weights = 3 * c * c + c * c + 8 * c * 4
    scores = _SPLIT_GROUP * n * n * 6
    x_io = 2 * n * c * 4
    return qkv + weights + scores + x_io < _VMEM_BUDGET


def mlp_fits_vmem(c: int, hidden: int, block_m: int = 256) -> bool:
    """The JAX MLP sublayer's gate (`fused_sublayer.py:57`)."""
    weights = c * hidden + hidden * c + 4 * (c + hidden) * 4
    act = block_m * hidden * 4 + 2 * block_m * c * 4
    return weights + act < _VMEM_BUDGET


# ----------------------------------------------------------------------------
# plain versions


def layernorm(x, g, b, eps: float):
    """(x - mu)·rsqrt(var + eps)·g + b in float32. mu, var and the rsqrt
    are taken in float64 and rounded to float32 once: the float32 values an
    exact sum gives, so that the kernel, which sums in another order,
    agrees with this to the bit."""
    mu = x.double().mean(-1, keepdim=True).float()
    d = x - mu
    var = (d.double() ** 2).mean(-1, keepdim=True).float()
    return d * torch.rsqrt((var + eps).double()).float() * g + b


def gelu_tanh(x):
    """`jax.nn.gelu(x, approximate=True)`, in its operation order."""
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def attention_reference(q, k, v, mask: Optional[torch.Tensor],
                        exact_scores: bool = False, exact_pv: bool = False):
    """q: (B, H, N, D), k/v: (B, H, M, D), all bf16 or all f32; mask: bool,
    broadcastable to (B, H, N, M), True = attend, or None. → (B, H, N, D)
    f32, fully masked rows 0. Scores, softmax and PV are f32; beside bf16
    inputs P is cast to bf16 for PV (the sublayer and BERT kernels), beside
    f32 ones it stays f32 (fused_attention_int8). exact_scores: each score
    is the float64 product rounded once to f32 (exact beside bf16 inputs:
    the sums of bf16 x bf16 products are exact there; beside f32 ones every
    product is exact and the sums are float64 sums), whatever order a
    kernel sums in. exact_pv: P.V likewise, a float64 product rounded once
    to f32."""
    if exact_scores:
        s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s + NEG_INF * (1.0 - mask.float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_r = 1.0 / p.sum(-1, keepdim=True).clamp_min(1e-30)
    l_r = torch.where(m > 0.5 * NEG_INF, l_r, 0.0)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    if exact_pv:
        return torch.matmul(p.double(), v.double()).float() * l_r
    return torch.matmul(p, v.float()) * l_r


def fold_sm_scale(w_qkv: QuantizedWeight, b_qkv: torch.Tensor, c: int,
                  scale: float):
    """qkv scales and bias with the q columns multiplied by sm_scale."""
    s = w_qkv.scales
    b = b_qkv.float()
    return (torch.cat([s[:c] * scale, s[c:]]),
            torch.cat([b[:c] * scale, b[c:]]))


def sm_scale_or_default(c: int, num_heads: int,
                        sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else (c // num_heads) ** -0.5


def attn_sublayer_int8_reference(x, ln_g, ln_b, w_qkv: QuantizedWeight,
                                 b_qkv, w_proj: QuantizedWeight, b_proj,
                                 num_heads: int,
                                 mask: Optional[torch.Tensor] = None,
                                 sm_scale: Optional[float] = None,
                                 ln_eps: float = 1e-6):
    """Plain version of `attn_sublayer_int8`."""
    x = x.float()
    b, n, c = x.shape
    hd = c // num_heads
    s_qkv, b_qkv = fold_sm_scale(
        w_qkv, b_qkv, c, sm_scale_or_default(c, num_heads, sm_scale))
    y8, ys = quant_rows(layernorm(x, ln_g, ln_b, ln_eps))
    qkv = int8_dense(y8, ys, w_qkv.values, s_qkv, b_qkv).to(torch.bfloat16)
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = attention_reference(q, k, v, None if mask is None else mask[:, None],
                            exact_scores=True)
    o8, os_ = quant_rows(o.transpose(1, 2).reshape(b, n, c))
    return x + int8_dense(o8, os_, w_proj.values, w_proj.scales, b_proj)


def mlp_int8_core(y, w1: QuantizedWeight, b1, w2: QuantizedWeight, b2):
    """fc2(gelu_tanh(fc1 y)), int8, f32 in and out (no LayerNorm, no
    residual): the plain steps of the int8 MLP kernels."""
    y8, ys = quant_rows(y)
    h = gelu_tanh(int8_dense(y8, ys, w1.values, w1.scales, b1))
    h8, hs = quant_rows(h)
    return int8_dense(h8, hs, w2.values, w2.scales, b2)


def mlp_sublayer_int8_reference(x, ln_g, ln_b, w1: QuantizedWeight, b1,
                                w2: QuantizedWeight, b2,
                                ln_eps: float = 1e-6):
    """Plain version of `mlp_sublayer_int8`."""
    x = x.float()
    return x + mlp_int8_core(layernorm(x, ln_g, ln_b, ln_eps), w1, b1, w2,
                             b2)


def mlp_postnorm_int8_reference(x, w1: QuantizedWeight, b1,
                                w2: QuantizedWeight, b2, ln_g, ln_b,
                                ln_eps: float = 1e-12):
    """Plain version of `mlp_postnorm_int8`."""
    x = x.float()
    return layernorm(mlp_int8_core(x, w1, b1, w2, b2) + x, ln_g, ln_b,
                     ln_eps)


# ----------------------------------------------------------------------------
# wrappers


def ptr_or_null(t: Optional[torch.Tensor]):
    """The tensor's device pointer, or None (a C null) for no tensor."""
    return None if t is None else t.data_ptr()


def check_weight(name: str, w: QuantizedWeight, out: int, inp: int,
                 device) -> None:
    if w.values.dtype != torch.int8 or tuple(w.values.shape) != (out, inp):
        raise ValueError(f"{name}: int8 ({out}, {inp}) weight expected, got "
                         f"{w.values.dtype} {tuple(w.values.shape)}")
    if w.scales.dtype != torch.float32 or tuple(w.scales.shape) != (out,):
        raise ValueError(f"{name}: float32 ({out},) scales expected")
    for t in w:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: weight must be contiguous on {device}")


def check_vectors(device, **vectors) -> None:
    for name, (t, n) in vectors.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous float32 ({n},) on {device} "
                             f"expected, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def check_input(name: str, x: torch.Tensor,
                dims: Optional[int] = None) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 input, got {x.dtype}")
    if dims is not None and x.dim() != dims:
        raise ValueError(f"{name} takes a {dims}-d input, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous input")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels read rows 16 bytes a load)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def scratch(device, *sizes: int) -> list:
    """One byte buffer holding `sizes` bytes at 16-byte aligned offsets: the
    buffer and each part's address."""
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + (size + 15) // 16 * 16)
    buf = torch.empty((offsets[-1] + sizes[-1],), dtype=torch.uint8,
                      device=device)
    return [buf, *(buf.data_ptr() + off for off in offsets)]


def count(name: str, launched: ctypes.c_int, err: int, launches: dict,
          calls: dict) -> None:
    launches[name] += launched.value
    if launched.value:
        calls[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} "
                           f"after {launched.value} launches")


def attn_sublayer_int8(x, ln_g, ln_b, w_qkv: QuantizedWeight, b_qkv,
                       w_proj: QuantizedWeight, b_proj, num_heads: int,
                       mask: Optional[torch.Tensor] = None,
                       sm_scale: Optional[float] = None,
                       ln_eps: float = 1e-6):
    """x: (B, N, C) f32 → x + Attn(LN(x)). mask: (B, N, N) bool or None.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input("attn_sublayer_int8", x, 3)
    b, n, c = x.shape
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (b, n, n)):
        raise ValueError(f"mask must be bool ({b}, {n}, {n})")
    if x.device.type == "cpu":
        return attn_sublayer_int8_reference(x, ln_g, ln_b, w_qkv, b_qkv,
                                            w_proj, b_proj, num_heads, mask,
                                            sm_scale, ln_eps)
    dev = x.device
    check_weight("w_qkv", w_qkv, 3 * c, c, dev)
    check_weight("w_proj", w_proj, c, c, dev)
    check_vectors(dev, ln_g=(ln_g, c), ln_b=(ln_b, c), b_qkv=(b_qkv, 3 * c),
                  b_proj=(b_proj, c))
    s_qkv, bq = fold_sm_scale(
        w_qkv, b_qkv, c, sm_scale_or_default(c, num_heads, sm_scale))
    m8 = None
    if mask is not None:
        if mask.device != dev:
            raise ValueError(f"mask must lie on {dev}")
        m8 = mask.contiguous().view(torch.uint8)
    x, ln_g, ln_b = aligned16(x), aligned16(ln_g), aligned16(ln_b)
    out = torch.empty_like(x)
    m = b * n
    # x8 (then o's int8 rows), xs, qkv (bf16), o (f32), omax
    buf, *parts = scratch(dev, m * c, 4 * m, 6 * m * c, 4 * m * c, 4 * m)
    launched = ctypes.c_int(0)
    err = _entry("attn_sublayer_int8_f32")(
        x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), ln_eps,
        w_qkv.values.data_ptr(), s_qkv.data_ptr(), bq.data_ptr(),
        w_proj.values.data_ptr(), w_proj.scales.data_ptr(), b_proj.data_ptr(),
        ptr_or_null(m8), out.data_ptr(), *parts, b, n, c, num_heads,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(launched))
    count("attn_sublayer_int8", launched, err, LAUNCHES, CALLS)
    return out


def _mlp(name: str, x, ln_g, ln_b, ln_eps, w1: QuantizedWeight, b1,
         w2: QuantizedWeight, b2, ln2_g, ln2_b, ln2_eps):
    c = x.shape[-1]
    hd = w1.values.shape[0]
    dev = x.device
    check_weight("w1", w1, hd, c, dev)
    check_weight("w2", w2, c, hd, dev)
    vectors = {"b1": (b1, hd), "b2": (b2, c)}
    for key, t in (("ln_g", ln_g), ("ln_b", ln_b), ("ln2_g", ln2_g),
                   ("ln2_b", ln2_b)):
        if t is not None:
            vectors[key] = (t, c)
    check_vectors(dev, **vectors)
    x = aligned16(x)
    if ln_g is not None:
        ln_g, ln_b = aligned16(ln_g), aligned16(ln_b)
    m = x.numel() // c
    out = torch.empty_like(x)
    # x8, xs, h (f32), h8, hmax, and z (f32) for the post-norm
    sizes = [m * c, 4 * m, 4 * m * hd, m * hd, 4 * m]
    if ln2_g is not None:
        sizes.append(4 * m * c)
    buf, *parts = scratch(dev, *sizes)
    if ln2_g is None:
        parts.append(None)
    launched = ctypes.c_int(0)
    err = _entry("mlp_int8_f32")(
        x.data_ptr(), ptr_or_null(ln_g), ptr_or_null(ln_b), ln_eps,
        w1.values.data_ptr(), w1.scales.data_ptr(), b1.data_ptr(),
        w2.values.data_ptr(), w2.scales.data_ptr(), b2.data_ptr(),
        ptr_or_null(ln2_g), ptr_or_null(ln2_b), ln2_eps, out.data_ptr(),
        *parts, m, c, hd, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    count(name, launched, err, LAUNCHES, CALLS)
    return out


def mlp_sublayer_int8(x, ln_g, ln_b, w1: QuantizedWeight, b1,
                      w2: QuantizedWeight, b2, ln_eps: float = 1e-6):
    """x: (..., C) f32 → x + fc2(gelu_tanh(fc1(LN x))), int8.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input("mlp_sublayer_int8", x)
    if x.device.type == "cpu":
        return mlp_sublayer_int8_reference(x, ln_g, ln_b, w1, b1, w2, b2,
                                           ln_eps)
    return _mlp("mlp_sublayer_int8", x, ln_g, ln_b, ln_eps, w1, b1, w2, b2,
                None, None, 0.0)


def mlp_postnorm_int8(x, w1: QuantizedWeight, b1, w2: QuantizedWeight, b2,
                      ln_g, ln_b, ln_eps: float = 1e-12):
    """x: (..., C) f32 → LN(x + fc2(gelu_tanh(fc1 x))), int8.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_input("mlp_postnorm_int8", x)
    if x.device.type == "cpu":
        return mlp_postnorm_int8_reference(x, w1, b1, w2, b2, ln_g, ln_b,
                                           ln_eps)
    return _mlp("mlp_postnorm_int8", x, None, None, 0.0, w1, b1, w2, b2,
                ln_g, ln_b, ln_eps)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "attn_sublayer_int8_f32": [_P] * 3 + [_F] + [_P] * 13 + [_I] * 5
    + [_P, ctypes.POINTER(_I)],
    "mlp_int8_f32": [_P] * 3 + [_F] + [_P] * 8 + [_F] + [_P] * 7 + [_I] * 4
    + [_P, ctypes.POINTER(_I)],
}


@functools.cache
def _entry(name: str):
    """A C entry of csrc/fused_sublayer.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = getattr(load_library("fused_sublayer"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn
