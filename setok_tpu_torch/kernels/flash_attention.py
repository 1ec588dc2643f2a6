"""Masked flash attention with saved log-sum-exp, and its gradient.

The counterpart of `setok_tpu/kernels/flash_attention.py`: q (B, H, Lq, D),
k/v (B, H, Lk, D), a boolean mask (B, Lq, Lk), True = attend, with holes
anywhere (the Setokim splice). The arithmetic is the JAX kernels':

  forward  s = q·kᵀ·scale in float32, -1e30 where masked;
           m = max(rowmax(s), -1e30), p = exp(s - m)·mask,
           l = max(Σp, 1e-30), o = (p cast to v's type)·v / l, 0 for a row
           without a valid key; lse = m + log(l);
  backward in float32, p = exp(s - lse)·mask, dp = do·vᵀ,
           delta = Σ(do·o), ds = p·(dp - delta)·scale,
           dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do; no gradient for the mask.

`flash_attention` is a `torch.autograd.Function`: its forward launches the
forward kernel of `csrc/flash_attention.cu` and saves `o` and `lse`, its
backward launches the dq kernel (which also writes `delta`) and then the
dk/dv kernel. For tensors on the CPU it runs the plain versions
(`flash_fwd_plain`, `flash_dq_plain`, `flash_dkv_plain`); for tensors on
the card it launches or raises. `flash_attention_plain` is the same
Function on the plain versions wherever the tensors lie (the card's parity
runs compare the two). The kernels write float32; o, dq, dk and dv are cast
to the input type afterwards, as the JAX kernels' refs are. The kernels
take float32 or bfloat16 inputs and head_dim 64 or 128.

bfloat16 (the training path) runs every product on the tensor cores. The
forward's S and P·V and the backward's S and dP take bf16 operands as they
are; the backward's products with a float32 operand (dS·K, Pᵀ·dO, dSᵀ·Q)
split that operand into two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
which keeps it to 2⁻¹⁶ relative. All three skip the 64 × 64 tiles where the
mask is empty (their contribution is exactly zero) and test the mask only
in mixed tiles. float32 inputs run on the CUDA cores over every tile.
csrc/flash_attention.cu says why; `kernel_info` reports the bf16 kernels'
shared memory and blocks per SM (their registers and spills are in the
build log, `_build.build_log`)."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

NEG_INF = -1e30

# kernel launches on the card since import or since reset_counts(): the
# bf16 forward's C entry queues two (FWD_LAUNCHES_BF16), its class map and
# the forward
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
FWD_LAUNCHES_BF16 = 2


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _scores(q, k, mask, scale):
    """(B, H, Lq, Lk) float32 masked scores, as the JAX kernels take them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.where(mask[:, None], s, NEG_INF)


def flash_fwd_plain(q, k, v, mask, sm_scale: float):
    """The forward → (o float32, lse float32 (B, H, Lq))."""
    s = _scores(q, k, mask, sm_scale)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m) * mask[:, None]
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    o = o * mask.any(-1)[:, None, :, None]
    return o, (m + torch.log(l))[..., 0]


def _p_ds(q, k, v, mask, o, do, lse, scale):
    s = _scores(q, k, mask, scale)
    p = torch.exp(s - lse[..., None]) * mask[:, None]
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return p, p * (dp - delta) * scale


def flash_dq_plain(q, k, v, mask, o, do, lse, sm_scale: float):
    """dq in float32."""
    _, ds = _p_ds(q, k, v, mask, o, do, lse, sm_scale)
    return torch.matmul(ds, k.float())


def flash_dkv_plain(q, k, v, mask, o, do, lse, sm_scale: float):
    """(dk, dv) in float32."""
    p, ds = _p_ds(q, k, v, mask, o, do, lse, sm_scale)
    return (torch.matmul(ds.transpose(-1, -2), q.float()),
            torch.matmul(p.transpose(-1, -2), do.float()))


def attention_reference(q, k, v, mask, sm_scale: Optional[float] = None):
    """Materialised-scores reference (a copy of the JAX package's): the
    same math through softmax; fully masked rows give zero."""
    scale = _scale(q, sm_scale)
    s = _scores(q, k, mask, scale)
    p = torch.where(mask[:, None], torch.softmax(s, dim=-1), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float())
    return torch.where(mask[:, None].any(-1, keepdim=True), o,
                       0.0).to(q.dtype)


# ----------------------------------------------------------------------------
# the kernels


def _check(q, k, v, mask):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"k/v (B, H, Lk, D) expected for q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if mask.shape != (b, lq, lk) or mask.dtype != torch.bool:
        raise ValueError(f"mask: bool ({b}, {lq}, {lk}) expected, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v of one type expected, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")


def _kernel_args(q):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"the CUDA kernels take head_dim 64 or 128, got "
                         f"{q.shape[-1]}")
    dev = q.device
    return (int(q.dtype == torch.bfloat16), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)


def _raise(name, err, q, k):
    raise RuntimeError(f"{name} launch failed with CUDA error {err} "
                       f"(q {tuple(q.shape)}, Lk={k.shape[2]}, {q.dtype})")


def flash_fwd(q, k, v, mask, sm_scale: float):
    """The forward on the card → (o float32, lse float32). For bf16 inputs
    the C entry queues two kernels: the class of every 64 × 64 tile of the
    mask (once for all heads, into a scratch map), then the forward."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bf16, dev, stream = _kernel_args(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m8 = mask.contiguous().view(torch.uint8)
    o = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    classes = torch.empty((b * -(-lq // 64) * -(-lk // 64) if bf16 else 0,),
                          dtype=torch.uint8, device=q.device)
    launched = ctypes.c_int(0)
    err = _entry("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
        classes.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d,
        bf16, float(sm_scale), dev, stream, ctypes.byref(launched))
    LAUNCHES["flash_fwd"] += launched.value
    if err != 0:
        _raise("flash_fwd", err, q, k)
    return o, lse


def flash_dq(q, k, v, mask, o, do, lse, sm_scale: float):
    """The dq kernel on the card → (dq float32, delta = rowsum(do·o))."""
    b, h, lq, d = q.shape
    bf16, dev, stream = _kernel_args(q)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    m8 = mask.contiguous().view(torch.uint8)
    dq = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    launched = ctypes.c_int(0)
    err = _entry("flash_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        delta.data_ptr(), b, h, lq, k.shape[2], d, bf16, float(sm_scale),
        dev, stream, ctypes.byref(launched))
    LAUNCHES["flash_dq"] += launched.value
    if err != 0:
        _raise("flash_dq", err, q, k)
    return dq, delta


def flash_dkv(q, k, v, mask, do, lse, delta, sm_scale: float):
    """The dk/dv kernel on the card, given the dq kernel's delta →
    (dk, dv) float32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bf16, dev, stream = _kernel_args(q)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    m8 = mask.contiguous().view(torch.uint8)
    dk = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    launched = ctypes.c_int(0)
    err = _entry("flash_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, lq, lk, d, bf16, float(sm_scale), dev, stream,
        ctypes.byref(launched))
    LAUNCHES["flash_dkv"] += launched.value
    if err != 0:
        _raise("flash_dkv", err, q, k)
    return dk, dv


def flash_bwd(q, k, v, mask, o, do, lse, sm_scale: float):
    """dq, then dk/dv, on the card → (dq, dk, dv) float32."""
    do = do.to(q.dtype)
    dq, delta = flash_dq(q, k, v, mask, o, do, lse, sm_scale)
    dk, dv = flash_dkv(q, k, v, mask, do, lse, delta, sm_scale)
    return dq, dk, dv


def kernel_info(kernel: str, head_dim: int, length: int,
                device=None) -> dict:
    """The bf16 kernel `kernel` ("flash_fwd", "flash_dq" or "flash_dkv") as
    the card runs it at `head_dim` and sweep length `length` (Lk for the
    forward and dq, Lq for dk/dv): dynamic shared memory bytes a block,
    resident blocks per SM."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    info = (ctypes.c_int * 2)()
    err = _entry("flash_kernel_info")(tuple(LAUNCHES).index(kernel),
                                      head_dim, length, index, info)
    if err != 0:
        raise RuntimeError(f"flash_kernel_info failed with CUDA error {err}")
    return {"smem_bytes": info[0], "blocks_per_sm": info[1]}


def _route(q, plain: bool):
    if plain or q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return "kernel"


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale, plain):
        _check(q, k, v, mask)
        if _route(q, plain) == "plain":
            o, lse = flash_fwd_plain(q, k, v, mask, sm_scale)
        else:
            o, lse = flash_fwd(q, k, v, mask, sm_scale)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.sm_scale, ctx.plain = sm_scale, plain
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if _route(q, ctx.plain) == "plain":
            dq = flash_dq_plain(q, k, v, mask, o, do, lse, ctx.sm_scale)
            dk, dv = flash_dkv_plain(q, k, v, mask, o, do, lse, ctx.sm_scale)
        else:
            dq, dk, dv = flash_bwd(q, k, v, mask, o, do, lse, ctx.sm_scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q, k, v, mask, sm_scale: Optional[float] = None):
    """Fused masked attention → (B, H, Lq, D) in q's type; differentiable in
    q, k and v through the kernels (plain versions for CPU tensors)."""
    return _FlashAttention.apply(q, k, v, mask, _scale(q, sm_scale), False)[0]


def flash_attention_plain(q, k, v, mask, sm_scale: Optional[float] = None):
    """`flash_attention` through the plain versions wherever q lies."""
    return _FlashAttention.apply(q, k, v, mask, _scale(q, sm_scale), True)[0]


@functools.cache
def _entry(name: str):
    """A C entry of csrc/flash_attention.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = getattr(load_library("flash_attention"), name)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "flash_kernel_info":
        fn.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        return fn
    n_ptr = {"flash_fwd": 7, "flash_dq": 9, "flash_dkv": 9}[name]
    fn.argtypes = ([p] * n_ptr + [i] * 6 + [ctypes.c_float, i, p,
                                            ctypes.POINTER(i)])
    return fn
