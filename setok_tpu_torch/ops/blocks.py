"""Transformer building blocks, mask-aware: float paths and the int8 form.

The counterparts of `setok_tpu/ops/blocks.py`, with the same sub-module names
as the flax tree so that `utils/from_flax.py` is a plain rename:

  * every attention takes an optional boolean mask (True = may attend),
    applied as `where(mask, s, -1e30)` before an f32 softmax; a fully masked
    row becomes a uniform average, as in the JAX package;
  * `Block` builds `depth` attention sub-layers that share ONE `norm1`, as
    the reference SeTok block does;
  * parameters live in `param_dtype` (float32 by default, bf16 as
    `bench.py` stores so400m); `dtype` is the compute type: each op casts
    its inputs to it (bf16 is the mixed policy of the JAX package), and the
    softmax and LayerNorm statistics run in float32. A `Dense` casts its
    weight to `dtype` at each use, as flax's does (with bf16 parameters
    and bf16 compute, no cast at all). Where a parameter vector meets a
    kernel or a float32 statistic (the LayerNorms, the int8 kernels'
    biases and LayerNorm vectors), it is read as float32 through
    `param_f32`, a copy cached per weight version, as `Dense.int8` caches
    the int8 weight; the JAX package casts at each call.

Attention is written as matmul → softmax → matmul on purpose: PyTorch's
fused attention is a library kernel, and its fully-masked-row result differs.

`quant8=True` (inference only) routes every block as the JAX package does,
on int8 weights that each `Dense` quantises once and caches (`Dense.int8`):

  * where the block's gates (`attn_fits_vmem`, `mlp_fits_vmem`) both pass,
    each sublayer is one call of the whole-sublayer int8 kernels of
    `kernels/fused_sublayer.py` (LayerNorm and residual inside), in float32
    whatever `dtype` is;
  * otherwise the block keeps its float structure (LayerNorms in `dtype`,
    the shared `norm1`, the residuals) and its `Attention` and `Mlp` run
    their int8 forwards, the unfused route: `Attention` takes
    `kernels/fused_attention_int8.py` where its own gate passes, `Mlp`
    takes `kernels/fused_mlp.py` where its gate passes (both return
    float32, and `x + f32` promotes a bf16 residual, as in JAX); else
    each `Dense` runs `quant_matmul` while in·out <= 8 Mi
    (`DENSE_INT8_MAX`) and its float product in `dtype` above that,
    where no weight is quantised.

`QuantDense` and `Quant4Dense` are the serving trunk's linears, whose
weights live quantised (int8, or packed int4) as buffers; their forward is
the w8a8 / w4a8 kernel of `kernels/quant_matmul.py`.

Dropout sits where the flax `nn.Dropout` sites are (`Attention`'s
`attn_drop` on the probabilities and `proj_drop` on the output, `Mlp`'s
`drop` after the activation and after fc2). It runs only when the forward
is given a `torch.Generator` (the JAX package's `deterministic=False` with
a dropout key); without one the blocks are deterministic. Its bits are the
generator's, not JAX's.

A `Dense` may carry a LoRA adapter (`train/lora.py`): its weight is then
`W + (alpha/r)·(A@B)ᵀ`, formed at each use in the weight's type (the
product cast to it, the JAX package's `apply_lora` on the (in, out)
kernel) and cast to the compute type. Under QLoRA (`train/qlora.py`) the
weight is stored int8 with a (1, out) float32 buffer `qscale`; at use it is
`(q·s)` cast to the compute type (the JAX `dequantize`), plus the adapter
product cast to that type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (Quant4Weight, QuantizedWeight,
                                           quantize_weight)

NEG_INF = -1e30
# the JAX Dense's int8 gate (`ops/blocks.py:52`): in·out at most 8 Mi
DENSE_INT8_MAX = 8 * 1024 * 1024


def param_f32(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """The parameter `name` of `module` as float32: the parameter itself
    when it is float32, its differentiable cast while a graph is built
    through it, else a float32 copy cached until the parameter changes (its
    storage or its version). Widening bf16 to float32 is exact."""
    p = getattr(module, name)
    if p is None or p.dtype == torch.float32:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.float()
    key = (p.data_ptr(), p._version)
    cache = module.__dict__.setdefault("_f32", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        # a plain tensor even when first read under inference_mode
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[name] = (key, p.detach().float())
    return hit[1]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, kept values
    divided by 1 - rate. The identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Linear):
    """`nn.Linear` that computes in `dtype` (parameters in `param_dtype`:
    the weight is cast to `dtype` at each use, as flax's Dense does), with an
    optional LoRA adapter (`lora`: the (A (in, r), B (r, out), alpha/r)
    that `train.lora.apply_lora` attaches; kept out of the module's
    parameters and state dict).

    `quant8=True` (inference only): while in·out <= `DENSE_INT8_MAX`, the
    forward is `quant_dense` of the JAX package, `quant_matmul` of x in
    `dtype` on the cached int8 weight, output in `dtype`, then + bias in
    that type; above it, the float forward."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.quant8 = quant8
        self.compute_dtype = dtype
        self.__dict__["lora"] = None

    def effective_weight(self) -> torch.Tensor:
        """The (out, in) weight in use: W (an int8 QLoRA weight dequantised
        to the compute type), plus scale·(A@B)ᵀ cast to W's type where an
        adapter is attached."""
        w = self.weight
        if w.dtype == torch.int8:
            w = (w.float() * self.qscale.t()).to(self.compute_dtype)
        if self.lora is None:
            return w
        a, b, scale = self.lora
        return w + scale * (a @ b).t().to(w.dtype)

    def forward(self, x):
        dt = self.compute_dtype
        if (self.quant8
                and self.in_features * self.out_features <= DENSE_INT8_MAX):
            y = qm.quant_matmul(x.to(dt), self.int8())
            return y if self.bias is None else y + self.bias.to(y.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.effective_weight().to(dt), bias)

    def int8(self) -> QuantizedWeight:
        """The weight quantised per output channel. Cached until the weight
        changes (its storage or its version, so `load_state_dict` takes
        effect) and kept out of the state dict."""
        key = (self.weight.data_ptr(), self.weight._version)
        cached = self.__dict__.get("_int8")
        if cached is None or cached[0] != key:
            cached = (key, quantize_weight(self.weight.detach()))
            self.__dict__["_int8"] = cached
        return cached[1]


class QuantDense(nn.Module):
    """Bias-free linear whose weight lives as int8: buffers `q` (out, in)
    int8 and `s` (1, out) float32 per-output-channel scales (the JAX
    `QuantDense`'s `q` and `s`, transposed to the torch layout). The forward
    is the w8a8 `quant_matmul` kernel, output in `dtype`."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("q", torch.zeros(out_features, in_features,
                                              dtype=torch.int8, device=device))
        self.register_buffer("s", torch.ones(1, out_features, device=device))

    def forward(self, x):
        return qm.quant_matmul(x, QuantizedWeight(self.q, self.s),
                               out_dtype=self.compute_dtype)


class Quant4Dense(nn.Module):
    """Bias-free linear whose weight lives as half-packed int4 nibbles:
    buffers `p` (out, in/2) int8 and `s` (1 or in/G, out) float32 scales,
    one per output channel (`quant_group=0`) or per G input rows. The
    forward is the w4a8 `quant4_matmul` kernel."""

    def __init__(self, in_features: int, out_features: int, *,
                 quant_group: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        if in_features % 2:
            raise ValueError("int4 packing needs even in-features")
        self.compute_dtype = dtype
        self.quant_group = quant_group
        n_scales = 1 if quant_group == 0 else in_features // quant_group
        self.register_buffer("p", torch.zeros(out_features, in_features // 2,
                                              dtype=torch.int8, device=device))
        self.register_buffer("s", torch.ones(n_scales, out_features,
                                             device=device))

    def forward(self, x):
        return qm.quant4_matmul(x, Quant4Weight(self.p, self.s),
                                out_dtype=self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` with a required eps; statistics and the affine step in
    float32 (flax's order: a bf16 scale and bias widen to float32), output
    in `dtype`."""

    def __init__(self, features: int, *, eps: float, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__(features, eps=eps, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         param_f32(self, "weight"), param_f32(self, "bias"),
                         self.eps)
        return y.to(self.compute_dtype)


def masked_softmax(scores: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis in ≥ float32; masked entries get -1e30."""
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores.softmax(dim=-1)


class Mlp(nn.Module):
    """fc1 → GELU → fc2. GELU is the exact erf form unless `gelu_exact` is
    False (the tanh form of SigLIP).

    `quant8=True`: where `mlp_fits_vmem` passes, the whole MLP is one call
    of `fused_mlp_int8` (float32 out, tanh GELU whatever `gelu_exact`
    says); otherwise fc1 and fc2 run their int8 `Dense` forwards around the
    module's own GELU."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, *,
                 gelu_exact: bool = True, drop: float = 0.0,
                 quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.approximate = "none" if gelu_exact else "tanh"
        self.drop = drop
        self.quant8 = quant8
        self.fc1 = Dense(in_features, hidden_features, quant8=quant8,
                         dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc2 = Dense(hidden_features, out_features or in_features,
                         quant8=quant8, dtype=dtype, param_dtype=param_dtype,
                         device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.quant8 and fs.mlp_fits_vmem(x.shape[-1],
                                            self.fc1.out_features):
            return fm.fused_mlp_int8(x.contiguous(), self.fc1.int8(),
                                     param_f32(self.fc1, "bias"),
                                     self.fc2.int8(),
                                     param_f32(self.fc2, "bias"))
        x = dropout(F.gelu(self.fc1(x), approximate=self.approximate),
                    self.drop, generator)
        return dropout(self.fc2(x), self.drop, generator)

    def sublayer_int8(self, x, norm: LayerNorm):
        """x + MLP(norm(x)), the fused int8 kernel (tanh GELU, as the JAX
        kernel has, whatever `gelu_exact` says)."""
        return fs.mlp_sublayer_int8(x, param_f32(norm, "weight"),
                                    param_f32(norm, "bias"),
                                    self.fc1.int8(),
                                    param_f32(self.fc1, "bias"),
                                    self.fc2.int8(),
                                    param_f32(self.fc2, "bias"),
                                    ln_eps=norm.eps)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection.

    `mask` broadcasts against (B, H, N, N); a (B, N, N) mask gets the head
    axis added.

    `quant8=True`: with one batch axis, a qkv bias, `attn_fits_vmem` and
    no mask or a (B, N, N) one, the whole attention is one call of
    `fused_attention_int8` (float32 out; a fully masked row gives the proj
    bias); otherwise qkv and proj run their int8 `Dense` forwards around
    the float masked attention in `dtype`.
    """

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, quant8: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv_bias = qkv_bias
        self.quant8 = quant8
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, quant8=quant8,
                         dtype=dtype, param_dtype=param_dtype, device=device)
        self.proj = Dense(dim, dim, quant8=quant8, dtype=dtype,
                          param_dtype=param_dtype, device=device)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        *batch, n, c = x.shape
        if (self.quant8 and len(batch) == 1 and self.qkv_bias
                and fs.attn_fits_vmem(n, c)
                and (mask is None or mask.dim() == 3)):
            return fai.fused_attention_int8(
                x.float().contiguous(), self.qkv.int8(),
                param_f32(self.qkv, "bias"), self.proj.int8(),
                param_f32(self.proj, "bias"), self.num_heads, mask,
                self.scale)
        qkv = self.qkv(x).reshape(*batch, n, 3, self.num_heads,
                                  c // self.num_heads)
        q, k, v = (t.transpose(-3, -2) for t in qkv.unbind(-3))  # (.., H, n, hd)
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None and mask.dim() == scores.dim() - 1:
            mask = mask.unsqueeze(-3)
        attn = dropout(masked_softmax(scores, mask).to(self.dtype),
                       self.attn_drop, generator)
        out = torch.matmul(attn, v).transpose(-3, -2).reshape(*batch, n, c)
        return dropout(self.proj(out), self.proj_drop, generator)

    def sublayer_int8(self, x, norm: LayerNorm, mask=None):
        """x + Attn(norm(x)), the fused int8 kernel."""
        return fs.attn_sublayer_int8(x, param_f32(norm, "weight"),
                                     param_f32(norm, "bias"),
                                     self.qkv.int8(),
                                     param_f32(self.qkv, "bias"),
                                     self.proj.int8(),
                                     param_f32(self.proj, "bias"),
                                     self.num_heads, mask=mask,
                                     sm_scale=self.scale, ln_eps=norm.eps)


class CrossAttention(nn.Module):
    """Multi-head cross-attention: queries attend to a context sequence.

    The JAX `CrossAttention` (`q`, `kv` and `proj` linears, so the flax
    paths match; `context_dim` is the context's width, which flax reads
    from the input). `context_mask` (B, M) boolean over the context keys:
    a masked score takes -1e30 before the f32 softmax, so a fully masked
    row weighs every key evenly and returns proj(mean of v), as in JAX.
    Nothing in either package calls it.
    """

    def __init__(self, dim: int, num_heads: int, *,
                 context_dim: Optional[int] = None, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.scale = (dim // num_heads) ** -0.5
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q = Dense(dim, dim, bias=qkv_bias, **kw)
        self.kv = Dense(context_dim or dim, 2 * dim, bias=qkv_bias, **kw)
        self.proj = Dense(dim, dim, **kw)

    def forward(self, x, context, context_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        *batch, n, c = x.shape
        m, h = context.shape[-2], self.num_heads
        q = self.q(x).reshape(*batch, n, h, c // h).transpose(-3, -2)
        kv = self.kv(context).reshape(*batch, m, 2, h, c // h)
        k, v = (t.transpose(-3, -2) for t in kv.unbind(-3))   # (.., H, m, hd)
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        mask = (None if context_mask is None
                else context_mask[..., None, None, :])
        attn = dropout(masked_softmax(scores, mask).to(self.dtype),
                       self.attn_drop, generator)
        out = torch.matmul(attn, v).transpose(-3, -2).reshape(*batch, n, c)
        return dropout(self.proj(out), self.proj_drop, generator)


def fused_int8_fits(attn: Attention, mlp: Mlp, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> bool:
    """The JAX blocks' gate of the whole-sublayer int8 kernels: one batch
    axis, a qkv bias, both VMEM gates, and no mask or a (B, N, N) one."""
    c = x.shape[-1]
    return (attn.qkv_bias and x.dim() == 3
            and fs.attn_fits_vmem(x.shape[-2], c)
            and fs.mlp_fits_vmem(c, mlp.fc1.out_features)
            and (mask is None or mask.dim() == 3))


class Block(nn.Module):
    """SeTok block: `depth` attention sub-layers sharing one pre-norm, then
    one MLP sub-layer (LayerNorm eps 1e-5, as torch's default in the
    reference)."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden_dim: int, *,
                 depth: int = 1, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, norm_eps: float,
                 proj_drop: float = 0.0, attn_drop: float = 0.0,
                 quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.depth = depth
        self.quant8 = quant8
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=norm_eps, **kw)
        for i in range(depth):
            self.add_module(f"attn_{i}", Attention(
                dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                attn_drop=attn_drop, proj_drop=proj_drop, quant8=quant8,
                **kw))
        self.norm2 = LayerNorm(dim, eps=norm_eps, **kw)
        self.mlp = Mlp(dim, mlp_hidden_dim, drop=proj_drop, quant8=quant8,
                       **kw)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if self.quant8:
            if generator is not None:
                raise ValueError("quant8 is inference only: no dropout")
            if fused_int8_fits(self.attn_0, self.mlp, x, mask):
                x = x.float()
                for i in range(self.depth):
                    x = getattr(self, f"attn_{i}").sublayer_int8(
                        x, self.norm1, mask)
                return self.mlp.sublayer_int8(x, self.norm2)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(self.norm1(x), mask=mask,
                                               generator=generator)
        return x + self.mlp(self.norm2(x), generator)


class ViTBlock(nn.Module):
    """Pre-norm timm-style ViT block, used by the pixel decoder; its
    attention takes `attn_drop` and `proj_drop`, its MLP `proj_drop`."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, norm_eps: float,
                 proj_drop: float = 0.0, attn_drop: float = 0.0,
                 quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.quant8 = quant8
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=norm_eps, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=proj_drop,
                              quant8=quant8, **kw)
        self.norm2 = LayerNorm(dim, eps=norm_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=proj_drop,
                       quant8=quant8, **kw)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if self.quant8:
            if generator is not None:
                raise ValueError("quant8 is inference only: no dropout")
            if fused_int8_fits(self.attn, self.mlp, x, mask):
                x = self.attn.sublayer_int8(x.float(), self.norm1, mask)
                return self.mlp.sublayer_int8(x, self.norm2)
        x = x + self.attn(self.norm1(x), mask=mask, generator=generator)
        return x + self.mlp(self.norm2(x), generator)
