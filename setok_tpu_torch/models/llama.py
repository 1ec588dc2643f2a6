"""LLaMA trunk: the Setokim language model, for serving and training.

The counterpart of `setok_tpu/models/llama.py`, with the flax module names
(`embed_tokens`, `model.layer_{i}.attn.q_proj`, ...) so that
`utils/from_flax.py` is a rename: RMSNorm with float32 statistics (without
autograd, the mean of squares summed in float64 and rounded once), rotary
embeddings in the HF rotate-half convention, GQA attention with a boolean
mask (holes inside the sequence allowed), SwiGLU MLP.

Parameters live in `param_dtype` (float32 by default, bf16 as the JAX
trainers' `param_dtype` stores them): the embedding, the RMSNorm scales
(read as float32 for their statistics, as the JAX RMSNorm reads
`scale.astype(f32)`), every float trunk linear and the LM head; `dtype` is
the compute type. `weight_bits` selects the trunk linears: 16 → `Dense`
(float), 8 → `QuantDense` (the w8a8 kernel), 4 → `Quant4Dense` (the w4a8
kernel, per channel or per `quant_group` input rows).

The KV cache is static-shaped, (layers, B, max_len, kv_heads, head_dim).
Where the JAX package returns a new cache, the port writes the new entries
into the cache's tensors in place and returns them with the new length:
`KVCache.length` is a Python int (one write column for every row) or a (B,)
int32 tensor (serving: each row appends at its own column, clamped to the
last columns as the JAX scatter is). An int8 cache stores per-token,
per-head scales `max(absmax, 1e-8)/127` beside the data. A decode step
(one query a row) with `cache_kernel=True` runs `int8_cache_decode_attention`
(kernels/cache_attention.py) where the JAX package would; every other read
of an int8 cache (a prefill, a chunk, a verify, or a decode without the
kernel) takes the dequantised route in that kernel's arithmetic
(`int8_cache_attention_exact`: float64 sums rounded once), so that the
attention of a position does not depend on how many share the forward.

Without a cache (the training forward), `use_flash` routes the attention
through the flash-attention kernels (`kernels/flash_attention.py`, forward
and backward), and `remat` recomputes each block in the backward pass
(`torch.utils.checkpoint`), as the JAX package's `nn.remat` does. Not ported
here: `ring_mesh` (sequence-parallel training), which raises
`NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from setok_tpu_torch.config import LlamaConfig
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import flash_attention as fa
from setok_tpu_torch.kernels.quant import (_div, quantize_weight,
                                           quantize_weight_int4)
from setok_tpu_torch.ops.blocks import Dense, Quant4Dense, QuantDense
from setok_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30

NOT_PORTED = {
    "ring_mesh": "sequence-parallel training: ROADMAP.md, Queue A "
                 "(parallel)",
}

TRUNK_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


def refuse(**options) -> None:
    """Raise for any option of the JAX package this port does not run."""
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"{name}: {NOT_PORTED[name]}")


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device,
                                              dtype=param_dtype))

    def forward(self, x):
        x32 = x.float()
        if torch.is_grad_enabled():
            var = (x32 * x32).mean(-1, keepdim=True)
        else:
            # serving: the mean of squares summed in float64 and rounded
            # once, the same whatever order the reduction takes, which on
            # the card depends on how many rows share the call (a verify's
            # positions get the single steps' statistics, and so their int8
            # activation steps). Training, which needs no such agreement,
            # keeps the float32 pass and saves no float64 copy for the
            # backward.
            x64 = x32.double()
            var = (x64 * x64).mean(-1, keepdim=True).float()
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.compute_dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for the given positions: (..., L, head_dim/2)."""
    steps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device)
    inv_freq = 1.0 / (theta ** _div(steps, float(head_dim)))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D); cos/sin: (B, L, D/2), or (B, L, 1, D/2) with the
    head axis already added. HF rotate-half convention (pairs (i, i + D/2))."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == x.dim() - 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor        # (layers, B, max_len, kv_heads, head_dim)
    v: torch.Tensor
    length: Union[int, torch.Tensor]   # filled columns, or (B,) per row
    k_scale: Optional[torch.Tensor] = None   # int8 cache: (layers, B,
    v_scale: Optional[torch.Tensor] = None   # max_len, kv_heads) float32


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """An empty cache; an int8 one with its own k and v scale buffers."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    quant = dtype == torch.int8

    def scales():
        return (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                if quant else None)

    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0, k_scale=scales(), v_scale=scales())


def _dense(weight_bits: int, quant_group: int, dtype, device,
           param_dtype=torch.float32):
    """Trunk linear constructor for the weight-at-rest precision (a float
    `Dense` keeps its weight in `param_dtype`)."""
    if weight_bits == 8:
        return lambda i, o: QuantDense(i, o, dtype=dtype, device=device)
    if weight_bits == 4:
        return lambda i, o: Quant4Dense(i, o, quant_group=quant_group,
                                        dtype=dtype, device=device)
    if weight_bits != 16:
        raise ValueError(f"weight_bits must be 16, 8 or 4, got {weight_bits}")
    return lambda i, o: Dense(i, o, bias=False, dtype=dtype,
                              param_dtype=param_dtype, device=device)


def _quant_int8(t: torch.Tensor):
    """Per-(token, head) symmetric int8 of K or V: (int8, scales)."""
    scale = _div(t.abs().amax(-1).clamp_min(1e-8), 127.0)
    q = torch.round(t / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def write_index(start, l: int, s: int, b: int, device):
    """Where L new entries go in an (B, S, ...) cache: at column `start`
    (an int, clamped so that the block fits, as `dynamic_update_slice`
    does), or at per-row columns `start` (B,), clamped to S - L (a retired
    row writes into its last columns, which its key validity never marks).
    Computed once per forward, for every layer's writes."""
    if isinstance(start, torch.Tensor):
        rows = torch.arange(b, device=device)[:, None]
        cols = (torch.clamp(start, max=s - l)[:, None]
                + torch.arange(l, device=device))
        return rows, cols
    s0 = min(max(int(start), 0), s - l)
    return slice(None), slice(s0, s0 + l)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.cache_kernel = cache_kernel
        self.use_flash = use_flash
        dense = _dense(weight_bits, quant_group, dtype, device, param_dtype)
        hd = cfg.head_dim
        self.q_proj = dense(cfg.hidden_size, cfg.num_heads * hd)
        self.k_proj = dense(cfg.hidden_size, cfg.num_kv_heads * hd)
        self.v_proj = dense(cfg.hidden_size, cfg.num_kv_heads * hd)
        self.o_proj = dense(cfg.num_heads * hd, cfg.hidden_size)

    def forward(self, x, mask, rope, cache_kv=None, index=None):
        """x: (B, L, hidden); mask: (B, 1, L, S) bool (True = attend);
        rope: the (cos, sin) tables of the positions. With a cache, keys
        and values cover its S columns, and the new entries are written in
        place at `index` (`write_index`)."""
        cfg = self.cfg
        b, l, _ = x.shape
        hd = cfg.head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        q = self.q_proj(x).reshape(b, l, h, hd)
        k = self.k_proj(x).reshape(b, l, kvh, hd)
        v = self.v_proj(x).reshape(b, l, kvh, hd)
        # q and k rotate as one tensor (the same elementwise operations)
        q, k = apply_rope(torch.cat([q, k], dim=2), *rope).split([h, kvh],
                                                                  dim=2)

        if cache_kv is not None:
            ck, cv, cks, cvs = cache_kv
            quant = ck.dtype == torch.int8
            if quant:
                # K and V quantise as one tensor: per (token, head) rows
                kv8, kv_scale = _quant_int8(torch.cat([k, v], dim=2))
                kw, vw = kv8.split(kvh, dim=2)
                cks[index], cvs[index] = kv_scale.split(kvh, dim=2)
            else:
                kw, vw = k.to(ck.dtype), v.to(cv.dtype)
            ck[index] = kw
            cv[index] = vw
            # the CUDA kernel has no layout rule: the JAX package's route in
            # interpret mode
            if (self.cache_kernel and quant and l == 1
                    and ca.fits_vmem(ck.shape[1], hd, kvh, interpret=True)):
                out = ca.int8_cache_decode_attention(
                    q[:, 0], ck, cks, cv, cvs, mask[:, 0, 0],
                    1.0 / math.sqrt(hd))
                return self.o_proj(out.to(self.dtype).reshape(b, l, h * hd))
            if quant:
                # the dequantised route, in the decode kernel's exact
                # arithmetic: a verify or a chunk attends as single steps
                out = ca.int8_cache_attention_exact(
                    q, ck, cks, cv, cvs, mask[:, 0], 1.0 / math.sqrt(hd))
                return self.o_proj(out.to(self.dtype).reshape(b, l, h * hd))
            k, v = ck.to(self.dtype), cv.to(self.dtype)

        groups = h // kvh
        if groups > 1:
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        if self.use_flash and cache_kv is None:
            out = fa.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                mask[:, 0], 1.0 / math.sqrt(hd))
            out = out.transpose(1, 2).to(self.dtype)
            return self.o_proj(out.reshape(b, l, h * hd))
        attn = torch.einsum("blhd,bshd->bhls", q, k) / torch.tensor(
            math.sqrt(hd), dtype=q.dtype, device=q.device)
        attn = torch.where(mask, attn.float(), NEG_INF)
        attn = attn.softmax(dim=-1).to(self.dtype)
        out = torch.einsum("bhls,bshd->blhd", attn, v)
        return self.o_proj(out.reshape(b, l, h * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        dense = _dense(weight_bits, quant_group, dtype, device, param_dtype)
        self.gate_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, weight_bits=weight_bits,
                  quant_group=quant_group, param_dtype=param_dtype,
                  device=device)
        norm = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **norm)
        self.attn = LlamaAttention(cfg, cache_kernel=cache_kernel,
                                   use_flash=use_flash, **kw)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                      **norm)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, x, mask, rope, cache_kv=None, index=None):
        x = x + self.attn(self.input_norm(x), mask, rope, cache_kv, index)
        return x + self.mlp(self.post_attn_norm(x))


def make_attention_mask(valid: torch.Tensor, positions: torch.Tensor,
                        cache_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, 1, L, S) bool mask: causal in position order, and validity.

    `valid`: (B, L) query (and, without a cache, key) validity.
    `cache_valid`: (B, S) validity of the cache's columns; key positions
    are then the running count of valid columns."""
    q_pos = positions[:, :, None]
    if cache_valid is not None:
        s = cache_valid.shape[1]
        k_pos = torch.where(
            cache_valid, torch.cumsum(cache_valid.to(torch.int32), dim=1) - 1,
            s + 1)
        m = ((q_pos >= k_pos[:, None, :]) & valid[:, :, None]
             & cache_valid[:, None, :])
    else:
        m = ((q_pos >= positions[:, None, :]) & valid[:, :, None]
             & valid[:, None, :])
    return m[:, None]


class LlamaModel(nn.Module):
    """Embeddings in → normed hidden states out (no LM head)."""

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 remat: bool = False, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(
                cfg, dtype=dtype, weight_bits=weight_bits,
                quant_group=quant_group, cache_kernel=cache_kernel,
                use_flash=use_flash, param_dtype=param_dtype, device=device))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  dtype=dtype, param_dtype=param_dtype,
                                  device=device)

    def forward(self, inputs_embeds, mask, positions,
                cache: Optional[KVCache] = None):
        """→ (hidden, cache with `length` advanced by L, or None)."""
        cfg = self.cfg
        x = inputs_embeds.to(self.dtype)
        b, l = x.shape[:2]
        rope = tuple(t[..., None, :] for t in rope_tables(
            positions, cfg.head_dim, cfg.rope_theta))
        index = (None if cache is None else
                 write_index(cache.length, l, cache.k.shape[2], b, x.device))
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = checkpoint(block, x, mask, rope, use_reentrant=False)
                continue
            cache_kv = None
            if cache is not None:
                cache_kv = (cache.k[i], cache.v[i],
                            None if cache.k_scale is None else cache.k_scale[i],
                            None if cache.v_scale is None else cache.v_scale[i])
            x = block(x, mask, rope, cache_kv, index)
        x = self.final_norm(x)
        if cache is not None:
            cache = cache._replace(length=cache.length + inputs_embeds.shape[1])
        return x, cache


class LlamaForCausalLM(nn.Module):
    """Trunk, token embedding table and untied (or tied) LM head."""

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 ring_mesh: Any = None, remat: bool = False,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        refuse(ring_mesh=ring_mesh)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=param_dtype)
        self.model = LlamaModel(cfg, dtype=dtype, weight_bits=weight_bits,
                                quant_group=quant_group,
                                cache_kernel=cache_kernel,
                                use_flash=use_flash, remat=remat,
                                param_dtype=param_dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.hidden_size, cfg.vocab_size, bias=False,
                              dtype=dtype, param_dtype=param_dtype,
                              device=device))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        # clamped at both ends: negative multimodal sentinels (replaced
        # later by spliced features) and out-of-vocabulary ids
        ids = input_ids.clamp(0, self.cfg.vocab_size - 1)
        table = self.embed_tokens.weight
        if table.dtype != self.dtype and torch.is_grad_enabled() \
                and table.requires_grad:
            # flax's Embed casts the table to the compute type before the
            # gather, so a repeated id's gradient sums in that type (a
            # gather from the bf16 table would sum it in bf16)
            return nn.functional.embedding(ids, table.to(self.dtype))
        return self.embed_tokens(ids).to(self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return torch.matmul(hidden, self.embed_tokens.weight.to(
                hidden.dtype).t())
        return self.lm_head(hidden)

    @torch.inference_mode()
    def forward(self, input_ids, valid=None, cache: Optional[KVCache] = None):
        """→ (logits, hidden, new cache or None), for serving callers (a
        training forward calls `model` and `logits` itself)."""
        if valid is None:
            valid = torch.ones(input_ids.shape, dtype=torch.bool,
                               device=input_ids.device)
        positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        mask = make_attention_mask(valid, positions)
        hidden, cache = self.model(self.embed(input_ids), mask, positions,
                                   cache)
        return self.logits(hidden), hidden, cache


def valid_quant_group(cfg: LlamaConfig, group_size: int) -> int:
    """`group_size` if every trunk-linear input width takes it (the full
    width and the nibble plane's half), else 0 (per channel)."""
    if group_size <= 0:
        return 0
    for k in (cfg.hidden_size, cfg.intermediate_size,
              cfg.num_heads * cfg.head_dim):
        if k % (2 * group_size) != 0:
            return 0
    return group_size


def quantize_linear(weight: torch.Tensor, bits: int, group_size: int = 0,
                    clip_search: int = 0,
                    row_weight=None) -> Dict[str, torch.Tensor]:
    """A float (out, in) weight → the buffers of `QuantDense` (bits 8:
    `q`, `s`) or `Quant4Dense` (bits 4: `p`, `s`; `row_weight` the
    calibration's (in,) E[x²] for the clip search)."""
    if bits == 8:
        qw = quantize_weight(weight)
        return {"q": qw.values, "s": qw.scales[None]}
    if bits == 4:
        qw = quantize_weight_int4(weight, group_size=group_size or None,
                                  clip_search=clip_search,
                                  row_weight=row_weight)
        return {"p": qw.packed, "s": qw.scales}
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def quantize_trunk_weights(state: Dict[str, torch.Tensor], bits: int = 8,
                           group_size: int = 0, clip_search: int = 0,
                           row_weights=None) -> Dict[str, torch.Tensor]:
    """A state dict of a `weight_bits=16` model (or of any model holding
    one) → the `weight_bits=bits` layout: each trunk linear's `weight`
    becomes its quantised buffers. Embeddings, norms and the LM head stay
    float. `row_weights` ({module path: (in,) E[x²]}, from
    `serve/calibrate.collect_row_weights`) weights the int4 clip search of
    each linear found in it by its state-dict path
    (`serve/calibrate.lookup_row_weight`); bits 8 ignores them."""
    from setok_tpu_torch.serve.calibrate import lookup_row_weight
    out = {}
    for key, value in state.items():
        *mod, leaf = key.split(".")
        if leaf == "weight" and mod and mod[-1] in TRUNK_LINEARS \
                and value.dim() == 2:
            rw = (lookup_row_weight(row_weights, tuple(mod))
                  if row_weights and bits == 4 else None)
            for name, t in quantize_linear(value, bits, group_size,
                                           clip_search, rw).items():
                out[".".join([*mod, name])] = t
        else:
            out[key] = value
    return out
