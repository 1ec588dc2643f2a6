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
(`torch.utils.checkpoint`), as the JAX package's `nn.remat` does.

Sequence parallelism (`ring_mesh`, a (data, seq) mesh from
parallel/mesh.make_sp_mesh): `ring_forward` runs the trunk on this rank's
slice of the sequence with no global mask, each attention through
`parallel/ring_attention.py` (K/V, positions and validity rotating around
the `seq` ranks), and all-gathers the hidden states.

Tensor parallelism (`tensor_parallel_`, Megatron by hand over the `model`
ranks): q/k/v, gate/up and the LM head keep a slice of their output
features, o/down a slice of their input features, and each attention and
MLP block ends in one all-reduce (parallel/comm.reduce_from; its input
enters through `copy_to`, whose backward is the all-reduce of the
gradient). The local shards run the same kernels at the local shapes.

A row-parallel int8 (or per-channel int4) layer gives the one-card
output bit for bit: x is quantised with the row absmax of the whole x (an
all-reduce MAX) and its slice enters the kernel as int8 values with a pad
column of 127 (zero weights) and unit weight scales, so the kernel's own
row scale is 1 and its float32 output is the slice's exact integer dot
(while |acc| < 2^24); the ranks' sums are added (exact integers) and
scaled as the kernel's epilogue scales, (acc·x_scale)·w_scale. A grouped
int4 layer sums its groups' scaled products in float32 in one order that
no split of K reproduces: it stays whole on every rank, its input
all-gathered. KV heads split where `num_kv_heads % tp == 0`; otherwise
each rank keeps the one kv head its query heads read (the repeat of kv
heads stays local).
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
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import Quant4Weight, QuantizedWeight
from setok_tpu_torch.ops.blocks import Dense, Quant4Dense, QuantDense
from setok_tpu_torch.parallel import comm
from setok_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group
from setok_tpu_torch.parallel.ring_attention import ring_attention
from setok_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30

TRUNK_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


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
               dtype=torch.bfloat16, device=None,
               kv_heads: Optional[int] = None) -> KVCache:
    """An empty cache; an int8 one with its own k and v scale buffers.
    `kv_heads`: the heads this rank holds (a tensor-parallel model's
    `LlamaForCausalLM.kv_heads`), default all of them."""
    shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.num_kv_heads,
             cfg.head_dim)
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
        # the heads this rank computes, and its tensor-parallel group
        self.n_heads, self.n_kv = cfg.num_heads, cfg.num_kv_heads
        self.tp_group = None

    def forward(self, x, mask, rope, cache_kv=None, index=None, ring=None):
        """x: (B, L, hidden); mask: (B, 1, L, S) bool (True = attend);
        rope: the (cos, sin) tables of the positions. With a cache, keys
        and values cover its S columns, and the new entries are written in
        place at `index` (`write_index`). `ring`: (group, positions,
        valid) of this rank's sequence slice, for ring attention (no
        mask)."""
        cfg = self.cfg
        b, l, _ = x.shape
        hd = cfg.head_dim
        h, kvh = self.n_heads, self.n_kv
        x = comm.copy_to(x, self.tp_group)
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
                return self._out(out.to(self.dtype).reshape(b, l, h * hd))
            if quant:
                # the dequantised route, in the decode kernel's exact
                # arithmetic: a verify or a chunk attends as single steps
                out = ca.int8_cache_attention_exact(
                    q, ck, cks, cv, cvs, mask[:, 0], 1.0 / math.sqrt(hd))
                return self._out(out.to(self.dtype).reshape(b, l, h * hd))
            k, v = ck.to(self.dtype), cv.to(self.dtype)

        groups = h // kvh
        if groups > 1:
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        if ring is not None and cache_kv is None:
            group, positions, valid = ring
            out = ring_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                group, causal=True, sm_scale=1.0 / math.sqrt(hd),
                positions=positions, valid=valid)
            out = out.transpose(1, 2).to(self.dtype)
            return self._out(out.reshape(b, l, h * hd))
        if self.use_flash and cache_kv is None:
            out = fa.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                mask[:, 0], 1.0 / math.sqrt(hd))
            out = out.transpose(1, 2).to(self.dtype)
            return self._out(out.reshape(b, l, h * hd))
        attn = torch.einsum("blhd,bshd->bhls", q, k) / torch.tensor(
            math.sqrt(hd), dtype=q.dtype, device=q.device)
        attn = torch.where(mask, attn.float(), NEG_INF)
        attn = attn.softmax(dim=-1).to(self.dtype)
        out = torch.einsum("bhls,bshd->blhd", attn, v)
        return self._out(out.reshape(b, l, h * hd))

    def _out(self, o):
        return row_parallel(self.o_proj, o, self.tp_group)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        dense = _dense(weight_bits, quant_group, dtype, device, param_dtype)
        self.gate_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size)
        self.tp_group = None

    def forward(self, x):
        x = comm.copy_to(x, self.tp_group)
        return row_parallel(self.down_proj,
                            F.silu(self.gate_proj(x)) * self.up_proj(x),
                            self.tp_group)


def row_parallel(layer: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer on this rank's slice of its input, summed over
    `group` (one all-reduce; the layer itself without a group).

    int8 and per-channel int4: the one-card output bit for bit (the
    module docstring): x quantised with the whole row's scale, the slice's
    integer dot through the kernel (`k_pad` zero-weight columns, the first
    holding 127, and unit scales `s_one`), the sums added, then the
    epilogue's (acc·x_scale)·w_scale. Grouped int4: the whole layer on the
    gathered input. Float: the float32 partial outputs summed."""
    if group is None:
        return layer(x)
    if getattr(layer, "tp_whole", False):
        return layer(comm.all_gather_cat(x.contiguous(), -1, group))
    if isinstance(layer, (QuantDense, Quant4Dense)):
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        comm.all_reduce_(amax, group, torch.distributed.ReduceOp.MAX)
        sx = _div(amax.clamp_min(1e-8), 127.0)
        x8 = torch.round(xf / sx).clamp(-127, 127)
        pad = x8.new_zeros((*x8.shape[:-1], layer.k_pad))
        pad[..., :1] = 127.0
        xp = torch.cat([x8, pad], dim=-1)
        if isinstance(layer, QuantDense):
            acc = qm.quant_matmul(xp, QuantizedWeight(layer.q, layer.s_one),
                                  out_dtype=torch.float32)
        else:
            acc = qm.quant4_matmul(xp, Quant4Weight(layer.p, layer.s_one),
                                   out_dtype=torch.float32)
        comm.all_reduce_(acc, group)
        return (acc * sx * layer.s.reshape(-1)).to(layer.compute_dtype)
    y = layer(x)
    return comm.reduce_from(y.float(), group).to(y.dtype)


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

    def forward(self, x, mask, rope, cache_kv=None, index=None, ring=None):
        x = x + self.attn(self.input_norm(x), mask, rope, cache_kv, index,
                          ring)
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
        self.ring_group = None

    def forward(self, inputs_embeds, mask, positions,
                cache: Optional[KVCache] = None, valid=None):
        """→ (hidden, cache with `length` advanced by L, or None). With
        `mask=None` (sequence parallelism, no cache) the inputs are this
        rank's slice of the sequence, `positions` / `valid` its (B, L)
        global positions and validity, and every attention is
        `ring_attention` over `ring_group`."""
        cfg = self.cfg
        x = inputs_embeds.to(self.dtype)
        b, l = x.shape[:2]
        rope = tuple(t[..., None, :] for t in rope_tables(
            positions, cfg.head_dim, cfg.rope_theta))
        ring = None
        if mask is None and cache is None:
            if valid is None:
                valid = torch.ones((b, l), dtype=torch.bool, device=x.device)
            ring = (self.ring_group, positions, valid)
        index = (None if cache is None else
                 write_index(cache.length, l, cache.k.shape[2], b, x.device))
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = checkpoint(block, x, mask, rope, None, None, ring,
                               use_reentrant=False)
                continue
            cache_kv = None
            if cache is not None:
                cache_kv = (cache.k[i], cache.v[i],
                            None if cache.k_scale is None else cache.k_scale[i],
                            None if cache.v_scale is None else cache.v_scale[i])
            x = block(x, mask, rope, cache_kv, index, ring)
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
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.ring_mesh = ring_mesh
        # tensor parallelism (`tensor_parallel_`): the group, and whether
        # the embedding and the LM head hold slices
        self.tp_group = None
        self.tp_embed = self.tp_head = False
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
        if ring_mesh is not None:
            self.model.ring_group = axis_group(ring_mesh, SEQ_AXIS)

    @property
    def kv_heads(self) -> int:
        """The KV heads this rank's cache holds."""
        return self.model.layer_0.attn.n_kv

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
            out = nn.functional.embedding(ids, table.to(self.dtype))
        else:
            out = nn.functional.embedding(ids, table).to(self.dtype)
        if self.tp_embed:
            # this rank's slice of the hidden width, gathered
            out = comm.gather_replicated(out, -1, self.tp_group)
        return out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            if self.tp_embed:
                # the tied head over this rank's slice of the width
                n = self.embed_tokens.weight.shape[1]
                r = comm.group_rank(self.tp_group)
                hidden = comm.copy_to(hidden, self.tp_group)
                part = torch.matmul(
                    hidden[..., r * n:(r + 1) * n],
                    self.embed_tokens.weight.to(hidden.dtype).t())
                return comm.reduce_from(part.float(), self.tp_group).to(
                    hidden.dtype)
            return torch.matmul(hidden, self.embed_tokens.weight.to(
                hidden.dtype).t())
        if not self.tp_head:
            return self.lm_head(hidden)
        # column-parallel: its input's gradient sums over the ranks
        out = self.lm_head(comm.copy_to(hidden, self.tp_group))
        return comm.gather_replicated(out, -1, self.tp_group)

    def ring_forward(self, embeds, positions, valid):
        """The trunk over a (data, seq) mesh: this rank's slice of the
        sequence through `ring_attention` (no global mask), the hidden
        states all-gathered along the sequence. The inputs cover the whole
        sequence (alike on the `seq` ranks). The gather's backward sums
        the ranks' gradients, so a loss computed alike on n ranks is
        scaled by 1/n before its backward (train/stage2.py)."""
        group = self.model.ring_group
        n, r = comm.group_size(group), comm.group_rank(group)
        l = embeds.shape[1]
        if l % n:
            raise ValueError(f"sequence length {l} must divide over {n} "
                             "sequence-parallel ranks")
        lc = l // n
        part = slice(r * lc, (r + 1) * lc)
        hidden, _ = self.model(embeds[:, part], None, positions[:, part],
                               valid=valid[:, part])
        return comm.gather_summed(hidden, 1, group)

    @torch.inference_mode()
    def forward(self, input_ids, valid=None, cache: Optional[KVCache] = None):
        """→ (logits, hidden, new cache or None), for serving callers (a
        training forward calls `model` and `logits` itself)."""
        if valid is None:
            valid = torch.ones(input_ids.shape, dtype=torch.bool,
                               device=input_ids.device)
        positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        if self.ring_mesh is not None and cache is None:
            # ring attention never materialises the (L, L) mask
            hidden = self.ring_forward(self.embed(input_ids), positions,
                                       valid)
            return self.logits(hidden), hidden, None
        mask = make_attention_mask(valid, positions)
        hidden, cache = self.model(self.embed(input_ids), mask, positions,
                                   cache)
        return self.logits(hidden), hidden, cache

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tensor_parallel_(self, group, lora: Optional[dict] = None) -> dict:
        """Keep this rank's tensor-parallel slices (in place): q/k/v,
        gate/up and the LM head split their output features, o/down their
        input features, the embedding its hidden width (each where it
        divides, as `parallel/sharding.llama_tp_spec` has it). `lora`
        ({module path: (A (in, r), B (r, out))}, train/lora.py) is sliced
        alike: B of a column-parallel layer, A of a row-parallel one.
        Query heads split evenly; KV heads split where `num_kv_heads % tp
        == 0`, else each rank keeps the one its query heads read (tp a
        multiple of num_kv_heads). A grouped int4 o/down stays whole (its
        input gathered: `row_parallel`). Returns {id(tensor): Piece} of
        every float weight and adapter sliced (where each lies in its full
        tensor)."""
        from setok_tpu_torch.parallel.sharding import Piece
        n, r = comm.group_size(group), comm.group_rank(group)
        pieces: dict = {}
        if group is None:
            return pieces

        def keep(t, dim, a, b):
            full = tuple(t.shape)
            t.data = t.data.narrow(dim, a, b - a).clone()
            pieces[id(t)] = Piece(dim, a, b - a, full)

        cfg, hd = self.cfg, self.cfg.head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        for name, width in (("num_heads", h),
                            ("intermediate_size", cfg.intermediate_size)):
            if width % n:
                raise ValueError(f"{name} {width} must divide over {n} "
                                 "ranks")
        h_loc = h // n
        if kvh % n == 0:
            kv_lo, kv_loc = r * (kvh // n), kvh // n
        elif n % kvh == 0:
            kv_lo, kv_loc = (r * h_loc) // (h // kvh), 1
        else:
            raise ValueError(f"tensor parallelism over {n} ranks needs "
                             f"num_kv_heads {kvh} to divide it or be "
                             f"divisible by it")
        lora = lora or {}
        names = {m: name for name, m in self.named_modules()}
        q_rows = (r * h_loc * hd, (r + 1) * h_loc * hd)
        kv_rows = (kv_lo * hd, (kv_lo + kv_loc) * hd)
        w = cfg.intermediate_size // n
        mid = (r * w, (r + 1) * w)
        for i in range(cfg.num_layers):
            blk = getattr(self.model, f"layer_{i}")
            att, mlp = blk.attn, blk.mlp
            for layer, rows in ((att.q_proj, q_rows), (att.k_proj, kv_rows),
                                (att.v_proj, kv_rows), (mlp.gate_proj, mid),
                                (mlp.up_proj, mid)):
                _slice_out(layer, rows, lora.get(names[layer]), keep)
            _slice_in(att.o_proj, q_rows, lora.get(names[att.o_proj]), keep)
            _slice_in(mlp.down_proj, mid, lora.get(names[mlp.down_proj]),
                      keep)
            att.n_heads, att.n_kv = h_loc, kv_loc
            att.tp_group = mlp.tp_group = group
        if self.lm_head is not None and cfg.vocab_size % n == 0:
            v = cfg.vocab_size // n
            _slice_out(self.lm_head, (r * v, (r + 1) * v),
                       lora.get(names[self.lm_head]), keep)
            self.tp_head = True
        if cfg.hidden_size % n == 0:
            w = cfg.hidden_size // n
            keep(self.embed_tokens.weight, 1, r * w, (r + 1) * w)
            self.embed_tokens.embedding_dim = w
            self.tp_embed = True
        self.tp_group = group
        return pieces


def _unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """Half-packed int4 (out, in/2) → the (out, in) int8 values."""
    from setok_tpu_torch.kernels.quant import unpack_nibbles
    lo, hi = unpack_nibbles(p)
    return torch.cat([lo, hi], dim=1)


def _pack_rows(q: torch.Tensor) -> torch.Tensor:
    """(out, in) int4 values → half-packed (out, in/2) bytes."""
    k = q.shape[1]
    q32 = q.to(torch.int32)
    return ((q32[:, :k // 2] & 0xF) | ((q32[:, k // 2:] & 0xF) << 4)).to(
        torch.int8)


def _slice_out(layer: nn.Module, rows, lora_ab, keep) -> None:
    """Keep output features [rows) of a trunk linear (and B's columns)."""
    a, b = rows
    if isinstance(layer, QuantDense):
        layer.q = layer.q[a:b].clone()
        layer.s = layer.s[:, a:b].clone()
    elif isinstance(layer, Quant4Dense):
        layer.p = layer.p[a:b].clone()
        layer.s = layer.s[:, a:b].clone()
    else:
        keep(layer.weight, 0, a, b)
        if getattr(layer, "qscale", None) is not None:
            keep(layer.qscale, 1, a, b)
        layer.out_features = b - a
        if lora_ab is not None:
            keep(lora_ab[1], 1, a, b)


def _k_pad(k: int) -> int:
    """Extra zero-weight input columns of a row-parallel quantised slice
    of width k: at least one (it holds the 127 that sets the kernel's row
    scale to 1), up to a multiple of 64 (the kernels' K step)."""
    return 64 - k % 64 if k % 64 else 64


def _slice_in(layer: nn.Module, cols, lora_ab, keep) -> None:
    """Keep input features [cols) of a trunk linear (and A's rows); a
    quantised one gets its `k_pad` zero columns and unit scales `s_one`;
    a grouped int4 one stays whole (`tp_whole`)."""
    a, b = cols
    if isinstance(layer, Quant4Dense) and layer.quant_group:
        layer.tp_whole = True
    elif isinstance(layer, (QuantDense, Quant4Dense)):
        pad = layer.k_pad = _k_pad(b - a)
        if isinstance(layer, QuantDense):
            q = layer.q[:, a:b]
            layer.q = torch.cat([q, q.new_zeros((q.shape[0], pad))], 1)
        else:
            q = _unpack_rows(layer.p)[:, a:b]
            layer.p = _pack_rows(torch.cat(
                [q, q.new_zeros((q.shape[0], pad))], 1))
        layer.register_buffer("s_one", torch.ones_like(layer.s),
                              persistent=False)
    else:
        keep(layer.weight, 1, a, b)
        layer.in_features = b - a
        if lora_ab is not None:
            keep(lora_ab[0], 0, a, b)


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
