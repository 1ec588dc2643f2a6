"""Query-only Q-Former mapper (BLIP-2 lineage), float path.

The counterpart of `setok_tpu/models/qformer.py`: what the reference's
stripped BertModel executes for query-only input, per layer

    h = LN(W_o · selfattn(h) + h)                      post-norm, eps 1e-12
    h = LN(W_o · crossattn(h, enc, enc_mask) + h)      every `freq` layers
    h = LN(W_2 · gelu(W_1 · h) + h)                    exact-erf GELU

after the input embedding h = LN(query_embeds).

Dropout sits at the flax sites: `dropout` after the embedding LN and after
the FFN's output dense, `attn_dropout` on each attention's probabilities
and after its output dense (the JAX defaults are 0.1 and 0.1; the
detokenizer passes its `proj_drop` and `attn_drop`). It runs only when the
forward is given a `torch.Generator`.

`quant8=True` runs each attention sublayer as the fused int8 BERT kernel
(`kernels/fused_bert_attention_int8.py`) and the FFN as the fused int8
post-norm MLP (tanh GELU), in float32, where the JAX package's gates pass;
where they fail the JAX package computes the float sublayer, and so does
the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.ops.blocks import (Dense, LayerNorm, dropout,
                                        masked_softmax)
from setok_tpu_torch.utils.device import resolve_device

BERT_LN_EPS = 1e-12


class BertSelfAttentionCore(nn.Module):
    """BERT attention with separate q/k/v, output dense and post-norm
    residual. `kv` defaults to `x`; `kv_mask` is (B, M), True = attend."""

    def __init__(self, dim: int, num_heads: int, *, dropout: float = 0.0,
                 quant8: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.quant8 = quant8
        self.dtype = dtype
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim, dtype=dtype, device=device))
        self.out_norm = LayerNorm(dim, eps=BERT_LN_EPS, dtype=dtype,
                                  device=device)

    def forward(self, x, kv=None, kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        c = x.shape[-1]
        # the JAX gate reads the query length only
        if (self.quant8 and x.dim() == 3
                and fs.attn_fits_vmem(x.shape[-2], c)):
            if generator is not None:
                raise ValueError("quant8 is inference only: no dropout")
            x = x.float()
            kv = x if kv is None else kv.float()
            return fba.fused_bert_attention_int8(
                x, kv, self.query.int8(), self.query.bias, self.key.int8(),
                self.key.bias, self.value.int8(), self.value.bias,
                self.out.int8(), self.out.bias, self.out_norm.weight,
                self.out_norm.bias, self.num_heads, kv_mask=kv_mask,
                eps=self.out_norm.eps)
        kv = x if kv is None else kv
        hd = c // self.num_heads

        def heads(t):                                  # (.., n, c) → (.., H, n, hd)
            return t.reshape(*t.shape[:-1], self.num_heads, hd).transpose(-3, -2)

        q, k, v = heads(self.query(x)), heads(self.key(kv)), heads(self.value(kv))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        mask = None if kv_mask is None else kv_mask[..., None, None, :]
        attn = dropout(masked_softmax(scores, mask).to(self.dtype),
                       self.dropout, generator)
        out = torch.matmul(attn, v).transpose(-3, -2)
        out = self.out(out.reshape(*out.shape[:-2], c))
        return self.out_norm(dropout(out, self.dropout, generator) + x)


class QFormerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden: int,
                 has_cross_attention: bool, *, dropout: float = 0.0,
                 attn_dropout: float = 0.0, quant8: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.quant8 = quant8
        self.dropout = dropout
        self.self_attn = BertSelfAttentionCore(
            dim, num_heads, dropout=attn_dropout, quant8=quant8, dtype=dtype,
            device=device)
        self.cross_attn = (BertSelfAttentionCore(
            dim, num_heads, dropout=attn_dropout, quant8=quant8, dtype=dtype,
            device=device) if has_cross_attention else None)
        self.ffn_in = Dense(dim, mlp_hidden, dtype=dtype, device=device)
        self.ffn_out = Dense(mlp_hidden, dim, dtype=dtype, device=device)
        self.ffn_norm = LayerNorm(dim, eps=BERT_LN_EPS, dtype=dtype,
                                  device=device)

    def forward(self, h, enc, enc_mask=None,
                generator: Optional[torch.Generator] = None):
        h = self.self_attn(h, generator=generator)
        if self.cross_attn is not None:
            h = self.cross_attn(h, kv=enc, kv_mask=enc_mask,
                                generator=generator)
        if self.quant8 and fs.mlp_fits_vmem(h.shape[-1],
                                            self.ffn_in.out_features):
            if generator is not None:
                raise ValueError("quant8 is inference only: no dropout")
            return fs.mlp_postnorm_int8(
                h.float(), self.ffn_in.int8(), self.ffn_in.bias,
                self.ffn_out.int8(), self.ffn_out.bias, self.ffn_norm.weight,
                self.ffn_norm.bias, ln_eps=self.ffn_norm.eps)
        y = self.ffn_out(F.gelu(self.ffn_in(h)))       # HF 'gelu' = exact erf
        return self.ffn_norm(dropout(y, self.dropout, generator) + h)


class QFormer(nn.Module):
    """Queries cross-attend to the encoder states every
    `cross_attention_freq` layers. Returns (B, Q, dim)."""

    def __init__(self, dim: int, *, num_layers: int, num_heads: int,
                 mlp_ratio: float = 4.0, cross_attention_freq: int = 2,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 quant8: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        self.embed_norm = LayerNorm(dim, eps=BERT_LN_EPS, dtype=dtype,
                                    device=device)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", QFormerLayer(
                dim, num_heads, int(dim * mlp_ratio),
                has_cross_attention=(i % cross_attention_freq == 0),
                dropout=dropout, attn_dropout=attn_dropout, quant8=quant8,
                dtype=dtype, device=device))

    def forward(self, query_embeds, encoder_hidden_states,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = dropout(self.embed_norm(query_embeds.to(self.dtype)),
                    self.dropout, generator)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, encoder_hidden_states,
                                            encoder_attention_mask, generator)
        return h
