"""Text tower of the stage-1 contrastive branch (SigLIP-style).

The counterpart of `setok_tpu/models/text_encoder.py`: token embedding plus
a learned position embedding, `depth` pre-norm blocks (attention under the
(B, L, L) mask of the valid tokens, tanh-GELU MLP; LayerNorm eps 1e-6),
the final LayerNorm, the last valid token's state, and the `head` linear to
`embed_dim`. Token id 0 is padding unless `valid` says otherwise. The
stage-1 trainer runs it in float32, as the JAX trainer builds it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from setok_tpu_torch.ops.blocks import Attention, Dense, LayerNorm, Mlp
from setok_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6          # flax nn.LayerNorm's default


class TextEncoder(nn.Module):
    """Token ids (B, L) → pooled (B, embed_dim) text embedding."""

    def __init__(self, vocab_size: int = 32000, width: int = 768,
                 depth: int = 6, num_heads: int = 12, max_len: int = 512,
                 embed_dim: int = 768, *, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.depth = depth
        self.dtype = dtype
        self.token_embed = nn.Embedding(vocab_size, width, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, width,
                                                  device=device))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(width, eps=LN_EPS,
                                                    dtype=dtype,
                                                    device=device))
            self.add_module(f"attn_{i}", Attention(width, num_heads,
                                                   dtype=dtype,
                                                   device=device))
            self.add_module(f"norm2_{i}", LayerNorm(width, eps=LN_EPS,
                                                    dtype=dtype,
                                                    device=device))
            self.add_module(f"mlp_{i}", Mlp(width, 4 * width,
                                            gelu_exact=False, dtype=dtype,
                                            device=device))
        self.final_norm = LayerNorm(width, eps=LN_EPS, dtype=dtype,
                                    device=device)
        self.head = Dense(width, embed_dim, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l = input_ids.shape
        if valid is None:
            valid = input_ids != 0
        x = self.token_embed(input_ids.clamp_min(0)).to(self.dtype)
        x = x + self.pos_embed[:, :l].to(self.dtype)
        mask = valid[:, None, :] & valid[:, :, None]
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(
                getattr(self, f"norm1_{i}")(x), mask=mask)
            x = x + getattr(self, f"mlp_{i}")(getattr(self, f"norm2_{i}")(x))
        x = self.final_norm(x)
        # the last valid token's state
        last = (valid.sum(dim=1) - 1).clamp_min(0)
        pooled = x[torch.arange(b, device=x.device), last]
        return self.head(pooled)
