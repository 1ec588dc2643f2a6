"""SeTok stage-1 model: tokenizer + detokenizer, inference forward.

The counterpart of `setok_tpu/models/setok.py`. Parameters are float32;
`dtype=torch.bfloat16` follows the JAX package's mixed policy (activations
cast per op, softmax, LayerNorm statistics and clustering in float32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from setok_tpu_torch.config import DetokenizerConfig, TokenizerConfig
from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.utils.device import resolve_device


class SetokOutput(NamedTuple):
    tokens: torch.Tensor        # (B, k_max, token_feat_dim)
    token_valid: torch.Tensor   # (B, k_max)
    recon: torch.Tensor         # (B, H, W, 3)
    idx_cluster: torch.Tensor   # (B, N)
    num_clusters: torch.Tensor  # (B,)


class SeTok(nn.Module):
    """`tokenizer` then `detokenizer`; call either alone for one half."""

    def __init__(self, tok_cfg: TokenizerConfig, det_cfg: DetokenizerConfig,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.tokenizer = SetokTokenizer(tok_cfg, dtype=dtype, device=device)
        self.detokenizer = SetokDeTokenizer(det_cfg, dtype=dtype,
                                            device=device)

    def forward(self, images: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> SetokOutput:
        """images: (B, H, W, 3) NHWC in [-1, 1] → SetokOutput."""
        tok = self.tokenizer(images, token_mask=token_mask)
        det = self.detokenizer(tok.tokens, tok.token_valid)
        return SetokOutput(tokens=tok.tokens, token_valid=tok.token_valid,
                           recon=det.image, idx_cluster=tok.idx_cluster,
                           num_clusters=tok.num_clusters)
