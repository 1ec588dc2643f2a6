"""SeTok stage-1 model: tokenizer + detokenizer, inference forward.

The counterpart of `setok_tpu/models/setok.py`. Parameters are float32;
`dtype=torch.bfloat16` follows the JAX package's mixed policy (activations
cast per op, softmax, LayerNorm statistics and clustering in float32).
`quant8=True` is the int8 inference form that the JAX package's `bench.py`
times: every transformer sublayer runs as a fused int8 CUDA kernel.
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
                 dtype=torch.float32, device=None, quant8: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.tokenizer = SetokTokenizer(tok_cfg, quant8=quant8, dtype=dtype,
                                        device=device)
        self.detokenizer = SetokDeTokenizer(det_cfg, quant8=quant8,
                                            dtype=dtype, device=device)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> SetokOutput:
        """images: (B, H, W, 3) NHWC in [-1, 1] → SetokOutput."""
        tok = self.tokenizer(images, token_mask=token_mask)
        det = self.detokenizer(tok.tokens, tok.token_valid)
        return SetokOutput(tokens=tok.tokens, token_valid=tok.token_valid,
                           recon=det.image, idx_cluster=tok.idx_cluster,
                           num_clusters=tok.num_clusters)


def expected_calls(tok_cfg: TokenizerConfig,
                   det_cfg: DetokenizerConfig) -> dict:
    """Calls of each fused int8 kernel in one `quant8=True` forward (at the
    base configuration 32 / 30 / 9 / 6). The ViT runs up to its tapped
    block; each Block runs its attention sublayers and one MLP."""
    vit = tok_cfg.vit.select_layer % tok_cfg.vit.depth + 1
    blocks = tok_cfg.inner_cluster_layers + tok_cfg.intra_cluster_layers
    cross = len(range(0, det_cfg.mapper_layers, det_cfg.cross_attention_freq))
    return {"attn_sublayer_int8": vit + blocks + det_cfg.decoder_depth,
            "mlp_sublayer_int8": vit + 2 + det_cfg.decoder_depth,
            "fused_bert_attention_int8": det_cfg.mapper_layers + cross,
            "mlp_postnorm_int8": det_cfg.mapper_layers}
