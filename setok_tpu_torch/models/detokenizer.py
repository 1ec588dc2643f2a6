"""SetokDeTokenizer: K semantic tokens → reconstructed image.

The counterpart of `setok_tpu/models/detokenizer.py`: learned mask-token
queries, the Q-Former mapper cross-attending to the tokens, a linear to the
decoder width plus a 2-D sin-cos encoding, `decoder_depth` ViT blocks, the
final LayerNorm (eps 1e-5) and the pixel head with unpatchify. Images are
NHWC. The forward carries gradients and returns `hidden`, the pixel head's
input, beside the image (stage-1's adaptive GAN weight differentiates the
head alone on it). A `generator` runs the dropout of the Q-Former
(`proj_drop`, `attn_drop`) and of the decoder blocks. `quant8=True`
(inference only) passes to the Q-Former and the decoder blocks.
The forward runs inside the span `setok.detokenizer`, split into
`setok.detokenizer.mapper` (the queries, `mapper_fc_in`, the Q-Former) and
`setok.detokenizer.decoder` (from `decoder_fc_in` to the pixels)
(`utils/profiling.span`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from setok_tpu_torch.config import DetokenizerConfig
from setok_tpu_torch.models.qformer import QFormer
from setok_tpu_torch.ops.blocks import Dense, LayerNorm, ViTBlock
from setok_tpu_torch.ops.posenc import posenc_2d_flat
from setok_tpu_torch.utils.device import resolve_device
from setok_tpu_torch.utils.profiling import span


class DetokenizerOutput(NamedTuple):
    image: torch.Tensor     # (B, H, W, 3) reconstructed pixels
    hidden: torch.Tensor    # (B, grid², decoder_embed_dim) pre-head features


def unpatchify(x: torch.Tensor, patch_size: int, channels: int = 3) -> torch.Tensor:
    """(B, h·w, p²·c) patch pixels → (B, h·p, w·p, c) image (NHWC)."""
    b, n, _ = x.shape
    h = w = int(round(n ** 0.5))
    p = patch_size
    x = x.reshape(b, h, w, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, channels)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, c) image → (B, h·w, p²·c) patches, h = H // p, each
    flattened in (row, column, channel) order (the inverse of unpatchify).
    A side that is not a multiple of p loses its last H % p rows (W % p
    columns), as a VALID stride-p convolution drops them (so400m: 384 px
    in patches of 14)."""
    b, hh, ww, c = images.shape
    p = patch_size
    h, w = hh // p, ww // p
    x = images[:, :h * p, :w * p].reshape(b, h, p, w, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, p * p * c)


class SetokDeTokenizer(nn.Module):
    def __init__(self, cfg: DetokenizerConfig, *, quant8: bool = False,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.mask_tokens = nn.Parameter(torch.zeros(
            1, cfg.num_mask_tokens, cfg.hidden_dim, dtype=param_dtype,
            device=device))
        nn.init.normal_(self.mask_tokens, std=cfg.initializer_range)
        self.mapper_fc_in = Dense(cfg.token_feat_dim, cfg.hidden_dim, **kw)
        self.mapper = QFormer(cfg.hidden_dim, num_layers=cfg.mapper_layers,
                              num_heads=cfg.mapper_heads,
                              cross_attention_freq=cfg.cross_attention_freq,
                              dropout=cfg.proj_drop,
                              attn_dropout=cfg.attn_drop, quant8=quant8,
                              **kw)
        self.decoder_fc_in = Dense(cfg.hidden_dim, cfg.decoder_embed_dim,
                                   **kw)
        self.register_buffer("pos", posenc_2d_flat(
            cfg.grid, cfg.grid, cfg.decoder_embed_dim, dtype=torch.float64,
            device=device), persistent=False)
        for i in range(cfg.decoder_depth):
            self.add_module(f"pixel_decoder_{i}", ViTBlock(
                cfg.decoder_embed_dim, cfg.decoder_nheads,
                mlp_ratio=cfg.mlp_ratio, norm_eps=1e-5,
                proj_drop=cfg.proj_drop, attn_drop=cfg.attn_drop,
                quant8=quant8, **kw))
        self.decoder_norm = LayerNorm(cfg.decoder_embed_dim, eps=1e-5, **kw)
        self.pixel_head = Dense(cfg.decoder_embed_dim,
                                cfg.patch_size ** 2 * 3, **kw)

    def forward(self, tokens: torch.Tensor,
                token_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> DetokenizerOutput:
        """tokens: (B, K, token_feat_dim); token_valid: (B, K) bool."""
        cfg = self.cfg
        b = tokens.shape[0]
        with span("detokenizer"):
            with span("detokenizer.mapper"):
                queries = self.mask_tokens.to(self.dtype).expand(b, -1, -1)
                x = self.mapper_fc_in(tokens)
                x = self.mapper(queries, x, token_valid, generator)
            with span("detokenizer.decoder"):
                x = self.decoder_fc_in(x)
                x = x + self.pos.to(x.dtype)[None]
                for i in range(cfg.decoder_depth):
                    x = getattr(self, f"pixel_decoder_{i}")(
                        x, generator=generator)
                hidden = self.decoder_norm(x)
                image = unpatchify(self.pixel_head(hidden), cfg.patch_size)
        return DetokenizerOutput(image=image, hidden=hidden)
