"""SigLIP-style ViT patch-feature extractor.

The counterpart of `setok_tpu/models/vit.py`. Differences from the SeTok
blocks: LayerNorm eps 1e-6 (flax's default) and the tanh form of GELU
(SigLIP's gelu_pytorch_tanh). The VALID stride-p patch convolution is written
as a patchify reshape and a matmul with the HWIO kernel reshaped to
(p·p·3, C), which is the same product and needs no cuDNN.

`quant8=True` routes each block as the JAX `ViTEncoderBlock` does: the two
whole-sublayer int8 kernels where its gates pass (LayerNorm eps 1e-6, the
block output float32), else the float block structure with `Attention` and
`Mlp` in their int8 forwards (ops/blocks.py): at 384 px the attention's
int8 `Dense`s and `fused_mlp_int8`, at so400m every linear through
`quant_matmul`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from setok_tpu_torch.config import ViTConfig
from setok_tpu_torch.models.detokenizer import patchify
from setok_tpu_torch.ops.blocks import (Attention, Dense, LayerNorm, Mlp,
                                        fused_int8_fits)
from setok_tpu_torch.utils.device import resolve_device

VIT_LN_EPS = 1e-6


class ViTEncoderBlock(nn.Module):
    """Pre-norm ViT encoder block (SigLIP layout)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, *,
                 quant8: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.quant8 = quant8
        self.norm1 = LayerNorm(dim, eps=VIT_LN_EPS, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=True, quant8=quant8,
                              dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=VIT_LN_EPS, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_exact=False,
                       quant8=quant8, dtype=dtype, device=device)

    def forward(self, x):
        if self.quant8 and fused_int8_fits(self.attn, self.mlp, x):
            x = self.attn.sublayer_int8(x.float(), self.norm1)
            return self.mlp.sublayer_int8(x, self.norm2)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Patch-embedding ViT returning the features of one block.

    Input (B, H, W, 3) NHWC images; output (B, N, width), N = (H/patch)².
    """

    def __init__(self, cfg: ViTConfig, *, quant8: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if cfg.merge_layer is not None:
            raise NotImplementedError(
                "ViTConfig.merge_layer (the 2x2 token merge) is not ported "
                "yet: ROADMAP.md, Queue A, 'token merge'")
        if cfg.use_class_token:
            raise NotImplementedError(
                "ViTConfig.use_class_token is not ported: no configuration "
                "uses it")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        p, c = cfg.patch_size, cfg.width
        self.patch_embed = Dense(p * p * 3, c, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches, c, device=device))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ViTEncoderBlock(
                c, cfg.num_heads, cfg.mlp_ratio, quant8=quant8, dtype=dtype,
                device=device))

    # frozen wherever the port runs it (the JAX package stops its gradient)
    @torch.no_grad()
    def forward(self, images: torch.Tensor,
                select_layer: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        sel = cfg.select_layer if select_layer is None else select_layer
        if not -cfg.depth <= sel < cfg.depth:
            raise IndexError(f"select_layer {sel} out of range for depth "
                             f"{cfg.depth}")
        tap = sel % cfg.depth          # HF hidden_states: -1 = last block

        x = self.patch_embed(patchify(images.to(self.dtype), cfg.patch_size))
        x = x + self.pos_embed.to(self.dtype)
        # blocks after the tapped one would be dead compute
        for i in range(tap + 1):
            x = getattr(self, f"block_{i}")(x)
        return x
