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

`ViTConfig.merge_layer` folds each 2x2 neighbourhood of patches into one
token after that block (space-to-depth, then the `merge_proj` linear from
4·width to width), so the later blocks and the tokenizer run at N/4. With
`merge_pool_init` the projection starts as the exact 2x2 average pool.
The forward carries gradients; `freeze_pre_merge` runs the blocks up to
the merge without them (the JAX package's stop-gradient there), which the
tokenizer asks for when a frozen backbone meets a randomly initialised
merge projection.
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
                 quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.quant8 = quant8
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=VIT_LN_EPS, **kw)
        self.attn = Attention(dim, num_heads, qkv_bias=True, quant8=quant8,
                              **kw)
        self.norm2 = LayerNorm(dim, eps=VIT_LN_EPS, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_exact=False,
                       quant8=quant8, **kw)

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
                 freeze_pre_merge: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if cfg.use_class_token:
            raise NotImplementedError(
                "ViTConfig.use_class_token is not ported: no configuration "
                "uses it")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.freeze_pre_merge = freeze_pre_merge
        p, c = cfg.patch_size, cfg.width
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.patch_embed = Dense(p * p * 3, c, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_patches, c, dtype=param_dtype, device=device))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ViTEncoderBlock(
                c, cfg.num_heads, cfg.mlp_ratio, quant8=quant8, **kw))
        self.merge_proj = None
        if cfg.merge_layer is not None:
            self.merge_proj = Dense(4 * c, c, **kw)
            self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        """The parameters that the configuration fixes rather than draws:
        with `merge_pool_init`, `merge_proj` as the exact 2x2 average pool
        (the folded axis holds the four neighbours as blocks of width, so
        0.25·[I I I I] averages them) and a zero bias."""
        if self.merge_proj is None or not self.cfg.merge_pool_init:
            return
        c = self.cfg.width
        eye = torch.eye(c, device=self.merge_proj.weight.device)
        self.merge_proj.weight.copy_(0.25 * torch.cat([eye] * 4, dim=1))
        self.merge_proj.bias.zero_()

    def pre_merge_parameters(self) -> list:
        """The parameters of what runs before the merge (the patch and
        position embeddings and the blocks up to `merge_layer`): those
        `freeze_pre_merge` runs without a gradient."""
        blocks = [getattr(self, f"block_{i}")
                  for i in range(self.cfg.merge_layer + 1)]
        return [self.pos_embed, *self.patch_embed.parameters(),
                *(p for b in blocks for p in b.parameters())]

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """(B, g·g, C) → (B, g/2·g/2, 4C): each 2x2 neighbourhood of the
        patch grid into one token, its four patches in row-major order."""
        b, n, c = x.shape
        g = int(round(n ** 0.5))
        x = x.reshape(b, g // 2, 2, g // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (g // 2) * (g // 2), 4 * c)

    def forward(self, images: torch.Tensor,
                select_layer: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        sel = cfg.select_layer if select_layer is None else select_layer
        if not -cfg.depth <= sel < cfg.depth:
            raise IndexError(f"select_layer {sel} out of range for depth "
                             f"{cfg.depth}")
        tap = sel % cfg.depth          # HF hidden_states: -1 = last block
        merge_at = cfg.merge_layer
        if merge_at is not None and tap < merge_at:
            raise ValueError(f"select_layer {sel} taps a block before the "
                             f"merge after block {merge_at}")

        # blocks after the tapped one would be dead compute
        pre = tap if merge_at is None else merge_at
        frozen = self.freeze_pre_merge and merge_at is not None
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            x = self.patch_embed(patchify(images.to(self.dtype),
                                          cfg.patch_size))
            x = x + self.pos_embed.to(self.dtype)
            for i in range(pre + 1):
                x = getattr(self, f"block_{i}")(x)
        if merge_at is not None:
            x = self.merge_proj(self.merge(x))
        for i in range(pre + 1, tap + 1):
            x = getattr(self, f"block_{i}")(x)
        return x
