"""SeTok stage-1 model: tokenizer + detokenizer.

The counterpart of `setok_tpu/models/setok.py`. `tokenize` and `detokenize`
are the training entry points: they build a graph (the tokenizer's
clustering and frozen backbone excepted) and take a `torch.Generator` for
the dropout. `forward` is the inference entry: the whole encode→decode
under `torch.inference_mode()`, deterministic. Parameters live in
`param_dtype` (float32 by default; bf16 as `bench.py` stores so400m's);
`dtype=torch.bfloat16` follows the JAX package's mixed policy (activations
cast per op, softmax, LayerNorm statistics and clustering in float32).
`quant8=True` is the int8 inference form that the JAX package's `bench.py`
and `eval_recon.py --precision quant8` run: every transformer block takes
the int8 route that the JAX package's gates pick at its shapes (the
whole-sublayer kernels, or the unfused route of ops/blocks.py), each as a
CUDA kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from setok_tpu_torch.config import DetokenizerConfig, TokenizerConfig
from setok_tpu_torch.kernels import attention_bf16 as ab
from setok_tpu_torch.kernels import cluster_dpc
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.models.detokenizer import (DetokenizerOutput,
                                                SetokDeTokenizer)
from setok_tpu_torch.models.tokenizer import SetokTokenizer, TokenizerOutput
from setok_tpu_torch.ops.blocks import DENSE_INT8_MAX
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
                 dtype=torch.float32, device=None, quant8: bool = False,
                 param_dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(quant8=quant8, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.tokenizer = SetokTokenizer(tok_cfg, **kw)
        self.detokenizer = SetokDeTokenizer(det_cfg, **kw)

    def tokenize(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> TokenizerOutput:
        """images (B, H, W, 3) → concept tokens, with a graph."""
        return self.tokenizer(images, generator=generator)

    def detokenize(self, tokens: torch.Tensor,
                   token_valid: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> DetokenizerOutput:
        """Concept tokens → image and the pixel head's input, with a graph."""
        return self.detokenizer(tokens, token_valid, generator)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> SetokOutput:
        """images: (B, H, W, 3) NHWC in [-1, 1] → SetokOutput."""
        tok = self.tokenizer(images, token_mask=token_mask)
        det = self.detokenizer(tok.tokens, tok.token_valid)
        return SetokOutput(tokens=tok.tokens, token_valid=tok.token_valid,
                           recon=det.image, idx_cluster=tok.idx_cluster,
                           num_clusters=tok.num_clusters)


INT8_KERNELS = ("attn_sublayer_int8", "mlp_sublayer_int8",
                "fused_bert_attention_int8", "mlp_postnorm_int8",
                "fused_mlp_int8", "fused_attention_int8", "quant_matmul")


def expected_calls(tok_cfg: TokenizerConfig,
                   det_cfg: DetokenizerConfig) -> dict:
    """Calls of each int8 kernel (`INT8_KERNELS`) in one `quant8=True`
    forward, from the gates the modules read (ops/blocks.py):

      base @256             32 / 30 / 9 / 6, the whole-sublayer kernels
      base @384, @576       29 fused_mlp_int8, 60 quant_matmul, 2 / 1 / 0 / 6
      base, ffn 4096        4 fused_attention_int8, 4 quant_matmul,
                            28 / 28 / 9 / 6
      so400m                104 quant_matmul, 9 BERT, 6 post-norm

    The ViT runs up to its tapped block: at so400m (`select_layer=-2`) 26
    of its 27 blocks, 104 `quant_matmul` calls. The JAX package traces the
    27th block too (108 calls under `jax.eval_shape`), and XLA drops it as
    dead code. With a token merge (`merge_layer`), the blocks after it see
    the merged count, `num_output_patches`."""
    calls = dict.fromkeys(INT8_KERNELS, 0)

    def dense(k, n):
        if k * n <= DENSE_INT8_MAX:
            calls["quant_matmul"] += 1

    def block(n, c, hidden, depth=1):
        if fs.attn_fits_vmem(n, c) and fs.mlp_fits_vmem(c, hidden):
            calls["attn_sublayer_int8"] += depth
            calls["mlp_sublayer_int8"] += 1
            return
        for _ in range(depth):
            if fs.attn_fits_vmem(n, c):
                calls["fused_attention_int8"] += 1
            else:
                dense(c, 3 * c)
                dense(c, c)
        if fs.mlp_fits_vmem(c, hidden):
            calls["fused_mlp_int8"] += 1
        else:
            dense(c, hidden)
            dense(hidden, c)

    vit = tok_cfg.vit
    merge = vit.depth if vit.merge_layer is None else vit.merge_layer
    for i in range(vit.select_layer % vit.depth + 1):
        block(vit.num_patches if i <= merge else vit.num_output_patches,
              vit.width, int(vit.width * vit.mlp_ratio))
    c = tok_cfg.hidden_dim
    block(vit.num_output_patches, c, tok_cfg.dim_feedforward,
          tok_cfg.inner_cluster_layers)
    block(tok_cfg.k_max, c, tok_cfg.dim_feedforward,
          tok_cfg.intra_cluster_layers)
    # the Q-Former's gates read the query count and its width
    q, c = det_cfg.num_mask_tokens, det_cfg.hidden_dim
    cross = len(range(0, det_cfg.mapper_layers, det_cfg.cross_attention_freq))
    if fs.attn_fits_vmem(q, c):
        calls["fused_bert_attention_int8"] += det_cfg.mapper_layers + cross
    if fs.mlp_fits_vmem(c, 4 * c):
        calls["mlp_postnorm_int8"] += det_cfg.mapper_layers
    c = det_cfg.decoder_embed_dim
    for _ in range(det_cfg.decoder_depth):
        block(q, c, int(c * det_cfg.mlp_ratio))
    return calls


def cluster_launches(tok_cfg: TokenizerConfig) -> int:
    """Row 1's CUDA launches in one unmasked tokenize on the card: one
    `cluster_dpc` call at the ViT's output token count where the tokenizer
    takes the kernel (`use_pallas_cluster`, no `cluster_dist_norm`), else
    none (models/tokenizer.SetokTokenizer.cluster)."""
    if not tok_cfg.use_pallas_cluster or tok_cfg.cluster_dist_norm:
        return 0
    return cluster_dpc.launches_per_call(tok_cfg.vit.num_output_patches)


def attention_bf16_launches(tok_cfg: TokenizerConfig,
                            det_cfg: Optional[DetokenizerConfig] = None, *,
                            dtype: torch.dtype,
                            quant8: bool = False) -> int:
    """Row 12's launches (`attention_bf16`) in one forward on the card with
    no graph and no dropout: `SeTok.forward`, or the tokenizer alone where
    `det_cfg` is None. One for each ViT block up to the tap and each
    pixel-decoder block whose attention runs the float route with a bf16
    qkv at a head width the kernel takes (ops/blocks.Attention.forward);
    the int8 form keeps a block on its fused kernels wherever the
    attention fits (`attn_fits_vmem`). The cluster Blocks pass a mask and
    the Q-Former has its own attention: neither launches it.

      base @256      bf16: 12 ViT (12 heads of 64) + 16 decoder (16 of 48)
      so400m         bf16: 26 ViT (16 of 72); its decoder's 256 is too wide
      int8 @256      0: every block fused"""
    if dtype != torch.bfloat16:
        return 0

    def block(n, c, heads):
        hd = c // heads
        if quant8 and fs.attn_fits_vmem(n, c):
            return 0
        return int(hd % 8 == 0 and 8 <= hd <= ab.MAX_D)

    vit = tok_cfg.vit
    merge = vit.depth if vit.merge_layer is None else vit.merge_layer
    launches = sum(
        block(vit.num_patches if i <= merge else vit.num_output_patches,
              vit.width, vit.num_heads)
        for i in range(vit.select_layer % vit.depth + 1))
    if det_cfg is not None:
        launches += det_cfg.decoder_depth * block(
            det_cfg.num_mask_tokens, det_cfg.decoder_embed_dim,
            det_cfg.decoder_nheads)
    return launches
