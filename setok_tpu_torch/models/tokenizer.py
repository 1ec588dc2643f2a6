"""SetokTokenizer: image → variable-K semantic tokens (fixed-K_max padded).

The counterpart of `setok_tpu/models/tokenizer.py`: ViT features plus a 2-D
sin-cos encoding, DPC-KNN clustering, the inner Block under the same-cluster
mask with a segment mean per cluster, the inter Block over the valid concept
tokens, and the output linear. Clustering and group encoding are separate
methods (`cluster`, `group_encode`) so that each stage can be compared alone.
The forward and its three stages (`encode_features`, `cluster`,
`group_encode`) run inside the spans `setok.tokenizer`,
`setok.tokenizer.encode`, `.cluster` and `.group_encode`
(`utils/profiling.span`): host ops while a profiler runs, a shared no-op
otherwise.

Clustering routes as the JAX package does: the hand-written kernel
(kernels/cluster_dpc.py) runs when `use_pallas_cluster` is set, no
`token_mask` is given, `cluster_dist_norm` is off and the features lie on
the card; every other case runs ops.clustering.cluster_dpc_knn.

`quant8=True` (inference only) passes to the ViT and the two Blocks, which
then run the fused int8 sublayer kernels and return float32.

A `generator` runs the Blocks' dropout (`proj_drop`, `attn_drop`), as the
JAX package's `deterministic=False` does.

Gradients: the clustering never carries one (`cluster` runs under
`torch.no_grad()`: assignments are data). `freeze_backbone` (the default,
as in the JAX package) runs the ViT without a gradient; with a token merge
whose projection is randomly initialised (`merge_pool_init=False`) it
freezes only the blocks up to the merge, so that the projection and the
later blocks train (`_split_freeze`). The rest (the merge's LayerNorm
`merge_out_norm`, `feat_proj`, the two Blocks and `out`) carries gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from setok_tpu_torch.config import TokenizerConfig
from setok_tpu_torch.kernels.cluster_dpc import cluster_dpc_knn_kernel
from setok_tpu_torch.models.vit import ViT
from setok_tpu_torch.ops.blocks import Block, Dense, LayerNorm
from setok_tpu_torch.ops.clustering import (ClusterResult, cluster_dpc_knn,
                                            same_cluster_mask, segment_mean)
from setok_tpu_torch.ops.posenc import posenc_2d_flat
from setok_tpu_torch.utils.device import resolve_device
from setok_tpu_torch.utils.profiling import span


class TokenizerOutput(NamedTuple):
    tokens: torch.Tensor        # (B, k_max, token_feat_dim) concept tokens
    token_valid: torch.Tensor   # (B, k_max) bool
    idx_cluster: torch.Tensor   # (B, N) cluster id per patch token
    score: torch.Tensor         # (B, N) density-peak score
    num_clusters: torch.Tensor  # (B,)


class SetokTokenizer(nn.Module):
    def __init__(self, cfg: TokenizerConfig, *, freeze_backbone: bool = True,
                 quant8: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.cfg = cfg
        self.freeze_backbone = freeze_backbone
        merged = cfg.vit.merge_layer is not None
        self._split_freeze = (freeze_backbone and merged
                              and not cfg.vit.merge_pool_init)
        self.image_feature_encoder = ViT(cfg.vit, quant8=quant8,
                                         freeze_pre_merge=self._split_freeze,
                                         **kw)
        # the merge's LayerNorm (flax's default eps) pins the scale of the
        # features that the clustering and the tokens see
        self.merge_out_norm = (LayerNorm(cfg.vit.width, eps=1e-6, **kw)
                               if merged else None)
        # an explicit projection when the ViT width differs from hidden_dim
        self.feat_proj = (None if cfg.vit.width == cfg.hidden_dim else
                          Dense(cfg.vit.width, cfg.hidden_dim, **kw))
        grid = cfg.vit.grid // 2 if merged else cfg.vit.grid
        self.register_buffer("pos", posenc_2d_flat(
            grid, grid, cfg.hidden_dim, dtype=torch.float64, device=device),
            persistent=False)
        for name, depth in (("inner_encoder", cfg.inner_cluster_layers),
                            ("inter_encoder", cfg.intra_cluster_layers)):
            self.add_module(name, Block(
                cfg.hidden_dim, cfg.nheads, cfg.dim_feedforward, depth=depth,
                norm_eps=1e-5, proj_drop=cfg.proj_drop,
                attn_drop=cfg.attn_drop, quant8=quant8, **kw))
        self.out = Dense(cfg.hidden_dim, cfg.token_feat_dim, **kw)

    def frozen_parameters(self) -> list:
        """The backbone's parameters that no gradient reaches: under
        `freeze_backbone` the whole ViT, or with `_split_freeze` its patch
        and position embeddings and the blocks up to the merge."""
        vit = self.image_feature_encoder
        if not self.freeze_backbone:
            return []
        if self._split_freeze:
            return vit.pre_merge_parameters()
        return list(vit.parameters())

    def encode_features(self, images: torch.Tensor) -> torch.Tensor:
        """ViT features (+ `merge_out_norm`, `feat_proj`) + 2-D sin-cos
        encoding, (B, N, hidden_dim)."""
        frozen = self.freeze_backbone and not self._split_freeze
        with span("tokenizer.encode"):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not frozen):
                feats = self.image_feature_encoder(images)
            if self.merge_out_norm is not None:
                feats = self.merge_out_norm(feats)
            if self.feat_proj is not None:
                feats = self.feat_proj(feats)
            return feats + self.pos.to(feats.dtype)[None]

    @torch.no_grad()
    def cluster(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None,
                threshold: Optional[float] = None,
                k: Optional[int] = None) -> ClusterResult:
        """DPC-KNN over features x: (B, N, D), in float32, without a
        gradient."""
        cfg = self.cfg
        thr = cfg.threshold if threshold is None else threshold
        knn = cfg.knn if k is None else k
        with span("tokenizer.cluster"):
            xs = x.detach().float()
            if (cfg.use_pallas_cluster and token_mask is None
                    and not cfg.cluster_dist_norm and xs.is_cuda):
                return cluster_dpc_knn_kernel(
                    xs.contiguous(), k=knn, k_max=cfg.k_max,
                    min_cluster_num=cfg.min_cluster_num, threshold=thr)
            return cluster_dpc_knn(xs, k=knn, k_max=cfg.k_max,
                                   min_cluster_num=cfg.min_cluster_num,
                                   threshold=thr, token_mask=token_mask,
                                   dist_norm=cfg.cluster_dist_norm)

    def group_encode(self, x: torch.Tensor, res: ClusterResult,
                     token_mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> TokenizerOutput:
        """Masked inner Block, segment mean, inter Block and output linear
        over features x: (B, N, D) given their clustering."""
        k_max = self.cfg.k_max
        with span("tokenizer.group_encode"):
            grouped = self.inner_encoder(
                x, mask=same_cluster_mask(res.idx_cluster, token_mask),
                generator=generator)
            valid_tokens = (token_mask if token_mask is not None
                            else torch.ones(x.shape[:2], dtype=x.dtype,
                                            device=x.device))
            pooled, counts = segment_mean(grouped, res.idx_cluster, k_max,
                                          valid_tokens)
            cluster_valid = counts > 0
            inter_mask = (cluster_valid[:, None, :]
                          & cluster_valid[:, :, None])
            tokens = self.out(self.inter_encoder(pooled, mask=inter_mask,
                                                 generator=generator))
            tokens = tokens * cluster_valid[..., None].to(tokens.dtype)
        return TokenizerOutput(tokens=tokens, token_valid=cluster_valid,
                               idx_cluster=res.idx_cluster, score=res.score,
                               num_clusters=res.num_clusters)

    def tokenize_features(self, x: torch.Tensor,
                          token_mask: Optional[torch.Tensor] = None,
                          threshold: Optional[float] = None,
                          k: Optional[int] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> TokenizerOutput:
        """Cluster + group-encode pre-computed features x: (B, N, D)."""
        res = self.cluster(x, token_mask=token_mask, threshold=threshold, k=k)
        return self.group_encode(x, res, token_mask=token_mask,
                                 generator=generator)

    def forward(self, images: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None,
                threshold: Optional[float] = None,
                k: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> TokenizerOutput:
        """images: (B, H, W, 3) → TokenizerOutput; `generator` runs the
        Blocks' dropout."""
        with span("tokenizer"):
            return self.tokenize_features(self.encode_features(images),
                                          token_mask=token_mask,
                                          threshold=threshold, k=k,
                                          generator=generator)
