"""DPC-KNN density-peaks clustering as fixed-K masked tensor ops, batched.

The counterpart of `setok_tpu/ops/clustering.py`, with a leading batch axis
where the JAX package uses `vmap`. Per image of N tokens:

    dist      = cdist(x, x) / sqrt(C)                              (N, N)
    density_i = exp(-mean(k smallest dist_i²)) + (i + 0.5)/N · 1e-6
    parent_i  = min_j ( density_j > density_i ? dist[i, j] : rowmax_j )
    score_i   = parent_i · density_i

with rowmax_j = max_k dist[j, k]: the fill is the per-column row max, as in
the reference SeTok. Centers are the tokens whose score clears `threshold`
(the top `k_max` of them, index-ordered), or the top `min_cluster_num`
scores when none does; every token joins its nearest center (first index on
ties) and centers join themselves. The output has a static shape: `k_max`
center slots, the invalid ones holding the sentinel N.

Every function keeps its input's float type, so float64 runs are possible.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class ClusterResult(NamedTuple):
    """Static-shaped clustering output for B images of N tokens."""

    center_idx: torch.Tensor    # (B, k_max) int64, ascending; invalid = N
    center_valid: torch.Tensor  # (B, k_max) bool
    idx_cluster: torch.Tensor   # (B, N) int64 in [0, k_max)
    score: torch.Tensor         # (B, N) density-peak score
    num_clusters: torch.Tensor  # (B,) int64


def pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """cdist(x, x) / sqrt(C) by the matmul identity, exact zero diagonal.
    x: (..., N, C) → (..., N, N)."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    n, c = x.shape[-2:]
    sq = (x * x).sum(-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (x @ x.transpose(-1, -2))
    d2 = d2.clamp_min(0.0)
    d2 = d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))
    return d2.sqrt() / math.sqrt(c)


def density_tie_break(n: int, dtype, device) -> torch.Tensor:
    """The deterministic (i + 0.5)/N · 1e-6 density tie-break, (N,)."""
    return (torch.arange(n, dtype=dtype, device=device) + 0.5) / n * 1e-6


def select_centers(score: torch.Tensor, k_max: int, min_cluster_num: int,
                   threshold: float):
    """(center_idx, center_valid, num_clusters) from scores (B, N).

    Ranks by score with a stable sort, so that equal scores keep index order
    as `lax.top_k` does; only slots past `num_clusters` (masked) can hold
    the -inf ties.
    """
    n = score.shape[-1]
    if k_max > n:
        raise ValueError(f"k_max ({k_max}) exceeds the token count N={n}")
    above = score > threshold
    n_above = above.sum(-1)
    use_fallback = n_above == 0
    num_clusters = torch.where(use_fallback,
                               torch.full_like(n_above, min_cluster_num),
                               n_above.clamp_max(k_max))
    sel_score = torch.where(use_fallback[:, None] | above, score,
                            float("-inf"))
    top_idx = torch.sort(sel_score, dim=-1, descending=True,
                         stable=True).indices[:, :k_max]
    slot_valid = (torch.arange(k_max, device=score.device)[None, :]
                  < num_clusters[:, None])
    center_idx = torch.sort(torch.where(slot_valid, top_idx, n),
                            dim=-1).values
    return center_idx, center_idx < n, num_clusters


def assign_to_centers(center_dist: torch.Tensor, center_idx: torch.Tensor,
                      center_valid: torch.Tensor) -> torch.Tensor:
    """Nearest valid center per token, first index on ties; centers join
    their own slot and the sentinel N is dropped.
    center_dist: (B, k_max, N) distances (any monotone form)."""
    b, k_max, n = center_dist.shape
    center_dist = torch.where(center_valid[..., None], center_dist,
                              float("inf"))
    idx = torch.argmin(center_dist, dim=-2)                     # (B, N)
    # one spare column absorbs the sentinel writes
    idx = torch.cat([idx, idx.new_zeros(b, 1)], dim=-1)
    slots = torch.arange(k_max, device=idx.device).expand(b, k_max)
    return idx.scatter(-1, center_idx, slots)[:, :n]


def cluster_dpc_knn(x: torch.Tensor, k: int, k_max: int,
                    min_cluster_num: int, threshold: float,
                    token_mask: Optional[torch.Tensor] = None,
                    dist_norm: bool = False) -> ClusterResult:
    """Cluster B images of N tokens each into at most `k_max` groups.

    x: (B, N, C); token_mask: optional (B, N) validity mask. `dist_norm`
    divides the distances by their mean over valid off-diagonal pairs (not
    in the reference; off by default).
    """
    b, n, _ = x.shape
    if min_cluster_num > k_max:
        raise ValueError("k_max must bound the fallback count")
    k = min(k, n)
    dist = pairwise_dist(x)                                     # (B, N, N)
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)

    if token_mask is not None:
        valid = token_mask > 0
    if dist_norm:
        pair_w = torch.ones_like(dist)
        if token_mask is not None:
            v = valid.to(dist.dtype)
            pair_w = v[:, :, None] * v[:, None, :]
        pair_w = pair_w.masked_fill(eye, 0.0)
        mean_d = ((dist * pair_w).sum((-2, -1))
                  / pair_w.sum((-2, -1)).clamp_min(1.0))
        dist = dist / mean_d.clamp_min(1e-12)[:, None, None]

    if token_mask is not None:
        # invalid columns pushed beyond any real distance
        far = dist.amax((-2, -1)) + 1.0
        dist = torch.where(valid[:, None, :], dist, far[:, None, None])

    nearest = torch.topk(dist, k, dim=-1, largest=False).values
    density = torch.exp(-(nearest * nearest).mean(-1))
    density = density + density_tie_break(n, density.dtype, density.device)
    if token_mask is not None:
        density = density * valid

    higher = density[:, None, :] > density[:, :, None]
    rowmax = dist.amax(-1)
    parent = torch.where(higher, dist, rowmax[:, None, :]).amin(-1)
    score = parent * density

    center_idx, center_valid, num_clusters = select_centers(
        score, k_max, min_cluster_num, threshold)
    rows = torch.gather(dist, 1, center_idx.clamp_max(n - 1)[..., None]
                        .expand(b, k_max, n))
    idx_cluster = assign_to_centers(rows, center_idx, center_valid)
    return ClusterResult(center_idx=center_idx, center_valid=center_valid,
                         idx_cluster=idx_cluster, score=score,
                         num_clusters=num_clusters)


def segment_mean(x: torch.Tensor, idx_cluster: torch.Tensor, k_max: int,
                 token_mask: Optional[torch.Tensor] = None):
    """Mean-pool token features per cluster: (B, N, C) → (B, k_max, C),
    counts (B, k_max), by a one-hot matmul."""
    onehot = torch.nn.functional.one_hot(idx_cluster, k_max).to(x.dtype)
    if token_mask is not None:
        onehot = onehot * token_mask.to(x.dtype)[..., None]
    counts = onehot.sum(-2)
    pooled = onehot.transpose(-1, -2) @ x
    return pooled / counts.clamp_min(1.0)[..., None], counts


def same_cluster_mask(idx_cluster: torch.Tensor,
                      token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., N, N) bool: True where two tokens share a cluster (and are
    valid)."""
    same = idx_cluster[..., :, None] == idx_cluster[..., None, :]
    if token_mask is not None:
        valid = token_mask > 0
        same = same & valid[..., :, None] & valid[..., None, :]
    return same
