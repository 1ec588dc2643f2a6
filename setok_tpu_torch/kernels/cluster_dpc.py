"""DPC-KNN density/parent statistics: the CUDA kernel and its plain version.

The counterpart of `setok_tpu/kernels/cluster_pallas.py`. `dpc_density_parent`
launches `csrc/cluster_dpc.cu` for a tensor on the card and runs the plain
PyTorch version, `dpc_density_parent_reference`, for a tensor on the CPU;
both compute, from the Gram product G = x·xᵀ taken in float64 and rounded
to float32 once (an f32 × f32 product is exact in float64, so the two agree
but for rare float64 ties) and sq_i = G[i, i],

    d2        = max(sq_i + sq_j - 2·G[i, j], 0) / C,   d2[i, i] = 0
    density_i = exp(-(sum of the k smallest d2[i, :]) / k) + (i + 0.5)/N·1e-6
    rowmax_i  = max_j sqrt(d2[i, j])
    parent_i  = min_j (density_j > density_i ? sqrt(d2[i, j]) : rowmax_j)

`cluster_dpc_knn_kernel` is the counterpart of `cluster_dpc_knn_pallas`:
center selection, sort and assignment follow in PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from setok_tpu_torch.ops.clustering import (ClusterResult, assign_to_centers,
                                            density_tie_break, select_centers)

# Up to MAX_REG_N the kernel holds each row of d2 in registers and keeps 12
# bytes a row in each CTA's shared memory: 227 KB (the most a block may opt
# in to on the H100) / 12. Past it a warp takes a row, over every SM, the
# row in shared memory up to N = 3072 (csrc/cluster_dpc.cu); only the Gram
# scratch grows with N there, and MAX_N stays the bound.
MAX_N = 19370
MAX_REG_N = 1024

# Kernel launches on the card since import (or since a caller reset it):
# one call of `dpc_density_parent` launches `launches_per_call(N)`.
LAUNCHES = 0


def launches_per_call(n: int) -> int:
    """Launches of one call at N tokens: the Gram product and the
    density/parent pass, or past MAX_REG_N the Gram product, the densities
    and the parents."""
    return 2 if n <= MAX_REG_N else 3


def gram_f64(x: torch.Tensor) -> torch.Tensor:
    """(B, N, N) f32: x·xᵀ as float64 sums rounded once."""
    xd = x.double()
    return (xd @ xd.transpose(-1, -2)).float()


def d2_from_gram(gram: torch.Tensor, c: int) -> torch.Tensor:
    """Squared distances / C in float32, in the JAX kernel's order, from the
    Gram product (its diagonal the squared norms); the diagonal 0."""
    n = gram.shape[-1]
    sq = gram.diagonal(dim1=-2, dim2=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    d2 = d2.clamp_min(0.0) * (1.0 / c)
    return d2.masked_fill(torch.eye(n, dtype=torch.bool, device=gram.device),
                          0.0)


def dpc_density_parent_reference(x: torch.Tensor, k: int):
    """Plain PyTorch version: (density, parent, rowmax), each (B, N) f32."""
    x = x.float()
    _, n, c = x.shape
    k = min(k, n)
    d2 = d2_from_gram(gram_f64(x), c)
    sum_k = torch.topk(d2, k, dim=-1, largest=False).values.sum(-1)
    density = (torch.exp(-(sum_k / k))
               + density_tie_break(n, torch.float32, x.device))
    dist = d2.sqrt()
    rowmax = dist.amax(-1)
    higher = density[:, None, :] > density[:, :, None]
    parent = torch.where(higher, dist, rowmax[:, None, :]).amin(-1)
    return density, parent, rowmax


def _check(x: torch.Tensor, k: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"dpc_density_parent takes float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"dpc_density_parent takes (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    if b < 1 or c < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"dpc_density_parent supports 1 <= N <= {MAX_N} and "
                         f"nonempty B, C; got {tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not x.is_contiguous():
        raise ValueError("dpc_density_parent takes a contiguous tensor")


def dpc_density_parent(x: torch.Tensor, k: int):
    """(density, parent, rowmax), each (B, N) f32, for x: (B, N, C) f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises. dist_max is `rowmax.amax(-1)`.
    """
    global LAUNCHES
    _check(x, k)
    if x.device.type == "cpu":
        return dpc_density_parent_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"dpc_density_parent runs on cuda or cpu, got {x.device}")
    b, n, c = x.shape
    k = min(k, n)
    # density, parent, rowmax, and sq (the Gram's diagonal, scratch)
    out = torch.empty((4, b, n), dtype=torch.float32, device=x.device)
    density, parent, rowmax, sq = out.unbind(0)
    gram = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launched = ctypes.c_int(0)
    err = _entry()(x.data_ptr(), density.data_ptr(), parent.data_ptr(),
                   rowmax.data_ptr(), gram.data_ptr(), sq.data_ptr(), b, n, c,
                   k, 1.0 / c, x.device.index, stream, ctypes.byref(launched))
    LAUNCHES += launched.value
    if err != 0:
        raise RuntimeError(f"cluster_dpc launch failed with CUDA error {err}")
    return density, parent, rowmax


@functools.cache
def _entry():
    """The C entry of csrc/cluster_dpc.cu, built, loaded and bound once."""
    from setok_tpu_torch.kernels._build import load_library

    fn = load_library("cluster_dpc").dpc_density_parent_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    return fn


def cluster_dpc_knn_kernel(x: torch.Tensor, k: int, k_max: int,
                           min_cluster_num: int,
                           threshold: float) -> ClusterResult:
    """DPC-KNN through `dpc_density_parent`, for unmasked x: (B, N, C)."""
    if min_cluster_num > k_max:
        raise ValueError("k_max must bound the fallback count")
    density, parent, _ = dpc_density_parent(x, k)
    return select_and_assign(x, density * parent, k_max, min_cluster_num,
                             threshold)


def select_and_assign(x: torch.Tensor, score: torch.Tensor, k_max: int,
                      min_cluster_num: int, threshold: float) -> ClusterResult:
    """Centers from scores, then each token to its nearest center by
    squared distance to the k_max centers only, O(N·k_max·C)."""
    b, n, _ = x.shape
    center_idx, center_valid, num_clusters = select_centers(
        score, k_max, min_cluster_num, threshold)
    xf = x.float()
    centers = torch.gather(xf, 1, center_idx.clamp_max(n - 1)[..., None]
                           .expand(b, k_max, xf.shape[-1]))
    d2c = ((centers * centers).sum(-1)[..., None]
           + (xf * xf).sum(-1)[:, None, :]
           - 2.0 * (centers @ xf.transpose(-1, -2))).clamp_min(0.0)
    idx_cluster = assign_to_centers(d2c, center_idx, center_valid)
    return ClusterResult(center_idx=center_idx, center_valid=center_valid,
                         idx_cluster=idx_cluster, score=score,
                         num_clusters=num_clusters)
