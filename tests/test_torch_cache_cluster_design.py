"""CPU models of the Hopper designs of two kernels, held to their plain
versions and to the JAX package:

* the int8-cache decode attention (`csrc/cache_attention.cu`): keys in tiles
  of 32, a cluster of CS CTAs per (batch row, kv head), CTA r owning tiles
  r, r + CS, ...; each CTA's float32 maxima, its float64 partial sums of p
  and its float64 partial P.V, combined in rank order and rounded once; key
  tiles that are wholly masked skipped in a row that has a valid key. The
  model equals the plain version bit for bit (bar 0: both take the same
  float64 sums rounded once; only rare float64 ties could differ);
* the DPC-KNN density/parent kernel (`csrc/cluster_dpc.cu`): the Gram
  product over 64-row tile pairs I <= J with mirrored stores (and, on a
  diagonal pair, the 32 x 32 warp blocks on and below the diagonal), and
  the radix select of the k-th smallest squared distance; the plain version
  (float64 Gram rounded once) against the JAX kernel in interpret mode with
  the bars of tests/test_torch_cluster_kernel.py: density rtol 1e-5, scores
  rtol 1e-3 on the peaks and within 1e-3 on >= 90 % of tokens, the same
  centers and assignments.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setok_tpu.kernels.cluster_pallas import (cluster_dpc_knn_pallas,
                                              dpc_density_parent as j_dpc)
from setok_tpu.ops.clustering import cluster_dpc_knn as j_cluster
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels.cluster_dpc import (cluster_dpc_knn_kernel,
                                                 d2_from_gram,
                                                 dpc_density_parent,
                                                 gram_f64)
from tests.test_clustering import make_clustered_data
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TILE = ca.TILE


def _cache(seed, b, s, kvh, g, d):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(b, kvh * g, d).astype(np.float32))

    def int8():
        f = rs.randn(b, s, kvh, d).astype(np.float32)
        sc = np.abs(f).max(-1) / 127
        q8 = np.clip(np.round(f / sc[..., None]), -127, 127).astype(np.int8)
        return torch.from_numpy(q8), torch.from_numpy(sc.astype(np.float32))

    (k8, ks), (v8, vs) = int8(), int8()
    return rs, q, k8, ks, v8, vs


def cluster_split(q, k8, ks, v8, vs, valid, sm_scale, cs, skip=True):
    """The kernel's split at CTA granularity: (out, tiles skipped)."""
    b, h, d = q.shape
    s, kvh = k8.shape[1], k8.shape[2]
    g = h // kvh
    nt = math.ceil(s / TILE)
    qg = q.float().reshape(b, kvh, g, d).double()
    out = torch.empty(b, kvh, g, d)
    skipped = 0
    for bi in range(b):
        row_valid = bool(valid[bi].any())
        for hi in range(kvh):
            parts = []
            for r in range(cs):
                tiles = list(range(r, nt, cs))
                live = [t for t in tiles
                        if not (skip and row_valid)
                        or bool(valid[bi, t * TILE:(t + 1) * TILE].any())]
                skipped += len(tiles) - len(live)
                keys = torch.tensor([j for t in live
                                     for j in range(t * TILE,
                                                    min(s, (t + 1) * TILE))],
                                    dtype=torch.long)
                sc = (qg[bi, hi] @ k8[bi, keys, hi].double().T).float()
                sc = sc * (ks[bi, keys, hi] * sm_scale)
                sc = torch.where(valid[bi, keys], sc, ca.NEG_INF)
                parts.append((keys, sc))
            m = torch.stack([sc.amax(-1) if len(keys) else
                             torch.full((g,), -math.inf)
                             for keys, sc in parts]).amax(0)
            ps = [torch.exp((sc - m[:, None]).double()).float()
                  for _, sc in parts]
            l = torch.zeros(g, dtype=torch.float64)
            for p in ps:                                  # rank order
                l = l + p.double().sum(-1)
            o = torch.zeros(g, d, dtype=torch.float64)
            for (keys, _), p in zip(parts, ps):
                pv = p / l.float()[:, None] * vs[bi, keys, hi]
                o = o + pv.double() @ v8[bi, keys, hi].double()
            out[bi, hi] = o.float()
    return out.reshape(b, h, d), skipped


def _masks(rs, b, s):
    valid = torch.from_numpy(rs.rand(b, s) > 0.3)
    valid[0, 0] = True
    valid[1] = False
    valid[1, :s // 3] = True                       # a prefix (serving)
    valid[-1] = False                              # the uniform average
    return valid


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_cache_cluster_split_is_the_plain_version_to_the_bit(cs, g):
    b, s, kvh, d = 3, 300, 2, 32                   # S: 9 tiles and a ragged one
    rs, q, k8, ks, v8, vs = _cache(cs * 10 + g, b, s, kvh, g, d)
    valid = _masks(rs, b, s)
    sm = d ** -0.5
    got, _ = cluster_split(q, k8, ks, v8, vs, valid, sm, cs)
    want = ca.int8_cache_decode_attention_plain(q, k8, ks, v8, vs, valid, sm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["prefix", "holes", "none_valid"])
def test_skipping_masked_tiles_changes_no_bit(layout):
    b, s, kvh, g, d = 4, 512, 2, 2, 64
    rs, q, k8, ks, v8, vs = _cache(7, b, s, kvh, g, d)
    lengths = torch.tensor([160, 128, 33, 97])[:, None]
    valid = torch.arange(s)[None] < lengths        # the serving layout
    if layout == "holes":
        valid &= torch.from_numpy(rs.rand(b, s) > 0.2)
    elif layout == "none_valid":
        valid[2] = False
    sm = d ** -0.5
    want = ca.int8_cache_decode_attention_plain(q, k8, ks, v8, vs, valid, sm)
    for cs in (1, 4):
        full, none = cluster_split(q, k8, ks, v8, vs, valid, sm, cs,
                                   skip=False)
        got, skipped = cluster_split(q, k8, ks, v8, vs, valid, sm, cs)
        assert none == 0 and skipped == ca.masked_tiles(valid, kvh) > 0
        assert torch.equal(got, full) and torch.equal(got, want)
    if layout == "none_valid":      # every key read: the uniform average
        uniform = (v8[2].float() * vs[2][..., None]).mean(0)
        torch.testing.assert_close(got[2], uniform.repeat_interleave(g, 0),
                                   rtol=1e-5, atol=1e-6)


def test_cache_skip_count_on_the_cpu_route():
    rs, q, k8, ks, v8, vs = _cache(3, 2, 100, 2, 1, 16)
    valid = torch.zeros(2, 100, dtype=torch.bool)
    valid[0, :40] = True                           # tiles 2 and 3 dead
    valid[1, [5, 70]] = True                       # tiles 1 and 3 dead
    skipped = torch.zeros(1, dtype=torch.int32)
    ca.int8_cache_decode_attention(q, k8, ks, v8, vs, valid, skipped=skipped)
    assert int(skipped) == ca.masked_tiles(valid, 2) == 8
    assert ca.LAUNCHES == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cache_attention_keeps_q_type(dtype):
    rs, q, k8, ks, v8, vs = _cache(4, 2, 64, 2, 2, 32)
    valid = _masks(rs, 2, 64)
    got = ca.int8_cache_decode_attention(q.to(dtype), k8, ks, v8, vs, valid)
    want = ca.int8_cache_decode_attention_plain(q.to(dtype).float(), k8, ks,
                                                v8, vs, valid, 32 ** -0.5)
    assert got.dtype == dtype
    assert torch.equal(got, want.to(dtype))


# ----------------------------------------------------------------------------
# row 1


def _check_scores(got_score, ref_score, threshold=0.55):
    close = np.isclose(got_score, ref_score, rtol=1e-3, atol=1e-3)
    assert close.mean() >= 0.9
    peaks = ref_score > threshold
    np.testing.assert_allclose(got_score[peaks], ref_score[peaks], rtol=1e-3)


@pytest.mark.parametrize("seed,n,c,k", [(0, 50, 48, 8), (1, 100, 16, 16)])
def test_plain_version_meets_the_jax_bars(seed, n, c, k):
    x = make_clustered_data(seed, n=n, c=c)
    want_d, want_p, want_max = j_dpc(jnp.asarray(x), k=k, block_rows=32,
                                     interpret=True)
    dens, parent, rowmax = dpc_density_parent(torch.from_numpy(x[None]), k=k)
    np.testing.assert_allclose(dens[0].numpy(), np.asarray(want_d), rtol=1e-5)
    np.testing.assert_allclose(float(rowmax.amax()), float(want_max),
                               rtol=1e-5)
    _check_scores((dens * parent)[0].numpy(), np.asarray(want_d * want_p))
    kw = dict(k=k, k_max=16, min_cluster_num=4, threshold=0.55)
    got = cluster_dpc_knn_kernel(torch.from_numpy(x[None]), **kw)
    for ref in (cluster_dpc_knn_pallas(jnp.asarray(x), interpret=True, **kw),
                j_cluster(jnp.asarray(x), **kw)):
        assert int(got.num_clusters[0]) == int(ref.num_clusters)
        np.testing.assert_array_equal(got.center_idx[0].numpy(),
                                      np.asarray(ref.center_idx))
        np.testing.assert_array_equal(got.idx_cluster[0].numpy(),
                                      np.asarray(ref.idx_cluster))


def symmetric_gram(x: torch.Tensor, tile: int = 64, block: int = 32):
    """The Gram kernel's schedule: tile pairs I <= J, each block stored and
    mirrored; on a diagonal pair only the warp blocks on and below the
    diagonal, the ones below mirrored. Unwritten entries stay NaN."""
    b, n, _ = x.shape
    out = torch.full((b, n, n), math.nan)
    xd = x.double()
    nt = math.ceil(n / tile)
    for i_t in range(nt):
        for j_t in range(i_t, nt):
            for wm in range(tile // block):
                for wn in range(tile // block):
                    if i_t == j_t and wm < wn:
                        continue               # the idle warp
                    i0, j0 = i_t * tile + wm * block, j_t * tile + wn * block
                    if i0 >= n or j0 >= n:
                        continue
                    xi, xj = xd[:, i0:i0 + block], xd[:, j0:j0 + block]
                    blk = (xi @ xj.transpose(-1, -2)).float()
                    ri, rj = blk.shape[1], blk.shape[2]
                    out[:, i0:i0 + ri, j0:j0 + rj] = blk
                    if not (i_t == j_t and wm == wn):
                        out[:, j0:j0 + rj, i0:i0 + ri] = blk.transpose(-1, -2)
    return out


@pytest.mark.parametrize("n,c", [(100, 48), (64, 16), (129, 40), (50, 99)])
def test_symmetric_tile_schedule_reproduces_the_plain_d2(n, c):
    x = torch.from_numpy(np.stack([make_clustered_data(s, n=n, c=c)
                                   for s in (0, 1)]))
    gram = symmetric_gram(x)
    assert not torch.isnan(gram).any()          # every entry written
    assert torch.equal(gram, gram.transpose(-1, -2))
    assert torch.equal(d2_from_gram(gram, c), d2_from_gram(gram_f64(x), c))


def radix_kth(v: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's select: the largest float bit pattern t (31 steps from
    bit 30) with fewer than k values below it, over rows of d2 >= +0."""
    bits = v.contiguous().view(torch.int32).long()
    kth = torch.zeros(v.shape[:-1], dtype=torch.long)
    for bit in range(30, -1, -1):
        cand = kth | (1 << bit)
        below = (bits < cand[..., None]).sum(-1)
        kth = torch.where(below < k, cand, kth)
    return kth.int().view(torch.float32)


@pytest.mark.parametrize("n,k", [(50, 8), (100, 16), (100, 100), (64, 1)])
def test_radix_select_is_the_exact_kth_smallest(n, k):
    x = torch.from_numpy(np.stack([make_clustered_data(s, n=n, c=16)
                                   for s in (2, 3)]))
    d2 = d2_from_gram(gram_f64(x), 16)
    kth = radix_kth(d2, k)
    assert torch.equal(kth, torch.kthvalue(d2, k, dim=-1).values)
    below = torch.where(d2 < kth[..., None], d2, 0.0).double().sum(-1)
    n_below = (d2 < kth[..., None]).sum(-1)
    exact = below + kth.double() * (k - n_below)
    torch.testing.assert_close(
        exact, torch.topk(d2, k, dim=-1, largest=False).values.double()
        .sum(-1), rtol=1e-12, atol=0)
