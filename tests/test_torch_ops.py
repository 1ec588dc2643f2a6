"""The port's ops against the JAX package on the CPU.

Blocks: the flax module's params go through `from_flax`; max-abs 1e-5 in
float32. Clustering: float64 on both sides (as tests/test_clustering.py
runs it), where centers and assignments must be identical and scores agree
to 1e-12. Pooling and masks: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.ops import blocks as jblocks
from setok_tpu.ops.clustering import cluster_dpc_knn as j_cluster
from setok_tpu.ops.clustering import same_cluster_mask as j_same
from setok_tpu.ops.clustering import segment_mean as j_segment_mean
from setok_tpu.ops.posenc import posenc_2d_flat as j_posenc
from setok_tpu_torch.ops import blocks
from setok_tpu_torch.ops.clustering import (cluster_dpc_knn, same_cluster_mask,
                                            segment_mean)
from setok_tpu_torch.ops.posenc import posenc_2d_flat
from setok_tpu_torch.utils.from_flax import load_flax_params
from tests.test_clustering import make_clustered_data

BLOCK_TOL = 1e-5


@pytest.mark.parametrize("h,w,c", [(4, 4, 32), (16, 16, 768), (3, 5, 30)])
def test_posenc_matches_jax(h, w, c):
    got = posenc_2d_flat(h, w, c).numpy()
    want = np.asarray(j_posenc(h, w, c))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(jmod, tmod, *args, **kw):
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = jmod.init(jax.random.PRNGKey(0), *jargs, **jkw)
    want = np.asarray(jmod.apply(params, *jargs, **jkw))
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = tmod(*[torch.from_numpy(a) for a in args],
                   **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= BLOCK_TOL, err
    return got


@pytest.mark.parametrize("exact", [True, False])
def test_mlp_matches_jax(exact):
    _compare(jblocks.Mlp(hidden_features=64, gelu_exact=exact),
             blocks.Mlp(32, 64, gelu_exact=exact), _x(0, (2, 10, 32)))


def _block_diag_mask(n, groups):
    idx = np.repeat(np.arange(groups), -(-n // groups))[:n]
    return np.broadcast_to(idx[:, None] == idx[None, :], (2, n, n)).copy()


@pytest.mark.parametrize("mask_kind", ["none", "block_diag", "fully_masked"])
def test_attention_matches_jax(mask_kind):
    n = 12
    kw = {}
    if mask_kind == "block_diag":
        kw["mask"] = _block_diag_mask(n, 3)
    elif mask_kind == "fully_masked":
        mask = _block_diag_mask(n, 2)
        mask[:, 9:, :] = False          # rows that may attend to nothing
        kw["mask"] = mask
    got = _compare(jblocks.Attention(num_heads=4),
                   blocks.Attention(32, 4), _x(1, (2, n, 32)), **kw)
    if mask_kind == "fully_masked":
        # a fully masked row averages every value uniformly: finite output
        assert np.isfinite(got).all()


def test_block_shared_norm1_matches_jax():
    tmod = blocks.Block(32, 2, 64, depth=2, norm_eps=1e-5)
    _compare(jblocks.Block(num_heads=2, mlp_hidden_dim=64, depth=2), tmod,
             _x(2, (2, 12, 32)), mask=_block_diag_mask(12, 4))
    names = [n for n, _ in tmod.named_parameters()]
    assert sum(n.startswith("norm1.") for n in names) == 2   # one shared LN
    assert any(n.startswith("attn_1.") for n in names)


def test_vit_block_matches_jax():
    _compare(jblocks.ViTBlock(num_heads=2), blocks.ViTBlock(32, 2, norm_eps=1e-5),
             _x(3, (2, 16, 32)))


def _batch(seeds, n=64, c=16, dtype=np.float64):
    return np.stack([make_clustered_data(s, n=n, c=c) for s in seeds]).astype(dtype)


def _jax_cluster_batch(xs, masks=None, **kw):
    outs = []
    with jax.enable_x64():
        for i, x in enumerate(xs):
            m = None if masks is None else jnp.asarray(masks[i])
            res = j_cluster(jnp.asarray(x), token_mask=m, **kw)
            outs.append(jax.tree.map(np.asarray, res))
    return outs


def _assert_cluster_equal(got, want):
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got.center_idx[i].numpy(), w.center_idx)
        np.testing.assert_array_equal(got.center_valid[i].numpy(),
                                      w.center_valid)
        np.testing.assert_array_equal(got.idx_cluster[i].numpy(),
                                      w.idx_cluster)
        assert int(got.num_clusters[i]) == int(w.num_clusters)
        assert np.max(np.abs(got.score[i].numpy() - w.score)) <= 1e-12


@pytest.mark.parametrize("threshold", [0.55, 1e9])   # 1e9 forces the fallback
def test_cluster_dpc_knn_matches_jax_float64(threshold):
    xs = _batch([0, 1, 2])
    kw = dict(k=8, k_max=16, min_cluster_num=4, threshold=threshold)
    got = cluster_dpc_knn(torch.from_numpy(xs), **kw)
    assert got.score.dtype == torch.float64
    _assert_cluster_equal(got, _jax_cluster_batch(xs, **kw))


def test_cluster_dpc_knn_token_mask_matches_jax_float64():
    xs = _batch([3, 4], n=48)
    masks = np.ones((2, 48))
    masks[0, 40:] = 0
    masks[1, 30:] = 0
    kw = dict(k=8, k_max=16, min_cluster_num=4, threshold=0.55)
    got = cluster_dpc_knn(torch.from_numpy(xs),
                          token_mask=torch.from_numpy(masks), **kw)
    _assert_cluster_equal(got, _jax_cluster_batch(xs, masks, **kw))


def test_cluster_dpc_knn_dist_norm_matches_jax_float64():
    xs = _batch([5, 6])
    kw = dict(k=8, k_max=16, min_cluster_num=4, threshold=0.4, dist_norm=True)
    got = cluster_dpc_knn(torch.from_numpy(xs), **kw)
    _assert_cluster_equal(got, _jax_cluster_batch(xs, **kw))


def test_segment_mean_matches_jax_exactly():
    rs = np.random.RandomState(0)
    # small integers: every sum is exact in any order, so equality is exact
    x = rs.randint(-8, 9, size=(2, 30, 8)).astype(np.float32)
    idx = rs.randint(0, 5, size=(2, 30))
    mask = (rs.rand(2, 30) > 0.2).astype(np.float32)
    got, counts = segment_mean(torch.from_numpy(x), torch.from_numpy(idx), 8,
                               torch.from_numpy(mask))
    for i in range(2):
        want, want_counts = j_segment_mean(jnp.asarray(x[i]),
                                           jnp.asarray(idx[i]), 8,
                                           jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(counts[i].numpy(),
                                      np.asarray(want_counts))


def test_same_cluster_mask_matches_jax_exactly():
    rs = np.random.RandomState(1)
    idx = rs.randint(0, 4, size=(3, 20))
    tm = (rs.rand(3, 20) > 0.3).astype(np.float32)
    for mask in (None, tm):
        got = same_cluster_mask(torch.from_numpy(idx),
                                None if mask is None else torch.from_numpy(mask))
        for i in range(3):
            want = j_same(jnp.asarray(idx[i]),
                          None if mask is None else jnp.asarray(mask[i]))
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
