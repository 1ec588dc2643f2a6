"""The DPC-KNN kernel module: its plain version against the JAX Pallas
kernel (interpret mode) on the CPU, its checks, and its build path.

Bars are those of tests/test_cluster_pallas.py: density rtol 1e-5; scores
rtol 1e-3 on the peaks and within 1e-3 on ≥ 90 % of tokens, because float32
summation order can flip a parent between same-blob density near-ties.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.cluster_pallas import (cluster_dpc_knn_pallas,
                                              dpc_density_parent as j_dpc)
from setok_tpu.ops.clustering import cluster_dpc_knn as j_cluster
from setok_tpu_torch.kernels import _build, cluster_dpc
from setok_tpu_torch.kernels.cluster_dpc import (cluster_dpc_knn_kernel,
                                                 dpc_density_parent,
                                                 dpc_density_parent_reference)
from tests.test_clustering import make_clustered_data
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _check_scores(got_score, ref_score, threshold=0.55):
    close = np.isclose(got_score, ref_score, rtol=1e-3, atol=1e-3)
    assert close.mean() >= 0.9
    peaks = ref_score > threshold
    np.testing.assert_allclose(got_score[peaks], ref_score[peaks], rtol=1e-3)


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 64), (0, 50), (1, 50)])
def test_reference_matches_pallas_interpret(seed, n):
    x = make_clustered_data(seed, n=n, c=16)
    want_d, want_p, want_max = j_dpc(jnp.asarray(x), k=8, block_rows=32,
                                     interpret=True)
    dens, parent, rowmax = dpc_density_parent(torch.from_numpy(x[None]), k=8)
    assert dens.shape == parent.shape == rowmax.shape == (1, n)
    np.testing.assert_allclose(dens[0].numpy(), np.asarray(want_d), rtol=1e-5)
    np.testing.assert_allclose(float(rowmax.amax()), float(want_max),
                               rtol=1e-5)
    _check_scores((dens * parent)[0].numpy(),
                  np.asarray(want_d * want_p))


@pytest.mark.parametrize("threshold", [0.55, 1e9])
def test_cluster_kernel_cpu_route_matches_jax(threshold):
    seeds = [2, 3, 4]
    xs = np.stack([make_clustered_data(s, n=64, c=16) for s in seeds])
    kw = dict(k=8, k_max=16, min_cluster_num=4, threshold=threshold)
    got = cluster_dpc_knn_kernel(torch.from_numpy(xs), **kw)
    for i, x in enumerate(xs):
        for want in (cluster_dpc_knn_pallas(jnp.asarray(x), interpret=True,
                                            **kw),
                     j_cluster(jnp.asarray(x), **kw)):
            assert int(got.num_clusters[i]) == int(want.num_clusters)
            np.testing.assert_array_equal(got.center_idx[i].numpy(),
                                          np.asarray(want.center_idx))
            np.testing.assert_array_equal(got.idx_cluster[i].numpy(),
                                          np.asarray(want.idx_cluster))


def test_cpu_route_is_the_reference():
    x = torch.from_numpy(np.stack([make_clustered_data(s, n=40, c=12)
                                   for s in (5, 6)]))
    for a, b in zip(dpc_density_parent(x, k=6),
                    dpc_density_parent_reference(x, k=6)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cluster_dpc.LAUNCHES == 0     # no kernel launch on the CPU


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros(2, 8, 4, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(8, 4), ValueError),
    (lambda: torch.zeros(1, cluster_dpc.MAX_N + 1, 4), ValueError),
    (lambda: torch.zeros(2, 4, 8).transpose(1, 2), ValueError),
], ids=["float64", "2d", "too_many_tokens", "non_contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        dpc_density_parent(bad(), k=4)


def test_wrapper_rejects_k_below_one():
    with pytest.raises(ValueError):
        dpc_density_parent(torch.zeros(1, 8, 4), k=0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The module imports without nvcc; building then raises, never falls
    back."""
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", ("no-such-nvcc",))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("cluster_dpc")


def test_build_hash_tracks_the_source():
    path = _build._library_path("cluster_dpc")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libcluster_dpc-") and path.suffix == ".so"
    with pytest.raises(FileNotFoundError):
        _build._library_path("no_such_kernel")

