"""The port's SeTok forward at 576 px against the JAX package on the CPU.

Patch 16 at 576 px gives N = 1296 tokens, past the 1024 rows that row 1's
kernel holds in registers. The model is narrow so that the file stays cheap:
ViT depth 2 at width 64, the tokenizer at width 64, a 1-layer Q-Former and a
1-layer decoder at width 64, over the full 36 x 36 grid (1296 queries and
decoder tokens) and the base configuration's clustering (k_max 80, knn 64,
min_cluster_num 64). Weights: a seeded port model as a flax tree
(`to_flax_tree`: no flax init compiles), loaded back through
`utils/from_flax.py`; the JAX model applies the same tree. Inputs from a
numpy seed. Bars: centers and assignments exact (ROADMAP's clustering bar),
tokens and reconstruction 1e-4 max-abs (tests/test_torch_models.py's).
On the CPU both packages cluster through their plain paths; the kernel
route's plain version (`cluster_dpc_knn_kernel`) is held to the JAX
package's clustering on the same features, and on blob features with real
clusters at the same N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu.ops.clustering import cluster_dpc_knn as j_cluster
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.kernels.cluster_dpc import (MAX_REG_N,
                                                 cluster_dpc_knn_kernel)
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_random_
from tests.test_clustering import make_clustered_data
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
SIZE, PATCH, WIDTH = 576, 16, 64


def configs(mod):
    """(tokenizer, detokenizer) of config module `mod` (either package's)."""
    vit = mod.ViTConfig(image_size=SIZE, patch_size=PATCH, width=WIDTH,
                        depth=2, num_heads=2)
    tok = mod.TokenizerConfig(vit=vit, hidden_dim=WIDTH,
                              token_feat_dim=WIDTH, nheads=2,
                              dim_feedforward=2 * WIDTH)
    det = mod.DetokenizerConfig(token_feat_dim=WIDTH, hidden_dim=WIDTH,
                                patch_size=PATCH, image_size=SIZE,
                                decoder_embed_dim=WIDTH, decoder_nheads=2,
                                decoder_depth=1, mapper_layers=1,
                                mapper_heads=2)
    return tok, det


@pytest.fixture(scope="module")
def models():
    tok, det = configs(tcfg)
    assert tok.vit.num_patches == det.num_mask_tokens == 1296 > MAX_REG_N
    tree = to_flax_tree(init_random_(SeTok(tok, det, device="cpu"), 5))
    port = load_flax_params(SeTok(tok, det, device="cpu"), tree)
    return port, JSeTok(*configs(jcfg)), jax.tree.map(jnp.asarray, tree)


def same_clusters(got, want):
    for name in ("center_idx", "center_valid", "idx_cluster",
                 "num_clusters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_setok_forward_at_576px_matches_jax(models):
    port, jm, tree = models
    x = np.random.RandomState(21).uniform(
        -1.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(tree, jnp.asarray(x))   # one compile, ~2 s
    got = port(torch.from_numpy(x))
    for name in ("idx_cluster", "num_clusters", "token_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.recon.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.recon.numpy(), np.asarray(want.recon),
                               rtol=0, atol=TOL)
    # the kernel route (its plain version on the CPU) on the port's
    # features: the JAX package's centers and assignments
    tok = port.tokenizer.cfg
    kw = dict(k=tok.knn, k_max=tok.k_max, min_cluster_num=tok.min_cluster_num,
              threshold=tok.threshold)
    with torch.no_grad():
        feats = port.tokenizer.encode_features(torch.from_numpy(x))
    for i in range(2):
        same_clusters(
            cluster_dpc_knn_kernel(feats[i:i + 1], **kw),
            jax.tree.map(lambda a: a[None], j_cluster(
                jnp.asarray(feats[i].numpy()), **kw)))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_route_clusters_blobs_at_1296_as_jax(seed):
    """Blob features (real clusters) at the path's N and the base knobs."""
    x = make_clustered_data(seed, n=1296, c=WIDTH)
    kw = dict(k=64, k_max=80, min_cluster_num=64, threshold=0.55)
    got = cluster_dpc_knn_kernel(torch.from_numpy(x[None]), **kw)
    want = j_cluster(jnp.asarray(x), **kw)
    assert int(got.num_clusters[0]) == int(want.num_clusters) > 1
    same_clusters(got, jax.tree.map(lambda a: a[None], want))
