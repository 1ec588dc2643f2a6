"""The port's 2x2 token merge against the JAX package.

Mirrors tests/test_token_merge.py on the port: `ViTConfig.merge_layer`
folds each 2x2 neighbourhood of patches (space-to-depth + `merge_proj`)
after a chosen block, so the later blocks and the tokenizer run at N/4.
Bars: 1e-4 max-abs in float32 against JAX on the same flax weights (the
tolerance of tests/test_torch_models.py), exact clusters; the pool-init
projection exact; the freezing rules by which parameters get a gradient.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.tokenizer import SetokTokenizer as JTok
from setok_tpu.models.vit import ViT as JViT
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.models.vit import ViT
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.utils.from_flax import load_flax_params
from setok_tpu_torch.utils.init import init_random_
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


def merged_cfg(pkg, pool_init=True):
    tc = pkg.tiny_tokenizer()
    vit = dataclasses.replace(tc.vit, merge_layer=0,
                              merge_pool_init=pool_init)
    return dataclasses.replace(tc, vit=vit, k_max=4, knn=3,
                               min_cluster_num=2)


def images(seed, b=2, size=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("pool_init", [True, False])
def test_vit_merge_matches_jax(pool_init):
    jc, tc = merged_cfg(jcfg, pool_init), merged_cfg(tcfg, pool_init)
    x = images(0)
    jm = JViT(jc.vit)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_flax_params(ViT(tc.vit, device="cpu"), to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tc.vit.num_patches // 4,
                                       tc.vit.width)
    assert max_abs(got, want) <= TOL


def test_merge_groups_spatial_neighbours():
    """Merged slot (i, j) holds patches (2i, 2j), (2i, 2j+1), (2i+1, 2j),
    (2i+1, 2j+1) of the row-major grid, in that order."""
    vit = ViT(merged_cfg(tcfg).vit, device="cpu")
    x = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1)
    y = vit.merge(x)
    assert y.shape == (1, 4, 4)
    assert y[0, 0].tolist() == [0.0, 1.0, 4.0, 5.0]
    assert y[0, 3].tolist() == [10.0, 11.0, 14.0, 15.0]


def test_tokenizer_merged_matches_jax():
    jc, tc = merged_cfg(jcfg), merged_cfg(tcfg)
    x = images(1)
    jm = JTok(jc)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert "merge_out_norm" in params["params"]
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(SetokTokenizer(tc, device="cpu"), to_np(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    n_merged = tc.vit.num_patches // 4
    assert got.idx_cluster.shape == (2, n_merged)
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    assert max_abs(got.tokens.numpy(), want.tokens) <= TOL


def test_merge_config_is_validated():
    tc = tcfg.tiny_tokenizer()
    with pytest.raises(ValueError, match="merge_layer"):
        dataclasses.replace(tc.vit, merge_layer=0, use_class_token=True)
    with pytest.raises(ValueError, match="merge_layer"):
        dataclasses.replace(tc.vit, merge_layer=tc.vit.depth)
    with pytest.raises(ValueError, match="even patch grid"):
        dataclasses.replace(tc.vit, merge_layer=0, image_size=40)
    vit = dataclasses.replace(tc.vit, merge_layer=0)
    with pytest.raises(ValueError, match="k_max"):
        dataclasses.replace(tc, vit=vit, k_max=tc.vit.num_patches)
    late = ViT(dataclasses.replace(tc.vit, merge_layer=1), device="cpu")
    with pytest.raises(ValueError, match="select_layer"):
        late(torch.zeros(1, 32, 32, 3), select_layer=0)  # before the merge


def test_pool_init_merge_is_exact_average():
    vit = ViT(merged_cfg(tcfg).vit, device="cpu")
    init_random_(vit, 3)          # the fixed parameters survive a draw
    c = vit.cfg.width
    want = 0.25 * torch.cat([torch.eye(c)] * 4, dim=1)
    assert torch.equal(vit.merge_proj.weight.detach(), want)
    assert not vit.merge_proj.bias.detach().any()
    # it averages the four neighbours
    x = torch.randn(1, 16, c)
    with torch.no_grad():
        got = vit.merge_proj(vit.merge(x))
    grid = x.reshape(1, 2, 2, 2, 2, c).mean(dim=(2, 4)).reshape(1, 4, c)
    assert float((got - grid).abs().max()) <= 1e-6


def grads_of(tok):
    init_random_(tok, 0)
    x = torch.from_numpy(images(2))
    loss = (tok(x).tokens ** 2).sum()
    params = dict(tok.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {n: 0.0 if g is None else float((g ** 2).sum())
            for n, g in zip(params, grads)}


def test_merge_proj_trains_under_frozen_backbone():
    """A random-init merge projection under freeze_backbone: the blocks up
    to the merge frozen, the projection and the later blocks trained."""
    g = grads_of(SetokTokenizer(merged_cfg(tcfg, pool_init=False),
                                device="cpu"))
    vit = "image_feature_encoder."
    group = lambda key: sum(v for n, v in g.items()
                            if n.startswith(vit + key))
    assert group("merge_proj") > 0.0
    assert group("block_1") > 0.0           # after the merge: trainable
    assert group("block_0") == 0.0          # before it: frozen
    assert group("patch_embed") == 0.0 and group("pos_embed") == 0.0


def test_fully_frozen_without_merge():
    g = grads_of(SetokTokenizer(tcfg.tiny_tokenizer(), device="cpu"))
    assert all(v == 0.0 for n, v in g.items()
               if n.startswith("image_feature_encoder."))
    assert g["out.weight"] > 0.0


def test_pool_init_merge_fully_frozen():
    g = grads_of(SetokTokenizer(merged_cfg(tcfg), device="cpu"))
    assert all(v == 0.0 for n, v in g.items()
               if n.startswith("image_feature_encoder."))
    assert sum(v for n, v in g.items()
               if n.startswith("merge_out_norm.")) > 0.0


@pytest.mark.parametrize("pool_init", [True, False])
def test_frozen_parameters_are_those_without_gradient(pool_init):
    tok = SetokTokenizer(merged_cfg(tcfg, pool_init), device="cpu")
    g = grads_of(tok)
    names = {id(p): n for n, p in tok.named_parameters()}
    frozen = {names[id(p)] for p in tok.frozen_parameters()}
    vit = {n for n in g if n.startswith("image_feature_encoder.")}
    assert frozen == {n for n in vit if g[n] == 0.0}


def test_merge_out_norm_pins_feature_scale():
    """With a drifted (100x) merge projection the LayerNorm keeps the
    features at the scale the clustering expects."""
    tc = merged_cfg(tcfg)
    tok = init_random_(SetokTokenizer(tc, device="cpu"), 0)
    x = torch.from_numpy(images(3))
    with torch.no_grad():
        rms0 = float(tok.encode_features(x).pow(2).mean().sqrt())
        tok.image_feature_encoder.merge_proj.weight.mul_(100.0)
        rms = float(tok.encode_features(x).pow(2).mean().sqrt())
        out = tok(x)
    assert rms < 4.0 * rms0
    assert int(out.num_clusters.max()) <= tc.k_max


def test_unmerged_tokenizer_has_no_merge_norm():
    tok = SetokTokenizer(tcfg.tiny_tokenizer(), device="cpu")
    assert tok.merge_out_norm is None
    assert not any("merge" in n for n, _ in tok.named_parameters())


def test_detok_patch_variant_shapes():
    det = dataclasses.replace(tcfg.tiny_detokenizer(), patch_size=16)
    toks = torch.randn(2, 5, det.token_feat_dim)
    with torch.no_grad():
        out = SetokDeTokenizer(det, device="cpu")(toks)
        det2 = dataclasses.replace(det, patch_size=32)
        out2 = SetokDeTokenizer(det2, device="cpu")(toks)
    assert out.image.shape == out2.image.shape == (2, 32, 32, 3)
    assert out.hidden.shape == (2, det.grid ** 2, det.decoder_embed_dim)
    assert out2.hidden.shape[1] == out.hidden.shape[1] // 4


def merged_trainer(det):
    tc = tcfg.tiny_tokenizer()
    vit = dataclasses.replace(tc.vit, merge_layer=0)
    n_out = vit.num_output_patches
    tc = dataclasses.replace(tc, vit=vit, k_max=min(tc.k_max, n_out),
                             knn=min(tc.knn, n_out),
                             min_cluster_num=min(tc.min_cluster_num, n_out))
    tr = Stage1Trainer(tc, det, train_cfg=tcfg.TrainConfig(
        batch_size=2, warmup_steps=0, compute_dtype="float32"),
        device="cpu")
    tr.init_weights_(0)
    tr.init_state()
    return tr


@pytest.mark.parametrize("det", ["depth1", "patch16"])
def test_merge_recipes_train_one_step(det):
    """The merge with a shallower decoder, and with a coarser decoder
    patch: one SeTok forward and one stage-1 step each."""
    base = tcfg.tiny_detokenizer()
    det = (dataclasses.replace(base, decoder_depth=1) if det == "depth1"
           else dataclasses.replace(base, patch_size=base.patch_size * 2))
    tr = merged_trainer(det)
    imgs = torch.from_numpy(images(4))
    out = tr.model(imgs)
    assert out.recon.shape == (2, 32, 32, 3)
    metrics = tr.train_step({"comp_image": imgs, "gen_image": imgs})
    assert np.isfinite(float(metrics["total_loss"]))
    assert isinstance(tr.model, SeTok)
