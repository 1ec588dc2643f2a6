"""The flax → PyTorch weight bridge is strict and complete."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.utils.from_flax import from_flax, load_flax_params


@pytest.fixture(scope="module")
def flax_params():
    model = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree.map(np.asarray, params)


def _model():
    return SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(), device="cpu")


def test_every_leaf_fills_exactly_one_parameter(flax_params):
    leaves = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    state = from_flax(flax_params)
    assert len(state) == len(leaves)
    model = _model()
    own = dict(model.named_parameters())
    assert set(state) == set(own)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(own[key].shape), key
    load_flax_params(model, flax_params)
    for key, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), state[key], rtol=0, atol=0)


def test_conversions(flax_params):
    state = from_flax(flax_params)
    tok = flax_params["params"]["tokenizer"]
    qkv = tok["image_feature_encoder"]["block_0"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(
        state["tokenizer.image_feature_encoder.block_0.attn.qkv.weight"], qkv.T)
    conv = tok["image_feature_encoder"]["patch_embed"]["kernel"]    # HWIO
    np.testing.assert_array_equal(
        state["tokenizer.image_feature_encoder.patch_embed.weight"],
        conv.reshape(-1, conv.shape[-1]).T)
    np.testing.assert_array_equal(
        state["tokenizer.inner_encoder.norm1.weight"],
        tok["inner_encoder"]["norm1"]["scale"])
    det = flax_params["params"]["detokenizer"]
    np.testing.assert_array_equal(state["detokenizer.mask_tokens"],
                                  det["mask_tokens"])
    np.testing.assert_array_equal(
        state["detokenizer.mapper.layer_0.cross_attn.out_norm.weight"],
        det["mapper"]["layer_0"]["cross_attn"]["out_norm"]["scale"])


def test_missing_leaf_raises(flax_params):
    pruned = jax.tree.map(lambda a: a, flax_params)
    del pruned["params"]["detokenizer"]["pixel_head"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(_model(), pruned)


def test_extra_leaf_raises(flax_params):
    extra = jax.tree.map(lambda a: a, flax_params)
    extra["params"]["tokenizer"]["stray"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(_model(), extra)


def test_shape_mismatch_raises(flax_params):
    bad = jax.tree.map(lambda a: a, flax_params)
    bad["params"]["tokenizer"]["out"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="tokenizer.out.bias"):
        load_flax_params(_model(), bad)
