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


@pytest.fixture(scope="module")
def llama_trees():
    """tiny_llama flax trees: int8, and int4 in groups of 16 rows."""
    from setok_tpu.models.llama import LlamaForCausalLM as JLlama
    from setok_tpu.models.llama import quantize_trunk_weights

    ids = jnp.zeros((1, 4), jnp.int32)
    params = JLlama(jcfg.tiny_llama()).init(jax.random.PRNGKey(0), ids)
    return {bits: jax.tree.map(np.asarray, quantize_trunk_weights(
        params, bits=bits, group_size=16 if bits == 4 else 0))
        for bits in (8, 4)}


def _llama(bits):
    from setok_tpu_torch.models.llama import LlamaForCausalLM

    return LlamaForCausalLM(tcfg.tiny_llama(), weight_bits=bits,
                            quant_group=16 if bits == 4 else 0, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_stay_int8(llama_trees, bits):
    tree = llama_trees[bits]
    state = from_flax(tree)
    lin = tree["params"]["model"]["layer_0"]["mlp"]["down_proj"]
    leaf = "q" if bits == 8 else "p"
    got = state[f"model.layer_0.mlp.down_proj.{leaf}"]
    assert got.dtype == torch.int8
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), lin[leaf].T)   # (out, in)
    scales = state["model.layer_0.mlp.down_proj.s"]
    assert scales.dtype == torch.float32
    np.testing.assert_array_equal(scales.numpy(), lin["s"])
    assert tuple(scales.shape) == ((1, 64) if bits == 8 else (8, 64))
    np.testing.assert_array_equal(
        state["embed_tokens.weight"],
        tree["params"]["embed_tokens"]["embedding"])
    model = load_flax_params(_llama(bits), tree)
    np.testing.assert_array_equal(
        getattr(model.model.layer_0.mlp.down_proj, leaf).numpy(),
        lin[leaf].T)


def test_skip_names_top_level_subtrees_only(llama_trees):
    tree = jax.tree.map(lambda a: a, llama_trees[8])
    tree["params"]["diffloss"] = {"net": {"kernel": np.zeros((2, 2))}}
    load_flax_params(_llama(8), tree, skip=("diffloss",))
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(_llama(8), tree)
    stray = jax.tree.map(lambda a: a, llama_trees[8])
    stray["params"]["model"]["layer_1"]["attn"]["extra"] = {
        "q": np.zeros((4, 4), np.int8)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(_llama(8), stray, skip=("diffloss",))


def test_type_mismatch_raises(llama_trees):
    tree = jax.tree.map(lambda a: a, llama_trees[8])
    attn = tree["params"]["model"]["layer_0"]["attn"]
    attn["q_proj"]["s"] = attn["q_proj"]["s"].astype(np.int32)
    with pytest.raises(ValueError, match="q_proj.s"):
        load_flax_params(_llama(8), tree)


def test_setokim_tree_with_diffloss_and_lora_loads_strictly():
    """A tiny Setokim tree, diffloss included, fills the port's Setokim
    with no skip; the JAX LoRA tree fills its adapters; a leaf or an
    adapter path the port does not hold raises."""
    from setok_tpu.constants import IMAGE_TOKEN_INDEX
    from setok_tpu.models.setokim import Setokim as JSetokim
    from setok_tpu.train.lora import init_lora as j_init_lora
    from setok_tpu_torch.models.setokim import Setokim
    from setok_tpu_torch.train.lora import lora_targets
    from setok_tpu_torch.utils.from_flax import lora_from_flax

    ids = np.zeros((1, 24), np.int64)
    ids[0, 1:9] = IMAGE_TOKEN_INDEX
    images = np.zeros((1, 32, 32, 3), np.float32)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    params = jax.tree.map(np.asarray, jax.jit(lambda r: jm.init(
        r, ids, images, ids, images, jax.random.PRNGKey(1),
        method=jm.init_all))(jax.random.PRNGKey(0)))
    assert "diffloss" in params["params"]
    model = load_flax_params(Setokim(tcfg.tiny_setokim(), device="cpu"),
                             params)
    np.testing.assert_array_equal(
        model.diffloss.net.res_0.mlp_fc1.weight.detach().numpy(),
        params["params"]["diffloss"]["net"]["res_0"]["mlp_fc1"]["kernel"].T)

    lora = jax.tree.map(np.asarray,
                        j_init_lora(params, jax.random.PRNGKey(2), 4))
    got = lora_from_flax(lora, model)
    assert set(got) == set(lora_targets(model)) and len(got) == 14
    path = "['params']['llama']['model']['layer_1']['mlp']['up_proj']['kernel']"
    a, b = got["llama.model.layer_1.mlp.up_proj"]
    np.testing.assert_array_equal(a.detach().numpy(), lora[path]["a"])
    assert tuple(b.shape) == (4, 128)

    stray = jax.tree.map(lambda x: x, params)
    stray["params"]["diffloss"]["net"]["extra"] = {"bias": np.zeros(3)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(Setokim(tcfg.tiny_setokim(), device="cpu"), stray)
    bad = {path.replace("up_proj", "lm_head"): lora[path]}
    with pytest.raises(KeyError, match="no Dense"):
        lora_from_flax(bad, model)
    wrong = {path: {"a": lora[path]["a"][:3], "b": lora[path]["b"]}}
    with pytest.raises(ValueError, match="LoRA shapes"):
        lora_from_flax(wrong, model)
