"""The port's LLaMA trunk against the JAX package on the CPU.

`tiny_llama()` with the same flax weights, float or quantised by the JAX
package's `quantize_trunk_weights` (int8; int4 per channel and per group of
16 input rows with the clip search), on numpy ids with padded rows. The JAX
quantised linears run their Pallas kernels in interpret mode. Bars, max-rel
= max|got - want| / max|want|: logits and hidden 1e-4 at bits 16 (float32
on both sides, sums in another order); 2e-3 at bits 8 and 4, where a
last-bit difference upstream can flip one int8 rounding of an activation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.llama import LlamaForCausalLM as JLlama
from setok_tpu.models.llama import make_attention_mask as j_mask
from setok_tpu.models.llama import quantize_trunk_weights as j_quantize
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.llama import (LlamaForCausalLM,
                                          make_attention_mask,
                                          quantize_trunk_weights,
                                          valid_quant_group)
from setok_tpu_torch.utils.from_flax import from_flax, load_flax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {"bits16": (16, 0, 1e-4), "bits8": (8, 0, 2e-3),
         "bits4": (4, 0, 2e-3), "bits4-g16": (4, 16, 2e-3)}


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def ids_and_valid():
    rs = np.random.RandomState(2)
    ids = rs.randint(3, 512, (2, 12)).astype(np.int64)
    valid = np.ones((2, 12), bool)
    valid[1, 9:] = False
    ids[1, 9:] = 0
    return ids, valid


@pytest.fixture(scope="module")
def llama_params():
    ids, _ = ids_and_valid()
    params = JLlama(jcfg.tiny_llama()).init(jax.random.PRNGKey(0),
                                            jnp.asarray(ids))
    return jax.tree.map(np.asarray, params)


def quantized(params, bits, group):
    if bits == 16:
        return params
    return jax.tree.map(np.asarray, j_quantize(
        params, bits=bits, group_size=group,
        clip_search=8 if bits == 4 else 0))


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax(llama_params, case):
    bits, group, bar = CASES[case]
    params = quantized(llama_params, bits, group)
    ids, valid = ids_and_valid()
    jm = JLlama(jcfg.tiny_llama(), weight_bits=bits, quant_group=group)
    w_logits, w_hidden, _ = jm.apply(params, jnp.asarray(ids),
                                     jnp.asarray(valid))
    model = load_flax_params(LlamaForCausalLM(
        tcfg.tiny_llama(), weight_bits=bits, quant_group=group,
        device="cpu"), params)
    logits, hidden, cache = model(torch.from_numpy(ids),
                                  torch.from_numpy(valid))
    assert cache is None
    assert max_rel(logits, w_logits) <= bar
    assert max_rel(hidden, w_hidden) <= bar


@pytest.mark.parametrize("case", ["bits8", "bits4", "bits4-g16"])
def test_port_quantizes_like_jax(llama_params, case):
    bits, group, _ = CASES[case]
    want = from_flax(quantized(llama_params, bits, group))
    got = quantize_trunk_weights(from_flax(llama_params), bits=bits,
                                 group_size=group,
                                 clip_search=8 if bits == 4 else 0)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)


def test_valid_quant_group():
    assert valid_quant_group(tcfg.tiny_llama(), 128) == 0
    assert valid_quant_group(tcfg.tiny_llama(), 16) == 16
    assert valid_quant_group(tcfg.vicuna_7b(), 128) == 128


@pytest.mark.parametrize("with_cache", [False, True])
def test_attention_mask_matches_jax(with_cache):
    rs = np.random.RandomState(4)
    valid = rs.rand(3, 7) > 0.3
    positions = np.cumsum(valid, axis=1).astype(np.int32) - 1
    cache_valid = None
    if with_cache:
        cache_valid = np.concatenate([valid, rs.rand(3, 5) > 0.5], axis=1)
    want = j_mask(jnp.asarray(valid), jnp.asarray(positions),
                  None if cache_valid is None else jnp.asarray(cache_valid))
    got = make_attention_mask(
        torch.from_numpy(valid), torch.from_numpy(positions),
        None if cache_valid is None else torch.from_numpy(cache_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_options_not_ported_raise(tmp_path):
    """Every option of the JAX LlamaForCausalLM runs: use_flash and remat
    (tests/test_torch_stage2.py), calibrated int4
    (tests/test_torch_calibrate.py) and `ring_mesh`, whose forward over a
    (1, 1) sequence-parallel mesh (ring attention, no global mask) gives
    the masked forward's logits (the ring over more ranks:
    tests/test_torch_parallel_ring.py)."""
    from setok_tpu_torch.parallel.mesh import make_sp_mesh
    from tests.torch_parallel_workers import one_rank_group
    LlamaForCausalLM(tcfg.tiny_llama(), device="cpu", use_flash=True,
                     remat=True)
    assert quantize_trunk_weights({}, bits=4, row_weights={("a",): 1}) == {}
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        1, 500, (2, 12)))
    valid = torch.ones_like(ids, dtype=torch.bool)
    valid[1, 4:6] = False
    dense = LlamaForCausalLM(tcfg.tiny_llama(), device="cpu")
    torch.manual_seed(0)
    for p in dense.parameters():
        p.data.normal_(0, 0.05)
    with one_rank_group(tmp_path):
        ring = LlamaForCausalLM(tcfg.tiny_llama(), device="cpu",
                                ring_mesh=make_sp_mesh(1, 1))
        ring.load_state_dict(dense.state_dict())
        got, _, cache = ring(ids, valid)
    want = dense(ids, valid)[0]
    assert cache is None
    assert (got - want)[valid].abs().max() <= 1e-5
