"""bf16 parameter storage (`param_dtype`) of the port's SeTok against the
JAX package's, on the CPU.

One tiny SeTok flax tree in bf16 (a port model's seeded weights in the flax
layout, cast to bf16: exact, as they were drawn into bf16 parameters)
goes through the JAX SeTok (`param_dtype=bfloat16`) and, carried across
by `from_flax` (a bf16 leaf stays bf16), through the port's SeTok built
with `param_dtype=torch.bfloat16`, whose state dict is then bf16
throughout. Bars, on the same numpy images:

  * f32 compute: identical clusters, recon and tokens within 1e-4 max-abs
    (tests/test_torch_models.py's bar; widening bf16 to f32 is exact);
  * bf16 compute, against JAX's bf16 compute over the same bf16 weights:
    identical clusters, recon and tokens within 5e-2 max-rel (the two
    frameworks round their bf16 products in different orders; measured
    2.5e-2 on the recon, 8.6e-3 on the tokens);
  * quant8: identical clusters, within 5e-2 max-rel (the int8 forward's
    bar of chip_smoke.py, FWD_INT8_TOL; measured 2.3e-2 and 1.1e-2);
  * a bf16 leaf into a float32 model raises, as the type check always
    did; `param_f32` caches one float32 copy per weight version.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.ops.blocks import LayerNorm, param_f32
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_random_

X = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
    np.float32)
# the file's tiny flax tree, bf16 leaves (ml_dtypes' bfloat16 under numpy)
TREE_BF16 = jax.tree.map(
    lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
    to_flax_tree(init_random_(SeTok(
        tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(), device="cpu",
        param_dtype=torch.bfloat16), 3)))
CASES = {
    # JAX kwargs, port kwargs, bar, bar kind
    "f32": ({}, {}, 1e-4, "abs"),
    "bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}, 5e-2,
             "rel"),
    "quant8": ({"quant8": True}, {"quant8": True}, 5e-2, "rel"),
}


def gap(got: torch.Tensor, want, kind: str) -> float:
    a = got.float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    d = float(np.abs(a - b).max())
    return d if kind == "abs" else d / float(np.abs(b).max())


def port_model(**kw) -> SeTok:
    return load_flax_params(SeTok(tcfg.tiny_tokenizer(),
                                  tcfg.tiny_detokenizer(), device="cpu",
                                  param_dtype=torch.bfloat16, **kw),
                            TREE_BF16)


def test_state_dict_is_bf16_throughout():
    assert all(a.dtype.name == "bfloat16" for a in jax.tree.leaves(TREE_BF16))
    model = port_model()
    state = model.state_dict()
    assert state and all(t.dtype == torch.bfloat16 for t in state.values())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_params_forward_matches_jax(case):
    jkw, tkw, bar, kind = CASES[case]
    jm = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer(),
                param_dtype=jnp.bfloat16, **jkw)
    params = jax.tree.map(jnp.asarray, TREE_BF16)
    want = jax.jit(lambda p, x: jm.apply(p, x))(params, jnp.asarray(X))
    model = port_model(**tkw)
    got = model(torch.from_numpy(X))
    np.testing.assert_array_equal(got.idx_cluster.numpy(),
                                  np.asarray(want.idx_cluster))
    np.testing.assert_array_equal(got.num_clusters.numpy(),
                                  np.asarray(want.num_clusters))
    assert gap(got.recon, want.recon, kind) <= bar
    assert gap(got.tokens, want.tokens, kind) <= bar
    # the parameters stayed bf16: no float32 copy in the state dict
    assert all(t.dtype == torch.bfloat16
               for t in model.state_dict().values())


def test_bf16_leaf_into_float32_model_raises():
    with pytest.raises(ValueError, match="flax type torch.bfloat16"):
        load_flax_params(SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                               device="cpu"), TREE_BF16)


def test_param_f32_caches_per_version():
    ln = LayerNorm(8, eps=1e-5, param_dtype=torch.bfloat16, device="cpu")
    ln.requires_grad_(False)
    a = param_f32(ln, "weight")
    assert a.dtype == torch.float32 and param_f32(ln, "weight") is a
    with torch.no_grad():
        ln.weight.mul_(2)                      # a new version
    b = param_f32(ln, "weight")
    assert b is not a and torch.equal(b, 2 * a)
    f32 = LayerNorm(8, eps=1e-5, device="cpu")
    assert param_f32(f32, "weight") is f32.weight
