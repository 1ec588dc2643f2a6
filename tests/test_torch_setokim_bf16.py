"""Setokim with bf16 parameters in the port against the JAX package.

`tiny_setokim()` (proj_drop 0) built with `param_dtype=bfloat16` on both
sides, the same bf16 flax weights (seeded port weights rounded to bf16,
carried as a flax tree), float32 compute. Bars, max-rel = max|got -
want| / max|want|:

  * every parameter of the port model is bf16 (the embedding, the trunk,
    the RMSNorm and LayerNorm scales, the LM head, the projectors, the
    tower, the generator and the diffusion head);
  * the training forward's lm_loss and diff_loss within 1e-5 and the
    logits within 1e-5, as for float32 parameters (tests/test_torch_stage2
    .py): both widen each bf16 weight to float32 exactly before use;
  * `prefill` with an image (float32 cache): logits and hidden within
    1e-4, the bar of tests/test_torch_setokim.py's float trunk;
  * the trunk's adapters follow the weight's type: LoRA factors drawn on
    the bf16 model are bf16, and the adapted weight is the bf16 sum.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.train.lora import apply_lora
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_lora_random, init_setokim_random_
from tests.test_torch_setokim import MAX_LEN, prompts
from tests.test_torch_stage2 import (TGT, jax_cfg, jax_draws, make_batch,
                                     max_rel, port_cfg, torch_batch)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TREE = to_flax_tree(init_setokim_random_(
    Setokim(port_cfg(), target_token_id=TGT, device="cpu"), 8))
BF16_TREE = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                         TREE)


def models():
    jm = JSetokim(jax_cfg(), target_token_id=TGT, dtype=jnp.float32,
                  param_dtype=jnp.bfloat16)
    tm = load_flax_params(Setokim(port_cfg(), target_token_id=TGT,
                                  param_dtype=torch.bfloat16, device="cpu"),
                          BF16_TREE)
    return jm, tm


def test_training_forward_matches_jax():
    jm, tm = models()
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    batch = make_batch(5)
    rng = jax.random.PRNGKey(13)
    drop_rng, diff_rng = jax.random.split(rng)
    params = jax.tree.map(jnp.asarray, BF16_TREE)
    want = jax.jit(lambda p, *a: jm.apply(
        p, *a, diff_rng, deterministic=False, rngs={"dropout": drop_rng}))(
        params, *(jnp.asarray(batch[k]) for k in (
            "input_ids", "comp_image", "labels", "gen_image")))
    tb = torch_batch(batch)
    with torch.no_grad():
        got = tm(tb["input_ids"], tb["comp_image"], tb["labels"],
                 tb["gen_image"], jax_draws(rng, jax_cfg(), 2))
    assert max_rel(got.lm_loss, want.lm_loss) <= 1e-5
    assert max_rel(got.diff_loss, want.diff_loss) <= 1e-5
    assert max_rel(got.logits, want.logits) <= 1e-5


def test_prefill_matches_jax():
    jm, tm = models()
    ids, images = prompts(6)
    params = jax.tree.map(jnp.asarray, BF16_TREE)
    logits, hidden, _, valid, _ = jax.jit(lambda p, i, im: jm.apply(
        p, i, im, MAX_LEN, cache_dtype=jnp.float32, method=jm.prefill))(
        params, jnp.asarray(ids), jnp.asarray(images))
    got = tm.prefill(torch.from_numpy(ids), torch.from_numpy(images),
                     MAX_LEN, cache_dtype=torch.float32)
    assert max_rel(got[0], np.asarray(logits)) <= 1e-4
    assert max_rel(got[1], np.asarray(hidden)) <= 1e-4
    assert np.array_equal(got[3].numpy(), np.asarray(valid))


def test_adapters_follow_the_weight_type():
    _, tm = models()
    lora = init_lora_random(tm, 0, 4)
    assert all(a.dtype == b.dtype == torch.bfloat16
               for a, b in lora.values())
    with torch.no_grad():
        lora["llama.model.layer_0.attn.q_proj"][1].normal_()
    apply_lora(tm, lora, 8.0, 4)
    dense = tm.llama.model.layer_0.attn.q_proj
    a, b = lora["llama.model.layer_0.attn.q_proj"]
    with torch.no_grad():
        w = dense.effective_weight()
        want = dense.weight + 2.0 * (a @ b).t().to(torch.bfloat16)
    assert w.dtype == torch.bfloat16 and torch.equal(w, want)
