"""`Stage2Trainer` of the port against the JAX trainer on the CPU.

`tiny_setokim()` in float32 with `proj_drop = 0`, the same flax weights,
LoRA tree and numpy batches, and the JAX draws replayed (the helpers of
tests/test_torch_stage2.py). Bars:

  * two updates (LoRA r 4, the clip active at max_grad_norm 0.05, two
    micro-batches each, projectors at their own constant rates): each
    micro-batch's loss within 1e-5 max-rel, and every parameter and LoRA
    factor within 1e-5 after the second update; the first update runs at
    lr 0, so the LoRA factors stay where they were, and all move in the
    second;
  * the labels of every parameter and adapter, for each freezing flag,
    equal the JAX trainer's, and exactly the 'frozen' ones have
    requires_grad off;
  * QLoRA, 8-bit moments, the vision tower's training and ring attention
    raise `NotImplementedError` naming their ROADMAP.md entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.train.lora import init_lora as j_init_lora
from setok_tpu.train.stage2 import Stage2Trainer as JTrainer
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.train.stage2 import Stage2Trainer, warmup_cosine
from setok_tpu_torch.utils.from_flax import (flax_state_key, from_flax,
                                             load_flax_params, lora_from_flax)
from tests.test_torch_stage2 import (  # noqa: F401 (flax_params: fixture)
    TGT, flax_params, jax_cfg, jax_draws, make_batch, max_rel, port_cfg,
    torch_batch)


TRAIN_CFG = dict(learning_rate=1e-3, max_grad_norm=0.05, warmup_steps=1,
                 total_steps=3, grad_accum_steps=2, remat=False,
                 compute_dtype="float32")
TRAINER_KW = dict(target_token_id=TGT, lora_enable=True, lora_r=4,
                  lora_alpha=8.0, mm_in_projector_lr=2e-3,
                  mm_out_projector_lr=5e-4)


def test_two_updates_match_jax_trainer(flax_params):
    batches = [make_batch(10 + i) for i in range(4)]
    jt = JTrainer(jax_cfg(), train_cfg=jcfg.TrainConfig(**TRAIN_CFG),
                  **TRAINER_KW)
    state = jt.create_state(jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batches[0].items()})
    params0 = jax.tree.map(np.asarray, state.params)
    lora0 = jax.tree.map(np.asarray, state.lora)
    keys = jax.random.split(jax.random.PRNGKey(21), 4)

    tt = Stage2Trainer(port_cfg(), train_cfg=tcfg.TrainConfig(**TRAIN_CFG),
                       device="cpu", **TRAINER_KW)
    load_flax_params(tt.model, params0)
    tt.init_state(lora=lora_from_flax(lora0, tt.model))
    lora_b0 = {n: b.detach().clone() for n, (_, b) in tt.lora.items()}
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, keys[i])
        tm = tt.train_step(torch_batch(batch),
                           jax_draws(keys[i], jax_cfg(), 2))
        assert max_rel(tm["total_loss"], jm["total_loss"]) <= 1e-5
        if i == 1:      # update 1 ran at lr 0: the adapters did not move
            assert tt.updates == 1
            for n, (_, b) in tt.lora.items():
                assert torch.equal(b.detach(), lora_b0[n])
    assert tt.updates == 2 and tt.lr("lora") == warmup_cosine(2, 1e-3, 1, 3)

    want = from_flax(jax.tree.map(np.asarray, state.params))
    named = dict(tt.model.named_parameters())
    for key, leaf in want.items():
        assert (named[key].detach() - leaf).abs().max() <= 1e-5, key
    moved = 0
    for path, ab in state.lora.items():
        name = ".".join(k.strip("[]'") for k in path.split("][")[1:-1])
        for got, key in zip(tt.lora[name], ("a", "b")):
            assert np.abs(got.detach().numpy()
                          - np.asarray(ab[key])).max() <= 1e-5
        moved += not torch.equal(tt.lora[name][1].detach(), lora_b0[name])
    assert moved == len(tt.lora)
    merged = tt.merged_params()
    q = "llama.model.layer_0.attn.q_proj.weight"
    assert not torch.equal(merged[q], named[q])


FLAGS = [{}, {"freeze_backbone": True}, {"tune_mm_in_mlp_adapter": True},
         {"tune_mm_out_mlp_adapter": True},
         {"freeze_mm_in_mlp_adapter": True},
         {"freeze_mm_out_mlp_adapter": True},
         {"lora_enable": True, "lora_r": 4}]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "full")
def test_labels_match_jax_trainer(flax_params, flags):
    jt = JTrainer(jax_cfg(), target_token_id=TGT, **flags)
    tree = {"params": flax_params}
    if flags.get("lora_enable"):
        tree["lora"] = j_init_lora(flax_params, jax.random.PRNGKey(0), 4)
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(
            jt._labels(tree))[0]:
        keys = tuple(p.key for p in path)
        if keys[0] == "lora":
            name = ".".join(k.strip("[]'") for k in keys[1].split("][")[1:-1])
            want[f"lora.{name}.{keys[2]}"] = label
        else:
            want[flax_state_key(keys[1:])] = label
    tt = Stage2Trainer(port_cfg(), device="cpu", target_token_id=TGT, **flags)
    tt.init_state(seed=0)
    assert tt.labels() == want
    frozen = {n for n, p in tt.model.named_parameters() if not p.requires_grad}
    assert frozen == {n for n, lab in want.items() if lab == "frozen"}


@pytest.mark.parametrize("option", [{"quant_base": True, "lora_enable": True},
                                    {"optim_bits": 8},
                                    {"unfreeze_mm_vision_tower": True},
                                    {"ring_mesh": object()}])
def test_options_not_ported_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Stage2Trainer(port_cfg(), device="cpu", **option)
