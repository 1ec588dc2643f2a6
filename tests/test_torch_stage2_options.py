"""The stage-2 trainer's memory options in the port against the JAX package.

`tiny_setokim()` with `proj_drop = 0`, seeded port weights carried to the
JAX side as a flax tree (`to_flax_tree`, no flax init compiles), the
micro-batches, draws and optimizer settings of
tests/test_torch_stage2_trainer.py (two updates of two micro-batches,
warm-up 1, the clip active). Bars:

  * bf16 parameters with 8-bit moments, a full fine-tune in float32
    compute (one JAX trainer): each micro-batch's losses within 1e-5
    max-rel. The two sides' bf16 arithmetic differs: XLA's CPU build
    fuses bf16 expressions (the gradients' accumulation, the clip) into
    float32 ones rounded once, where the port rounds each operation to
    bf16 as the optax source reads; so ~0.1 % of the gradients differ by a
    bf16 ulp, and the moments' block quantisation turns such differences
    into payloads a step or two off (9.3 % of them after two updates,
    bar 25 % and 3 steps). The bf16 parameters are JAX's, or one ulp off
    where the float32 step lands across a rounding boundary (0.7 %, bar
    2 %), but for 0.17 % (bar 0.5 %) whose moments nearly cancel, where
    Adam's normalisation magnifies the gradients' ulp into a larger step
    difference, all within Adam's bound of lr an update. The
    embedding table (32-bit AdamW, the schedule before the increment)
    bit for bit unchanged by update 1 (lr 0), the 8-bit groups moved by
    it (the schedule after the increment; those of their elements whose
    step is under half a bf16 ulp do not move); the optimizers hold bf16
    AdamW moments for the table and int8 ones for the rest;
  * the labels of every parameter and adapter under QLoRA, 8-bit moments
    and the trainable tower equal the JAX trainer's;
  * `scripts/train_setokim.py --bits 8 --lora-enable --optim-bits 8
    --unfreeze-mm-vision-tower`: 2 steps saved every step; with step 2
    removed, the same command resumes at step 1 and prints the first
    run's metrics for it (the int8 base and its scales, the int8 moments
    and theirs restored); a `param_dtype` bf16 trainer's checkpoint
    restores bit for bit.
"""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.train.lora import init_lora as j_init_lora
from setok_tpu.train.stage2 import Stage2State
from setok_tpu.train.stage2 import Stage2Trainer as JTrainer
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.scripts import train_setokim
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import (flax_state_key, from_flax,
                                             load_flax_params, to_flax_tree)
from setok_tpu_torch.utils.init import init_setokim_random_
from tests.test_torch_stage2 import (TGT, jax_cfg, jax_draws, make_batch,
                                     max_rel, port_cfg, torch_batch)
from tests.test_torch_opt8 import bf16_ulp
from tests.test_torch_qlora import payload_agreement
from tests.test_torch_stage2_trainer import TRAIN_CFG

TREE = to_flax_tree(init_setokim_random_(
    Setokim(port_cfg(), target_token_id=TGT, device="cpu"), 6))
BF16 = dict(TRAIN_CFG, param_dtype="bfloat16")
FULL8 = dict(target_token_id=TGT, optim_bits=8, mm_in_projector_lr=2e-3,
             mm_out_projector_lr=5e-4)


def test_bf16_params_8bit_full_finetune_matches_jax_trainer(capsys):
    batches = [make_batch(10 + i) for i in range(4)]
    jt = JTrainer(jax_cfg(), train_cfg=jcfg.TrainConfig(**BF16), **FULL8)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), TREE)
    tp = {"params": params}
    state = Stage2State(step=jnp.zeros((), jnp.int32), params=params,
                        lora=None, opt_state=jt._tx.init(tp))
    keys = jax.random.split(jax.random.PRNGKey(21), 4)

    tt = Stage2Trainer(port_cfg(), train_cfg=tcfg.TrainConfig(**BF16),
                       device="cpu", **FULL8)
    load_flax_params(tt.model, jax.tree.map(np.asarray, params))
    tt.init_state()
    assert set(tt.optimizers) == {"adamw_optax", "adam8bit"}
    named = dict(tt.model.named_parameters())
    assert all(p.dtype == torch.bfloat16 for p in named.values())
    embed = "llama.embed_tokens.weight"
    before = {n: p.detach().clone() for n, p in named.items()}
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, keys[i])
        tm = tt.train_step(torch_batch(batch),
                           jax_draws(keys[i], jax_cfg(), 2))
        for k in ("lm_loss", "diff_loss", "total_loss"):
            assert max_rel(tm[k], jm[k]) <= 1e-5, (i, k)
        if i == 1:      # update 1: AdamW at lr 0, Adam8bit at the peak
            assert torch.equal(named[embed].detach(), before[embed])
            # a bf16 sum swallows a step under half an ulp of the weight
            moved = sum(int((p.detach() != before[n]).sum())
                        for n, p in named.items()
                        if p.requires_grad and n != embed)
            assert moved > 0
    assert tt.updates == 2
    assert not torch.equal(named[embed].detach(), before[embed])
    st = tt.optimizers["adamw_optax"].state[named[embed]]
    assert st["mu"].dtype == torch.bfloat16
    _, q_differ, q_total, q_worst = payload_agreement(tt, state.opt_state)
    want = from_flax(jax.tree.map(np.asarray, state.params))
    total = differ = beyond = 0
    for key, w in want.items():
        got = named[key].detach()
        assert got.dtype == w.dtype == torch.bfloat16
        gap = (got.float() - w.float()).abs()
        ulp = torch.maximum(bf16_ulp(w), bf16_ulp(got))
        # Adam's bound: a step is at most the learning rate, 1e-3 here
        assert float(gap.max()) <= 2 * 1e-3 + float(ulp.max()), key
        total += got.numel()
        differ += int((gap > 0).sum())
        beyond += int((gap > ulp).sum())
    with capsys.disabled():
        print(f"\nbf16 + Adam8bit full fine-tune vs JAX: {q_differ} of "
              f"{q_total} payload elements differ (by {q_worst} steps at "
              f"most); {differ} of {total} bf16 parameters differ, {beyond}"
              f" by more than one ulp")
    assert q_worst <= 3 and q_differ <= 0.25 * q_total
    assert differ <= 0.02 * total and beyond <= 0.005 * total


OPTION_SETS = [
    {"lora_enable": True, "lora_r": 4, "quant_base": True},
    {"optim_bits": 8},
    {"lora_enable": True, "lora_r": 4, "optim_bits": 8},
    {"unfreeze_mm_vision_tower": True, "freeze_backbone": True},
]


@pytest.mark.parametrize("flags", OPTION_SETS,
                         ids=lambda f: "-".join(k for k in f if k != "lora_r"))
def test_option_labels_match_jax_trainer(flags):
    params = jax.tree.map(jnp.asarray, TREE)
    jt = JTrainer(jax_cfg(), target_token_id=TGT, **flags)
    tree = {"params": params}
    if flags.get("lora_enable"):
        tree["lora"] = j_init_lora(params, jax.random.PRNGKey(0), 4)
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(
            jt._labels(tree))[0]:
        keys = tuple(p.key for p in path)
        if keys[0] == "lora":
            name = ".".join(k.strip("[]'") for k in keys[1].split("][")[1:-1])
            want[f"lora.{name}.{keys[2]}"] = label
        else:
            want[flax_state_key(keys[1:])] = label
    tt = Stage2Trainer(port_cfg(), device="cpu", target_token_id=TGT,
                       **flags)
    tt.init_state(seed=0)
    assert tt.labels() == want
    trains = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert trains == {n for n, lab in want.items()
                      if lab != "frozen" and not n.startswith("lora.")}


def test_cli_qlora_8bit_tower_resumes(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = ["--cpu", "--tiny", "--synthetic", "--steps", "2",
            "--batch-size", "2", "--model-max-length", "48",
            "--bits", "8", "--lora-enable", "--lora-r", "4",
            "--optim-bits", "8", "--unfreeze-mm-vision-tower",
            "--grad-accum-steps", "1", "--warmup-steps", "1",
            "--checkpoint-every", "1", "--output-dir", out]

    def lines():
        return [{k: v for k, v in json.loads(x).items() if k != "seconds"}
                for x in capsys.readouterr().out.splitlines()]

    train_setokim.main(argv)
    first = lines()
    assert [x["step"] for x in first] == [0, 1]
    assert all(np.isfinite(x["total_loss"]) for x in first)
    cdir = os.path.join(out, "checkpoints")
    saved = ckpt.restore_checkpoint(cdir, 2)
    q = "llama.model.layer_0.attn.q_proj"
    assert saved["params"][f"{q}.weight"].dtype == torch.int8
    assert saved["params"][f"{q}.qscale"].dtype == torch.float32
    opt = saved["train"]["optimizers"]["adam8bit"]["state"]
    assert all(s["m_q"].dtype == torch.int8 and s["m_s"].dtype ==
               torch.float32 for s in opt.values())
    shutil.rmtree(os.path.join(cdir, "2"))
    train_setokim.main(argv)
    assert lines() == first[1:]


def test_bf16_trainer_checkpoint_restores_bit_for_bit(tmp_path):
    def trainer():
        tr = Stage2Trainer(port_cfg(), train_cfg=tcfg.TrainConfig(**BF16),
                           device="cpu", **FULL8)
        init_setokim_random_(tr.model, 0)
        tr.init_state()
        return tr

    batches = [torch_batch(make_batch(40 + i)) for i in range(3)]
    straight = trainer()
    gen = torch.Generator().manual_seed(2)
    want = [straight.train_step(b, gen) for b in batches]
    first = trainer()
    gen = torch.Generator().manual_seed(2)
    for b in batches[:2]:
        first.train_step(b, gen)
    ckpt.save_checkpoint(str(tmp_path), 2, first.state_dict({"draws": gen}))
    resumed = trainer()
    gen = torch.Generator().manual_seed(9)
    resumed.load_state_dict(ckpt.restore_checkpoint(str(tmp_path)),
                            {"draws": gen})
    got = resumed.train_step(batches[2], gen)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want[2].items()}
    for (n, p), (_, q) in zip(straight.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), n
