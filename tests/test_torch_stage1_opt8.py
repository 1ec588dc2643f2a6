"""Stage-1 `optim_bits=8` in the port against the JAX trainer on the CPU.

The cut of tests/test_torch_stage1.py (tiny configs in float32, every
dropout rate 0, `disc_start=0`, a `text_emb` per image, the same
`Stage1State` carried by `load_stage1_flax`), both trainers with
`optim_bits=8`, warm-up 1. Bars:

  * the first update's metrics within 1e-4 relative (test_torch_stage1's
    bar); the generator moves at once (Adam8bit reads the schedule after
    the increment, at the peak); the frozen ViT does not;
  * the generator's int8 moment payloads against JAX's: the elements that
    differ counted (at most one step, at most 0.1 %; the BERT key biases,
    whose gradient is rounding noise, held apart as in
    test_torch_stage1), and the generator's parameters within 1e-5 of
    JAX's where their blocks' payloads agree, all but one element in
    10,000 (test_torch_stage1's share: a gradient near Adam's eps turns a
    last-bit difference into a visible step), all within Adam's bound of
    lr an update;
  * `scripts/train_setok.py --optim-bits 8` runs 2 steps on the CPU with
    int8 moments in its generator optimizer.
"""

import json

import numpy as np
import jax
import torch

from setok_tpu.train import opt8 as jopt8
from setok_tpu.train import stage1 as jstage1
from setok_tpu import config as jcfg
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.scripts import train_setok
from setok_tpu_torch.train.opt8 import Adam8bit, _inverse, module_perms
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.utils.from_flax import flax_state_key
from tests.test_torch_stage1 import (check_metrics, gen_named, gen_state,
                                     jbatch, key_bias, make_batch,
                                     no_dropout, paired, tbatch)

LR = 1e-3


def trainers():
    out = []
    for pkg, cls in ((jcfg, jstage1.Stage1Trainer), (tcfg, Stage1Trainer)):
        extra = {} if pkg is jcfg else {"device": "cpu"}
        out.append(cls(*no_dropout(pkg),
                       gan_cfg=pkg.GANLossConfig(disc_start=0),
                       contrastive_cfg=pkg.ContrastiveLossConfig(
                           text_embed_dim=32),
                       train_cfg=pkg.TrainConfig(
                           compute_dtype="float32", learning_rate=LR,
                           warmup_steps=1, total_steps=3),
                       optim_bits=8, **extra))
    return out


def test_one_8bit_update_matches_jax_trainer(capsys):
    jt, tt = trainers()
    batch = make_batch(3)
    state = paired(jt, tt, batch)
    assert isinstance(tt.gen_opt, Adam8bit)
    named = gen_named(tt)
    before = {k: p.detach().clone() for k, p in named.items()}
    state, jm = jt.train_step(state, jbatch(batch), jax.random.PRNGKey(7))
    check_metrics(tt.train_step(tbatch(batch)), jm)
    assert tt.updates == 1
    frozen = {id(p) for p in tt.model.tokenizer.frozen_parameters()}
    moved = [k for k, p in named.items() if id(p) not in frozen
             and not torch.equal(p.detach(), before[k])]
    assert len(moved) > 0.9 * (len(named) - len(frozen))
    assert all(torch.equal(p.detach(), before[k]) for k, p in named.items()
               if id(p) in frozen)

    is_state = lambda x: isinstance(x, jopt8.Adam8bitState)
    adam = next(x for x in jax.tree_util.tree_leaves(
        state.gen_opt_state, is_leaf=is_state) if is_state(x))
    is_q = lambda x: isinstance(x, jopt8._Q)
    vs = dict(jax.tree_util.tree_flatten_with_path(adam.v, is_leaf=is_q)[0])
    perms = module_perms(*tt.parts().values())
    want = gen_state(state.gen_params)
    differ = total = compared = n_kept = beyond = 0
    for path, mq in jax.tree_util.tree_flatten_with_path(
            adam.m, is_leaf=is_q)[0]:
        keys = [k.key for k in path]
        key = f"{keys[0]}.{flax_state_key(keys[1:])}"
        p = named[key]
        if id(p) in frozen:            # in no optimizer here: zero steps
            continue
        if key.endswith("key.bias"):
            # its gradient is rounding noise on both sides (the softmax
            # ignores a shift of a query's scores): held by Adam's bound
            assert float((p.detach() - want[key]).abs().max()) <= 2 * LR
            compared += 1
            continue
        st = tt.gen_opt.state[p]
        ok = torch.ones(st["m_q"].shape[0], dtype=torch.bool)
        for mom, jq in (("m", mq), ("v", vs[path])):
            q = st[f"{mom}_q"].to(torch.int32)
            jqq = torch.from_numpy(np.array(jq.q)).to(torch.int32)
            assert int((q - jqq).abs().max()) <= 1, key
            differ += int((q != jqq).sum())
            total += q.numel()
            ok &= ~(q != jqq).any(dim=1)
        perm = perms[p]
        keep = ok.repeat_interleave(256)[:p.numel()].reshape(
            p.permute(perm).shape).permute(_inverse(perm))
        keep &= ~key_bias(key, keep.shape)     # a fused qkv's k third
        gap = (p.detach() - want[key]).abs()
        assert float(gap.max()) <= 2 * LR, key
        n_kept += int(keep.sum())
        beyond += int((gap[keep] > 1e-5).sum())
        compared += 1
    with capsys.disabled():
        print(f"\nstage-1 Adam8bit vs JAX: {differ} of {total} payload "
              f"elements differ; {beyond} of {n_kept} parameters in agreeing"
              f" blocks beyond 1e-5")
    assert compared == len(named) - len(frozen)
    assert differ <= 1e-3 * total and beyond <= 1e-4 * n_kept


def test_cli_optim_bits_8_trains(capsys):
    argv = ["--cpu", "--tiny", "--synthetic", "8", "--synthetic-structured",
            "--steps", "2", "--batch-size", "2", "--image-size", "32",
            "--disc-start", "0", "--optim-bits", "8"]
    train_setok.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert lines[-1]["updates"] == 2
    assert all(np.isfinite(x["total_loss"]) for x in lines)
    tr, _ = train_setok.build(train_setok.parse_args(argv))
    assert isinstance(tr.gen_opt, Adam8bit)
