"""`Stage1Trainer`'s two updates against the JAX trainer's, with and
without LPIPS: the case of tests/test_torch_stage1.py that compiles the
JAX step twice, in a file of its own so that `--dist loadfile` runs it
beside the rest (the bars and helpers are that file's)."""

import jax
import pytest
import torch

from tests.test_torch_stage1 import (adam_mu, check_metrics, check_moments,
                                     check_params, gen_named, gen_state,
                                     jbatch, make_batch, paired, tbatch,
                                     trainers, tree_state)


@pytest.mark.parametrize("use_lpips", [False, True], ids=["l1", "lpips"])
def test_two_updates_match_jax_trainer(use_lpips):
    # with LPIPS, the generator's factor ramps: 0 at step 0, 1/2 at step 1
    jt, tt = trainers(use_lpips=use_lpips, warm_up_end=2 if use_lpips else 0)
    batches = [make_batch(s) for s in (3, 4)]
    state = paired(jt, tt, batches[0])
    gen0 = {k: p.detach().clone() for k, p in gen_named(tt).items()}
    disc0 = {n: p.detach().clone() for n, p in tt.disc.named_parameters()}
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(state, jbatch(batch), keys[i])
        tm = tt.train_step(tbatch(batch))
        check_metrics(tm, jm)
        assert float(tm["disc_factor"]) == (0.5 * i if use_lpips else 1.0)
        assert float(tm["d_weight"]) > 0 and float(tm["g_loss"]) != 0
        if i == 0:     # the generator's first update runs at lr 0
            assert all(torch.equal(p.detach(), gen0[k])
                       for k, p in gen_named(tt).items())
            # (the logit bias's hinge gradient is 0 inside the margins)
            assert all(not torch.equal(p.detach(), disc0[n])
                       for n, p in tt.disc.named_parameters()
                       if n.endswith("weight"))
    assert tt.updates == 2 and tt.step == 2
    named = gen_named(tt)
    frozen = {id(p) for p in tt.model.tokenizer.frozen_parameters()}
    moved = [k for k, p in named.items() if id(p) not in frozen
             and not torch.equal(p.detach(), gen0[k])]
    assert len(moved) > 0.9 * (len(named) - len(frozen))
    check_params(named, gen_state(state.gen_params), 1e-3, updates=1)
    check_moments(named, tt.gen_opt,
                  gen_state(adam_mu(state.gen_opt_state)))
    disc = dict(tt.disc.named_parameters())
    check_params(disc, tree_state(state.disc_params), 1e-3)
    check_moments(disc, tt.disc_opt,
                  tree_state(adam_mu(state.disc_opt_state)))
