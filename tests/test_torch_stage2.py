"""Stage-2 Setokim training in the port against the JAX package on the CPU.

`tiny_setokim()` in float32 with `proj_drop = 0` (dropout's bits cannot
match across frameworks; its statistics are tested alone), the same flax
weights and numpy batches, and the JAX draws replayed through the same
`jax.random.split` sequence as `Stage2Trainer._train_step_full` and
`Setokim._diffusion_branch` take them. Bars:

  * the training forward's lm_loss and diff_loss: 1e-5 max-rel;
  * `use_flash` and `remat` on and off: the same losses (1e-6); the same
    gradients under `remat` (1e-6: the same operations again), and within
    2e-4 through the flash route, the gradient bar of
    tests/test_flash_attention.py (its p comes back from the saved
    float32 log-sum-exp; measured 1.3e-4);
  * the gradients of the LoRA factors, the projectors and the diffusion
    head against `jax.grad`: 1e-4 max-rel per leaf;
  * dropout keeps 1 - rate of the entries, within 3σ.

The trainer itself is held to the JAX trainer in
tests/test_torch_stage2_trainer.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.train.lora import apply_lora as j_apply_lora
from setok_tpu.train.lora import init_lora as j_init_lora
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setokim import (DiffusionDraws, ForwardDraws,
                                            Setokim)
from setok_tpu_torch.ops.blocks import dropout
from setok_tpu_torch.train.lora import apply_lora
from setok_tpu_torch.utils.from_flax import (flax_state_key, lora_from_flax,
                                             load_flax_params)

L = 40
TGT = 3
# gradients through the flash route against the materialised attention:
# the bar of tests/test_flash_attention.py (p recomputed from the saved
# float32 log-sum-exp)
GRAD_FLASH_TOL = 2e-4


def jax_cfg():
    c = jcfg.tiny_setokim()
    return dataclasses.replace(c, tokenizer=dataclasses.replace(
        c.tokenizer, proj_drop=0.0))


def port_cfg():
    c = tcfg.tiny_setokim()
    return tcfg.replace(c, tokenizer=tcfg.replace(c.tokenizer, proj_drop=0.0))


def make_batch(seed, b=2):
    """The JAX tests' layout (BOS, 8 image slots, text, 8 <target> slots),
    row 1 with a pad tail."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((b, L), np.int64)
    labels = np.full((b, L), IGNORE_INDEX, np.int64)
    ids[:, 0] = 1
    ids[:, 1:9] = IMAGE_TOKEN_INDEX
    text = rs.randint(10, 400, size=(b, 6))
    ids[:, 9:15] = text
    labels[:, 10:15] = text[:, 1:]
    ids[:, 15:23] = TGT
    labels[:, 15:23] = TGT
    answer = rs.randint(10, 400, size=(b, 8))
    ids[:, 23:31] = labels[:, 23:31] = answer
    ids[1, 28:] = labels[1, 28:] = 0
    labels[1, 28:] = IGNORE_INDEX
    img = (rs.rand(b, 32, 32, 3) * 2 - 1).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "comp_image": img,
            "gen_image": img}


def torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def jax_draws(rng, cfg, b) -> ForwardDraws:
    """The draws of one JAX training step, from its key, in its order."""
    _, diff_rng = jax.random.split(rng)
    r_order, r_rate, r_diff = jax.random.split(diff_rng, 3)
    tn = cfg.target_num
    orders = jax.random.permutation(
        r_order, jnp.broadcast_to(jnp.arange(tn), (b, tn)), axis=1,
        independent=True)
    mr = cfg.diffloss.mask_ratio_min
    rate = jax.random.truncated_normal(r_rate, (mr - 1.0) / 0.25, 0.0,
                                       ()) * 0.25 + 1.0
    t_rng, noise_rng = jax.random.split(r_diff)
    n = cfg.diffloss.diffusion_batch_mul * b * tn
    t = jax.random.randint(t_rng, (n,), 0, 1000)
    noise = jax.random.normal(noise_rng, (n, cfg.diffloss.target_channels),
                              jnp.float32)
    return ForwardDraws(None, DiffusionDraws(
        *(torch.tensor(np.asarray(a)) for a in (orders, rate, t, noise))))


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def flax_params():
    model = JSetokim(jax_cfg(), target_token_id=TGT)
    b = make_batch(0)
    params = jax.jit(lambda r: model.init(
        r, b["input_ids"], b["comp_image"], b["labels"], b["gen_image"],
        jax.random.PRNGKey(1), method=model.init_all))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_lora(flax_params):
    """A LoRA tree with nonzero B (at init B = 0 would hide A's gradient)."""
    lora = j_init_lora(flax_params, jax.random.PRNGKey(2), 4)
    rs = np.random.RandomState(3)
    return {k: {"a": np.asarray(v["a"]),
                "b": (0.1 * rs.randn(*v["b"].shape)).astype(np.float32)}
            for k, v in lora.items()}


def port_model(params, **kw):
    return load_flax_params(Setokim(port_cfg(), target_token_id=TGT,
                                    device="cpu", **kw), params)


@pytest.mark.parametrize("use_flash", [False, True])
def test_training_forward_matches_jax(flax_params, use_flash):
    batch = make_batch(1)
    rng = jax.random.PRNGKey(7)
    drop_rng, diff_rng = jax.random.split(rng)
    jm = JSetokim(jax_cfg(), target_token_id=TGT, use_flash=use_flash)
    want = jax.jit(lambda p, *a: jm.apply(
        p, *a, diff_rng, deterministic=False, rngs={"dropout": drop_rng}))(
        flax_params, *(jnp.asarray(batch[k]) for k in (
            "input_ids", "comp_image", "labels", "gen_image")))
    tb = torch_batch(batch)
    got = port_model(flax_params, use_flash=use_flash)(
        tb["input_ids"], tb["comp_image"], tb["labels"], tb["gen_image"],
        jax_draws(rng, jax_cfg(), 2))
    assert float(want.diff_loss) > 0
    assert max_rel(got.lm_loss.detach(), want.lm_loss) <= 1e-5
    assert max_rel(got.diff_loss.detach(), want.diff_loss) <= 1e-5
    assert max_rel(got.logits.detach(), want.logits) <= 1e-5


def _loss_and_grads(model, batch, draws, lora):
    apply_lora(model, lora, 8.0, 4)
    out = model(batch["input_ids"], batch["comp_image"], batch["labels"],
                batch["gen_image"], draws)
    params = [p for a_b in lora.values() for p in a_b]
    params += [model.mm_in_projector.fc_0.weight,
               model.diffloss.net.input_proj.weight]
    return out, torch.autograd.grad(out.loss, params)


@pytest.mark.parametrize("use_flash,remat", [(True, False), (False, True),
                                             (True, True)])
def test_flash_and_remat_change_nothing(flax_params, flax_lora, use_flash,
                                        remat):
    batch = torch_batch(make_batch(2))
    draws = jax_draws(jax.random.PRNGKey(9), jax_cfg(), 2)
    base = port_model(flax_params)
    want, want_g = _loss_and_grads(base, batch, draws,
                                   lora_from_flax(flax_lora, base))
    model = port_model(flax_params, use_flash=use_flash, remat=remat)
    got, got_g = _loss_and_grads(model, batch, draws,
                                 lora_from_flax(flax_lora, model))
    assert max_rel(got.loss.detach(), want.loss.detach()) <= 1e-6
    for g, w in zip(got_g, want_g):
        assert max_rel(g, w) <= (GRAD_FLASH_TOL if use_flash else 1e-6)


def test_gradients_match_jax_grad(flax_params, flax_lora):
    batch = make_batch(3)
    rng = jax.random.PRNGKey(11)
    drop_rng, diff_rng = jax.random.split(rng)
    jm = JSetokim(jax_cfg(), target_token_id=TGT)
    args = tuple(jnp.asarray(batch[k]) for k in (
        "input_ids", "comp_image", "labels", "gen_image"))

    def loss_fn(tp):
        p = j_apply_lora(tp["params"], tp["lora"], 8.0, 4)
        return jm.apply(p, *args, diff_rng, deterministic=False,
                        rngs={"dropout": drop_rng}).loss

    want = jax.jit(jax.grad(loss_fn))({"params": flax_params,
                                       "lora": flax_lora})
    model = port_model(flax_params)
    lora = lora_from_flax(flax_lora, model)
    apply_lora(model, lora, 8.0, 4)
    tb = torch_batch(batch)
    out = model(tb["input_ids"], tb["comp_image"], tb["labels"],
                tb["gen_image"], jax_draws(rng, jax_cfg(), 2))
    out.loss.backward()
    for path, ab in want["lora"].items():
        name = ".".join(k.strip("[]'") for k in path.split("][")[1:-1])
        for got, key in zip(lora[name], ("a", "b")):
            assert max_rel(got.grad, ab[key]) <= 1e-4, (name, key)
    named = dict(model.named_parameters())
    checked = nonzero = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            want["params"])[0]:
        keys = tuple(p.key for p in path)
        if keys[1] not in ("mm_in_projector", "mm_out_projector",
                           "diffloss"):
            continue
        key = flax_state_key(keys)
        grad = named[key].grad
        want_leaf = np.asarray(leaf)
        if key.endswith(".weight") and want_leaf.ndim == 2:
            want_leaf = want_leaf.T
        checked += 1
        if np.abs(want_leaf).max() == 0:      # behind a zero-init layer
            assert grad is None or float(grad.abs().max()) == 0, key
            continue
        assert max_rel(grad, want_leaf) <= 1e-4, key
        nonzero += 1
    assert checked >= 20 and nonzero >= 4


def test_dropout_keeps_its_share():
    rate, n = 0.2, 200_000
    gen = torch.Generator().manual_seed(0)
    out = dropout(torch.ones(n), rate, gen)
    kept = float((out != 0).double().mean())
    assert abs(kept - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)
    assert torch.all((out == 0) | (out == 1 / (1 - rate)))
    assert torch.equal(dropout(torch.ones(5), rate, None), torch.ones(5))


def test_tower_dropout_runs_only_with_a_generator(flax_params):
    """At proj_drop 0.2 the tower's tokens move with a generator and are
    the deterministic ones without."""
    cfg = tcfg.tiny_setokim()
    model = load_flax_params(Setokim(cfg, device="cpu"), flax_params)
    img = torch.from_numpy(make_batch(4)["comp_image"])
    det = model.tokenize(img).tokens
    assert torch.equal(det, model.tokenize(img).tokens)
    noisy = model.tokenize(img, torch.Generator().manual_seed(1)).tokens
    assert not torch.equal(det, noisy)


def test_train_script_runs_three_steps(capsys):
    from setok_tpu_torch.scripts import train_setokim

    train_setokim.main(["--cpu", "--tiny", "--synthetic", "--steps", "3",
                        "--batch-size", "2", "--model-max-length", "48",
                        "--lora-enable", "--lora-r", "4", "--use-flash",
                        "--grad-accum-steps", "1", "--warmup-steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    import json
    last = json.loads(lines[-1])
    assert last["updates"] == 3 and np.isfinite(last["total_loss"])
    with pytest.raises(SystemExit):
        train_setokim.main(["--cpu", "--tiny", "--synthetic",
                            "--data-path", "x.json"])
