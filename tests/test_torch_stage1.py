"""`Stage1Trainer` of the port against the JAX trainer on the CPU.

Tiny configs in float32 with every dropout rate at 0, `disc_start=0` (the
GAN and adaptive-weight terms live), a `text_emb` per image (contrastive
on), the same `Stage1State` (carried by `load_stage1_flax`) and the same
numpy batches. Bars:

  * each step's metrics within 1e-4 relative (the adaptive weight, the
    GAN factor, the contrastive loss and the pre-clip `grad_norm`
    included; two frameworks' float32 sums in other orders, through a
    clustering that must come out identical);
  * after the first update (lr 0) every generator parameter is unchanged,
    bit for bit, and every discriminator weight has moved; after the
    second both have moved; every Adam first moment (the clipped
    gradients' running mean) is within 1e-4 of the largest of its tensor,
    and the parameters are within 1e-5 (1 % of the lr) of the JAX
    trainer's, all but one element in 10,000, which stay within Adam's
    bound of 2·lr an update: Adam's steps are lr·m/(sqrt(v) + 1e-8), so
    an element whose gradient is near 1e-8 turns a last-bit difference
    into a visible one (4 of the discriminator's 663,745 here). The
    attention key biases are held apart: their gradient is zero in exact
    arithmetic (the softmax ignores a shift of a query's scores), so both
    sides' moments are rounding noise (under a millionth of the largest
    moment) that Adam scales into steps of up to lr; they stay within
    2·lr an update of JAX's;
  * grad_accum_steps=2 over one batch twice gives the single step's update
    (1e-6), with nothing moved after the first micro-batch, and over two
    batches the JAX trainer's (as above);
  * a max_grad_norm clip against the JAX trainer's update (as above), and
    a 1e-30 clip that all but stops it;
  * `eval_step` (PSNR, SSIM) and the text-tower path against JAX;
  * dropout under a `torch.Generator`: at each flax site with its
    configured rate, reproducible for a seed;
  * the CLI on the CPU, its clamps and its refusals.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.train import stage1 as jstage1
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.ops import blocks
from setok_tpu_torch.scripts import train_setok
from setok_tpu_torch.train.stage1 import Stage1Trainer, eval_step, psnr
from setok_tpu_torch.utils.from_flax import from_flax, load_stage1_flax

REL = 1e-4
PARAM_TOL = 1e-5
PARAM_SHARE = 1e-4           # elements beyond PARAM_TOL, at most
MOMENT_REL = 1e-4
KEY_BIAS_MOMENT_REL = 1e-6
B = 4


def no_dropout(pkg):
    tok = pkg.replace(pkg.tiny_tokenizer(), proj_drop=0.0, attn_drop=0.0)
    det = pkg.replace(pkg.tiny_detokenizer(), proj_drop=0.0, attn_drop=0.0)
    return tok, det


def trainers(use_lpips=False, use_text_encoder=False, warm_up_end=0,
             **train_kw):
    kw = dict(compute_dtype="float32", warmup_steps=1, total_steps=3)
    kw.update(train_kw)
    out = []
    for pkg, cls in ((jcfg, jstage1.Stage1Trainer), (tcfg, Stage1Trainer)):
        extra = {} if pkg is jcfg else {"device": "cpu"}
        out.append(cls(*no_dropout(pkg),
                       gan_cfg=pkg.GANLossConfig(disc_start=0,
                                                 warm_up_end=warm_up_end),
                       contrastive_cfg=pkg.ContrastiveLossConfig(
                           text_embed_dim=32),
                       train_cfg=pkg.TrainConfig(**kw), use_lpips=use_lpips,
                       use_text_encoder=use_text_encoder, **extra))
    return out


def make_batch(seed, b=B, size=32, text=True):
    rs = np.random.RandomState(seed)
    img = rs.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    batch = {"comp_image": img, "gen_image": img}
    if text:
        batch["text_emb"] = rs.randn(b, 32).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def paired(jt, tt, batch, seed=0):
    """A JAX state from `seed` and the port trainer holding its weights."""
    state = jt.create_state(jax.random.PRNGKey(seed), jbatch(batch))
    np_ = lambda t: jax.tree.map(np.asarray, t)
    load_stage1_flax(tt, np_(state.gen_params), np_(state.disc_params),
                     None if state.lpips_params is None
                     else np_(state.lpips_params))
    tt.init_state()
    return state


def rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-6)


def check_metrics(tm, jm):
    assert set(tm) == set(jm)
    for key, want in jm.items():
        assert rel(tm[key], want) <= REL, (key, float(tm[key]), float(want))


def gen_named(tt):
    """The port's generator parameters by their flax-tree state keys."""
    out = {f"setok.{n}": p for n, p in tt.model.named_parameters()}
    out.update({f"contrastive.{n}": p
                for n, p in tt.contrastive.named_parameters()})
    if tt.text_encoder is not None:
        out.update({f"text_encoder.{n}": p
                    for n, p in tt.text_encoder.named_parameters()})
    return out


def gen_state(gen_tree):
    return {k: v for part, tree in gen_tree.items()
            for k, v in tree_state(tree, f"{part}.").items()}


def amax(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def key_bias(name: str, shape) -> torch.Tensor:
    """The elements of a parameter that are attention key biases: a BERT
    `key.bias`, or the middle third of a fused `qkv.bias`."""
    mask = torch.zeros(shape, dtype=torch.bool)
    if name.endswith("key.bias"):
        mask[:] = True
    elif name.endswith("qkv.bias"):
        c = shape[0] // 3
        mask[c:2 * c] = True
    return mask


def check_params(named, want, lr, updates=2):
    assert set(named) == set(want)
    bound = 2 * lr * updates
    n = beyond = 0
    for k, w in want.items():
        gap = (named[k].detach() - w).abs()
        kb = key_bias(k, gap.shape)
        assert amax(gap) <= bound, k
        n += int((~kb).sum())
        beyond += int((gap[~kb] > PARAM_TOL).sum())
    assert beyond <= PARAM_SHARE * n, (beyond, n)


def adam_mu(opt_state):
    """The first moments of the JAX optimizer state's Adam."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    return next(x for x in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=is_adam)
                if is_adam(x)).mu


def check_moments(named, opt, mu):
    """The port optimizer's exp_avg against JAX's mu, per parameter; the
    key biases' noise against the largest moment of all."""
    top = max(amax(m.abs()) for m in mu.values())
    for k, m in mu.items():
        p = named[k]
        if not p.requires_grad:         # frozen: in no optimizer
            continue
        gap = (opt.state[p]["exp_avg"] - m).abs()
        kb = key_bias(k, gap.shape)
        scale = amax(m[~kb].abs())
        assert amax(gap[~kb]) <= MOMENT_REL * scale, k
        noise = KEY_BIAS_MOMENT_REL * top
        assert amax(m[kb].abs()) <= noise, k
        assert amax(opt.state[p]["exp_avg"][kb].abs()) <= noise, k


def tree_state(tree, prefix=""):
    return {f"{prefix}{k}": v for k, v in from_flax(
        jax.tree.map(np.asarray, tree)).items()}


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


def test_frozen_backbone_stays_bit_identical():
    _, tt = trainers(warmup_steps=0)
    tt.init_weights_(0)
    tt.init_state()
    vit = tt.model.tokenizer.image_feature_encoder
    before = {n: p.detach().clone() for n, p in vit.named_parameters()}
    assert not any(p.requires_grad for p in vit.parameters())
    for s in range(2):
        tt.train_step(tbatch(make_batch(s)))
    assert all(torch.equal(p.detach(), before[n])
               for n, p in vit.named_parameters())


def test_grad_accum_matches_single_step_mean():
    batch = tbatch(make_batch(5))
    runs = []
    for k in (1, 2):
        _, tt = trainers(warmup_steps=0, total_steps=10, grad_accum_steps=k)
        tt.init_weights_(0)
        tt.init_state()
        before = [p.detach().clone() for p in tt.gen_params + tt.disc_params]
        for i in range(k):
            if i == 1:          # nothing moves before the k-th micro-batch
                assert all(torch.equal(p.detach(), b) for p, b in zip(
                    tt.gen_params + tt.disc_params, before))
            tt.train_step(batch)
        assert tt.updates == 1
        runs.append([p.detach() for p in tt.gen_params + tt.disc_params])
    assert max(float((a - b).abs().max()) for a, b in zip(*runs)) <= 1e-6


def test_grad_accum_matches_jax_trainer():
    """Two different micro-batches per update: the running mean of both
    optimizers' gradients, as optax.MultiSteps takes it."""
    jt, tt = trainers(warmup_steps=0, total_steps=10, grad_accum_steps=2)
    batches = [make_batch(s) for s in (11, 12)]
    state = paired(jt, tt, batches[0])
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(state, jbatch(batch), keys[i])
        check_metrics(tt.train_step(tbatch(batch)), jm)
    assert tt.updates == 1
    named = gen_named(tt)
    check_params(named, gen_state(state.gen_params), 1e-3, updates=1)
    check_moments(named, tt.gen_opt,
                  gen_state(adam_mu(state.gen_opt_state)))
    disc = dict(tt.disc.named_parameters())
    check_params(disc, tree_state(state.disc_params), 1e-3, updates=1)


def test_clip_matches_jax_trainer():
    jt, tt = trainers(warmup_steps=0, max_grad_norm=0.05)
    batch = make_batch(6)
    state = paired(jt, tt, batch)
    state, jm = jt.train_step(state, jbatch(batch), jax.random.PRNGKey(1))
    tm = tt.train_step(tbatch(batch))
    assert float(tm["grad_norm"]) > 0.05       # the clip is active
    check_metrics(tm, jm)
    named = gen_named(tt)
    check_params(named, gen_state(state.gen_params), 1e-3, updates=1)
    check_moments(named, tt.gen_opt,
                  gen_state(adam_mu(state.gen_opt_state)))


def test_max_grad_norm_all_but_stops_the_update():
    batch = tbatch(make_batch(7))

    def step_delta(max_grad_norm):
        _, tt = trainers(warmup_steps=0, total_steps=10,
                         max_grad_norm=max_grad_norm)
        tt.init_weights_(0)
        tt.init_state()
        before = [p.detach().clone() for p in tt.gen_params]
        tt.train_step(batch)
        return max(float((p.detach() - b).abs().max())
                   for p, b in zip(tt.gen_params, before))

    assert step_delta(1e-30) < 1e-9
    assert step_delta(0.0) > 1e-5       # 0 disables the clip


def test_eval_step_matches_jax():
    jt, tt = trainers()
    batch = make_batch(8, text=False)
    state = paired(jt, tt, make_batch(8))
    want = jstage1.eval_step(jt, state, jbatch(batch))
    got = eval_step(tt, tbatch(batch))
    assert set(got) == set(want)
    for key in want:
        assert rel(got[key], want[key]) <= REL, key
    x = torch.zeros(1, 8, 8, 3)
    assert float(psnr(x, x)) > 90
    assert float(psnr(x, x + 1.0)) == pytest.approx(10 * np.log10(4.0),
                                                    abs=1e-4)


def test_text_encoder_path_matches_jax():
    jt, tt = trainers(use_text_encoder=True, warmup_steps=0)
    batch = make_batch(9, text=False)
    batch["input_ids_for_contrastive"] = np.random.RandomState(9).randint(
        3, 30000, size=(B, 12))
    state = paired(jt, tt, batch)
    before = {k: v.clone() for k, v in gen_named(tt).items()
              if k.startswith("text_encoder.")}
    state, jm = jt.train_step(state, jbatch(batch), jax.random.PRNGKey(2))
    tm = tt.train_step(tbatch(batch))
    check_metrics(tm, jm)
    named = {k: p for k, p in gen_named(tt).items()
             if k.startswith("text_encoder.")}
    assert any(not torch.equal(p.detach(), before[k])
               for k, p in named.items())       # the tower trains
    # its 768-wide gradients sit near Adam's eps: held by the moments
    check_moments(named, tt.gen_opt,
                  {k: v for k, v in gen_state(
                      adam_mu(state.gen_opt_state)).items()
                   if k.startswith("text_encoder.")})


def test_dropout_under_a_generator(monkeypatch):
    """Every dropout site of the trained path draws at its configured
    rate; a seed reproduces the step; no generator, no dropout."""
    tok = tcfg.replace(tcfg.tiny_tokenizer(), proj_drop=0.2, attn_drop=0.1)
    det = tcfg.replace(tcfg.tiny_detokenizer(), proj_drop=0.3,
                       attn_drop=0.4)
    tt = Stage1Trainer(tok, det, gan_cfg=tcfg.GANLossConfig(disc_start=0),
                       contrastive_cfg=tcfg.ContrastiveLossConfig(
                           text_embed_dim=32),
                       train_cfg=tcfg.TrainConfig(compute_dtype="float32"),
                       device="cpu")
    tt.init_weights_(0)
    tt.init_state()
    images = tbatch(make_batch(10))["comp_image"]
    seen = []
    real = blocks.dropout

    def counting(x, rate, generator):
        y = real(x, rate, generator)
        if generator is not None and rate > 0:
            seen.append((rate, float((y == 0).float().mean())))
        return y

    for mod in ("ops.blocks", "models.qformer"):
        monkeypatch.setattr(f"setok_tpu_torch.{mod}.dropout", counting)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = tt.model.tokenize(images, gen)
            return tt.model.detokenize(out.tokens, out.token_valid,
                                       gen).image

    plain = run(None)
    assert not seen
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
    rates = {r for r, _ in seen}
    # tokenizer Blocks: proj 0.2 and attn 0.1; Q-Former: dropout 0.3 and
    # attn_dropout 0.4; decoder blocks: proj 0.3 and attn 0.4
    assert rates == {0.2, 0.1, 0.3, 0.4}
    q = tt.model.detokenizer.mapper
    assert (q.dropout, q.layer_0.self_attn.dropout) == (0.3, 0.4)
    big = torch.ones(200_000)
    for rate in (0.1, 0.4):
        y = real(big, rate, torch.Generator().manual_seed(0))
        assert abs(float((y == 0).float().mean()) - rate) < 0.005
        assert float(y.max()) == pytest.approx(1 / (1 - rate))


def test_cli_trains_on_the_cpu(capsys):
    train_setok.main(["--cpu", "--tiny", "--synthetic", "16",
                      "--synthetic-structured", "--steps", "3",
                      "--batch-size", "2", "--image-size", "32",
                      "--disc-start", "0"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert lines[-1]["updates"] == 3
    assert all(np.isfinite(x["total_loss"]) for x in lines)


def test_cli_batches_follow_the_jax_cli():
    """The synthetic stream draws as the JAX CLI's: the pool, the frozen
    per-image caption table, and a pick per batch."""
    args = train_setok.parse_args(["--synthetic", "8",
                                   "--synthetic-structured",
                                   "--batch-size", "3", "--image-size",
                                   "16", "--tiny"])
    it = train_setok.synthetic_batches(args, 32)
    rs = np.random.RandomState(0)
    from setok_tpu.utils.synthetic import structured_images
    pool = structured_images(8, 16, seed=0)
    temb = np.random.RandomState(1).randn(8, 32).astype(np.float32)
    for _ in range(2):
        rs.randint(0, 8)
        pick = rs.randint(0, 8, size=3)
        got = next(it)
        np.testing.assert_array_equal(got["comp_image"], pool[pick])
        np.testing.assert_array_equal(got["text_emb"], temb[pick])


def test_cli_clamps_like_the_jax_cli():
    args = train_setok.parse_args(["--synthetic", "4", "--merge-layer", "3",
                                   "--detok-patch", "32",
                                   "--detok-depth", "2"])
    tok, det = train_setok.configs(args)
    assert tok.vit.merge_layer == 3 and tok.vit.num_output_patches == 64
    assert (tok.k_max, tok.min_cluster_num, tok.knn) == (64, 64, 64)
    assert (det.patch_size, det.decoder_depth) == (32, 2)
    with pytest.raises(SystemExit):
        train_setok.configs(train_setok.parse_args(
            ["--synthetic", "4", "--detok-patch", "24"]))


@pytest.mark.parametrize("argv", [
    ["--data-path", "x.json"], ["--resume"], ["--checkpoint-every", "5"],
    ["--optim-bits", "8"], ["--offload-optimizer"]])
def test_cli_refuses_unported_flags(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md|not ported"):
        train_setok.main(["--cpu", "--tiny", "--synthetic", "4", *argv])


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_setok.main(["--tiny", "--synthetic", "4", "--steps", "1"])
