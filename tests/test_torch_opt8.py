"""The port's optimizer pieces against the JAX package and optax on the CPU.

  * `opt8.Adam8bit` against the jitted JAX `adam8bit` over 3 steps on
    seeded leaves (sizes not a multiple of 256, a Dense kernel held in the
    torch (out, in) layout and blocked in the flax (in, out) order, a 4-D
    convolution, a bf16 leaf), the schedule read after the increment. The
    elements that differ are counted (printed with -s): XLA's CPU build
    fuses each moment's b·m + (1 - b)·g into one multiply-add, fusing one
    product or the other leaf by leaf, where the port rounds each
    operation; so a payload may differ by one step (none did: 0 of
    20,646 readings), a block scale by an ulp (14 of 108 readings here,
    1.1e-7 relative; bar 20 % and 2.5e-7), a parameter by a few ulps of
    the learning rate (bar: one ulp of the parameter + 1e-5·lr), and the
    bf16 leaf not at all. The
    first step, where m and v start at 0, agrees to the bit;
  * `moment_bytes` equals the JAX `moment_bytes` of the same moments;
  * the trainers read an 8-bit group's schedule at the count after the
    increment, so its first update moves where AdamW's runs at lr 0;
  * `AdamWOptax` on bf16 leaves against `optax.adamw` (bf16 moments, as
    optax keeps them): over 3 steps every parameter and moment within one
    bf16 ulp of optax's and at most 1 % of them off by it (none were: 0 of
    10,116);
  * a state dict round trip keeps the float32 block scales of bf16
    parameters float32;
  * the in-place global-norm clip against `optax.clip_by_global_norm`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from setok_tpu.train import opt8 as jopt8
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.train import opt8
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.train.stage2 import (AdamWOptax, Stage2Trainer,
                                          clip_by_global_norm_, warmup_cosine)
from tests.test_torch_stage2 import port_cfg

LR = 2.0 ** -7       # exact in float32: the schedule adds no rounding


def sched(count):
    return LR * count


def leaves(rs):
    """{name: (flax array, torch permutation)} of the test leaves."""
    return {"kernel": (rs.randn(33, 70).astype(np.float32), (1, 0)),
            "conv": (rs.randn(3, 3, 5, 7).astype(np.float32), (2, 3, 1, 0)),
            "bias": (rs.randn(513).astype(np.float32), ()),
            "small": (rs.randn(3).astype(np.float32), ())}


def to_torch(x, perm):
    """The torch layout of a flax array: the inverse of `perm`."""
    t = torch.from_numpy(np.array(x))
    return t if not perm else t.permute(opt8._inverse(perm)).contiguous()


def test_adam8bit_matches_jax_step_for_step(capsys):
    rs = np.random.RandomState(0)
    flax = leaves(rs)
    bf16 = rs.randn(300).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, (v, _) in flax.items()}
    jparams["bf16"] = jnp.asarray(bf16, jnp.bfloat16)
    tx = jopt8.adam8bit(lambda c: LR * c.astype(jnp.float32))
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(to_torch(v, perm))
              for k, (v, perm) in flax.items()}
    params["bf16"] = torch.nn.Parameter(torch.tensor(bf16).bfloat16())
    perms = {k: perm or None for k, (_, perm) in flax.items()}
    names = list(params)
    opt = opt8.Adam8bit([{"params": [params[k] for k in names],
                          "flax_perms": [perms.get(k) for k in names]}])
    step = jax.jit(tx.update)
    differ = {"q": 0, "scale": 0, "param": 0}
    worst = {"q": 0, "scale_rel": 0.0, "param_over_lr": 0.0}
    readings = 0
    for i in range(3):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, (v, _) in flax.items()}
        grads["bf16"] = rs.randn(300).astype(np.float32)
        jg = {k: jnp.asarray(g) for k, g in grads.items()}
        jg["bf16"] = jg["bf16"].astype(jnp.bfloat16)
        updates, jstate = step(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k in names:
            g = to_torch(grads[k], perms.get(k))
            params[k].grad = g.to(params[k].dtype)
        for group in opt.param_groups:
            group["lr"] = sched(i + 1)        # after the increment
        opt.step()
        for k in names:
            st = opt.state[params[k]]
            for mom in ("m", "v"):
                jq = getattr(jstate, mom)[k]
                q = st[f"{mom}_q"].numpy().astype(np.int32)
                differ["q"] += int((q != np.asarray(jq.q)).sum())
                worst["q"] = max(worst["q"], int(np.abs(
                    q - np.asarray(jq.q)).max()))
                sc, jsc = st[f"{mom}_s"].numpy(), np.asarray(jq.scale)
                differ["scale"] += int((sc != jsc).sum())
                readings += sc.size
                worst["scale_rel"] = max(worst["scale_rel"], float(
                    (np.abs(sc - jsc) / jsc).max()))
            got = params[k].detach().float()
            want = torch.from_numpy(np.array(jparams[k], np.float32))
            if perms.get(k):
                got = got.permute(perms[k])
            differ["param"] += int((got != want).sum())
            if k != "bf16":
                # beyond one ulp of the parameter (the sum's rounding)
                ulp = torch.nextafter(want.abs(), torch.tensor(np.inf)) \
                    - want.abs()
                worst["param_over_lr"] = max(worst["param_over_lr"], float(
                    ((got - want).abs() - ulp).clamp_min(0).max()) / LR)
            else:                     # the sum rounded to bf16 agrees
                assert torch.equal(got, want)
    n = sum(p.numel() for p in params.values())
    with capsys.disabled():
        print(f"\nAdam8bit vs JAX adam8bit over 3 steps ({n} parameters):"
              f" elements that differ {differ} (of {6 * n} payload and "
              f"{readings} scale readings), largest gaps {worst}")
    # XLA's CPU build contracts b·m + (1 - b)·g into one fused
    # multiply-add, fusing one product or the other as it compiles each
    # leaf; the port rounds each operation, as the source is written (and
    # the same on the card). A moment then differs in its last bit at some
    # elements: a block's absmax, and so its scale, by an ulp or two, a
    # payload by at most one step (none in this run), a step by a few
    # float32 ulps of the learning rate: a parameter within one ulp of its
    # own plus 1e-5·lr.
    assert worst["q"] <= 1 and differ["q"] <= 1e-3 * 6 * n
    assert worst["scale_rel"] <= 2.5e-7 and differ["scale"] <= 0.2 * readings
    assert worst["param_over_lr"] <= 1e-5 and differ["param"] <= 0.05 * n
    assert all(st["count"] == 3 for st in opt.state.values())


@pytest.mark.parametrize("n", [1 << 16, 1000])
def test_moment_bytes_match_jax(n):
    jstate = jopt8.adam8bit(1e-3).init({"w": jnp.zeros((n,))})
    want = jopt8.moment_bytes((jstate.m, jstate.v))
    p = torch.nn.Parameter(torch.zeros(n))
    opt = opt8.Adam8bit([p])
    assert opt8.moment_bytes(opt) == 0          # moments made at the step
    p.grad = torch.zeros(n)
    opt.step()
    assert opt8.moment_bytes(opt) == want
    assert torch.equal(p.detach(), torch.zeros(n))   # zero gradient: no step


def test_trainers_read_8bit_schedule_after_the_increment():
    """Warm-up 1: AdamW's first update reads the schedule at count 0 (lr 0),
    Adam8bit's at count 1 (the peak); the JAX adam8bit moves at once."""
    tc = tcfg.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                          compute_dtype="float32", remat=False)
    eight = Stage2Trainer(port_cfg(), train_cfg=tc, device="cpu",
                          optim_bits=8)
    eight.init_state(0)
    assert eight.lr("main") == eight.lr("lora") == 1e-3
    assert eight.lr("embed32") == 0.0                # 32-bit AdamW
    assert eight.lr("proj_in") == 1e-3               # a constant rate
    assert "embed32" in set(eight.labels().values())
    plain = Stage2Trainer(port_cfg(), train_cfg=tc, device="cpu")
    plain.init_state(0)
    assert plain.lr("main") == 0.0
    s1 = Stage1Trainer(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                       train_cfg=tc, optim_bits=8, device="cpu")
    s1.init_state()
    assert s1.lr() == warmup_cosine(1, 1e-3, 1, 3) == 1e-3
    assert isinstance(s1.gen_opt, opt8.Adam8bit)
    tx = jopt8.adam8bit(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 3))
    p = {"w": jnp.ones((4,))}
    u, _ = tx.update({"w": jnp.ones((4,))}, tx.init(p))
    assert float(jnp.abs(u["w"]).max()) > 0


def test_adamw_optax_matches_optax_on_bf16(capsys):
    rs = np.random.RandomState(1)
    shapes = {"a": (64, 48), "b": (300,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4),
                     b1=0.9, b2=0.999, weight_decay=0.0)
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.tensor(v).bfloat16())
              for k, v in init.items()}
    opt = AdamWOptax(list(params.values()), betas=(0.9, 0.999))
    step = jax.jit(tx.update)
    for i in range(3):
        grads = {k: (rs.randn(*s) * 1e-2).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = step({k: jnp.asarray(g, jnp.bfloat16)
                                for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.tensor(grads[k]).bfloat16()
        opt.param_groups[0]["lr"] = warmup_cosine(i, 1e-2, 1, 4)
        opt.step()
    adam = jstate[0]
    total = differ = 0
    for k, p in params.items():
        for got, want in ((p.detach(), jparams[k]),
                          (opt.state[p]["mu"], adam.mu[k]),
                          (opt.state[p]["nu"], adam.nu[k])):
            want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
            assert got.dtype == torch.bfloat16
            ulp = bf16_ulp(want)
            assert bool(((got.float() - want.float()).abs() <= ulp).all()), k
            total += got.numel()
            differ += int((got != want).sum())
    with capsys.disabled():
        print(f"\nAdamWOptax vs optax.adamw (bf16): {differ} of {total} "
              f"elements differ, each by one ulp at most")
    assert differ <= 0.01 * total


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (at least the smallest normal's)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def test_state_dict_keeps_bf16_params_scales_float32():
    p = torch.nn.Parameter(torch.randn(700).bfloat16())
    opt = opt8.Adam8bit([p])
    p.grad = torch.randn(700).bfloat16()
    opt.step()
    saved = {k: v.clone() for k, v in opt.state[p].items()
             if torch.is_tensor(v)}
    other = opt8.Adam8bit([p])
    other.load_state_dict(opt.state_dict())
    st = other.state[p]
    assert st["m_s"].dtype == st["v_s"].dtype == torch.float32
    assert all(torch.equal(st[k], v) for k, v in saved.items())
    assert st["count"] == 1


def test_inplace_clip_matches_optax():
    rs = np.random.RandomState(2)
    grads = [rs.randn(40, 7).astype(np.float32),
             rs.randn(11).astype(np.float32)]
    for max_norm in (0.5, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
