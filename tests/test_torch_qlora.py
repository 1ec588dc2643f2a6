"""QLoRA in the port against the JAX package on the CPU.

`tiny_setokim()` with `proj_drop = 0`, seeded port weights carried to the
JAX side as a flax tree (`to_flax_tree`, no flax init compiles). Bars:

  * `quantize_base` against the JAX `quantize_base`: the same 14 targets,
    int8 weights and (1, out) scales equal element for element; the JAX
    QLoRA state (int8 kernels and `qscales`) loads into a quantised port
    model through `load_flax_params(..., qscales=)` and gives the same
    state;
  * the dequantised, LoRA-adapted weight each targeted `Dense` uses
    against the JAX `apply_lora(dequantize(...))`: float32 compute within
    1e-6 of the largest element (the A·B products' float32 sums in
    another order), bf16 compute within one bf16 ulp;
  * `extract_overlay` / `apply_overlay`: the trainable float parameters
    by name (the live tensors) and a write back;
  * two updates of `Stage2Trainer(lora_enable, quant_base, optim_bits=8,
    unfreeze_mm_vision_tower)` in float32 against the JAX trainer's (one
    JAX trainer, the micro-batches and draws of
    tests/test_torch_stage2_trainer.py): each micro-batch's losses within
    1e-5 max-rel; the int8 base unchanged and equal to JAX's; the 8-bit
    moments' payloads counted against JAX's (each at most one step off);
    the adapters, the projectors, the diffusion head and the tower's
    trainable part within 1e-5 (1 % of the learning rate, the bar of
    tests/test_torch_stage2_trainer.py) where their blocks' payloads
    agree; the tower's backbone bit for bit
    unchanged; `merged_params` (the base dequantised, the adapters merged)
    float and within 1e-5 of the JAX trainer's but for at most 0.1 % of
    the elements (those of blocks whose payloads differ), which stay within
    Adam's bound of lr an update.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.train import opt8 as jopt8
from setok_tpu.train import qlora as jqlora
from setok_tpu.train.lora import apply_lora as j_apply_lora
from setok_tpu.train.lora import default_target_filter
from setok_tpu.train.lora import init_lora as j_init_lora
from setok_tpu.train.stage2 import Stage2State
from setok_tpu.train.stage2 import Stage2Trainer as JTrainer
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.train.lora import apply_lora
from setok_tpu_torch.train.opt8 import _inverse, module_perms
from setok_tpu_torch.train.qlora import (apply_overlay, extract_overlay,
                                          quantize_base)
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils.from_flax import (flax_state_key, from_flax,
                                             load_flax_params, lora_from_flax,
                                             to_flax_tree)
from setok_tpu_torch.utils.init import init_setokim_random_
from tests.test_torch_opt8 import bf16_ulp
from tests.test_torch_stage2 import (TGT, jax_cfg, jax_draws, make_batch,
                                     max_rel, port_cfg, torch_batch)
from tests.test_torch_stage2_trainer import TRAIN_CFG

# the file's tiny Setokim flax tree (numpy leaves)
TREE = to_flax_tree(init_setokim_random_(
    Setokim(port_cfg(), target_token_id=TGT, device="cpu"), 5))
R, ALPHA = 4, 8.0


def jparams():
    return jax.tree.map(jnp.asarray, TREE)


def jlora(params):
    """A JAX LoRA tree with nonzero B (B = 0 would hide A's products)."""
    lora = j_init_lora(params, jax.random.PRNGKey(2), R)
    rs = np.random.RandomState(3)
    return {k: {"a": v["a"], "b": jnp.asarray(
        0.1 * rs.randn(*v["b"].shape), jnp.float32)}
        for k, v in lora.items()}


def module_of(path: str) -> str:
    """'.'-joined module name of a flax kernel keystr path."""
    return ".".join(k.strip("[]'") for k in path.split("][")[1:-1])


def port_model(dtype=torch.float32):
    return load_flax_params(Setokim(port_cfg(), target_token_id=TGT,
                                    dtype=dtype, device="cpu"), TREE)


def test_quantize_base_matches_jax():
    qparams, qscales = jqlora.quantize_base(jparams(), default_target_filter)
    model = port_model()
    scales = quantize_base(model)
    assert len(scales) == len(qscales) == 14
    mods = dict(model.named_modules())
    flat = dict(jax.tree_util.tree_flatten_with_path(qparams)[0] and
                ((jax.tree_util.keystr(p), v) for p, v in
                 jax.tree_util.tree_flatten_with_path(qparams)[0]))
    for path, s in qscales.items():
        mod = mods[module_of(path)]
        assert mod.weight.dtype == torch.int8 and not mod.weight.requires_grad
        assert np.array_equal(mod.weight.t().numpy(), np.asarray(flat[path]))
        assert np.array_equal(mod.qscale.numpy(), np.asarray(s))
    assert model.llama.lm_head.weight.dtype == torch.float32
    # the JAX QLoRA state loads into a quantised model
    other = Setokim(port_cfg(), target_token_id=TGT, device="cpu")
    quantize_base(other)
    load_flax_params(other, jax.tree.map(np.asarray, qparams),
                     qscales=jax.tree.map(np.asarray, qscales))
    want = model.state_dict()
    got = other.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dequantized_adapted_weights_match_jax(dtype):
    params = jparams()
    lora = jlora(params)
    qparams, qscales = jqlora.quantize_base(params, default_target_filter)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_apply_lora(jqlora.dequantize(qparams, qscales, jdt), lora,
                        ALPHA, R)
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    model = port_model(dtype)
    adapters = lora_from_flax(jax.tree.map(np.asarray, lora), model)
    quantize_base(model)
    apply_lora(model, adapters, ALPHA, R)
    mods = dict(model.named_modules())
    for path in qscales:
        with torch.no_grad():
            got = mods[module_of(path)].effective_weight().t()
        w = torch.from_numpy(np.asarray(flat[path], np.float32))
        assert got.dtype == dtype
        if dtype == torch.float32:
            assert max_rel(got, w) <= 1e-6, path
        else:
            assert bool(((got.float() - w).abs() <= bf16_ulp(w)).all()), path


def test_overlay_is_the_trainable_float_subset():
    """`extract_overlay` selects the float parameters the JAX trainer's
    `_wants_training` would (here: labels other than 'frozen' under
    QLoRA), the live tensors; `apply_overlay` writes values back."""
    model = port_model()
    quantize_base(model)
    jt = JTrainer(jax_cfg(), lora_enable=True, quant_base=True)
    overlay = extract_overlay(
        model, lambda n, p: jt._label_of(n, False) != "frozen")
    assert overlay and all(p.is_floating_point() for p in overlay.values())
    assert {n.split(".")[0] for n in overlay} == {
        "mm_in_projector", "mm_out_projector", "diffloss"}
    named = dict(model.named_parameters())
    assert all(overlay[n] is named[n] for n in overlay)
    key = next(iter(overlay))
    apply_overlay(model, {key: torch.full_like(overlay[key], 0.5)})
    assert bool((named[key] == 0.5).all())


# ---------------------------------------------------------------------------
# the trainer: QLoRA + 8-bit moments + the trainable tower


OPTIONS = dict(lora_enable=True, quant_base=True, optim_bits=8,
               unfreeze_mm_vision_tower=True, target_token_id=TGT,
               lora_r=R, lora_alpha=ALPHA, mm_in_projector_lr=2e-3,
               mm_out_projector_lr=5e-4)


def jax_state(jt, params, lora):
    """`create_state` without the flax init: the LoRA tree drawn on the
    float weights, then the int8 base, as create_state takes them."""
    qparams, qscales = jqlora.quantize_base(params, default_target_filter)
    overlay = jqlora.extract_overlay(qparams, jt._wants_training)
    tp = {"params": overlay, "lora": lora}
    return Stage2State(step=jnp.zeros((), jnp.int32), params=qparams,
                       lora=lora, opt_state=jt._tx.init(tp), qscales=qscales)


def adam8bit_moments(opt_state):
    """{(tree part, leaf path): (m _Q, v _Q)} of every Adam8bit state."""
    is_state = lambda x: isinstance(x, jopt8.Adam8bitState)
    out = {}
    for st in jax.tree_util.tree_leaves(opt_state, is_leaf=is_state):
        if not is_state(st):
            continue
        for part in ("params", "lora"):
            if part not in st.m:
                continue
            is_q = lambda x: isinstance(x, jopt8._Q)
            ms = jax.tree_util.tree_flatten_with_path(st.m[part],
                                                      is_leaf=is_q)[0]
            vs = dict(jax.tree_util.tree_flatten_with_path(
                st.v[part], is_leaf=is_q)[0])
            for path, mq in ms:
                if is_q(mq):
                    out[(part, path)] = (mq, vs[path])
    return out


def payload_agreement(tt, opt_state):
    """Against the JAX trainer's Adam8bit moments: for each parameter of
    the port's Adam8bit, a (blocks,) bool, True where both moments'
    payloads equal JAX's; the payload elements that differ, compared, and
    the largest payload gap (in quantisation steps)."""
    opt = tt.optimizers["adam8bit"]
    named = dict(tt.model.named_parameters())
    lora = {(name, f): t for name, ab in tt.lora.items()
            for f, t in zip("ab", ab)}
    agree, differ, total, worst = {}, 0, 0, 0
    for (part, path), (mq, vq) in adam8bit_moments(opt_state).items():
        keys = [getattr(k, "key", None) for k in path]
        if part == "lora":
            p = lora[(module_of(keys[0]), keys[1])]
        elif len(keys) == 1:       # the QLoRA overlay, keyed by keystr
            p = named[flax_state_key(
                [k.strip("[]'") for k in keys[0].split("][")])]
        else:
            p = named[flax_state_key(keys)]
        st = opt.state[p]
        ok = torch.ones(st["m_q"].shape[0], dtype=torch.bool)
        for mom, jq in (("m", mq), ("v", vq)):
            q = st[f"{mom}_q"].to(torch.int32)
            jqq = torch.from_numpy(np.array(jq.q)).to(torch.int32)
            worst = max(worst, int((q - jqq).abs().max()))
            differ += int((q != jqq).sum())
            total += q.numel()
            ok &= ~(q != jqq).any(dim=1)
        agree[id(p)] = ok
    return agree, differ, total, worst


def agreeing_elements(p, ok, perm=None):
    """p's elements (in p's layout) whose 256-element block (in the flax
    order `perm`) has payloads equal to JAX's."""
    perm = perm or tuple(range(p.dim()))
    keep = ok.repeat_interleave(256)[:p.numel()].reshape(
        p.permute(perm).shape)
    return keep.permute(_inverse(perm))


def test_qlora_8bit_tower_two_updates_match_jax_trainer(capsys):
    batches = [make_batch(10 + i) for i in range(4)]
    jt = JTrainer(jax_cfg(), train_cfg=jcfg.TrainConfig(**TRAIN_CFG),
                  **OPTIONS)
    params = jparams()
    lora = jlora(params)
    state = jax_state(jt, params, lora)
    keys = jax.random.split(jax.random.PRNGKey(21), 4)

    tt = Stage2Trainer(port_cfg(), train_cfg=tcfg.TrainConfig(**TRAIN_CFG),
                       device="cpu", **OPTIONS)
    load_flax_params(tt.model, TREE)
    tt.init_state(lora=lora_from_flax(jax.tree.map(np.asarray, lora),
                                      tt.model))
    assert set(tt.optimizers) == {"adam8bit"}
    tower = tt.model.vision_tower
    frozen = {id(p) for p in tower.frozen_parameters()}
    backbone0 = [p.detach().clone() for p in tower.frozen_parameters()]
    trainable_tower = [n for n, p in tower.named_parameters()
                       if id(p) not in frozen]
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, keys[i])
        tm = tt.train_step(torch_batch(batch),
                           jax_draws(keys[i], jax_cfg(), 2))
        for k in ("lm_loss", "diff_loss", "total_loss"):
            assert max_rel(tm[k], jm[k]) <= 1e-5, (i, k)
    assert tt.updates == 2

    # the int8 base: unchanged, and JAX's
    want = from_flax(jax.tree.map(np.asarray, state.params))
    named = dict(tt.model.named_parameters())
    for path in state.qscales:
        key = module_of(path) + ".weight"
        assert named[key].dtype == torch.int8
        assert torch.equal(named[key], before[key])
        assert torch.equal(named[key], want[key])
    assert all(torch.equal(p.detach(), b) for p, b in
               zip(tower.frozen_parameters(), backbone0))

    # moments: payloads against JAX's, then the parameters where they agree
    by_name = {n: p for n, p in named.items() if p.requires_grad}
    agree, differ, total, worst = payload_agreement(tt, state.opt_state)
    assert len(agree) == len(by_name) + 2 * len(tt.lora)
    with capsys.disabled():
        print(f"\nQLoRA + Adam8bit + tower vs JAX: {differ} of {total} "
              f"payload elements differ, by {worst} step(s) at most")
    assert differ <= 1e-3 * total and worst <= 1

    def check(p, w, perm):
        keep = agreeing_elements(p, agree[id(p)], perm)
        assert float(((p.detach().float() - w).abs() * keep).max()) <= 1e-5

    perms = module_perms(tt.model)
    jnamed = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in want.items()}
    moved_tower = 0
    for n, p in named.items():
        if not p.requires_grad or id(p) in frozen:
            continue
        check(p, jnamed[n], perms[p])
        if n.startswith("vision_tower."):
            moved_tower += not torch.equal(p.detach(), before[n])
    assert moved_tower >= 0.8 * len(trainable_tower)      # the tower trains
    for path, ab in state.lora.items():
        for f, t in zip("ab", tt.lora[module_of(path)]):
            check(t, torch.from_numpy(np.asarray(ab[f], np.float32)), None)

    merged = tt.merged_params()
    assert not any(k.endswith(".qscale") for k in merged)
    jmerged = from_flax(jax.tree.map(np.asarray, jt.merged_params(state)))
    n = beyond = 0
    for key, w in jmerged.items():
        assert merged[key].dtype == torch.float32
        gap = (merged[key] - w).abs()
        # Adam's bound (a step is at most lr), two updates at lr <= 2e-3
        assert float(gap.max()) <= 2 * 2 * 2e-3, key
        n += gap.numel()
        beyond += int((gap > 1e-5).sum())
    # beyond 1e-5 only where a payload differed (the blocks masked above)
    assert beyond <= 1e-3 * n, (beyond, n)
