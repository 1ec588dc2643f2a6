"""The port's checkpoints (`utils/checkpoint.py`) and resumable trainers.

  * a step round-trips bit for bit, bf16 and int8 tensors included;
    `latest_step` skips a leftover temporary directory, `max_to_keep`
    holds, a step saved twice logs a warning and keeps the first;
  * `CheckpointRunner.save` copies the state before it returns: a parameter
    changed right after it does not change what is restored; a SIGTERM
    sets `preempted`;
  * `restore_lazy` reads only the parts asked for: it works with the
    optimizer's file deleted;
  * `.npz` adapter files cross between the packages both ways: a whole
    SeTok tree written by the JAX package's `save_subtree` loads through
    the port's `load_subtree` into the same forward (1e-4 max-abs, the
    float32 bar of tests/test_torch_models.py), and a port-written file
    into the JAX forward; a subtree file replaces only its subtree;
  * the stage-1 trainer: 3 updates straight equal 2 updates, a save, a
    restore into a fresh trainer and 1 more, bit for bit on the CPU
    (parameters, Adam moments, metrics); the stage-2 trainer the same
    across a restore in the middle of an update (2 micro-batches an
    update, saved after the fifth), which carries the accumulated
    gradients, the LoRA factors and the draws' generator; the stage-1 CLI
    resumed from its `--output-dir` prints the uninterrupted run's metrics.
"""

import json
import logging
import os
import shutil
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu.utils import checkpoint as jckpt
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.scripts import train_setok
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_random_, init_setokim_random_
from tests.test_torch_stage2 import make_batch, port_cfg, torch_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
X = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
    np.float32)
# one tiny SeTok flax tree for the file: a port model's weights in the flax
# layout (no flax init to compile), and the JAX forward jitted once
JMODEL = JSeTok(jcfg.tiny_tokenizer(), jcfg.tiny_detokenizer())
JPARAMS = jax.tree.map(jnp.asarray, to_flax_tree(init_random_(SeTok(
    tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(), device="cpu"), 0)))
JFWD = jax.jit(lambda p: JMODEL.apply(p, jnp.asarray(X)).recon)


def state_of(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"a.weight": torch.randn(4, 3, generator=g),
                       "a.bias": torch.randn(3, generator=g).bfloat16(),
                       "q.q": torch.randint(-127, 128, (5, 2),
                                            dtype=torch.int8, generator=g)},
            "train": {"moments": [torch.randn(4, 3, generator=g)],
                      "step": 7, "rng": g.get_state()}}


def assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_round_trip_is_bit_exact(tmp_path):
    state = state_of()
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert_same(ckpt.restore_checkpoint(str(tmp_path)), state)
    # a target gives each tensor its type
    target = state_of(1)
    target["params"]["a.weight"] = target["params"]["a.weight"].double()
    got = ckpt.restore_checkpoint(str(tmp_path), 3, target)
    assert got["params"]["a.weight"].dtype == torch.float64
    assert torch.equal(got["params"]["a.weight"],
                       state["params"]["a.weight"].double())
    # the parts lie in files of their own
    assert sorted(os.listdir(tmp_path / "3")) == ["index.json", "params.pt",
                                                  "train.pt"]


def test_latest_step_skips_partial_and_keeps_three(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, step, state_of(step))
    (tmp_path / ".tmp-9-0-0").mkdir()          # an interrupted write
    assert ckpt.latest_step(d) == 4
    assert sorted(p for p in os.listdir(d) if p.isdigit()) == ["2", "3", "4"]
    assert_same(ckpt.restore_checkpoint(d, 2), state_of(2))


def test_repeated_step_warns_and_keeps_the_first(tmp_path, caplog):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 5, state_of(0))
    with caplog.at_level(logging.WARNING):
        ckpt.save_checkpoint(d, 5, state_of(1))
    assert "step 5 exists" in caplog.text
    runner = ckpt.CheckpointRunner(d, install_sigterm_hook=False)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        runner.save(5, state_of(2))
    runner.close()
    assert "step 5 exists" in caplog.text
    assert_same(ckpt.restore_checkpoint(d, 5), state_of(0))


def test_save_snapshots_before_it_returns(tmp_path):
    w = torch.nn.Parameter(torch.ones(256, 256))
    runner = ckpt.CheckpointRunner(str(tmp_path), install_sigterm_hook=False)
    runner.save(1, {"params": {"w": w}})
    with torch.no_grad():
        w.add_(1.0)                            # an optimizer step, in place
    runner.wait()
    assert runner.last_save["bytes"] == 256 * 256 * 4
    assert runner.last_save["write_s"] >= 0
    got = runner.restore()["params"]["w"]
    runner.close()
    assert torch.equal(got, torch.ones(256, 256))


def test_splice_and_filter_by_path():
    target = {"tok.out.weight": torch.zeros(2, 2),
              "det.out.weight": torch.zeros(2, 2, dtype=torch.bfloat16)}
    source = {"det.out.weight": torch.ones(2, 2),
              "tok.out.weight": torch.ones(2, 2)}
    got = ckpt.splice_params(target, source, ckpt.prefix_predicate("det"))
    assert torch.equal(got["tok.out.weight"], target["tok.out.weight"])
    assert got["det.out.weight"].dtype == torch.bfloat16
    assert torch.equal(got["det.out.weight"].float(), torch.ones(2, 2))
    assert set(ckpt.filter_subtree(source, ckpt.root_predicate("det"))) == \
        {"det.out.weight"}


def test_restore_lazy_reads_no_moment_file(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, state_of())
    os.remove(tmp_path / "1" / "train.pt")
    got = ckpt.restore_lazy(d, ckpt.root_predicate("params"))
    assert_same(got, {"params": state_of()["params"]})
    got = ckpt.restore_lazy(d, ckpt.prefix_predicate("['q']"))
    assert_same(got, {"params": {"q.q": state_of()["params"]["q.q"]}})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_lazy(d, ckpt.root_predicate("train"))


def test_sigterm_sets_preempted(tmp_path):
    runner = ckpt.CheckpointRunner(str(tmp_path))
    try:
        assert not runner.preempted(0)
        os.kill(os.getpid(), signal.SIGTERM)
        assert runner.preempted(0)
    finally:
        runner.close()


def _port_forward(model):
    with torch.no_grad():
        return model(torch.from_numpy(X)).recon.numpy()


def test_npz_from_jax_loads_into_the_port(tmp_path):
    path = str(tmp_path / "setok.npz")
    jckpt.save_subtree(path, JPARAMS, lambda name: True)
    want = np.asarray(JFWD(JPARAMS))
    model = init_random_(SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                               device="cpu"), 5)
    ckpt.load_subtree(path, model)
    assert float(np.abs(_port_forward(model) - want).max()) <= TOL


def test_npz_from_the_port_loads_into_jax(tmp_path):
    model = init_random_(SeTok(tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer(),
                               device="cpu"), 6)
    path = str(tmp_path / "port.npz")
    ckpt.save_subtree(path, model, lambda name: True)
    params = jckpt.load_subtree(path, JPARAMS)
    want = np.asarray(JFWD(params))
    assert float(np.abs(_port_forward(model) - want).max()) <= TOL
    # a detokenizer-only file replaces that subtree and nothing else
    part = str(tmp_path / "detok.npz")
    ckpt.save_subtree(part, model, ckpt.prefix_predicate("detokenizer"))
    keys = np.load(part).files
    assert keys and all(k.startswith("['params']['detokenizer']")
                        for k in keys)
    other = load_flax_params(SeTok(tcfg.tiny_tokenizer(),
                                   tcfg.tiny_detokenizer(), device="cpu"),
                             jax.tree.map(np.asarray, JPARAMS))
    tok_before = {k: v.clone() for k, v in
                  other.tokenizer.state_dict().items()}
    ckpt.load_subtree(part, other)
    assert all(torch.equal(v, tok_before[k])
               for k, v in other.tokenizer.state_dict().items())
    assert all(torch.equal(v, model.detokenizer.state_dict()[k])
               for k, v in other.detokenizer.state_dict().items())


# ----------------------------------------------------------------------------
# resumable trainers


def stage1_trainer():
    tok = tcfg.replace(tcfg.tiny_tokenizer(), proj_drop=0.1)
    tr = Stage1Trainer(tok, tcfg.tiny_detokenizer(),
                       gan_cfg=tcfg.GANLossConfig(disc_start=0),
                       contrastive_cfg=tcfg.ContrastiveLossConfig(
                           text_embed_dim=32),
                       train_cfg=tcfg.TrainConfig(compute_dtype="float32",
                                                  warmup_steps=1,
                                                  total_steps=3),
                       device="cpu")
    tr.init_weights_(0)
    tr.init_state()
    return tr


def stage1_batch(i):
    rs = np.random.RandomState(30 + i)
    img = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return {"comp_image": torch.from_numpy(img),
            "gen_image": torch.from_numpy(img),
            "text_emb": torch.from_numpy(rs.randn(2, 32).astype(np.float32))}


def params_and_moments(opts, modules):
    out = [t.detach().clone() for m in modules for t in m.state_dict()
           .values()]
    for opt in opts:
        for st in opt.state.values():
            out += [st["exp_avg"].clone(), st["exp_avg_sq"].clone()]
    return out


def test_stage1_resume_is_bit_exact(tmp_path):
    straight = stage1_trainer()
    gen = torch.Generator().manual_seed(1)
    want = [straight.train_step(stage1_batch(i), gen) for i in range(3)]

    first = stage1_trainer()
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        first.train_step(stage1_batch(i), gen)
    runner = ckpt.CheckpointRunner(str(tmp_path), install_sigterm_hook=False)
    runner.save(2, first.state_dict({"dropout": gen}))
    runner.close()
    del first

    resumed = stage1_trainer()
    gen = torch.Generator().manual_seed(99)
    resumed.load_state_dict(ckpt.restore_checkpoint(str(tmp_path)),
                            {"dropout": gen})
    assert (resumed.step, resumed.updates) == (2, 2)
    got = resumed.train_step(stage1_batch(2), gen)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want[2].items()}
    a = params_and_moments((straight.gen_opt, straight.disc_opt),
                           straight.parts().values())
    b = params_and_moments((resumed.gen_opt, resumed.disc_opt),
                           resumed.parts().values())
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def stage2_trainer():
    tr = Stage2Trainer(port_cfg(), train_cfg=tcfg.TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=3,
        grad_accum_steps=2, remat=False, compute_dtype="float32"),
        target_token_id=3, lora_enable=True, lora_r=4, lora_alpha=8.0,
        mm_in_projector_lr=2e-3, device="cpu")
    init_setokim_random_(tr.model, 0)
    tr.init_state(seed=1)
    return tr


def test_stage2_resume_mid_update_is_bit_exact(tmp_path):
    batches = [torch_batch(make_batch(40 + i)) for i in range(6)]
    straight = stage2_trainer()
    gen = torch.Generator().manual_seed(2)
    want = [straight.train_step(b, gen) for b in batches]

    first = stage2_trainer()
    gen = torch.Generator().manual_seed(2)
    for b in batches[:5]:
        first.train_step(b, gen)
    assert first._acc is not None              # half an update in flight
    ckpt.save_checkpoint(str(tmp_path), 5, first.state_dict({"draws": gen}))
    del first

    resumed = stage2_trainer()
    gen = torch.Generator().manual_seed(99)
    resumed.load_state_dict(ckpt.restore_checkpoint(str(tmp_path)),
                            {"draws": gen})
    got = resumed.train_step(batches[5], gen)
    assert resumed.updates == straight.updates == 3
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want[5].items()}
    for (name, (a, b)), (_, (a2, b2)) in zip(straight.lora.items(),
                                             resumed.lora.items()):
        assert torch.equal(a, a2) and torch.equal(b, b2), name
    a = params_and_moments((straight.optimizer,), (straight.model,))
    b = params_and_moments((resumed.optimizer,), (resumed.model,))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_setok_cli_resumes(tmp_path, capsys):
    """The stage-1 CLI with --output-dir: 2 steps saved every step; with
    step 2 removed, the same command resumes at step 1 and prints the
    first run's metrics for it."""
    out = str(tmp_path / "run")
    argv = ["--cpu", "--tiny", "--synthetic", "8", "--synthetic-structured",
            "--batch-size", "2", "--image-size", "32", "--disc-start", "0",
            "--steps", "2", "--checkpoint-every", "1", "--output-dir", out]

    def lines():
        return [{k: v for k, v in json.loads(x).items() if k != "seconds"}
                for x in capsys.readouterr().out.splitlines()]

    train_setok.main(argv)
    first = lines()
    cdir = os.path.join(out, "checkpoints")
    assert [x["step"] for x in first] == [0, 1]
    assert sorted(os.listdir(cdir)) == ["1", "2"]
    shutil.rmtree(os.path.join(cdir, "2"))
    train_setok.main(argv)
    assert lines() == first[1:]
    assert ckpt.latest_step(cdir) == 2
