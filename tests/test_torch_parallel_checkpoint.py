"""Checkpoints across layouts: a stage-2 full fine-tune's state written at
dp = 2 (every slice gathered, one rank writes utils/checkpoint's format)
restores into a tp = 2 trainer (each rank reads its slices through
`restore_sharded`) and into a one-process trainer, every tensor equal;
`restore_partial` reads only what matches; `checkpoint_metadata` reads no
tensor bytes. `abstract_like` carries the shardings."""

import torch

from setok_tpu_torch.utils import checkpoint as ckpt
from tests import torch_parallel_workers as W
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path


def test_save_at_dp2_restore_at_tp2_and_one_process(tmp_path):
    d = str(tmp_path / "ckpt")
    got = W.spawn(W.checkpoint_cycle, 2, tmp_path, d)
    saved = got[0]["saved"]
    for r in range(2):
        _equal(got[r]["tp"]["params"], saved["params"], "params")
        _equal(got[r]["tp"]["train"]["optimizers"],
               saved["train"]["optimizers"], "optimizers")
    # the tp ranks held slices of the trunk linears
    q = "llama.model.layer_0.attn.q_proj.weight"
    assert got[0]["tp_local"][q][0] * 2 == saved["params"][q].shape[0]

    one = W.stage2_trainer("one")
    one.load_state_dict(ckpt.restore_sharded(d, shardings=one.shardings()))
    state = one.state_dict()
    _equal(state["params"], saved["params"], "params")
    _equal(state["train"]["optimizers"], saved["train"]["optimizers"],
           "optimizers")
    assert one.step == 1 and one.updates == 1

    # metadata without tensor bytes; a partial restore of the parameters
    meta, step = ckpt.checkpoint_metadata(d)
    assert step == 1 and meta["params"][q] == ckpt.Abstract(
        tuple(saved["params"][q].shape), saved["params"][q].dtype)
    target = {"params": {k: torch.zeros_like(v)
                         for k, v in saved["params"].items()},
              "train": {"step": -1}}
    q_path = ckpt.keystr("params", *q.split("."))
    part = ckpt.restore_partial(d, target, lambda path: path == q_path)
    assert torch.equal(part["params"][q], saved["params"][q])
    other = "llama.model.layer_1.attn.q_proj.weight"
    assert not part["params"][other].any()
    assert part["train"] == {"step": -1}           # its file not read
    abs_tree = ckpt.abstract_like({"params": {q: saved["params"][q]}},
                                  {q_path: "piece"})
    assert abs_tree["params"][q].sharding == "piece"
