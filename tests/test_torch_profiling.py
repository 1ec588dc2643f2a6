"""`utils/profiling` of the port against the JAX package's.

`StepTimer` on both sides over the same patched `time.perf_counter`
sequence: the `warmup` first steps left out, equal step times, `mean` and
`p50` (exact: the same float64 differences and numpy reductions), `nan`
with no time kept. `force_completion` on nested CPU tensors (the first
tensor leaf read back, and no other: a meta tensor later in the tree is
not touched, one in front raises; a tree without one passes), and `trace(device=
"cpu")` writing a Chrome trace that names the traced op.
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from setok_tpu.utils import profiling as jprof
from setok_tpu_torch.utils import profiling as tprof
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# start and stop clock readings of five steps, uneven
CLOCK = [0.0, 1.5, 2.0, 2.25, 10.0, 10.125, 11.0, 14.0, 20.0, 20.5]


def run_timer(cls, monkeypatch, warmup, result=None):
    ticks = iter(CLOCK)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = cls(warmup=warmup)
    dts = []
    for _ in range(len(CLOCK) // 2):
        timer.start()
        dts.append(timer.stop(result))
    monkeypatch.undo()
    return timer, dts


@pytest.mark.parametrize("warmup", [0, 2, 4])
def test_step_timer_matches_jax(warmup, monkeypatch):
    jt, jdts = run_timer(jprof.StepTimer, monkeypatch, warmup)
    tt, tdts = run_timer(tprof.StepTimer, monkeypatch, warmup,
                         result={"x": torch.ones(3)})
    assert tdts == jdts
    assert tt.times == jt.times == jdts[warmup:]
    assert tt.mean == jt.mean and tt.p50 == jt.p50
    assert tt.p50 == float(np.median(jdts[warmup:]))


def test_step_timer_without_times_is_nan(monkeypatch):
    for cls in (jprof.StepTimer, tprof.StepTimer):
        timer, _ = run_timer(cls, monkeypatch, warmup=len(CLOCK))
        assert timer.times == []
        assert math.isnan(timer.mean) and math.isnan(timer.p50)


def test_force_completion_on_nested_cpu_tensors():
    tree = {"meta": "step", "out": [(1, torch.arange(6.0).reshape(2, 3)),
                                    {"loss": torch.tensor(0.5)}]}
    tprof.force_completion(tree)
    tprof.force_completion({"empty": torch.zeros(0), "n": 3})
    tprof.force_completion({"no": ["tensor"]})
    # only the first tensor leaf is read back: a meta tensor has no data
    meta = torch.empty(2, device="meta")
    tprof.force_completion([torch.ones(1), {"later": meta}])
    with pytest.raises((NotImplementedError, RuntimeError)):
        tprof.force_completion([{"first": meta}, torch.ones(1)])


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "profile"
    with tprof.trace(str(log_dir), device="cpu") as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
