"""`utils/profiling` of the port against the JAX package's.

`StepTimer` on both sides over the same patched `time.perf_counter`
sequence: the `warmup` first steps left out, equal step times, `mean` and
`p50` (exact: the same float64 differences and numpy reductions), `nan`
with no time kept. `force_completion` on nested CPU tensors (the first
tensor leaf read back, and no other: a meta tensor later in the tree is
not touched, one in front raises; a tree without one passes), and `trace(device=
"cpu")` writing a Chrome trace that names the traced op.

The port's own: `span` is one shared no-op with no profiler running and a
plain host op `setok.<name>` (not a user annotation) under one, inside a
user annotation around it; a tiny SeTok forward profiled on the CPU shows
its seven spans once each, nested as the tokenizer and detokenizer run
them; `device_time_breakdown` files row 1's four kernels under
`cluster_dpc`.
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

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


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = tprof.span("tokenizer")
    assert off is tprof.span("detokenizer.decoder")
    with off:
        pass
    with off:   # the shared no-op enters again
        pass


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("setok.", "h100_bench."))]


def test_span_under_the_profiler_is_a_plain_host_op():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("h100_bench.tokenizer"):
            with tprof.span("tokenizer.cluster"):
                torch.ones(4, dtype=torch.bfloat16).float()
    ev = {e.name(): e for e in _host_events(prof)}
    assert set(ev) == {"h100_bench.tokenizer", "setok.tokenizer.cluster"}
    assert ev["h100_bench.tokenizer"].is_user_annotation()
    inner = ev["setok.tokenizer.cluster"]
    assert not inner.is_user_annotation()
    outer = ev["h100_bench.tokenizer"]
    assert outer.start_ns() <= inner.start_ns()
    assert (inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())


# each span and the span it runs inside
SPANS = {"setok.tokenizer": None,
         "setok.tokenizer.encode": "setok.tokenizer",
         "setok.tokenizer.cluster": "setok.tokenizer",
         "setok.tokenizer.group_encode": "setok.tokenizer",
         "setok.detokenizer": None,
         "setok.detokenizer.mapper": "setok.detokenizer",
         "setok.detokenizer.decoder": "setok.detokenizer"}


def test_a_setok_forward_runs_the_seven_spans_nested():
    from setok_tpu_torch import config as C
    from setok_tpu_torch.models.setok import SeTok

    torch.manual_seed(0)
    model = SeTok(C.tiny_tokenizer(), C.tiny_detokenizer(), device="cpu")
    size = C.tiny_tokenizer().vit.image_size
    images = torch.rand(2, size, size, 3) * 2 - 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(images)
    ev = _host_events(prof)
    assert sorted(e.name() for e in ev) == sorted(SPANS)
    at = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in ev}
    assert not any(e.is_user_annotation() for e in ev)
    for name, parent in SPANS.items():
        if parent is not None:
            assert (at[parent][0] <= at[name][0] < at[name][1]
                    <= at[parent][1])
    # the stages in the order they run; the tokenizer ends before the
    # detokenizer starts
    order = sorted(at, key=lambda n: at[n][0])
    assert order == list(SPANS)
    assert at["setok.tokenizer"][1] <= at["setok.detokenizer"][0]


@pytest.mark.parametrize("name", [
    "gram_kernel(float const*, double*, int, int)",
    "void (anonymous namespace)::density_parent_kernel<32>(float const*)",
    "void density_rows_kernel<true>(double const*, float*, int, int)",
    "parent_rows_kernel(double const*, float const*, int*, int)"])
def test_row_1_kernels_fall_under_cluster_dpc(name):
    assert tprof._category(name) == "cluster_dpc"
