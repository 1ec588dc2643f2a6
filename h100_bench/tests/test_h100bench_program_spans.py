"""The program's spans read by launch (`program_spans.py`), on the CPU.

    python -m pytest -q h100_bench/tests/test_h100bench_program_spans.py

  * `attribute` on a synthetic event list: a kernel counts in each span
    around its launch; batch i+1's launches while batch i runs on the
    device; a launch with no ATen op open (a ctypes kernel); an
    `aten::_to_copy` kernel is a cast and a `clone` kernel is not; a launch
    on another thread is not the span's; idle gaps by the innermost span
    open on the host, or outside the program;
  * `profile_lists` takes launches from the runtime's launch calls alone
    (not another runtime call, nor a host op whose own id equals a
    kernel's correlation id) and leaves out the device's user annotations;
  * `trace.reduce`'s spans, busy time and kernels are the same with and
    without the program's spans among the host events;
  * each reading is None without its span;
  * a tiny cell's traced run under `reading_spans` records the seven spans
    once a batch.
"""

from __future__ import annotations

import time
import types

import pytest
from torch.autograd import DeviceType

from h100_bench import harness, trace
from h100_bench import program_spans as ps
from h100_bench.tests.test_h100bench_harness import (  # noqa: F401
    TRAFFIC, few_threads, tiny_root)

T, U = 7, 8          # the launching thread, and another
TOK = "setok.tokenizer"
ENC, CLU, GRP = (TOK + s for s in (".encode", ".cluster", ".group_encode"))

# two batches of the tokenizer on thread T, its stages inside each
SPANS = [(name, T, s + b, e + b) for b in (0, 200) for name, s, e in (
    (TOK, 0, 100), (ENC, 0, 50), (CLU, 50, 60), (GRP, 60, 100))]
CASTS = [(T, 10, 12)]                      # an aten::_to_copy in encode
LAUNCHES = [
    (1, T, 5),      # encode, batch 0
    (2, T, 11),     # encode, inside the cast
    (3, T, 55),     # cluster: a ctypes launch, no ATen op open
    (4, T, 70),     # group_encode: a clone's kernel, not a cast
    (5, T, 205),    # encode, batch 1, while batch 0 runs on the device
    (6, T, 150),    # between the batches: the loop's copy
    (7, U, 20),     # another thread, inside encode's time
    (8, T, 310),    # after the batches
]
DEVICE = [(1, 210, 10), (2, 220, 5), (3, 225, 20), (4, 245, 5),
          (6, 260, 2), (7, 262, 1), (5, 300, 30), (8, 500, 10)]


def test_launches_put_device_time_in_every_span_around_them():
    program, idle = ps.attribute(SPANS, CASTS, LAUNCHES, DEVICE)
    assert program == {
        TOK: {"count": 2, "device_us": 70.0, "casts_us": 5.0,
              "launches": 5},
        ENC: {"count": 2, "device_us": 45.0, "casts_us": 5.0,
              "launches": 3},
        CLU: {"count": 2, "device_us": 20.0, "casts_us": 0.0,
              "launches": 1},
        GRP: {"count": 2, "device_us": 5.0, "casts_us": 0.0,
              "launches": 1}}
    # the stages cover the tokenizer
    assert sum(program[n]["device_us"] for n in (ENC, CLU, GRP)) == \
        program[TOK]["device_us"]
    # the gaps: from 250 (cluster of batch 1 open on the host), from 263
    # (its group_encode), from 330 (no span)
    assert idle == {CLU: 10.0, GRP: 37.0, ps.OUTSIDE: 170.0}


def test_a_launch_on_another_thread_is_not_the_spans():
    moved = [(c, U if c == 1 else th, t) for c, th, t in LAUNCHES]
    program, _ = ps.attribute(SPANS, CASTS, moved, DEVICE)
    assert program[ENC]["device_us"] == 35.0
    assert program[ENC]["launches"] == 2


def test_no_spans_read_nothing_and_idle_is_outside():
    program, idle = ps.attribute([], [], LAUNCHES, DEVICE)
    assert program == {}
    assert idle == {ps.OUTSIDE: 10.0 + 37.0 + 170.0}


class Event:
    def __init__(self, name, device, corr, start, dur, thread=T,
                 annotation=False):
        self._v = dict(name=name, device_type=device, correlation_id=corr,
                       start_ns=start * 1000, duration_ns=dur * 1000,
                       device_resource_id=thread,
                       is_user_annotation=annotation)

    def __getattr__(self, key):
        return lambda: self._v[key]


def fake_profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_profile_lists_reads_launches_from_the_runtime_alone():
    events = [
        Event("h100_bench.tokenizer", CPU, 1, 0, 100, annotation=True),
        Event(TOK, CPU, 2, 1, 98),
        Event("aten::_to_copy", CPU, 3, 2, 10),
        Event("aten::clone", CPU, 4, 20, 10),
        Event("cudaLaunchKernel", CPU, 50, 5, 1),
        Event("cudaLaunchKernel", CPU, 51, 25, 1),
        Event("cudaLaunchKernelExC", CPU, 52, 40, 1),
        Event("cudaEventRecord", CPU, 53, 45, 1),
        # a host op whose own id equals a kernel's correlation id
        Event("aten::empty", CPU, 52, 60, 1),
        Event("h100_bench.tokenizer", CUDA, 1, 300, 40, annotation=True),
        Event("bf16_copy_kernel", CUDA, 50, 300, 4),
        Event("direct_copy_kernel", CUDA, 51, 304, 6),
        Event("gram_kernel", CUDA, 52, 310, 30),
    ]
    spans, casts, launches, device = ps.profile_lists(fake_profile(events))
    assert spans == [(TOK, T, 1.0, 99.0)]
    assert casts == [(T, 2.0, 12.0)]
    assert sorted(launches) == [(50, T, 5.0), (51, T, 25.0), (52, T, 40.0)]
    assert device == [(50, 300.0, 4.0), (51, 304.0, 6.0), (52, 310.0, 30.0)]
    rec = ps.record(fake_profile(events))
    assert rec["program"] == {TOK: {"count": 1, "device_us": 40.0,
                                    "casts_us": 4.0, "launches": 3}}


class FunctionEvent:
    def __init__(self, name, device, start, end):
        self.name, self.device_type = name, device
        self.time_range = types.SimpleNamespace(start=start, end=end)


def test_reduce_reads_the_same_with_the_programs_spans():
    host = [FunctionEvent("h100_bench.tokenizer", CPU, 0, 100),
            FunctionEvent("aten::addmm", CPU, 10, 20),
            FunctionEvent("cudaLaunchKernel", CPU, 12, 13)]
    device = [FunctionEvent("h100_bench.tokenizer", CUDA, 300, 340),
              FunctionEvent("gemm", CUDA, 300, 310),
              FunctionEvent("softmax", CUDA, 320, 340),
              FunctionEvent("copy", CUDA, 400, 410)]
    spans = [FunctionEvent(TOK, CPU, 1, 99),
             FunctionEvent(ENC, CPU, 2, 50)]
    plain = trace.reduce(types.SimpleNamespace(
        events=lambda: host + device), 1.0)
    with_spans = trace.reduce(types.SimpleNamespace(
        events=lambda: host + spans + device), 1.0)
    for key in ("window_s", "busy_s", "kernels", "spans", "device_ops"):
        assert with_spans[key] == plain[key], key
    assert plain["spans"] == {"tokenizer": {"count": 1, "device_us": 30.0}}


def test_each_reading_is_none_without_its_span():
    assert all(read({}) is None for read in ps.METRICS.values())
    program, _ = ps.attribute(SPANS, CASTS, LAUNCHES, DEVICE)
    got = {n: read({"program": program}) for n, read in ps.METRICS.items()}
    assert got == {"tokenizer.encode.device_ms": pytest.approx(0.0225),
                   "tokenizer.cluster.device_ms": pytest.approx(0.010),
                   "tokenizer.group_encode.device_ms": pytest.approx(0.0025),
                   "detokenizer.mapper.device_ms": None,
                   "detokenizer.decoder.device_ms": None,
                   "casts.device_ms": pytest.approx(0.0025)}


@pytest.mark.parametrize("mode,cell,spans", [
    ("recon", "base256-int8-recon", 7), ("tokenize", "so400m-bf16-tokenize",
                                         4)])
def test_a_traced_run_records_the_spans_once_a_batch(tmp_path, mode, cell,
                                                     spans):
    root = tiny_root(tmp_path, dict(TRAFFIC, mode=mode), cell)
    reduce = trace.reduce
    with ps.reading_spans():
        # a window long enough for a sampled batch under the profiler
        traced = harness.run(f"tiny-{mode}", 2 ** 31 + 5, 1.0, True,
                             t_start=time.perf_counter(), device="cpu",
                             root=root, log=lambda msg: None)
    assert trace.reduce is reduce
    rec = traced["_record"]
    assert traced["correct"]
    assert len(rec["program"]) == spans
    assert {s["count"] for s in rec["program"].values()} == {rec["batches"]}
    # the CPU has no device timeline: nothing launched, nothing idle
    assert all(s["device_us"] == 0 for s in rec["program"].values())
    assert rec["idle_by_span"] == {}
