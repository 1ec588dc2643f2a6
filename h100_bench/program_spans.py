"""The program's spans on a traced run's device trace, read by launch.

The port marks its stages with `setok_tpu_torch.utils.profiling.span`:
plain host ops named `setok.<stage>` while a profiler runs. The profiler
gives such an op no range on the device timeline, so they are read by
launch: a device operation (kernel, copy, fill) belongs to every span in
whose host range, on the launching thread, its launch lies. Its launch is
the runtime event (`cudaLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernel`, `cudaMemcpyAsync`, ...) that shares its correlation id.
So a kernel counts in each enclosing span, and in the span that launched
it whenever it runs (two batches in flight read as one), and a kernel
launched through ctypes reads as one of PyTorch's does.

`record(prof)` reads a finished `torch.profiler.profile` into

  * `program`: for each `setok.*` span, `count` (its host ranges),
    `device_us` (the device time of the operations launched inside it),
    `casts_us` (the part of that launched inside an `aten::_to_copy`: dtype
    conversions, `.float()`, `.to(dtype)`; layout copies under
    `aten::clone` or `aten::contiguous` are not casts) and `launches`;
  * `idle_by_span`: the device's idle time (us) by the innermost `setok.*`
    span open on the host when each gap began, or `(outside the
    program)`: the benchmark's loop and its waits. Host and device share
    the profiler's clock.

`attribute` does the reading on plain lists, so the CPU tests drive it
without a card. `METRICS` are the readings of a record a batch, in ms.
`reading_spans()` makes `trace.reduce` add both keys to the record it
returns, and

    python3 h100_bench/program_spans.py --workload <cell> --seed <n>

runs one cell's traced window (`harness.run` as `run.py --trace 1` runs
it), prints run.py's `spans:` and `calls:` lines, then `program spans:`
(each span's device ms, casts ms and launches a batch), `idle by span:`
(ms a batch), what a span costs the host with the profiler off and on, and
last one JSON line: `correct`, the cell's per-layer `metrics`, the
`program` readings, the traced pace and the card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
SPAN_PREFIX = "setok."
CAST_OP = "aten::_to_copy"
OUTSIDE = "(outside the program)"
# the CUDA API calls that put work on the device (cuda*, and cu* below them)
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
          "cudaGraphLaunch")
TOKENIZER, DETOKENIZER = "setok.tokenizer", "setok.detokenizer"


def _merged(ranges) -> tuple:
    """(starts, ends) of the ranges merged where they overlap, sorted."""
    starts, ends = [], []
    for s, e in sorted(ranges):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _inside(ranges, t) -> bool:
    starts, ends = ranges
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < ends[i]


def _innermost(spans) -> tuple:
    """(points, names): from points[i] to points[i + 1] the innermost span
    open (the latest to start, then the first to end), or None."""
    by_start = sorted(spans, key=lambda r: r[2])
    points = sorted({t for _, _, s, e in spans for t in (s, e)})
    open_, j, names = [], 0, []
    for p in points:
        open_ = [r for r in open_ if r[3] > p]
        while j < len(by_start) and by_start[j][2] <= p:
            if by_start[j][3] > p:
                open_.append(by_start[j])
            j += 1
        names.append(max(open_, key=lambda r: (r[2], -r[3]))[0]
                     if open_ else None)
    return points, names


def attribute(spans, casts, launches, device) -> tuple:
    """The program's spans on plain lists (times in us, one clock):

      spans     [(name, thread, start, end)]  the `setok.*` host ops;
      casts     [(thread, start, end)]        the `aten::_to_copy` host ops;
      launches  [(correlation, thread, t)]    the runtime launch events;
      device    [(correlation, start, duration)]  the device operations.

    Returns (program, idle_by_span) as `record` describes them."""
    per_thread = defaultdict(list)
    for name, thread, s, e in spans:
        per_thread[(name, thread)].append((s, e))
    ranges = {k: _merged(v) for k, v in per_thread.items()}
    names_on = defaultdict(list)
    for name, thread in ranges:
        names_on[thread].append(name)
    cast_ranges = defaultdict(list)
    for thread, s, e in casts:
        cast_ranges[thread].append((s, e))
    cast_ranges = {k: _merged(v) for k, v in cast_ranges.items()}

    count = Counter(name for name, *_ in spans)
    program = {name: {"count": n, "device_us": 0.0, "casts_us": 0.0,
                      "launches": 0} for name, n in count.items()}
    launched = {}   # correlation -> (the spans around its launch, a cast)
    for corr, thread, t in launches:
        inside = [n for n in names_on.get(thread, ())
                  if _inside(ranges[(n, thread)], t)]
        if not inside:
            continue
        for n in inside:
            program[n]["launches"] += 1
        cast = thread in cast_ranges and _inside(cast_ranges[thread], t)
        launched[corr] = (inside, cast)
    for corr, _, dur in device:
        if corr not in launched:
            continue
        inside, cast = launched[corr]
        for n in inside:
            program[n]["device_us"] += dur
            if cast:
                program[n]["casts_us"] += dur

    points, names = _innermost(spans)
    idle = defaultdict(float)
    busy = _merged((s, s + d) for _, s, d in device)
    for end, start in zip(busy[1][:-1], busy[0][1:]):
        i = bisect.bisect_right(points, end) - 1
        idle[(names[i] if i >= 0 else None) or OUTSIDE] += start - end
    return program, dict(idle)


def profile_lists(prof) -> tuple:
    """`attribute`'s four lists from a finished torch.profiler.profile.
    A host event's thread is its system thread id (`device_resource_id`),
    which the program's ops and the runtime's events share."""
    from torch.autograd import DeviceType

    spans, casts, runtime, device = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        if e.device_type() == DeviceType.CPU:
            name, thread = e.name(), e.device_resource_id()
            if name.startswith(SPAN_PREFIX):
                spans.append((name, thread, start,
                              start + e.duration_ns() / 1e3))
            elif name == CAST_OP:
                casts.append((thread, start, start + e.duration_ns() / 1e3))
            elif name.startswith(LAUNCH):
                runtime[e.correlation_id()] = (thread, start)
        elif not e.is_user_annotation():
            device.append((e.correlation_id(), start, e.duration_ns() / 1e3))
    ops = {corr for corr, _, _ in device}
    launches = [(corr, *at) for corr, at in runtime.items() if corr in ops]
    return spans, casts, launches, device


def record(prof) -> dict:
    program, idle = attribute(*profile_lists(prof))
    return {"program": program, "idle_by_span": idle}


@contextlib.contextmanager
def reading_spans():
    """While open, `trace.reduce` adds `program` and `idle_by_span` to the
    record it returns, and leaves its own keys as they are: the harness's
    traced window reads the spans without an edit of its own."""
    from h100_bench import trace

    reduce = trace.reduce

    def with_spans(prof, window_s):
        rec = reduce(prof, window_s)
        rec.update(record(prof))
        return rec

    trace.reduce = with_spans
    try:
        yield
    finally:
        trace.reduce = reduce


def _ms_a_batch(name, key="device_us"):
    def read(rec):
        span = rec.get("program", {}).get(name)
        if not span or span["count"] <= 0 or span[key] <= 0:
            return None
        return span[key] / span["count"] / 1e3
    return read


def _casts_ms(rec):
    spans = [rec.get("program", {}).get(n) for n in (TOKENIZER, DETOKENIZER)]
    spans = [s for s in spans if s and s["count"] > 0]
    if not spans:
        return None
    return sum(s["casts_us"] / s["count"] for s in spans) / 1e3


# ms a batch, each moving images_per_s: the stages of each part of the
# model, and the casts of the whole step
METRICS = {
    "tokenizer.encode.device_ms": _ms_a_batch("setok.tokenizer.encode"),
    "tokenizer.cluster.device_ms": _ms_a_batch("setok.tokenizer.cluster"),
    "tokenizer.group_encode.device_ms": _ms_a_batch(
        "setok.tokenizer.group_encode"),
    "detokenizer.mapper.device_ms": _ms_a_batch("setok.detokenizer.mapper"),
    "detokenizer.decoder.device_ms": _ms_a_batch(
        "setok.detokenizer.decoder"),
    "casts.device_ms": _casts_ms,
}


def span_cost_ns(n: int = 20000) -> dict:
    """The host's ns for one `with span(...)`: with no profiler running,
    under a CPU profiler, and an empty loop's turn beside them."""
    from torch.profiler import ProfilerActivity, profile

    from setok_tpu_torch.utils.profiling import span

    def per_turn(body):
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / n

    def spans():
        for _ in range(n):
            with span("cost"):
                pass

    def empty():
        for _ in range(n):
            pass

    off = min(per_turn(spans) for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_turn(spans)
    return {"off": off, "on": on, "loop": min(per_turn(empty)
                                              for _ in range(5))}


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        say("no CUDA card")
        return 2
    sys.path.insert(0, str(HERE.parent))
    from h100_bench import harness

    with reading_spans():
        result = harness.run(args.workload, args.seed, harness.TRACE_SECONDS,
                             True, t_start=T_START, device="cuda", log=say)
    rec = result["_record"]
    say(f"spans: {json.dumps(rec['spans'])}")
    say(f"calls: {json.dumps(rec['calls'])} row 1 launches "
        f"{rec['cluster_launches']} batches {rec['batches']}")
    spans = {name: {"ms": s["device_us"] / s["count"] / 1e3,
                    "casts_ms": s["casts_us"] / s["count"] / 1e3,
                    "launches": s["launches"] / s["count"]}
             for name, s in sorted(rec["program"].items())}
    say(f"program spans: {json.dumps(spans)}")
    batches = max(rec["batches"], 1)
    idle = {name: us / batches / 1e3 for name, us in sorted(
        rec["idle_by_span"].items(), key=lambda kv: -kv[1])}
    say(f"idle by span: {json.dumps(idle)}")
    cost = span_cost_ns()
    say(f"span ns: {json.dumps(cost)}")
    for name, c in result["checks"].items():
        say(f"{name} {c['value']!r} limit {c['limit']!r}")
    out = {"correct": result["correct"], "metrics": result["metrics"],
           "program": {n: read(rec) for n, read in METRICS.items()},
           "pace_ms": 1e3 * rec["window_s"] / batches, "span_ns": cost,
           "device": {"kind": torch.cuda.get_device_name(0),
                      "busy_s": rec["busy_s"], "window_s": rec["window_s"]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
