"""The traced run's record: device activity, spans and host gaps.

`reduce(prof, window_s)` reads a finished `torch.profiler.profile` (CPU and
CUDA activities) into one plain dict that the per-layer metrics read:

  * `window_s`: from the first device operation of the traced batches to
    the end of the last (the host's window where the device ran nothing);
  * `busy_s`: the union of the intervals in which a device operation
    (kernel, copy or fill) ran, so overlapping kernels count once;
  * `kernels`: [(name, start_us, duration_us)] of every device operation;
  * `spans`: for each of the benchmark's own `record_function` spans
    (names starting "h100_bench."), its count and the time in which device
    operations ran inside its range on the device timeline (the profiler
    marks each span there, from its first kernel to its last). Kernels
    that the program launches through ctypes are not linked to the host
    op that launched them, so the host-side sums would miss them;
  * `device_ops`: the 10 device operations that took the most time, summed
    by name; `idle_gaps`: the device's idle time summed by what the host was
    doing when each gap began (the innermost host op open then), the 10
    largest.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "h100_bench."


def _merge(intervals) -> list:
    """Sorted-by-start intervals merged where they overlap."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _busy_within(merged, ranges) -> float:
    """The length of the merged intervals inside the ranges (both sorted,
    each disjoint)."""
    total, j = 0.0, 0
    for r0, r1 in ranges:
        while j < len(merged) and merged[j][1] <= r0:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < r1:
            total += min(merged[k][1], r1) - max(merged[k][0], r0)
            k += 1
    return total


def _host_op_at(starts, ops, t):
    """The innermost host op open at time t: among the ops that started at
    or before t and end after it, the latest to start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        s, e, name = ops[j]
        if e >= t:
            return name
    return "(no host op)"


def reduce(prof, window_s: float) -> dict:
    from torch.autograd import DeviceType

    events = prof.events()
    device, host, marks = [], [], defaultdict(list)
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(SPAN_PREFIX):
                # the span's range on the device timeline
                marks[e.name[len(SPAN_PREFIX):]].append((tr.start, tr.end))
            else:
                device.append((e.name, tr.start, tr.end - tr.start))
        else:
            host.append((tr.start, tr.end, e.name))
    device.sort(key=lambda k: k[1])
    merged = _merge((s, s + d) for _, s, d in device)
    busy_us = sum(e - s for s, e in merged)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    spans = {name: {"count": len(r), "device_us": _busy_within(
        merged, sorted(r))} for name, r in marks.items()}

    by_name = defaultdict(float)
    for name, _, d in device:
        by_name[name] += d
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        idle[_host_op_at(starts, host, s)] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    if merged:
        # the device's window: from the first operation to the last, so
        # that the drain before and after the traced batches is left out
        window_s = (merged[-1][1] - merged[0][0]) / 1e6
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernels": device,
        "spans": dict(spans),
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in top_idle],
    }
