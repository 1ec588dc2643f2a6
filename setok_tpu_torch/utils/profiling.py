"""Profiling hooks: traces, completion barriers, step timing, and where
the device time goes.

The counterpart of `setok_tpu/utils/profiling.py`, with its names:

  trace(log_dir, device=None)  a region under `torch.profiler`, CUDA
                activity on the card (None: the card; "cpu": the CPU only),
                written as a Chrome trace (chrome://tracing, Perfetto,
                TensorBoard's profiler plugin) under `log_dir`;
  force_completion(result)  waits for the device of the first tensor leaf
                of `result` and reads one element of it back;
  StepTimer(warmup=2)  step times after `warmup` steps: `start`,
                `stop(result=None)`, `mean`, `p50` (nan without times).

and the port's own `span(name)`, the program's named stages, and
`device_time_breakdown`: kernel names grouped into a few categories by
substring, so that a forward's time reads as matmul / attention softmax /
LayerNorm / clustering / ...

`span(name)` marks a stage of the program as the host op `setok.<name>`
while a profiler runs (`trace`, or any `torch.profiler.profile`), and is a
shared no-op otherwise: the profiler being on is the only switch. It is a
plain host op, not a user annotation (`record_function`), so the profiler
gives it no range of its own on the device timeline and a user annotation
around it keeps its kernels there; a reader attributes device time to it by
the launches that lie inside it. Off it costs a check of whether a profiler
runs and the no-op's enter and exit.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from setok_tpu_torch.utils.device import resolve_device


SPAN_PREFIX = "setok."
_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span("tokenizer.cluster"): ...`: the host op
    `setok.tokenizer.cluster` while a profiler runs, else a shared
    no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """`with trace('build/profile'): step(...)`: the region's trace as
    `<log_dir>/trace-<pid>-<ns>.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def force_completion(tree: Any) -> None:
    """A completion barrier: synchronise the device of the first tensor
    leaf of `tree` and read back one element of it."""
    leaf = next((x for x in tree_leaves(tree)
                 if isinstance(x, torch.Tensor)), None)
    if leaf is None:
        return
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.detach().reshape(-1)[:1].cpu()


class StepTimer:
    """Rolling step-time statistics with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._t = None
        self._count = 0

    def start(self):
        self._t = time.perf_counter()

    def stop(self, result: Optional[Any] = None):
        if result is not None:
            force_completion(result)
        dt = time.perf_counter() - self._t
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

# first match wins; names are CUDA kernel names as the profiler reports them
CATEGORIES = (
    ("flash_forward", ("flash_fwd", "flash_classes")),
    ("flash_dq", ("flash_dq",)),
    ("flash_dkv", ("flash_dkv",)),
    ("cluster_dpc", ("gram_kernel", "density_parent_kernel",
                     "density_rows_kernel", "parent_rows_kernel")),
    # the int8 sublayers' and fused_mlp_int8's wgmma GEMMs (their epilogues
    # name them), and their one-read pass over the hidden or attention rows
    ("int8_mlp_gemm", ("mlpfc",)),
    ("int8_qkv_gemm", ("biasepi",)),
    ("int8_mlp_rows", ("hidden_quant",)),
    ("quant_rows", ("quant_rows",)),
    ("quant_gemv", ("gemv_kernel",)),
    ("quant_gemm", ("gemm_kernel",)),
    ("cache_attention", ("cache_attn_kernel",)),
    ("int8_attention_mma", ("attn_mma_kernel",)),
    ("int8_rows", ("rows_kernel",)),
    # cuDNN's convolutions (the discriminator, LPIPS), forward and both
    # backward products, before the GEMMs whose names they share
    ("convolution", ("fprop", "dgrad", "wgrad", "cudnn", "conv2d",
                     "convolve")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("pooling", ("max_pool", "pool2d")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
    ("sort_topk", ("sort", "topk", "radix")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                     "fill")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def device_time_breakdown(fn, top: int = 8) -> dict:
    """Run fn() once under torch.profiler on the card. Returns the window's
    wall time (CUDA events), the summed kernel time, the busy share, the
    kernel time per category and the `top` kernels by time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)

    by_cat = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        # CPU-side ops report their kernels' time too: count kernels only
        if evt.device_type == DeviceType.CPU:
            continue
        ms = _self_device_us(evt) / 1e3
        if ms > 0:
            by_cat[_category(evt.key)] += ms
            kernels.append((ms, evt.count, evt.key[:90]))
    device_ms = sum(by_cat.values())
    kernels.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms > 0 else None,
            "by_category_ms": dict(sorted(by_cat.items(),
                                          key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n, "ms": ms, "calls": c}
                            for ms, c, n in kernels[:top]]}
