"""Where the device time goes: a torch.profiler breakdown of one call.

The counterpart of `setok_tpu/utils/profiling.py` for the card. Kernel
names are grouped into a few categories by substring, so that a forward's
time reads as matmul / attention softmax / LayerNorm / clustering / ...
"""

from __future__ import annotations

from collections import defaultdict

import torch

# first match wins; names are CUDA kernel names as the profiler reports them
CATEGORIES = (
    ("flash_forward", ("flash_fwd", "flash_classes")),
    ("flash_dq", ("flash_dq",)),
    ("flash_dkv", ("flash_dkv",)),
    ("cluster_dpc", ("gram_kernel", "density_parent_kernel")),
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
