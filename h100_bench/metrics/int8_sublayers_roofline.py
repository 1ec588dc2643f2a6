"""Rows 2-5 (`kernels/fused_sublayer.py`, `fused_bert_attention_int8.py`):
the least time of their calls in the traced window (roofline/bounds
int8_bound_ms at each call's shape) over the device time of their kernels.
The calls are the program's counters (`CALLS`), which must equal the
forward's whole-sublayer calls (`bounds.int8_sublayer_calls`) times the
batches; with another route, or any call of rows 6-8 (whose kernels share
these names), it reads nothing."""

from collections import Counter

from h100_bench.roofline import bounds
from h100_bench.roofline import kernel_names as _k

UNIT = "%"
LAYER = "kernels"
MOVES = "images_per_s"
SOURCE = "device_trace"

OTHER = ("fused_mlp_int8", "fused_attention_int8", "quant_matmul",
         "quant4_matmul")


def read(rec):
    if not rec["quant8"] or rec["batches"] == 0:
        return None
    calls = bounds.int8_sublayer_calls(rec["config"], rec["batch"])
    want = Counter(c[0] for c in calls)
    got = rec["calls"]
    if any(got.get(k, 0) for k in OTHER) or any(
            got.get(k, 0) != n * rec["batches"] for k, n in want.items()):
        return None
    us = _k.device_us(rec, _k.INT8)
    if us <= 0:
        return None
    bound_ms = rec["batches"] * sum(bounds.int8_bound_ms(*c)[0]
                                    for c in calls)
    return 100.0 * bound_ms * 1e3 / us
