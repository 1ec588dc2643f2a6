"""Row 1 (`kernels/cluster_dpc.py`, `csrc/cluster_dpc.cu`): the least time of
its calls in the traced window (roofline/bounds.cluster_bound_ms at the
tokenizer's shapes, one call a batch) over the device time of its kernels."""

from h100_bench.roofline import bounds
from h100_bench.roofline import kernel_names as _k

UNIT = "%"
LAYER = "kernels"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(rec):
    us = _k.device_us(rec, _k.ROW1)
    if us <= 0 or rec["cluster_launches"] <= 0:
        return None
    v, t = rec["config"]["vit"], rec["config"]["tokenizer"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    bound_ms = rec["batches"] * bounds.cluster_bound_ms(
        rec["batch"], n, t["hidden_dim"])
    return 100.0 * bound_ms * 1e3 / us
