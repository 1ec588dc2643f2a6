"""The whole step's share of the chip's peak: 100 x the least time of the
traced window's work at the data-sheet peaks / the window's length. The work
is the traffic mode's count of one image (modes/<mode>.py `flops`, from
roofline/flops.py) times the images completed; int8 products (where the
traffic runs the int8 form) at 1,979 TOP/s, the rest at 989 TFLOP/s, by the
configuration's declared precision, whatever kernel ran."""

from h100_bench.roofline import bounds

UNIT = "%"
LAYER = "whole step"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(rec):
    ops = rec["step_flops"]
    if rec["quant8"]:
        least = ops["int8"] / bounds.PEAK_INT8_OPS + \
            ops["float"] / bounds.PEAK_BF16_FLOPS
    else:
        least = (ops["int8"] + ops["float"]) / bounds.PEAK_BF16_FLOPS
    images = rec["batches"] * rec["batch"]
    if images == 0:
        return None
    return 100.0 * least * images / rec["window_s"]
