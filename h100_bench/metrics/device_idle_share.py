"""The share of the traced window in which no operation ran on the card:
100 x (1 - the union of the device operations' intervals / the window)."""

UNIT = "%"
LAYER = "device"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
