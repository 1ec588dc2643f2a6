"""Device ms a batch of the kernels launched inside the benchmark's span
around the call of the detokenizer (the Q-Former, the pixel decoder)."""

UNIT = "ms"
LAYER = "detokenizer"
MOVES = "images_per_s"
SOURCE = "program_span"


def read(rec):
    span = rec["spans"].get("detokenizer")
    if not span or span["device_us"] <= 0:
        return None
    return span["device_us"] / span["count"] / 1e3
