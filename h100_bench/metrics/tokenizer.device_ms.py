"""Device ms a batch of the kernels launched inside the benchmark's span
around the call of the tokenizer (the ViT, the clustering, the Blocks)."""

UNIT = "ms"
LAYER = "tokenizer"
MOVES = "images_per_s"
SOURCE = "program_span"


def read(rec):
    span = rec["spans"].get("tokenizer")
    if not span or span["device_us"] <= 0:
        return None
    return span["device_us"] / span["count"] / 1e3
