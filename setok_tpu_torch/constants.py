"""Sentinel token ids shared by the data layout and the MLLM (the values of
`setok_tpu.constants`)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
