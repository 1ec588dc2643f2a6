"""Sentinel token ids and special-token strings shared by the data layout
and the MLLM (the values of `setok_tpu.constants`)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
TARGET_TOKEN_INDEX = -300

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
DEFAULT_TARGET_TOKEN = "<target>"
