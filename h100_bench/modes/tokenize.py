"""Traffic mode `tokenize`: each batch is turned into concept tokens.

The entry is `SetokTokenizer.forward` under `torch.inference_mode()` (no
detokenizer is built): the ViT, DPC-KNN clustering and the cluster Blocks.
Every batch's tokens, their validity and the cluster counts come down to
host memory; the sampled batches' clustering too, for the check, with the
features that the clustering took (harness.keep_cluster).
"""

from __future__ import annotations

import torch

from h100_bench import check, harness
from h100_bench.roofline import flops as F

PARTS = ("tokenizer",)
ALWAYS = ("tokens", "token_valid", "num_clusters")
CHECKED = ("idx_cluster", "score", "features")
NUMBERS = ("row1_score", "row1_assign", "token_err")


def build(tok_cfg, det_cfg, **kw):
    from setok_tpu_torch.models.tokenizer import SetokTokenizer
    model = SetokTokenizer(tok_cfg, **kw)
    model.eval()
    harness.keep_cluster(model, model.__dict__.setdefault("_kept", {}))
    return model


def parts(model) -> dict:
    return {"tokenizer": model}


def forward(model, images, keep: bool = False) -> dict:
    kept = model.__dict__["_kept"]
    kept["keep"] = keep
    with torch.inference_mode():
        out = model(images)._asdict()
    kept.pop("score")
    if keep:
        out["features"] = kept.pop("features")
    return out


def flops(cfg: dict) -> dict:
    """The step's operations an image (roofline/flops.py)."""
    return F.tokenizer_flops(cfg)


def judge(ref: check.Reference, images, got: dict) -> dict:
    out = check.row1_numbers(ref.config["tokenizer"], got)
    tokens, _ = ref.tokens_given(ref.features(images), got["idx_cluster"])
    out["token_err"] = check.rel_err(got["tokens"], tokens)
    return out
