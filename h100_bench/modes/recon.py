"""Traffic mode `recon`: each batch is reconstructed whole.

The entry is `SeTok.forward` (under `torch.inference_mode()`): the
tokenizer's ViT, DPC-KNN clustering and concept tokens, then the
detokenizer's Q-Former and pixel decoder. Every batch's reconstructions
come down to host memory; the sampled batches' tokens and clustering too,
for the check, with the features that the clustering took and its
density-peak scores (which `SeTok.forward` does not return:
harness.keep_cluster keeps them where the tokenizer calls its clustering).
"""

from __future__ import annotations

from h100_bench import check, harness
from h100_bench.roofline import flops as F

PARTS = ("tokenizer", "detokenizer")
ALWAYS = ("recon",)
CHECKED = ("tokens", "token_valid", "idx_cluster", "num_clusters", "score",
           "features")
NUMBERS = ("row1_score", "row1_assign", "token_err", "recon_err")


def build(tok_cfg, det_cfg, **kw):
    from setok_tpu_torch.models.setok import SeTok
    model = SeTok(tok_cfg, det_cfg, **kw)
    model.eval()
    harness.keep_cluster(model.tokenizer,
                         model.__dict__.setdefault("_kept", {}))
    return model


def parts(model) -> dict:
    """The modules that take each part's weights, and the layers whose
    calls the traced run's spans enclose."""
    return {"tokenizer": model.tokenizer, "detokenizer": model.detokenizer}


def forward(model, images, keep: bool = False) -> dict:
    """The outputs of one batch; with `keep` the features too, in host
    memory."""
    kept = model.__dict__["_kept"]
    kept["keep"] = keep
    out = model(images)._asdict()
    out["score"] = kept.pop("score")
    if keep:
        out["features"] = kept.pop("features")
    return out


def flops(cfg: dict) -> dict:
    """The step's operations an image (roofline/flops.py)."""
    return F.total(F.tokenizer_flops(cfg), F.detokenizer_flops(cfg))


def judge(ref: check.Reference, images, got: dict) -> dict:
    """This mode's numbers (check.py) for one block of images."""
    out = check.row1_numbers(ref.config["tokenizer"], got)
    tokens, valid = ref.tokens_given(ref.features(images), got["idx_cluster"])
    out["token_err"] = check.rel_err(got["tokens"], tokens)
    out["recon_err"] = check.rel_err(got["recon"],
                                     ref.reconstruct(tokens, valid))
    return out
