"""How `correct` is decided: the program's outputs against the reference.

For the batches sampled from the window (harness.sample_times), the plain
float32 reference (reference/setok_ref.py) computes, from the same images
and the same weights (redrawn from the seed), and judges what the timed
path produced, in blocks of images. Each traffic mode's file says which of
these numbers it compares (`judge`):

  * `row1_score`: row 1's density-peak scores, judged on the features that
    the program clustered (kept where the clustering is called): the
    reference's DPC-KNN over those same features; per image the median over
    tokens of |score - reference| / the reference's largest score, the
    largest over the images. The median, because a density near-tie moves
    a few tokens' parents.
  * `row1_assign`: the clustering, on the same features. The program's
    centers follow from its own scores by the selection rule (above the
    threshold, at most k_max, or the `min_cluster_num` highest); each
    token's distance to the center the program put it with, less its
    distance to the nearest of those centers, over the image's mean
    distance; the mean over a block's tokens, the largest over the blocks.
    1 where the program's cluster count or slots break the rule.
  * `token_err`: the concept tokens, and with them the features (the start
    that the two numbers above take from the program). The reference runs
    its own ViT, and the tokenizer's stages past the clustering under the
    program's clustering (a tie decided the other way would move every
    later slot); each image's ||tokens - reference|| / ||reference||, the
    largest over the images.
  * `recon_err`: the reference's detokenizer on those tokens; each image's
    ||recon - reference|| / ||reference||, the largest.

A cell compares the numbers that its file's `limits` name, each with its
limit, set between the readings of sound runs and of the control that its
file's `controls` names for it (PERF.md):

  * "quant8": the program's own int8 form (`quant8=True`);
  * "w4a8": the reference in the program's place, its block linears on int4
    weights and int8 inputs (reference/setok_ref.Ref);
  * "fp8-features": the clustering stage one step below the bfloat16
    features it takes: the reference's DPC-KNN over the program's features
    rounded to float8 e4m3 in the program's place (`fp8_clustering`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from h100_bench import weights
from h100_bench.reference import setok_ref as R

CONTROLS = ("quant8", "w4a8", "fp8-features")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over the leading axis of ||got - want|| / ||want||."""
    b = want.shape[0]
    d = (got.float() - want).reshape(b, -1).norm(dim=1)
    return (d / want.reshape(b, -1).norm(dim=1).clamp_min(1e-30)).max().item()


def score_median(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over images (B, N) of the median over tokens of
    |got - want| / max|want|."""
    e = (got - want).abs() / want.abs().amax(1, keepdim=True).clamp_min(1e-30)
    return e.quantile(0.5, dim=1).max().item()


def assignment_gap(score, idx, num, dist, t) -> float:
    """The mean gap of the program's assignment over a block of images
    (see the module's text)."""
    total = 0.0
    n = dist.shape[-1]
    for i in range(score.shape[0]):
        centers = R.select_centers(score[i], t)
        k = centers.numel()
        if k != int(num[i]) or int(idx[i].min()) < 0 or int(idx[i].max()) >= k:
            return 1.0
        d = dist[i][centers]                            # (k, N)
        gap = d.gather(0, idx[i][None]).squeeze(0) - d.amin(0)
        total += (gap.mean() / (dist[i].sum() / (n * (n - 1)))).item()
    return total / score.shape[0]


def row1_numbers(t: dict, got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """`row1_score` and `row1_assign` of one block: the program's clustering
    against the reference's over the features the program clustered."""
    with R.no_tf32(), torch.no_grad():
        cl = R.cluster(got["features"].float(), t)
        score = got["score"].float()
        return {"row1_score": score_median(score, cl["score"]),
                "row1_assign": assignment_gap(
                    score, got["idx_cluster"].long(), got["num_clusters"],
                    cl["dist"], t)}


def fp8_clustering(t: dict, got: Dict[str, torch.Tensor]) -> dict:
    """The "fp8-features" control: `got` with its clustering replaced by the
    reference's over its features rounded to float8 e4m3 (one scale a
    token)."""
    with R.no_tf32(), torch.no_grad():
        cl = R.cluster(R.fp8(got["features"].float(), -1), t)
    return dict(got, score=cl["score"], idx_cluster=cl["idx"],
                num_clusters=cl["num"])


class Reference:
    """The reference's float32 weights of one configuration and seed, drawn
    as the program's were (weights.py), for the model's `parts`, on
    `device`; `quant` computes it in a lower precision, for a control."""

    def __init__(self, config: dict, seed: int, parts: Sequence[str], device,
                 quant: Optional[str] = None):
        spec = R.param_spec(config)
        dtype = getattr(torch, config["param_dtype"])
        self.config = config
        self.tok = R.Ref(weights.draw_f32(spec["tokenizer"], seed,
                                          "tokenizer", dtype, device), quant)
        self.det = (R.Ref(weights.draw_f32(spec["detokenizer"], seed,
                                           "detokenizer", dtype, device),
                          quant) if "detokenizer" in parts else None)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        with R.no_tf32(), torch.no_grad():
            return R.features(self.tok, self.config, images)

    def tokens_given(self, x: torch.Tensor, idx: torch.Tensor):
        with R.no_tf32(), torch.no_grad():
            return R.tokens_given(self.tok, self.config, x, idx.long())

    def reconstruct(self, tokens: torch.Tensor, valid: torch.Tensor):
        with R.no_tf32(), torch.no_grad():
            return R.reconstruct(self.det, self.config["detokenizer"], tokens,
                                 valid)

    def outputs(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's own outputs (its own clustering): what a control
        puts in the program's place."""
        x = self.features(images)
        with R.no_tf32(), torch.no_grad():
            cl = R.cluster(x, self.config["tokenizer"])
        tokens, valid = self.tokens_given(x, cl["idx"])
        out = {"tokens": tokens, "token_valid": valid, "features": x,
               "idx_cluster": cl["idx"], "num_clusters": cl["num"],
               "score": cl["score"]}
        if self.det is not None:
            out["recon"] = self.reconstruct(tokens, valid)
        return out


def judge_batches(judge: Callable, batches, block: int) -> Dict[str, float]:
    """The largest of each number over [(images, outputs)], judged in
    blocks of `block` images by `judge(images, outputs)`; the outputs are
    moved to the images' device first."""
    worst: Dict[str, float] = {}
    for images, got in batches:
        for s in range(0, images.shape[0], block):
            part = {k: v[s:s + block].to(images.device)
                    for k, v in got.items()}
            for k, v in judge(images[s:s + block], part).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst
