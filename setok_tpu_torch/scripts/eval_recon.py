"""Reconstruction-quality eval: PSNR / SSIM (+ FID) through SeTok's encode
→ cluster → decode, on the card.

    python -m setok_tpu_torch.scripts.eval_recon --synthetic 64 \
        --synthetic-structured --precision quant8 --fid
    python -m setok_tpu_torch.scripts.eval_recon --tiny --cpu --synthetic 4

The port's counterpart of the JAX package's `scripts/eval_recon.py`, with
its flags. The model is `base_tokenizer()` / `base_detokenizer()`
(`--tiny`: the test configuration at `--image-size`, 256 by default, with
the stage-1 CLI's patch rule), with the clustering, merge and detokenizer
overrides clamped as that script clamps them. `--precision`: `fp32`,
`bf16` (bf16 compute) or `quant8` (the int8 kernels, bench.py's form).
Weights: random from seed 0, then `--checkpoint` (an `.npz` of flax-keyed
arrays, `utils/checkpoint.load_subtree`: a file written by either package's
`save_subtree`) and `--stage1-dir` (the generator's SeTok from the port's
stage-1 checkpoints, `scripts/train_setok.py --output-dir`; only its
parameter file is read). Images: `--synthetic N` (structured shapes with
`--synthetic-structured`, seeded by `--eval-seed`, else uniform noise from
seed 0) or the PNG / JPEG files of `--image-folder` through
`GeneratorImageProcessor`.

`--fid` adds `fid_vitfeat`: FID between the inputs and the
reconstructions, each image's feature the mean of its valid concept tokens
(`SeTok.tokenize`). Prints one JSON line: n, precision, psnr, ssim,
mean_clusters[, fid_vitfeat]. Unlike the JAX script it appends nothing to
`perf/history.jsonl`, whose rows are TPU numbers. `--compile-cache` chooses
the directory of the built kernels (utils/compile_cache.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.compile_cache import (add_cli_flag,
                                                 enable_compilation_cache)
from setok_tpu_torch.utils.init import init_random_
from setok_tpu_torch.utils.metrics import compute_fid, psnr, ssim

PRECISIONS = {"fp32": {}, "bf16": {"dtype": torch.bfloat16},
              "quant8": {"quant8": True}}
SETOK = "['params']['setok']"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image-folder", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--checkpoint", default="",
                   help="an .npz of flax-keyed arrays (save_subtree)")
    p.add_argument("--stage1-dir", default="",
                   help="stage-1 output dir: the trained SeTok from its "
                        "checkpoints")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--fid", action="store_true",
                   help="also FID over the mean valid concept token")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--synthetic-structured", action="store_true",
                   help="synthetic = coloured shapes (utils/synthetic.py)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--min-cluster-num", type=int, default=None)
    p.add_argument("--threshold", type=float, default=None,
                   help="cluster threshold: must match the trained run's")
    p.add_argument("--k-max", type=int, default=None)
    p.add_argument("--merge-layer", type=int, default=None,
                   help="2x2 token merge after this ViT block: must match "
                        "the trained run's (cluster knobs clamped)")
    p.add_argument("--detok-patch", type=int, default=None)
    p.add_argument("--detok-depth", type=int, default=None)
    p.add_argument("--cluster-dist-norm", action="store_true",
                   help="scale-invariant DPC-KNN distances")
    p.add_argument("--eval-seed", type=int, default=10_000,
                   help="seed of the structured synthetic eval set")
    p.add_argument("--precision", default="fp32", choices=list(PRECISIONS))
    add_cli_flag(p)
    args = p.parse_args(argv)
    if not args.synthetic and not args.image_folder:
        p.error("give --synthetic N or --image-folder")
    return args


def configs(args):
    """The tokenizer and detokenizer configurations, overridden and
    clamped as the JAX script does it."""
    if args.tiny:
        size = args.image_size or 256
        patch = max(size // 4, 8)
        tok = cfgs.tiny_tokenizer(size, patch)
        det = cfgs.tiny_detokenizer(size, patch)
    else:
        tok, det = cfgs.base_tokenizer(), cfgs.base_detokenizer()
        if args.image_size:
            tok = cfgs.replace(tok, vit=cfgs.replace(
                tok.vit, image_size=args.image_size))
            det = cfgs.replace(det, image_size=args.image_size)
    over = {k: v for k, v in (("min_cluster_num", args.min_cluster_num),
                              ("threshold", args.threshold),
                              ("k_max", args.k_max)) if v is not None}
    if args.cluster_dist_norm:
        over["cluster_dist_norm"] = True
    if args.merge_layer is not None:
        vit = cfgs.replace(tok.vit, merge_layer=args.merge_layer)
        n_out = vit.num_output_patches
        over["k_max"] = min(over.get("k_max", tok.k_max), n_out)
        over["min_cluster_num"] = min(
            over.get("min_cluster_num", tok.min_cluster_num), over["k_max"])
        over["knn"] = min(tok.knn, n_out)
        over["vit"] = vit               # one replace with the clamps
    if over:
        tok = cfgs.replace(tok, **over)
    if args.detok_patch is not None:
        if det.image_size % args.detok_patch:
            raise SystemExit(f"--detok-patch {args.detok_patch} must divide "
                             f"image size {det.image_size}")
        det = cfgs.replace(det, patch_size=args.detok_patch)
    if args.detok_depth is not None:
        det = cfgs.replace(det, decoder_depth=args.detok_depth)
    return tok, det


def eval_images(args, size: int) -> np.ndarray:
    if args.synthetic:
        if args.synthetic_structured:
            from setok_tpu_torch.utils.synthetic import structured_images
            return structured_images(args.synthetic, size,
                                     seed=args.eval_seed)
        rs = np.random.RandomState(0)
        return (rs.rand(args.synthetic, size, size, 3) * 2 - 1).astype(
            np.float32)
    from PIL import Image

    from setok_tpu_torch.data.image_processing import GeneratorImageProcessor
    proc = GeneratorImageProcessor(size=size)
    paths = sorted(sum((glob.glob(os.path.join(args.image_folder, e))
                        for e in ("*.jpg", "*.png", "*.jpeg")), []))
    if args.limit:
        paths = paths[:args.limit]
    if not paths:
        raise SystemExit(f"no images under {args.image_folder}")
    return np.stack([proc(Image.open(p)) for p in paths])


def load_stage1_setok(model: SeTok, stage1_dir: str) -> None:
    """The generator's SeTok of the newest stage-1 checkpoint under
    `stage1_dir` (or `stage1_dir/checkpoints`), strictly."""
    cdir = (stage1_dir if ckpt.latest_step(stage1_dir) is not None
            else os.path.join(stage1_dir, "checkpoints"))
    if ckpt.latest_step(cdir) is None:
        raise SystemExit(f"no checkpoint under {stage1_dir}")
    params = ckpt.restore_lazy(cdir, lambda name: name.startswith(SETOK),
                               map_location=next(model.parameters()).device)
    state = {k[len("setok."):]: v for k, v in params["params"].items()}
    model.load_state_dict(state, strict=True)


def build_model(args, device=None) -> SeTok:
    """The SeTok of the flags: configuration, precision and weights."""
    tok, det = configs(args)
    model = init_random_(SeTok(tok, det, device=device,
                               **PRECISIONS[args.precision]), 0)
    if args.checkpoint:
        ckpt.load_subtree(args.checkpoint, model)
    if args.stage1_dir:
        load_stage1_setok(model, args.stage1_dir)
    return model


@torch.no_grad()
def evaluate(model: SeTok, images: np.ndarray, batch_size: int,
             fid: bool) -> dict:
    """PSNR, SSIM and the mean cluster count per batch, averaged over the
    batches as the JAX script averages them; with `fid`, `fid_vitfeat`."""
    dev = next(model.parameters()).device
    recons, psnrs, ssims, ncs = [], [], [], []
    for i in range(0, len(images), batch_size):
        x = torch.from_numpy(images[i:i + batch_size]).to(dev)
        out = model(x)
        recons.append(out.recon.float().cpu().numpy())
        psnrs.append(float(psnr(out.recon, x)))
        ssims.append(float(ssim(out.recon, x)))
        ncs.append(float(out.num_clusters.float().mean()))
    result = {"n": int(len(images)), "psnr": float(np.mean(psnrs)),
              "ssim": float(np.mean(ssims)),
              "mean_clusters": float(np.mean(ncs))}
    if fid:
        def feats(imgs):
            tok = model.tokenize(torch.from_numpy(np.ascontiguousarray(
                imgs)).to(dev))
            valid = tok.token_valid
            denom = valid.sum(-1, keepdim=True).clamp_min(1)
            pooled = ((tok.tokens * valid[..., None]).sum(1) / denom)
            return pooled.float().cpu().numpy()
        result["fid_vitfeat"] = compute_fid(images, np.concatenate(recons),
                                            feats, batch_size=batch_size)
    return result


def main(argv=None) -> dict:
    args = parse_args(argv)
    enable_compilation_cache(args.compile_cache)
    model = build_model(args, "cpu" if args.cpu else None)
    images = eval_images(args, model.tokenizer.cfg.vit.image_size)
    res = evaluate(model, images, args.batch_size, args.fid)
    result = {"n": res.pop("n"), "precision": args.precision, **res}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
