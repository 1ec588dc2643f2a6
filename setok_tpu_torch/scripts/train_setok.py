"""Stage-1 SeTok training CLI, on the card.

    python -m setok_tpu_torch.scripts.train_setok --synthetic 64 \
        --synthetic-structured --steps 20 --batch-size 24
    python -m setok_tpu_torch.scripts.train_setok --cpu --tiny \
        --synthetic 16 --synthetic-structured --steps 3 --batch-size 2 \
        --image-size 32

Trains `Stage1Trainer` (train/stage1.py) with random weights from
`--seed`: `--tiny` runs the test configuration, otherwise ViT-B/16
(`base_tokenizer()` / `base_detokenizer()`) at `--image-size`, with the
JAX CLI's clamps for `--merge-layer`, `--detok-patch` and `--detok-depth`.
The defaults are `scripts/train_setok.sh`'s: batch 24, lr 1e-3,
`--min-cluster-num` 64, threshold 0.55, `--k-max` 80, clip 1.0, warm-up
100, `--disc-start` 5000, bf16 compute over float32 parameters. Prints one
JSON line of metrics per step.

Data: `--synthetic N` as the JAX CLI draws it, N structured images
(`--synthetic-structured`, utils/synthetic.py) or uniform noise, each
image with a frozen caption embedding (one table row per image, drawn from
seed + 1), so that the contrastive task is learnable.

The flags are the JAX CLI's (`scripts/train_setok.py`). Those that need
modules the port lacks raise `NotImplementedError` naming their ROADMAP.md
entry: real data, checkpoints (`--resume`, `--checkpoint-every`,
`--output-dir`), LPIPS weights and the compilation cache; the trainer
refuses 8-bit moments and optimizer offload.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.utils.synthetic import structured_images

DATA = "real data: ROADMAP.md, Queue A (checkpoint and data)"
CKPT = "checkpoints: ROADMAP.md, Queue A (checkpoint and data)"
# the JAX CLI's flags that this port does not run
REFUSED = {
    "data_path": DATA, "image_folder": DATA, "tokenizer": DATA,
    "task_type": DATA, "num_workers": DATA, "no_native_preprocess": DATA,
    "output_dir": CKPT, "resume": CKPT, "checkpoint_every": CKPT,
    "lpips_weights": "LPIPS weights (scripts/port_weights.py): ROADMAP.md, "
                     "Queue A (remaining scripts and utils)",
    "compile_cache": "the compilation cache: ROADMAP.md, Queue A "
                     "(remaining scripts and utils)",
}
FLAGS = ("no_native_preprocess", "resume")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples (the only data the "
                        "port reads)")
    p.add_argument("--synthetic-structured", action="store_true",
                   help="synthetic = coloured shapes over gradients "
                        "(utils/synthetic.py) instead of uniform noise")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--max-grad-norm", type=float, default=1.0,
                   help="global-norm gradient clip; 0 disables")
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--min-cluster-num", type=int, default=64)
    p.add_argument("--threshold", type=float, default=None,
                   help="cluster threshold; default the config's (0.55)")
    p.add_argument("--k-max", type=int, default=80)
    p.add_argument("--detok-patch", type=int, default=None)
    p.add_argument("--merge-layer", type=int, default=None,
                   help="2x2 token merge after this ViT block; the cluster "
                        "knobs are clamped to the merged patch count")
    p.add_argument("--detok-depth", type=int, default=None)
    p.add_argument("--disc-start", type=int, default=5000)
    p.add_argument("--lpips", action="store_true",
                   help="the LPIPS term (random VGG-16 weights)")
    p.add_argument("--optim-bits", type=int, default=32, choices=[32, 8],
                   help="8 is not ported (the trainer refuses it)")
    p.add_argument("--offload-optimizer", action="store_true",
                   help="not ported (the trainer refuses it)")
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    for name in REFUSED:
        if name in FLAGS:
            p.add_argument("--" + name.replace("_", "-"),
                           action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument("--" + name.replace("_", "-"), default=None,
                           help=argparse.SUPPRESS)
    return p.parse_args(argv)


def check_ported(args) -> None:
    for name, why in REFUSED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported: {why}")
    if not args.synthetic:
        raise NotImplementedError(f"only --synthetic data is ported: {DATA}")


def configs(args):
    """The tokenizer and detokenizer configurations, clamped as the JAX
    CLI clamps them."""
    if args.tiny:
        patch = max(args.image_size // 4, 8)
        tok = cfgs.tiny_tokenizer(args.image_size, patch)
        det = cfgs.tiny_detokenizer(args.image_size, patch)
        if args.merge_layer is not None:
            vit = cfgs.replace(tok.vit, merge_layer=args.merge_layer)
            n_out = vit.num_output_patches
            k_max = min(tok.k_max, n_out)
            tok = cfgs.replace(tok, vit=vit, k_max=k_max,
                               min_cluster_num=min(tok.min_cluster_num,
                                                   k_max),
                               knn=min(tok.knn, n_out))
        if args.threshold is not None:
            tok = cfgs.replace(tok, threshold=args.threshold)
    else:
        vit = cfgs.replace(cfgs.ViTConfig(), image_size=args.image_size,
                           merge_layer=args.merge_layer)
        n_out = vit.num_output_patches
        base = cfgs.base_tokenizer()
        k_max = min(args.k_max, n_out)
        tok = cfgs.replace(
            base, vit=vit, min_cluster_num=min(args.min_cluster_num, k_max),
            threshold=(base.threshold if args.threshold is None
                       else args.threshold),
            k_max=k_max, knn=min(base.knn, n_out))
        det = cfgs.replace(cfgs.base_detokenizer(),
                           image_size=args.image_size)
    if args.detok_patch is not None:
        if args.image_size % args.detok_patch:
            raise SystemExit(f"--detok-patch {args.detok_patch} must divide "
                             f"--image-size {args.image_size}")
        det = cfgs.replace(det, patch_size=args.detok_patch)
    if args.detok_depth is not None:
        if args.detok_depth < 1:
            raise SystemExit("--detok-depth must be >= 1")
        det = cfgs.replace(det, decoder_depth=args.detok_depth)
    return tok, det


def synthetic_batches(args, text_dim: int):
    """The JAX CLI's synthetic stream: numpy batches of comp_image =
    gen_image (B, S, S, 3) and text_emb (B, text_dim)."""
    rs = np.random.RandomState(args.seed)
    n, bs, size = args.synthetic, args.batch_size, args.image_size
    pool = (structured_images(n, size, seed=args.seed)
            if args.synthetic_structured else None)
    # one frozen caption embedding per image: a learnable contrastive task
    temb = np.random.RandomState(args.seed + 1).randn(
        n, text_dim).astype(np.float32)
    while True:
        r = np.random.RandomState(rs.randint(0, n))
        if pool is not None:
            pick = rs.randint(0, n, size=bs)
            img, te = pool[pick], temb[pick]
        else:
            # noise images keyed by the draw, with their own embeddings
            img = (r.rand(bs, size, size, 3) * 2 - 1).astype(np.float32)
            te = r.randn(bs, text_dim).astype(np.float32)
        yield {"comp_image": img, "gen_image": img, "text_emb": te}


def build(args):
    """The trainer of the parsed flags (random weights from --seed, its
    optimizers ready) and its synthetic batch stream."""
    check_ported(args)
    tok, det = configs(args)
    train_cfg = cfgs.TrainConfig(
        learning_rate=args.learning_rate, max_grad_norm=args.max_grad_norm,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        batch_size=args.batch_size, seed=args.seed,
        grad_accum_steps=args.grad_accum_steps)
    trainer = Stage1Trainer(
        tok, det, gan_cfg=cfgs.GANLossConfig(disc_start=args.disc_start),
        contrastive_cfg=cfgs.ContrastiveLossConfig(
            text_embed_dim=tok.token_feat_dim),
        train_cfg=train_cfg, use_lpips=args.lpips,
        offload_optimizer=args.offload_optimizer, optim_bits=args.optim_bits,
        device="cpu" if args.cpu else None)
    trainer.init_weights_(args.seed)
    trainer.init_state()
    return trainer, synthetic_batches(args, tok.token_feat_dim)


def main(argv=None) -> None:
    args = parse_args(argv)
    trainer, batches = build(args)
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(batches).items()}
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        print(json.dumps({"step": step, "updates": trainer.updates,
                          "seconds": time.perf_counter() - t0, **metrics}),
              flush=True)


if __name__ == "__main__":
    main()
