"""Stage-2/3 Setokim training CLI, on the card.

    python -m setok_tpu_torch.scripts.train_setokim --synthetic --lora-enable \
        --lora-r 128 --lora-alpha 256 --mm-in-projector-lr 2e-5 \
        --learning-rate 2e-4 --use-flash --batch-size 4 --steps 6 \
        --grad-accum-steps 2
    python -m setok_tpu_torch.scripts.train_setokim --cpu --tiny --synthetic

Trains `Stage2Trainer` (train/stage2.py) on synthetic batches with random
weights from `--seed`: `--tiny` runs the test configuration, otherwise the
full-width `base_setokim()` (Vicuna-7B trunk, ViT-B/16 SeTok). `--steps`
counts micro-batches, as the JAX CLI's does; every `--grad-accum-steps`-th
makes an optimizer update. Prints one JSON line of losses per step.

A synthetic batch fills `--model-max-length` slots per row: BOS, one
image's k_max slots, a text prompt, target_num `<target>` slots and a text
answer, then pads; each row's valid length is drawn between half the
length and the whole. The answer and the `<target>` slots carry labels.
The JAX CLI's own synthetic batch is cut to 48 slots and runs only with
`--tiny` (ROADMAP.md, Queue C).

The flags are the JAX CLI's (`scripts/train_setokim.py`); its real-data,
checkpoint, parallel, QLoRA and 8-bit-optimizer flags are refused with a
message naming their ROADMAP.md entry.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils.init import init_setokim_random_

TARGET_TOKEN_ID = 3

# the JAX CLI's flags that this port does not run
REFUSED = {
    "data_path": "real data: ROADMAP.md, Queue A (checkpoint and data)",
    "dataset_name": "real data: ROADMAP.md, Queue A (checkpoint and data)",
    "image_folder": "real data: ROADMAP.md, Queue A (checkpoint and data)",
    "tokenizer": "real data: ROADMAP.md, Queue A (checkpoint and data)",
    "output_dir": "checkpoints: ROADMAP.md, Queue A (checkpoint and data)",
    "pretrain_vision_tokenizer": "checkpoints: ROADMAP.md, Queue A "
                                 "(checkpoint and data)",
    "pretrain_vision_detokenizer": "checkpoints: ROADMAP.md, Queue A "
                                   "(checkpoint and data)",
    "pretrain_mm_in_mlp_adapter": "checkpoints: ROADMAP.md, Queue A "
                                  "(checkpoint and data)",
    "pretrain_mm_out_mlp_adapter": "checkpoints: ROADMAP.md, Queue A "
                                   "(checkpoint and data)",
    "tensor_parallel": "multi-card training: ROADMAP.md, Queue A (parallel)",
    "sequence_parallel": "sequence parallelism: ROADMAP.md, Queue A "
                         "(parallel)",
}


def synthetic_batch(cfg, batch: int, length: int, rs: np.random.RandomState,
                    min_len: int = None):
    """One batch as numpy arrays: input_ids, labels (B, length) int64;
    comp_image = gen_image (B, H, W, 3) float32 in [-1, 1]. Row i holds
    n_i valid slots, n_i drawn in [min_len, length] (default length/2)."""
    k_max, tn = cfg.tokenizer.k_max, cfg.target_num
    vocab, size = cfg.llama.vocab_size, cfg.tokenizer.vit.image_size
    fixed = 1 + k_max + tn
    min_len = max(length // 2 if min_len is None else min_len, fixed + 3)
    if min_len > length:
        raise ValueError(f"model-max-length {length} cannot hold BOS, "
                         f"{k_max} image slots, {tn} target slots and text")
    ids = np.zeros((batch, length), np.int64)
    labels = np.full((batch, length), IGNORE_INDEX, np.int64)
    for i in range(batch):
        n = rs.randint(min_len, length + 1)
        prompt = (n - fixed) // 2
        ids[i, 0] = 1
        ids[i, 1:1 + k_max] = IMAGE_TOKEN_INDEX
        s = 1 + k_max + prompt
        ids[i, 1 + k_max:s] = rs.randint(10, vocab - 10, prompt)
        ids[i, s:s + tn] = labels[i, s:s + tn] = TARGET_TOKEN_ID
        ids[i, s + tn:n] = labels[i, s + tn:n] = rs.randint(
            10, vocab - 10, n - s - tn)
    img = rs.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "comp_image": img,
            "gen_image": img}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches (the only data the port reads)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--model-max-length", type=int, default=2048)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration (default: base_setokim)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--tune-mm-in-mlp-adapter", action="store_true")
    p.add_argument("--tune-mm-out-mlp-adapter", action="store_true")
    p.add_argument("--freeze-mm-in-mlp-adapter", action="store_true")
    p.add_argument("--freeze-mm-out-mlp-adapter", action="store_true")
    p.add_argument("--unfreeze-mm-vision-tower", action="store_true")
    p.add_argument("--mm-in-projector-lr", type=float, default=None)
    p.add_argument("--mm-out-projector-lr", type=float, default=None)
    p.add_argument("--lora-enable", action="store_true")
    p.add_argument("--lora-r", type=int, default=64)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--use-flash", action="store_true",
                   help="the flash-attention kernels in the LLaMA trunk")
    p.add_argument("--optim-bits", type=int, default=32, choices=[32, 8])
    p.add_argument("--bits", type=int, default=16, choices=[16, 8])
    for name in REFUSED:
        p.add_argument("--" + name.replace("_", "-"), default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, why in REFUSED.items():
        if getattr(args, name) is not None:
            p.error(f"--{name.replace('_', '-')} is not ported: {why}")
    if not args.synthetic:
        p.error("only --synthetic data is ported: ROADMAP.md, Queue A "
                "(checkpoint and data)")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = cfgs.tiny_setokim() if args.tiny else cfgs.base_setokim()
    train_cfg = cfgs.TrainConfig(
        learning_rate=args.learning_rate, max_grad_norm=args.max_grad_norm,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        batch_size=args.batch_size, seed=args.seed,
        grad_accum_steps=args.grad_accum_steps)
    trainer = Stage2Trainer(
        cfg, train_cfg=train_cfg, target_token_id=TARGET_TOKEN_ID,
        freeze_backbone=args.freeze_backbone,
        tune_mm_in_mlp_adapter=args.tune_mm_in_mlp_adapter,
        tune_mm_out_mlp_adapter=args.tune_mm_out_mlp_adapter,
        freeze_mm_in_mlp_adapter=args.freeze_mm_in_mlp_adapter,
        freeze_mm_out_mlp_adapter=args.freeze_mm_out_mlp_adapter,
        unfreeze_mm_vision_tower=args.unfreeze_mm_vision_tower,
        mm_in_projector_lr=args.mm_in_projector_lr,
        mm_out_projector_lr=args.mm_out_projector_lr,
        lora_enable=args.lora_enable, lora_r=args.lora_r,
        lora_alpha=args.lora_alpha, quant_base=args.bits == 8,
        use_flash=args.use_flash, optim_bits=args.optim_bits,
        device="cpu" if args.cpu else None)
    init_setokim_random_(trainer.model, args.seed)
    trainer.init_state(args.seed + 1)
    dev = trainer.model.device
    rs = np.random.RandomState(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
            cfg, args.batch_size, args.model_max_length, rs).items()}
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        print(json.dumps({"step": step, "updates": trainer.updates,
                          "seconds": time.perf_counter() - t0, **metrics}),
              flush=True)


if __name__ == "__main__":
    main()
