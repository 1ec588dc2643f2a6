"""Stage-2/3 Setokim training CLI, on the card.

    python -m setok_tpu_torch.scripts.train_setokim --synthetic --lora-enable \
        --lora-r 128 --lora-alpha 256 --mm-in-projector-lr 2e-5 \
        --learning-rate 2e-4 --use-flash --batch-size 4 --steps 6 \
        --grad-accum-steps 2
    python -m setok_tpu_torch.scripts.train_setokim --cpu --tiny --synthetic
    python -m setok_tpu_torch.scripts.train_setokim --task-type instruction \
        --dataset-name llava --data-path llava.json --image-folder images \
        --lora-enable --lora-r 128 --use-flash --batch-size 4

Trains `Stage2Trainer` (train/stage2.py) with random weights from
`--seed`: `--tiny` runs the test configuration, otherwise the
full-width `base_setokim()` (Vicuna-7B trunk, ViT-B/16 SeTok). `--steps`
counts micro-batches, as the JAX CLI's does; every `--grad-accum-steps`-th
makes an optimizer update. Prints one JSON line of losses per step.

Data, as the JAX CLI reads it, tokenized by `--tokenizer` (a local HF
tokenizer directory, or the word-hash fallback over the vocabulary less 8)
with `<target>` added as a special token, whose id the trainer gathers on:
  --task-type pair         a cc3m-style json (`--data-path`), each record a
                           generation conversation (`TextImagePairDataset`);
  --task-type edit         a json of {source_image, target_image,
                           instruction} records (`EditingDataset`);
  --task-type instruction  LLaVA-form jsons, one per `--dataset-name` and
                           `--data-path` (and `--image-folder`), mixed by
                           `--data-multiple` (`InstructionTuningDataset`).
`--image-folder` prefixes the image paths of every task (the JAX CLI
passes it only to the instruction task). `Collator` lays each row out
in `--model-max-length` slots, a `BatchLoader` assembles batches on
`--num-workers` threads (a new permutation every epoch, seed + epoch) and
a `DeviceLoader` copies them to the card ahead of the step; images are
resized by the C++ resize + normalize of `data/native.py` unless
`--no-native-preprocess` (PIL, bicubic).

Or `--synthetic`: a synthetic batch fills `--model-max-length` slots per
row: BOS, one image's k_max slots, a text prompt, target_num `<target>`
slots and a text answer, then pads; each row's valid length is drawn
between half the length and the whole. The answer and the `<target>` slots carry labels.
The JAX CLI's own synthetic batch is cut to 48 slots and runs only with
`--tiny` (ROADMAP.md, Queue C).

Weights: random from `--seed`, then the four `--pretrain-*` `.npz` files
(the vision tokenizer, the vision detokenizer, the in and out projectors),
each loaded by path suffix (`utils/porting.load_flat_into`: keys 'a/b/c'
or flax `keystr`, arrays in the flax layout), as the JAX CLI stages them.
Checkpoints: with `--output-dir`, `<dir>/checkpoints/<step>/` (the
'params', 'lora' and 'train' parts, `utils/checkpoint.CheckpointRunner`)
every `--checkpoint-every` micro-batches and at the last, the directory
`models/builder.load_pretrained_model` reads; a run resumes from the
newest step there (the batch stream skips the batches already taken)
unless `--no-resume`; each step's metrics go to one JSON line of
`<dir>/metrics.jsonl` (`utils/logging.MetricsLogger`). Without
`--output-dir` nothing is written (the JAX CLI defaults to a directory
under /tmp).

The flags are the JAX CLI's (`scripts/train_setokim.py`). `--bits 8` is
QLoRA (with `--lora-enable`: the trunk's targeted linears int8 under the
adapters, train/qlora.py), `--optim-bits 8` gives the trained groups int8
Adam moments (train/opt8.py; the embedding table keeps 32-bit AdamW) and
`--unfreeze-mm-vision-tower` trains the vision tower's part above its
frozen backbone; a checkpoint of each resumes (the int8 base and its
scales, the int8 moments and theirs).

Parallelism, under `torchrun --nproc-per-node N` (one process per card;
with `--cpu`, gloo processes), as the JAX CLI builds its mesh over the
devices: `--tensor-parallel T` a (N/T, T) (data, model) mesh, the trunk
Megatron-split over `model` and the rest FSDP-sharded over `data`;
`--sequence-parallel S` a (N/S, S) (data, seq) mesh, ring attention over
`seq` (exclusive with `--tensor-parallel`, as in JAX); neither, every rank
on `data`. `--batch-size` is the global batch; each data rank takes its
rows (the ranks of a `model` or `seq` group the same ones). At one process
the mesh has size 1 and the flags change nothing, as the JAX CLI's on one
device. Only the first rank prints and writes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.constants import (DEFAULT_TARGET_TOKEN, IGNORE_INDEX,
                                       IMAGE_TOKEN_INDEX)
from setok_tpu_torch.data.collator import Collator
from setok_tpu_torch.data.datasets import (EditingDataset,
                                           InstructionTuningDataset,
                                           TextImagePairDataset, load_cc3m)
from setok_tpu_torch.data.image_processing import (GeneratorImageProcessor,
                                                   ImageProcessor)
from setok_tpu_torch.data.tokenizer import load_text_tokenizer
from setok_tpu_torch.scripts.train_setok import (data_loader,
                                                 parallel_setup, run_steps,
                                                 shard_stream)
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils.compile_cache import (add_cli_flag,
                                                 enable_compilation_cache)
from setok_tpu_torch.utils.init import init_setokim_random_
from setok_tpu_torch.utils.porting import load_flat_into

TARGET_TOKEN_ID = 3
PRETRAIN = ("vision_tokenizer", "vision_detokenizer", "mm_in_mlp_adapter",
            "mm_out_mlp_adapter")
logger = logging.getLogger("train_setokim")

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


def synthetic_batches(cfg, args):
    """`synthetic_batch` after `synthetic_batch`, drawn from --seed."""
    rs = np.random.RandomState(args.seed)
    while True:
        yield synthetic_batch(cfg, args.batch_size, args.model_max_length, rs)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-path", nargs="*", default=None)
    p.add_argument("--dataset-name", nargs="*", default=None)
    p.add_argument("--image-folder", nargs="*", default=None)
    p.add_argument("--data-multiple", nargs="*", type=float, default=None)
    p.add_argument("--task-type", default="instruction",
                   choices=["pair", "instruction", "edit"])
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer directory (word-hash fallback)")
    p.add_argument("--num-workers", type=int, default=8,
                   help="batch-assembly worker threads (real data)")
    p.add_argument("--no-native-preprocess", action="store_true",
                   help="PIL instead of the C++ resize + normalize")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches instead of a dataset")
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
    p.add_argument("--tensor-parallel", type=int, default=1)
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="shard the sequence over a ring-attention mesh "
                        "axis; exclusive with --tensor-parallel")
    p.add_argument("--output-dir", default=None,
                   help="checkpoints under <dir>/checkpoints (none without)")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true", default=True,
                   help="resume from the newest checkpoint (the default)")
    p.add_argument("--no-resume", dest="resume", action="store_false")
    for name in PRETRAIN:
        p.add_argument(f"--pretrain-{name.replace('_', '-')}", default=None,
                       help="an .npz of flat weights, loaded by path "
                            "suffix")
    add_cli_flag(p)
    args = p.parse_args(argv)
    if args.sequence_parallel > 1 and args.tensor_parallel > 1:
        p.error("--sequence-parallel and --tensor-parallel are mutually "
                "exclusive (one trunk mesh)")
    if args.synthetic == bool(args.data_path):
        p.error("give one of --synthetic and --data-path")
    if (args.data_path and args.task_type == "instruction"
            and len(args.dataset_name or ()) != len(args.data_path)):
        p.error("--task-type instruction takes one --dataset-name per "
                "--data-path")
    return args


def text_tokenizer(args, cfg):
    """The text tokenizer over the vocabulary less 8, with `<target>`
    registered as a special token, and that token's id."""
    tok = load_text_tokenizer(args.tokenizer,
                              vocab_size=cfg.llama.vocab_size - 8)
    tok.add_tokens([DEFAULT_TARGET_TOKEN], special_tokens=True)
    return tok, int(tok.convert_tokens_to_ids(DEFAULT_TARGET_TOKEN))


def _in_folder(folder: str, path: str) -> str:
    return os.path.join(folder, path) if folder else path


def dataset(args, cfg, tokenizer):
    """The dataset of `--task-type` over `--data-path`."""
    size = cfg.tokenizer.vit.image_size
    native = not args.no_native_preprocess
    kw = dict(image_processor=ImageProcessor(size=size, use_native=native),
              gen_processor=GeneratorImageProcessor(size=size,
                                                    use_native=native),
              target_num=cfg.target_num)
    folder = args.image_folder[0] if args.image_folder else ""
    if args.task_type == "pair":
        return TextImagePairDataset(load_cc3m(args.data_path[0], folder),
                                    tokenizer, task_type="generation", **kw)
    if args.task_type == "edit":
        with open(args.data_path[0]) as f:
            records = [{**r, "source_image": _in_folder(folder,
                                                        r["source_image"]),
                        "target_image": _in_folder(folder, r["target_image"])}
                       for r in json.load(f)]
        return EditingDataset(records, tokenizer, **kw)
    return InstructionTuningDataset(
        args.dataset_name, args.data_path, tokenizer,
        image_folders=args.image_folder, data_multiple=args.data_multiple,
        **kw)


def build(args):
    """The trainer of the parsed flags (random weights from --seed, the
    `--pretrain-*` files loaded, its optimizer ready, sharded over the
    mesh under torchrun) and its batch stream: the `DeviceLoader` of
    `--data-path`, or the synthetic numpy batches (this data rank's rows
    of each)."""
    dev, mesh, ring = parallel_setup(args.cpu, args.tensor_parallel,
                                     args.sequence_parallel)
    cfg = cfgs.tiny_setokim() if args.tiny else cfgs.base_setokim()
    target_id, tokenizer = TARGET_TOKEN_ID, None
    if args.data_path:
        tokenizer, target_id = text_tokenizer(args, cfg)
    train_cfg = cfgs.TrainConfig(
        learning_rate=args.learning_rate, max_grad_norm=args.max_grad_norm,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        batch_size=args.batch_size, seed=args.seed,
        grad_accum_steps=args.grad_accum_steps)
    trainer = Stage2Trainer(
        cfg, train_cfg=train_cfg, target_token_id=target_id,
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
        mesh=mesh, ring_mesh=ring, device=dev)
    init_setokim_random_(trainer.model, args.seed)
    for name in PRETRAIN:
        path = getattr(args, f"pretrain_{name}")
        if path:
            flat = dict(np.load(path))
            unmatched = load_flat_into(trainer.model, flat)
            logger.warning("loaded %s (%d arrays, %d unmatched)", path,
                           len(flat), len(unmatched))
    trainer.init_state(args.seed + 1)
    if not args.data_path:
        return trainer, shard_stream(synthetic_batches(cfg, args),
                                     trainer.data_mesh)
    return trainer, data_loader(
        args, dataset(args, cfg, tokenizer),
        Collator(max_len=args.model_max_length, k_max=cfg.tokenizer.k_max),
        trainer.model.device, trainer.data_mesh)


def main(argv=None) -> None:
    args = parse_args(argv)
    enable_compilation_cache(args.compile_cache)
    trainer, batches = build(args)
    batches = iter(batches)
    dev = trainer.model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    run_steps(args, trainer, batches, gen, "draws", dev)


if __name__ == "__main__":
    main()
