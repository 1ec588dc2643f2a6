"""Stage-1 SeTok training CLI, on the card.

    python -m setok_tpu_torch.scripts.train_setok --synthetic 64 \
        --synthetic-structured --steps 20 --batch-size 24
    python -m setok_tpu_torch.scripts.train_setok --cpu --tiny \
        --synthetic 16 --synthetic-structured --steps 3 --batch-size 2 \
        --image-size 32
    python -m setok_tpu_torch.scripts.train_setok --data-path cc3m.json \
        --image-folder images --steps 20 --disc-start 0

Trains `Stage1Trainer` (train/stage1.py) with random weights from
`--seed`: `--tiny` runs the test configuration, otherwise ViT-B/16
(`base_tokenizer()` / `base_detokenizer()`) at `--image-size`, with the
JAX CLI's clamps for `--merge-layer`, `--detok-patch` and `--detok-depth`.
The defaults are `scripts/train_setok.sh`'s: batch 24, lr 1e-3,
`--min-cluster-num` 64, threshold 0.55, `--k-max` 80, clip 1.0, warm-up
100, `--disc-start` 5000, bf16 compute over float32 parameters. Prints one
JSON line of metrics per step.

Data: `--data-path` (a cc3m-style JSON of {image, caption} records, or a
directory of them; image paths under `--image-folder`), as the JAX CLI
reads it: `TextImagePairDataset` (`--task-type` caption or generation,
the captions tokenized by `--tokenizer`, a local HF tokenizer directory,
or the word-hash fallback, also for the contrastive tower, which then
encodes `input_ids_for_contrastive`), `Collator(max_len=77)`, a
`BatchLoader` over `--num-workers` threads (a new permutation every epoch,
seed + epoch) and a `DeviceLoader` that copies each batch to the card
ahead of the step. Images are resized by the C++ resize + normalize of
`data/native.py` unless `--no-native-preprocess` (PIL, bicubic). Or
`--synthetic N` as the JAX CLI draws it, N structured images
(`--synthetic-structured`, utils/synthetic.py) or uniform noise, each
image with a frozen caption embedding (one table row per image, drawn from
seed + 1), so that the contrastive task is learnable.

Checkpoints: with `--output-dir`, `<dir>/checkpoints/<step>/` through
`utils/checkpoint.CheckpointRunner` (background writes after a copy to
the host, a SIGTERM hook) every `--checkpoint-every` micro-batches and at
the last, and each step's metrics as one JSON line of
`<dir>/metrics.jsonl` (`utils/logging.MetricsLogger`); a run finds its
newest step there and resumes from it (the trainer's parameters, Adam
moments, counts, accumulated gradients and the dropout generator; the
batch stream skips the batches already taken), unless `--no-resume`.
Without `--output-dir` nothing is written (the JAX CLI defaults to a
directory under /tmp).

The flags are the JAX CLI's (`scripts/train_setok.py`). `--lpips-weights`
(an `.npz` of `scripts/port_weights.py`'s `vgg16` and `lpips_lins`
porters, either package's) is loaded into the LPIPS net by path suffix
(`utils/porting.load_flat_into`, a warning for unmatched keys) when
`--lpips` is given, and ignored without it, as in JAX; a resume restores
the checkpoint's LPIPS weights over it. `--compile-cache` chooses the
directory of the built kernels (utils/compile_cache.py). `--optim-bits 8`
gives the generator int8 Adam moments (train/opt8.py);
`--offload-optimizer` keeps both optimizers' moments in pinned host memory
between steps (parallel/sharding.HostOffload).

Data parallelism, as the JAX CLI's mesh over every device: run under
`torchrun --nproc-per-node N` (one process per card; with `--cpu`, gloo
processes). The state is FSDP-sharded over the N data ranks
(parallel/sharding.Fsdp), `--batch-size` is the global batch and each rank
takes its rows of it; only the first rank prints and writes (a save
gathers the slices; a resume reads each rank's own).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.data.collator import Collator
from setok_tpu_torch.data.datasets import TextImagePairDataset, load_cc3m
from setok_tpu_torch.data.image_processing import (GeneratorImageProcessor,
                                                   ImageProcessor)
from setok_tpu_torch.data.loader import (BatchLoader, DeviceLoader,
                                         batch_rows, data_coordinates)
from setok_tpu_torch.data.tokenizer import load_text_tokenizer
from setok_tpu_torch.parallel.mesh import (initialize_multihost,
                                           local_device, make_mesh,
                                           make_sp_mesh)
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.utils.checkpoint import (CheckpointRunner,
                                              restore_sharded)
from setok_tpu_torch.utils.compile_cache import (add_cli_flag,
                                                 enable_compilation_cache)
from setok_tpu_torch.utils.logging import MetricsLogger
from setok_tpu_torch.utils.porting import load_flat_into
from setok_tpu_torch.utils.synthetic import structured_images

# the contrastive text tower's vocabulary (stage-1 text feeds only it)
TEXT_VOCAB = 32000
# the collator's static text length: CLIP's context
TEXT_LEN = 77
logger = logging.getLogger("train_setok")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-path", default=None,
                   help="cc3m-style json (or a directory of jsons)")
    p.add_argument("--image-folder", default="")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples instead of a dataset")
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
                   help="the LPIPS term (random VGG-16 weights unless "
                        "--lpips-weights)")
    p.add_argument("--lpips-weights", default=None,
                   help="an .npz of ported VGG-16 + LPIPS lin weights "
                        "(scripts/port_weights.py), with --lpips")
    p.add_argument("--optim-bits", type=int, default=32, choices=[32, 8],
                   help="8: the generator's Adam moments int8 in blocks "
                        "of 256 (train/opt8.py)")
    p.add_argument("--offload-optimizer", action="store_true",
                   help="both optimizers' moments in pinned host memory "
                        "between steps")
    p.add_argument("--task-type", default="caption",
                   choices=["caption", "generation"])
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer directory (word-hash fallback)")
    p.add_argument("--num-workers", type=int, default=8,
                   help="batch-assembly worker threads (real data)")
    p.add_argument("--no-native-preprocess", action="store_true",
                   help="PIL instead of the C++ resize + normalize")
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--output-dir", default=None,
                   help="checkpoints under <dir>/checkpoints (none without)")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true", default=True,
                   help="resume from the newest checkpoint (the default)")
    p.add_argument("--no-resume", dest="resume", action="store_false")
    add_cli_flag(p)
    return p.parse_args(argv)


def check_args(args) -> None:
    if bool(args.synthetic) == bool(args.data_path):
        raise SystemExit("give one of --synthetic N and --data-path")


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


def dataset(args) -> TextImagePairDataset:
    """The JAX CLI's dataset of `--data-path`."""
    native = not args.no_native_preprocess
    return TextImagePairDataset(
        load_cc3m(args.data_path, args.image_folder),
        load_text_tokenizer(args.tokenizer, vocab_size=TEXT_VOCAB),
        contrastive_tokenizer=load_text_tokenizer(args.tokenizer,
                                                  vocab_size=TEXT_VOCAB),
        task_type=args.task_type,
        image_processor=ImageProcessor(size=args.image_size,
                                       use_native=native),
        gen_processor=GeneratorImageProcessor(size=args.image_size,
                                              use_native=native))


def epochs(loader: BatchLoader, seed: int):
    """`loader`'s array batches without end, epoch e drawn from seed + e.
    Passthrough keys such as 'caption' stay behind."""
    epoch = 0
    while True:
        loader.seed = seed + epoch
        n = 0
        for b in loader:
            n += 1
            yield {k: v for k, v in b.items() if isinstance(v, np.ndarray)}
        if not n:
            raise ValueError(f"{len(loader.dataset)} records make no batch "
                             f"of {loader.batch_size}")
        epoch += 1


def data_loader(args, ds, collate, device, mesh=None) -> DeviceLoader:
    """`ds`'s collated batches over `--num-workers` threads, epoch after
    epoch, their arrays copied to `device` ahead of the step. Under a
    mesh, each data rank assembles its rows of every global batch of
    `--batch-size`."""
    loader = BatchLoader(ds, args.batch_size, collate,
                         num_workers=args.num_workers, seed=args.seed,
                         shard=data_coordinates(mesh))
    return DeviceLoader(epochs(loader, args.seed), device, prefetch=2)


def parallel_setup(cpu: bool, tp: int = 1, sp: int = 1):
    """Under `torchrun` (one process per card, or per CPU process with
    --cpu): the process group (NCCL on the card, gloo on the CPU), this
    rank's device and the mesh, as the JAX CLIs build theirs over the
    devices: (data, seq) for sp > 1, else (data, model). → (device, mesh,
    ring_mesh); one process: (device, None, None)."""
    dev = local_device(cpu)
    initialize_multihost(device=dev)
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    sp, tp = min(sp, world), min(tp, world)
    if world == 1:
        return dev, None, None
    if sp > 1:
        return dev, None, make_sp_mesh(world // sp, sp)
    return dev, make_mesh(cfgs.MeshConfig(data=world // tp, model=tp)), None


def main_rank() -> bool:
    dist = torch.distributed
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_stream(batches, mesh):
    """A data rank's rows of each global numpy batch."""
    index, count = data_coordinates(mesh)
    for b in batches:
        yield batch_rows(b, index, count)


def resume(trainer, ckpt_dir: str, generators, device) -> None:
    """Load the newest step into `trainer`: each rank reads its slices
    (`restore_sharded` by the trainer's layout)."""
    state = restore_sharded(ckpt_dir, shardings=trainer.shardings())
    trainer.load_state_dict(state, generators)


def on_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on `device` (tensors pass through)."""
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
                else v) for k, v in batch.items()}


def build(args):
    """The trainer of the parsed flags (random weights from --seed, its
    optimizers ready) and its batch stream: the `DeviceLoader` of
    `--data-path`, or the synthetic numpy batches."""
    check_args(args)
    enable_compilation_cache(args.compile_cache)
    dev, mesh, _ = parallel_setup(args.cpu)
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
        use_text_encoder=args.data_path is not None, mesh=mesh,
        device=dev)
    trainer.init_weights_(args.seed)
    if args.lpips and args.lpips_weights:
        unmatched = load_flat_into(trainer.lpips,
                                   dict(np.load(args.lpips_weights)))
        if unmatched:
            logger.warning("lpips weights: %d unmatched keys",
                           len(unmatched))
    trainer.init_state()
    if args.data_path:
        return trainer, data_loader(
            args, dataset(args), Collator(max_len=TEXT_LEN, k_max=tok.k_max),
            trainer.device, mesh)
    return trainer, shard_stream(synthetic_batches(args, tok.token_feat_dim),
                                 mesh)


def main(argv=None) -> None:
    args = parse_args(argv)
    trainer, batches = build(args)
    batches = iter(batches)
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    run_steps(args, trainer, batches, gen, "dropout", dev)


def run_steps(args, trainer, batches, gen, gen_key: str, dev) -> None:
    """The CLIs' loop: resume, then a step per micro-batch, one JSON line
    each and the checkpoints (under a mesh every rank takes part in a
    save, which gathers the slices, and the first writes); under
    torchrun the process group ends with it."""
    runner, metrics_log, start = None, None, 0
    main = main_rank()
    if args.output_dir:
        ckpt_dir = os.path.join(args.output_dir, "checkpoints")
        runner = CheckpointRunner(ckpt_dir)
        if main:
            metrics_log = MetricsLogger(
                os.path.join(args.output_dir, "metrics.jsonl"),
                print_every=0)
        if args.resume and runner.latest_step() is not None:
            resume(trainer, ckpt_dir, {gen_key: gen}, dev)
            start = trainer.step
            for _ in range(start):          # the batches already taken
                next(batches)
            logger.warning("resumed from step %d", start)
    for step in range(start, args.steps):
        batch = on_device(next(batches), dev)
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        if main:
            print(json.dumps({"step": step, "updates": trainer.updates,
                              "seconds": time.perf_counter() - t0,
                              **metrics}), flush=True)
        if runner is None:
            continue
        if main:
            metrics_log.log(step, metrics)
        last = (step + 1) % args.checkpoint_every == 0 \
            or step == args.steps - 1
        pre = runner.preempted(step)
        if last or pre:
            state = trainer.full_state_dict({gen_key: gen})
            if main:
                runner.save(step + 1, state, force=pre)
        if pre:
            logger.warning("preempted: saved @ %d, exiting", step + 1)
            break
    if runner is not None:
        runner.close()
        if metrics_log is not None:
            metrics_log.close()
    batches.close()
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
