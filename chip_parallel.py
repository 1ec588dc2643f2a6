#!/usr/bin/env python3
"""What exists only across cards: the port's mesh code on four cards.

    torchrun --standalone --nproc-per-node 4 chip_parallel.py
    torchrun --standalone --nproc-per-node 4 chip_parallel.py --cpu --tiny

One process per card (NCCL), or with `--cpu` gloo processes (`--tiny`: the
test configurations, a rehearsal of the script on the CPU). The first rank
prints one JSON line per phase, then the card's name and power limit from
nvidia-smi; any failed check exits non-zero.

  serve_tp      `base_setokim()` at full width served at TP = N (bits 8,
                then 4; int8 KV cache, the cache kernel): the greedy
                streams against the first rank's one-card run of the same
                weights, tokens/s, the mean TTFT and the peak GB a card;
  train_sp      stage-2 LoRA training with sequence parallelism SP = N at
                sequence length 2048: at a 2-layer cut in float32, the loss
                and the gradient norm of one update against the one-card
                flash path; at full depth (bf16), ms an update and the peak
                GB a card;
  train_fsdp    the full fine-tune of the 7B trunk, float32 parameters and
                32-bit AdamW, FSDP over DP = N: two updates, the peak GB a
                card beside what one card would hold;
  train_stage1  stage-1 SeTok training at DP = N, global batch 24, with the
                contrastive negatives gathered: the metrics of two updates
                against one card at the same global batch (float32); and
                on the first rank, AdamW with its moments in host memory
                (`HostOffload`, what `offload_optimizer` wraps) against
                AdamW on the card, on the same gradients: to the bit, the
                state left on the card, ms a step;
  checkpoint    the stage-1 state written at DP = N (every slice gathered,
                the first rank writes), then restored on the first rank
                alone, outside the group: every tensor equal, and a step
                that runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.kernels import _build
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import flash_attention as fa
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.models.llama import valid_quant_group
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.parallel.mesh import (MODEL_AXIS, initialize_multihost,
                                           local_device, make_mesh,
                                           make_sp_mesh)
from setok_tpu_torch.scripts.train_setokim import synthetic_batch
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.init import init_setokim_random_

SEED = 0
LOSS_TOL = 1e-5        # losses: the flash forward bar
NORM_TOL = 2e-4        # gradient norms: the flash gradient bar
STAGE1_TOL = 1e-4      # stage-1 metrics, N ranks against one card
GB = 2 ** 30


class Run:
    """The run's sizes: full width on the cards, or `--tiny` on the CPU."""

    def __init__(self, args):
        self.tiny, self.cpu = args.tiny, args.cpu
        self.dev = local_device(args.cpu)
        self.setokim = cfgs.tiny_setokim() if args.tiny \
            else cfgs.base_setokim()
        t = args.tiny
        self.serve = dict(max_batch=4, prompt_len=16 if t else 128,
                          max_len=32 if t else 512)
        self.new_tokens = 6 if t else 32
        self.seq_len = 48 if t else 2048
        self.sp_batch = 2 if t else 4
        self.fsdp_len = 48 if t else 2048
        self.stage1_batch = 8 if t else 24


def rank() -> int:
    return dist.get_rank()


def world() -> int:
    return dist.get_world_size()


def emit(obj) -> None:
    if rank() == 0:
        print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_parallel: FAILED on rank {rank()}: {msg}")


def sync(run: Run) -> None:
    if run.dev.type == "cuda":
        torch.cuda.synchronize(run.dev)


def reset_peak(run: Run) -> None:
    # a sharded trainer's hooks hold it in a reference cycle
    gc.collect()
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.dev)


def peak_gb(run: Run):
    if run.dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(run.dev) / GB


def from_rank0(obj):
    """Rank 0's object on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def reset_counts() -> None:
    qm.reset_counts()
    ca.reset_counts()
    fa.reset_counts()


# ----------------------------------------------------------------------------
# serving at TP = N


def serve_requests(run: Run):
    """Two image requests and two text-only ones, from the seed."""
    cfg = run.setokim
    rs = np.random.RandomState(SEED + 3)
    size, k_max = cfg.tokenizer.vit.image_size, cfg.tokenizer.k_max
    vocab, plen = cfg.llama.vocab_size, run.serve["prompt_len"]
    out = []
    for i in range(4):
        if i < 2:
            text = rs.randint(10, vocab, rs.randint(4, plen - k_max - 1))
            ids = np.concatenate([[1], np.full(k_max, IMAGE_TOKEN_INDEX),
                                  text])
            img = rs.uniform(-1, 1, (size, size, 3)).astype(np.float32)
        else:
            ids = np.concatenate([[1], rs.randint(10, vocab,
                                                  rs.randint(8, plen))])
            img = None
        out.append((ids.astype(np.int64), img))
    return out


def serve_once(run: Run, model, reqs, mesh=None) -> dict:
    eng = ServeEngine(model, eos_id=-1, pad_id=0, cache_dtype=torch.int8,
                      mesh=mesh, **run.serve)
    # a warm-up request (the libraries' first calls), then the clock
    eng.submit(reqs[0][0], image=reqs[0][1], max_new_tokens=2)
    eng.run()
    sync(run)
    t0 = time.perf_counter()
    handles = [eng.submit(ids, image=img, max_new_tokens=run.new_tokens)
               for ids, img in reqs]
    eng.run()
    sync(run)
    wall = time.perf_counter() - t0
    streams = [list(h.tokens) for h in handles]
    ntok = sum(map(len, streams))
    return {"streams": streams, "tokens": ntok, "wall_s": wall,
            "tok_per_s": ntok / wall,
            "ttft_ms": 1e3 * float(np.mean([h.ttft for h in handles]))}


def phase_serve_tp(run: Run, bits: int) -> None:
    cfg = run.setokim
    group = valid_quant_group(cfg.llama, 128 if not run.tiny else 16) \
        if bits == 4 else 0
    model = Setokim(cfg, target_token_id=3, weight_bits=bits,
                    quant_group=group, cache_kernel=True, device=run.dev)
    init_setokim_random_(model, SEED, clip_search=8 if bits == 4 else 0)
    reqs = serve_requests(run)
    one = None
    if rank() == 0:
        reset_peak(run)
        one = serve_once(run, model, reqs)
        one["peak_gb"] = peak_gb(run)
    dist.barrier()
    one = from_rank0(one)
    mesh = make_mesh(cfgs.MeshConfig(data=1, model=world()))
    model.llama.tensor_parallel_(mesh.get_group(MODEL_AXIS))
    reset_peak(run)
    reset_counts()
    tp = serve_once(run, model, reqs, mesh)
    tp["peak_gb"] = peak_gb(run)
    launches = {"quant_matmul": sum(qm.LAUNCHES.values()),
                "int8_cache_decode_attention": ca.LAUNCHES}
    del model
    same = tp["streams"] == one["streams"]
    emit({"phase": "serve_tp", "bits": bits, "tp": world(),
          "quant_group": group, "streams_identical": same,
          "tokens": tp["tokens"],
          "one_card": {k: one[k] for k in ("tok_per_s", "ttft_ms",
                                           "wall_s", "peak_gb")},
          "tp_run": {k: tp[k] for k in ("tok_per_s", "ttft_ms", "wall_s",
                                        "peak_gb")},
          "launches": launches})
    check(same, f"serve_tp bits {bits}: streams {tp['streams']} vs "
          f"{one['streams']}")
    if run.dev.type == "cuda":
        check(min(launches.values()) > 0,
              f"serve_tp: rows 8/9 and 11 did not run: {launches}")


# ----------------------------------------------------------------------------
# stage 2: sequence parallelism and FSDP


def s2_trainer(run: Run, cfg, *, lora=True, mesh=None, ring_mesh=None,
               compute_dtype="bfloat16", batch=1) -> Stage2Trainer:
    tc = cfgs.TrainConfig(learning_rate=2e-4, max_grad_norm=1.0,
                          warmup_steps=1, total_steps=3, batch_size=batch,
                          grad_accum_steps=1, compute_dtype=compute_dtype)
    kw = dict(lora_enable=True, lora_r=128 if not run.tiny else 4,
              lora_alpha=256.0) if lora else {}
    tr = Stage2Trainer(cfg, train_cfg=tc, target_token_id=3,
                       mm_in_projector_lr=2e-5, use_flash=True, mesh=mesh,
                       ring_mesh=ring_mesh, device=run.dev, **kw)
    init_setokim_random_(tr.model, SEED)
    tr.init_state(SEED + 1)
    return tr


def s2_batches(run: Run, cfg, n: int, batch: int, length: int):
    rs = np.random.RandomState(SEED + 7)
    return [{k: torch.from_numpy(v).to(run.dev) for k, v in synthetic_batch(
        cfg, batch, length, rs, min_len=length // 2).items()}
        for _ in range(n)]


def s2_steps(run: Run, tr: Stage2Trainer, batches, rows=None) -> dict:
    out = {"losses": [], "norms": [], "ms": []}
    for i, b in enumerate(batches):
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        gen = torch.Generator(device=run.dev).manual_seed(SEED + 11 + i)
        sync(run)
        t0 = time.perf_counter()
        m = tr.train_step(b, gen)
        sync(run)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(float(m["total_loss"]))
        out["norms"].append(float(tr.last_grad_norm))
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train_sp(run: Run) -> None:
    n = world()
    cut = cfgs.replace(run.setokim, llama=cfgs.replace(run.setokim.llama,
                                                       num_layers=2))
    batches = s2_batches(run, cut, 1, 1, run.seq_len)
    one = None
    if rank() == 0:
        one = s2_steps(run, s2_trainer(run, cut, compute_dtype="float32"),
                       batches)
    dist.barrier()
    one = from_rank0(one)
    reset_counts()
    sp = s2_steps(run, s2_trainer(run, cut, ring_mesh=make_sp_mesh(1, n),
                                  compute_dtype="float32"), batches)
    cut_res = {"layers": 2, "batch": [1, run.seq_len],
               "loss": [sp["losses"][0], one["losses"][0]],
               "loss_rel": rel(sp["losses"][0], one["losses"][0]),
               "norm": [sp["norms"][0], one["norms"][0]],
               "norm_rel": rel(sp["norms"][0], one["norms"][0])}
    check(cut_res["loss_rel"] <= LOSS_TOL,
          f"train_sp loss {cut_res['loss']}")
    check(cut_res["norm_rel"] <= NORM_TOL,
          f"train_sp gradient norm {cut_res['norm']}")
    # full depth, bf16, the finetune.sh micro-batch
    reset_peak(run)
    tr = s2_trainer(run, run.setokim, ring_mesh=make_sp_mesh(1, n),
                    batch=run.sp_batch)
    full = s2_steps(run, tr, s2_batches(run, run.setokim, 3, run.sp_batch,
                                        run.seq_len))
    del tr
    emit({"phase": "train_sp", "sp": n, "cut": cut_res,
          "full": {"batch": [run.sp_batch, run.seq_len],
                   "layers": run.setokim.llama.num_layers,
                   "ms_per_update": full["ms"][1:],
                   "losses": full["losses"], "peak_gb": peak_gb(run)}})
    check(all(np.isfinite(full["losses"])), "train_sp: a loss is not finite")


def phase_train_fsdp(run: Run) -> None:
    n = world()
    reset_peak(run)
    t0 = time.perf_counter()
    tr = s2_trainer(run, run.setokim, lora=False, batch=n,
                    mesh=make_mesh(cfgs.MeshConfig(data=n, model=1)))
    init_peak = peak_gb(run)
    built_s = time.perf_counter() - t0
    reset_peak(run)
    rows = slice(rank(), rank() + 1)
    before = tr.model.llama.model.layer_0.mlp.down_proj.weight.detach().clone()
    steps = s2_steps(run, tr, s2_batches(run, run.setokim, 2, n,
                                         run.fsdp_len), rows)
    moved = not torch.equal(
        before, tr.model.llama.model.layer_0.mlp.down_proj.weight.detach())
    n_params = sum(int(np.prod(tr.fsdp.pieces[id(p)].full))
                   for p in tr.model.parameters())
    local = sum(p.numel() * p.element_size() for p in tr.model.parameters())
    moments = sum(t.numel() * t.element_size()
                  for opt in tr.optimizers.values()
                  for st in opt.state.values() for t in st.values()
                  if isinstance(t, torch.Tensor))
    trained = sum(int(np.prod(tr.fsdp.pieces[id(p)].full))
                  for p in tr.trainable)
    del tr
    emit({"phase": "train_fsdp", "dp": n, "param_dtype": "float32",
          "optimizer": "adamw 32-bit",
          "batch": [n, run.fsdp_len], "params": n_params,
          "trained_params": trained,
          # what one card would hold: parameters, gradients, two moments
          "one_card_gb": (n_params + 3 * trained) * 4 / GB,
          "local_param_gb": local / GB, "local_moment_gb": moments / GB,
          "losses": steps["losses"], "norms": steps["norms"],
          "ms_per_update": steps["ms"], "build_s": built_s,
          "init_peak_gb": init_peak, "peak_gb": peak_gb(run),
          "layer0_down_moved": moved})
    check(all(np.isfinite(steps["losses"])) and moved,
          "train_fsdp: the updates did not run")


# ----------------------------------------------------------------------------
# stage 1 at DP = N and the checkpoint


def s1_configs(run: Run):
    if run.tiny:
        tok = cfgs.replace(cfgs.tiny_tokenizer(), proj_drop=0.0,
                           attn_drop=0.0)
        det = cfgs.replace(cfgs.tiny_detokenizer(), proj_drop=0.0,
                           attn_drop=0.0)
        return tok, det
    tok = cfgs.replace(cfgs.base_tokenizer(), proj_drop=0.0, attn_drop=0.0)
    det = cfgs.replace(cfgs.base_detokenizer(), proj_drop=0.0,
                       attn_drop=0.0)
    return tok, det


def s1_trainer(run: Run, mesh=None, offload=False) -> Stage1Trainer:
    tok, det = s1_configs(run)
    tr = Stage1Trainer(
        tok, det, gan_cfg=cfgs.GANLossConfig(disc_start=0),
        contrastive_cfg=cfgs.ContrastiveLossConfig(
            text_embed_dim=tok.token_feat_dim),
        train_cfg=cfgs.TrainConfig(compute_dtype="float32", warmup_steps=1,
                                   total_steps=4),
        offload_optimizer=offload, mesh=mesh, device=run.dev)
    tr.init_weights_(SEED)
    tr.init_state()
    return tr


def s1_batches(run: Run, n: int, b: int):
    tok, _ = s1_configs(run)
    size = tok.vit.image_size
    rs = np.random.RandomState(SEED + 21)
    out = []
    for _ in range(n):
        img = rs.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
        out.append({"comp_image": img, "gen_image": img,
                    "text_emb": rs.randn(b, tok.token_feat_dim).astype(
                        np.float32)})
    return out


def s1_steps(run: Run, tr: Stage1Trainer, batches, rows=slice(None)):
    out = []
    for b in batches:
        m = tr.train_step({k: torch.from_numpy(v[rows].copy()).to(run.dev)
                           for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def offload_check(run: Run, steps: int = 3) -> dict:
    """AdamW with its moments in host memory (`HostOffload`) against
    AdamW on the card, on the same parameters and gradients (the card's
    atomics make two trainers' gradients differ, so the trainers are not
    compared): parameters and moments to the bit, the bytes of state left
    on the card, and ms a step of each."""
    from setok_tpu_torch.parallel.sharding import HostOffload
    gen = torch.Generator(device=run.dev).manual_seed(SEED + 5)
    shapes = [(4096, 4096), (11008, 4096), (4096,)] if not run.tiny \
        else [(64, 64), (128,)]

    def draw():
        return [torch.randn(sh, generator=gen, device=run.dev)
                for sh in shapes]

    init = draw()
    a = [torch.nn.Parameter(t.clone()) for t in init]
    b = [torch.nn.Parameter(t.clone()) for t in init]
    plain = torch.optim.AdamW(a, lr=1e-3)
    off = HostOffload(torch.optim.AdamW(b, lr=1e-3))
    ms = {"plain": [], "offload": []}
    for _ in range(steps):
        grads = draw()
        for key, ps, opt in (("plain", a, plain), ("offload", b, off)):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            sync(run)
            t0 = time.perf_counter()
            opt.step()
            sync(run)
            ms[key].append(1e3 * (time.perf_counter() - t0))
    moments = all(torch.equal(plain.state[p][k], off.state[q][k].to(p.device))
                  for p, q in zip(a, b) for k in ("exp_avg", "exp_avg_sq"))
    return {"params_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
            "moments_equal": moments,
            "state_on_card_bytes": off.device_bytes(),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for st in off.state.values()
                                for t in st.values() if t.dim()),
            "ms_per_step": ms}


def phase_train_stage1(run: Run):
    n, b = world(), run.stage1_batch
    batches = s1_batches(run, 2, b)
    one, offload = None, None
    if rank() == 0:
        one = s1_steps(run, s1_trainer(run), batches)
        offload = offload_check(run)
    dist.barrier()
    one, offload = from_rank0(one), from_rank0(offload)
    mesh = make_mesh(cfgs.MeshConfig(data=n, model=1))
    tr = s1_trainer(run, mesh)
    rows = slice(rank() * b // n, (rank() + 1) * b // n)
    got = s1_steps(run, tr, batches, rows)
    worst, where = 0.0, None
    for i, (g, w) in enumerate(zip(got, one)):
        for k in w:
            r = rel(g[k], w[k])
            if r > worst:
                worst, where = r, f"step {i} {k}"
    emit({"phase": "train_stage1", "dp": n, "global_batch": b,
          "metrics_max_rel": worst, "worst": where,
          "total_loss": [[g["total_loss"], w["total_loss"]]
                         for g, w in zip(got, one)],
          "contrastive_loss": [[g.get("contrastive_loss"),
                                w.get("contrastive_loss")]
                               for g, w in zip(got, one)],
          "offload": offload})
    check(worst <= STAGE1_TOL, f"train_stage1: {where} {worst}")
    check(offload["params_equal"] and offload["moments_equal"],
          f"offload: the update differs: {offload}")
    return tr


def phase_checkpoint(run: Run, tr: Stage1Trainer) -> None:
    d = os.path.join("build", "chip_parallel_ckpt")
    state = tr.full_state_dict()
    if rank() == 0:
        shutil.rmtree(d, ignore_errors=True)
        ckpt.save_checkpoint(d, tr.step, state)
    dist.barrier()
    dist.destroy_process_group()
    if rank_at_start != 0:
        return
    one = s1_trainer(run)
    got = ckpt.restore_sharded(d, shardings=one.shardings())
    one.load_state_dict(got)
    mine = one.state_dict()
    equal = all(torch.equal(mine["params"][k].cpu(),
                            state["params"][k].cpu())
                for k in state["params"])
    meta, step = ckpt.checkpoint_metadata(d)
    m = s1_steps(run, one, s1_batches(run, 1, 2))[0]
    print(json.dumps({"phase": "checkpoint", "written_dp": world_at_start,
                      "restored_on": "one rank, no group",
                      "step": step, "leaves": sum(
                          1 for _ in ckpt._walk(meta["params"])),
                      "params_equal": equal,
                      "step_after_restore": {k: m[k] for k in
                                             ("total_loss", "d_loss")}}),
          flush=True)
    check_alone(equal and np.isfinite(m["total_loss"]),
                "checkpoint: the restored state differs or does not run")


def check_alone(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_parallel: FAILED: {msg}")


rank_at_start = 0
world_at_start = 1


def main() -> int:
    global rank_at_start, world_at_start
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("chip_parallel: no CUDA device; this script runs on the "
              "cards (or --cpu)", file=sys.stderr)
        return 2
    if args.cpu:
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = Run(args)
    initialize_multihost(device=run.dev)
    if not dist.is_initialized():
        print("chip_parallel: run it under torchrun with more than one "
              "process", file=sys.stderr)
        return 2
    rank_at_start, world_at_start = rank(), world()
    t0 = time.perf_counter()
    if run.dev.type == "cuda":
        # the first rank builds every kernel, the others load them: no
        # build inside a timed run
        if rank() == 0:
            _build.build_all()
        dist.barrier()
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for bits in (8, 4):
        phase_serve_tp(run, bits)
    phase_train_sp(run)
    phase_train_fsdp(run)
    tr = phase_train_stage1(run)
    phase_checkpoint(run, tr)
    if rank_at_start == 0:
        if not args.cpu:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip()
            print(smi, flush=True)
        print(json.dumps({"ok": True, "world": world_at_start,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
