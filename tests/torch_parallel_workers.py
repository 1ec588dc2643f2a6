"""The workers of tests/test_torch_parallel_*.py: functions that run in
processes spawned under a gloo group (one per rank), with the port's
one-process path as their reference. This module imports torch, numpy and
the port only, so that a spawned process never loads JAX."""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from setok_tpu_torch import config as tcfg
from setok_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

L = 32
TGT = 3
B = 2                # the global batch of the stage-1 and stage-2 runs


def one_thread(fn):
    """`fn` with one intra-op thread (the references that a test computes
    in its own process: under xdist, a tiny model's ops on every core
    only contend), the thread count restored after."""
    def run(*args, **kw):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kw)
        finally:
            torch.set_num_threads(n)
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


TIMEOUT_S = 300


def spawn(fn, world: int, tmp, *args, meanwhile=None):
    """fn(rank, world, *args) in `world` processes under a gloo group with
    a file rendezvous in `tmp`; → the list of their results by rank, or
    (that list, meanwhile()) where `meanwhile` (the one-process
    reference) runs in this process while they do. Processes still
    running after TIMEOUT_S are killed and the call raises."""
    import time
    import torch.multiprocessing as mp
    tmp = str(tmp)
    ctx = mp.spawn(_entry, args=(fn, world, tmp, args), nprocs=world,
                   join=False)
    ref = meanwhile() if meanwhile is not None else None
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} over {world} processes ran "
                               f"past {TIMEOUT_S} s")
    got = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
           for r in range(world)]
    return got if meanwhile is None else (got, ref)


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))


# ---------------------------------------------------------------------------
# stage 2

def port_cfg():
    c = tcfg.tiny_setokim()
    return tcfg.replace(c, tokenizer=tcfg.replace(c.tokenizer, proj_drop=0.0))


def make_batch(seed, b=B):
    """tests/test_torch_stage2.make_batch's layout in L = 32 slots, `b`
    rows, odd rows with a pad tail."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((b, L), np.int64)
    labels = np.full((b, L), IGNORE_INDEX, np.int64)
    ids[:, 0] = 1
    ids[:, 1:9] = IMAGE_TOKEN_INDEX
    text = rs.randint(10, 400, size=(b, 6))
    ids[:, 9:15] = text
    labels[:, 10:15] = text[:, 1:]
    ids[:, 15:23] = TGT
    labels[:, 15:23] = TGT
    answer = rs.randint(10, 400, size=(b, 8))
    ids[:, 23:31] = labels[:, 23:31] = answer
    ids[1::2, 28:] = 0
    labels[1::2, 28:] = IGNORE_INDEX
    img = (rs.rand(b, 32, 32, 3) * 2 - 1).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "comp_image": img,
            "gen_image": img}


STAGE2_TRAIN = dict(learning_rate=1e-3, max_grad_norm=0.05, warmup_steps=1,
                    total_steps=4, grad_accum_steps=1,
                    compute_dtype="float32")


@one_thread
def stage2_trainer(mode: str, remat: bool = False, **kw):
    """A tiny stage-2 trainer on its mode's mesh ('one': none; 'dp', 'tp',
    'sp': two ranks), weights from seed 0."""
    from setok_tpu_torch.parallel.mesh import (make_mesh, make_sp_mesh)
    from setok_tpu_torch.train.stage2 import Stage2Trainer
    from setok_tpu_torch.utils.init import init_setokim_random_
    mesh = ring = None
    if mode == "dp":
        mesh = make_mesh(tcfg.MeshConfig(data=2, model=1))
    elif mode == "tp":
        mesh = make_mesh(tcfg.MeshConfig(data=1, model=2))
    elif mode == "sp":
        ring = make_sp_mesh(1, 2)
    tc = tcfg.TrainConfig(remat=remat, **STAGE2_TRAIN)
    t = Stage2Trainer(port_cfg(), train_cfg=tc, target_token_id=TGT,
                      device="cpu", mesh=mesh, ring_mesh=ring, **kw)
    init_setokim_random_(t.model, 0)
    t.init_state(seed=0)
    return t


@one_thread
def stage2_run(mode: str, kw: dict, n_micro: int = 2):
    """Losses, the last update's gradient norm and the full state after
    `n_micro` updates of the global batch B."""
    t = stage2_trainer(mode, **kw)
    dp = 2 if mode == "dp" else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    losses = []
    for i in range(n_micro):
        batch = make_batch(10 + i)
        rows = slice(rank * B // dp, (rank + 1) * B // dp) if dp > 1 \
            else slice(None)
        local = {k: torch.from_numpy(v[rows].copy()) for k, v in batch.items()}
        gen = torch.Generator().manual_seed(100 + i)
        m = t.train_step(local, gen)
        losses.append(torch.stack([m["lm_loss"], m["diff_loss"],
                                   m["total_loss"]]))
    state = t.full_state_dict()
    return {"losses": torch.stack(losses), "norm": t.last_grad_norm,
            "params": state["params"], "lora": state["lora"],
            "train": state["train"]}


def stage2_modes(rank, world, cases):
    """Every (mode, kw) of `cases` on this rank → their results."""
    return [stage2_run(mode, kw) for mode, kw in cases]


# ---------------------------------------------------------------------------
# stage 1

def stage1_trainer(dp: int, offload: bool = False, multi_label: int = 1,
                   optim_bits: int = 32):
    from setok_tpu_torch.parallel.mesh import make_mesh
    from setok_tpu_torch.train.stage1 import Stage1Trainer
    tok = tcfg.replace(tcfg.tiny_tokenizer(), proj_drop=0.0, attn_drop=0.0)
    det = tcfg.replace(tcfg.tiny_detokenizer(), proj_drop=0.0,
                       attn_drop=0.0)
    mesh = make_mesh(tcfg.MeshConfig(data=dp, model=1)) if dp > 1 else None
    t = Stage1Trainer(
        tok, det, gan_cfg=tcfg.GANLossConfig(disc_start=0),
        contrastive_cfg=tcfg.ContrastiveLossConfig(text_embed_dim=32,
                                                   multi_label=multi_label),
        train_cfg=tcfg.TrainConfig(compute_dtype="float32", warmup_steps=1,
                                   total_steps=4, grad_accum_steps=1),
        offload_optimizer=offload, optim_bits=optim_bits, mesh=mesh,
        device="cpu")
    t.init_weights_(0)
    t.init_state()
    return t


def stage1_batch(seed, b=B):
    rs = np.random.RandomState(seed)
    img = rs.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    return {"comp_image": img, "gen_image": img,
            "text_emb": rs.randn(b, 32).astype(np.float32)}


@one_thread
def stage1_run(dp: int, steps: int = 2, **kw):
    """Metrics of each step and the full state after `steps` updates of
    the global batch B."""
    t = stage1_trainer(dp, **kw)
    rank = dist.get_rank() if dp > 1 else 0
    rows = slice(rank * B // dp, (rank + 1) * B // dp)
    metrics = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v[rows].copy())
                 for k, v in stage1_batch(20 + i).items()}
        metrics.append(t.train_step(batch))
    state = t.full_state_dict()
    return {"metrics": metrics, "params": state["params"],
            "train": state["train"]}


def stage1_cases(rank, world, cases):
    return [stage1_run(world, **kw) for kw in cases]


# ---------------------------------------------------------------------------
# serving

def serve_cfg(variant: str = ""):
    """tiny_setokim, or a variant: 'gqa4' (2 kv heads: over four ranks
    each keeps the one its query heads read; an MLP of 96, 24 a rank)."""
    c = tcfg.tiny_setokim()
    if variant == "gqa4":
        c = tcfg.replace(c, llama=tcfg.replace(
            c.llama, num_kv_heads=2, intermediate_size=96))
    return c


NEW_TOKENS = 5


@one_thread
def serve_run(bits: int, group: int = 0, chunk: int = 0, variant: str = "",
              tp: int = 1):
    """Greedy streams of three text requests (and one with an image,
    unless chunked) through a tiny
    engine at `bits`, an int8 KV cache and the cache kernel's route; over
    a (1, tp) mesh when tp > 1."""
    from setok_tpu_torch.models.setokim import Setokim
    from setok_tpu_torch.parallel.mesh import make_mesh
    from setok_tpu_torch.serve import ServeEngine
    from setok_tpu_torch.utils.init import init_setokim_random_
    model = Setokim(serve_cfg(variant), weight_bits=bits, quant_group=group,
                    cache_kernel=True, device="cpu")
    init_setokim_random_(model, 0)
    mesh = make_mesh(tcfg.MeshConfig(data=1, model=tp)) if tp > 1 else None
    eng = ServeEngine(model, max_batch=2, prompt_len=16, max_len=32,
                      eos_id=-1, cache_dtype=torch.int8, mesh=mesh,
                      prefill_chunk=chunk)
    rs = np.random.RandomState(5)
    reqs = []
    for n in (5, 9, 3):
        ids = np.concatenate([[1], rs.randint(10, 400, size=n)])
        reqs.append(eng.submit(ids, max_new_tokens=NEW_TOKENS))
    if not chunk:
        ids = np.concatenate([[1, IMAGE_TOKEN_INDEX], [20, 21, 22]])
        img = rs.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
        reqs.append(eng.submit(ids, image=img, max_new_tokens=NEW_TOKENS))
    eng.run()
    return [list(r.tokens) for r in reqs]


def row_layer(bits: int, group: int, k: int = 192, n: int = 40,
              seed: int = 0):
    """A whole int8 / int4 trunk linear and an input whose rows hold an
    outlier (a slice's own absmax would differ from its row's)."""
    from setok_tpu_torch.kernels.quant import (quantize_weight,
                                               quantize_weight_int4)
    from setok_tpu_torch.ops.blocks import Quant4Dense, QuantDense
    gen = torch.Generator().manual_seed(seed + bits + group)
    w = torch.randn((n, k), generator=gen)
    x = torch.randn((5, k), generator=gen)
    x[:, 7] *= 30.0
    if bits == 8:
        layer = QuantDense(k, n)
        qw = quantize_weight(w)
        layer.q, layer.s = qw.values, qw.scales[None]
    else:
        layer = Quant4Dense(k, n, quant_group=group)
        qw = quantize_weight_int4(w, group_size=group or None)
        layer.p, layer.s = qw.packed, qw.scales
    return layer, x


def row_parallel_run(rank, world, bits, group):
    """`row_parallel` of this rank's slice of `row_layer`."""
    from setok_tpu_torch.models import llama
    layer, x = row_layer(bits, group)
    k = x.shape[1] // world
    cols = (rank * k, (rank + 1) * k)
    llama._slice_in(layer, cols, None, None)
    return llama.row_parallel(layer, x[:, cols[0]:cols[1]],
                              dist.group.WORLD)


def serve_cases(rank, world, cases, layer_cases=()):
    """The streams of `cases`, then `row_parallel_run` of `layer_cases`."""
    return ([serve_run(tp=world, **kw) for kw in cases],
            [row_parallel_run(rank, world, *c) for c in layer_cases])


# ---------------------------------------------------------------------------
# ring attention

def ring_case(rank, world, q, k, v, ct, causal, positions, valid):
    """This rank's slice of the forward and of the gradients of
    sum(out · ct) with respect to q, k and v."""
    from setok_tpu_torch.parallel.ring_attention import ring_attention
    group = dist.group.WORLD
    n = q.shape[2] // world
    part = slice(rank * n, (rank + 1) * n)
    qs, ks, vs = (torch.from_numpy(x[:, :, part].copy()).requires_grad_()
                  for x in (q, k, v))
    pos = None if positions is None else torch.from_numpy(
        positions[:, part].copy())
    val = None if valid is None else torch.from_numpy(valid[:, part].copy())
    out = ring_attention(qs, ks, vs, group, causal=causal, positions=pos,
                         valid=val)
    (out * torch.from_numpy(ct[:, :, part].copy())).sum().backward()
    return [t.detach().numpy() for t in (out, qs.grad, ks.grad, vs.grad)]


def ring_cases(rank, world, cases):
    return [ring_case(rank, world, *c) for c in cases]


# ---------------------------------------------------------------------------
# checkpoints across layouts

def checkpoint_cycle(rank, world, ckpt_dir):
    """A full fine-tune's state saved at dp = 2 (after an update), then
    restored into a tp = 2 trainer: → (the saved state, the tp trainer's
    state gathered again)."""
    from setok_tpu_torch.utils import checkpoint as ckpt
    t = stage2_trainer("dp")
    batch = make_batch(30)
    rows = slice(rank * B // 2, (rank + 1) * B // 2)
    t.train_step({k: torch.from_numpy(v[rows].copy())
                  for k, v in batch.items()},
                 torch.Generator().manual_seed(3))
    saved = t.full_state_dict()
    if rank == 0:
        ckpt.save_checkpoint(ckpt_dir, t.step, saved)
    dist.barrier()
    tp = stage2_trainer("tp")
    tp.load_state_dict(ckpt.restore_sharded(ckpt_dir,
                                            shardings=tp.shardings()))
    return {"saved": saved, "tp": tp.full_state_dict(),
            "tp_local": {k: tuple(v.shape) for k, v in
                         tp.state_dict()["params"].items()}}


@contextlib.contextmanager
def one_rank_group(tmp):
    """A gloo group of this process alone (a mesh of size 1 in-process),
    ended on exit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp}/one-rank",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
