#!/usr/bin/env python3
"""Drive the PyTorch port of SeTok on one CUDA card and hold it to its plain
versions.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero before
the last line:

  device        the card's name, and its name and power limit from
                nvidia-smi;
  build         nvcc builds every setok_tpu_torch/csrc/*.cu (one nvcc
                each, in parallel) into build/torch_kernels/;
  kernels       each hand-written kernel against its plain PyTorch version
                on the card, at every shape the main paths give it (the
                clustering at N=256, 576 and 729), and its time (the
                clustering's device time split into its two kernels) at the
                throughput batch; the int8 attentions' shares
                beside their float32-score twins', row 4 with every key of
                an image masked (LN(bo + x)), and the registers and spills
                of the attention kernel (csrc/attn_mma.cuh);
  forward       the float SeTok forward at the base config (ViT-B/16 @256,
                random weights from a seed) on the card, its launch counts,
                and a stage-by-stage comparison with the same model on the
                CPU: encode_features, clustering, group encoding + decode;
  forward_int8  the same for the int8 form (quant8=True), with the calls
                per forward of each int8 kernel;
  throughput    the full forward in images/s at B=64: float32, bf16, and
                int8 with bf16 glue (the form bench.py times on the TPU),
                and one profiled forward each (device time by kernel kind);
  unfused_kernels  the unfused int8 route's kernels against their plain
                versions at every path shape: fused_mlp_int8 (576 tokens
                of 768, hidden 3072) and fused_attention_int8 (2 heads of
                384, the inner Block's cluster mask at N=256 and the inter
                Block's validity mask with fully masked rows at N=80, those
                rows exactly b_proj; its share also against a plain version
                with a float32 P.V, the JAX kernel's), and
                quant_matmul at the Dense shapes of the three
                configurations below (bf16 x, bf16 and f32 out; the row
                pass and the GEMM apart, the GEMM beside torch._int_mm);
                times, bounds, plain times; fused_mlp_int8 also from bf16
                x (0 elements may differ from the plain version), its
                time from bf16 x, its kernels' device times and its GEMMs'
                registers and spills;
  forward_unfused  the int8 forward of base @384, base with a 4096-wide
                tokenizer MLP (full depth, B=2) and so400m (full width,
                ViT depth 4, decoder depth 2), card against CPU stage by
                stage, calls per forward against expected_calls; then the
                full-depth so400m forward on the card alone;
  throughput_unfused  img/s of the three configurations, bf16 beside int8
                with bf16 glue (B=64, 64, 8), a profiled forward each,
                peak memory;
  serve_kernels quant_matmul (w8) and quant4_matmul (w4, per channel and
                group 128) at the seven Vicuna-7B trunk linears, decode
                M=4 and prefill M=512 rows, and the int8-cache decode
                attention at B=4, S=512 with holes in the key mask and in
                the serving layout (bf16 q, the tail of the cache masked:
                the tiles it skipped against the wholly masked ones), and
                at G=8, S=8192, each against its plain version (the count
                of elements that differ: 0 for all three), with its time,
                its device
                time split into the row pass and the product (decode has
                no row pass: the GEMV quantises x itself), the host µs a
                call, its bound and the nearest library call's time
                (torch._int_mm, SDPA); quant4_matmul's prefill (M=512)
                per format beside quant_matmul's wgmma GEMM, and the
                registers and spills of its GEMV and wgmma kernels;
  serve         base_setokim() at full width (32 trunk layers, hidden 4096,
                ViT-B/16 SeTok), random weights from the seed, bits 8 then
                bits 4 (group 128, clip search 8), int8 KV cache with the
                cache kernel: ServeEngine(max_batch=4, prompt_len=128,
                max_len=512) answers 8 requests (4 with an image) of 32
                greedy tokens; tokens/s, TTFT, decode ms per step beside
                the weight-streaming bound, a profiled decode step, and the
                launches of each kernel per decode step (one a trunk
                linear) and per admission;
  generate      on the bits-8 model of serve (its diffusion head moved off
                its zero initialisation by N(0, 0.02²) from the seed): the
                serving requests at decode_block 4 and in single steps, in
                turns (1, 4, 4, 1: identical greedy streams; tokens/s,
                dispatches, a profiled dispatch's busy share; per dispatch
                4 x the launches of rows 8 and 11 of a step), a batch mixing greedy rows and
                rows at temperature 0.8 / top-p 0.9 (the greedy rows
                unchanged), generate_image over the 80 hidden states of a
                real decode (16 iterations of 100 sampling steps, cfg 1
                and 3: a finite (1, 256, 256, 3) image, its ms, no launch
                of a table kernel, a profiled render by kernel kind), the
                requests again with im_start_id / im_end_id taken from the
                greedy streams (the pair with the fewest spans; every
                non-empty span rendered at retirement), and the render cut to 2 iterations of 10
                steps on a fixed span and fixed draws, card against CPU
                (tokens and image within FWD_REL_TOL);
  serve_parity  the same with the trunk cut to 2 layers, through the
                kernels and through the plain versions on the card: logits
                at every step and greedy tokens;
  flash_kernels the flash-attention forward, dq and dk/dv kernels against
                their plain versions at the training path's shape (B=4,
                32 heads, L=2048, head_dim 128, bf16, a mask from the
                splice of a synthetic batch: image-slot holes, a pad tail,
                fully masked query rows) and at a ragged one (L=1000),
                the forward's share beside its float64-score twin's,
                with their times, bounds and SDPA's (forward, and forward
                + backward); the path mask's shares of empty, full and
                mixed 64 x 64 tiles; the bf16 kernels' registers and
                spills (ptxas), shared memory and blocks per SM; and
                their times with no cell and with every cell attending;
  train         stage-2 LoRA training of base_setokim() at full width
                (r 128, alpha 256, lr 2e-4, mm_in projector lr 2e-5, flash
                attention, remat, bf16 compute, clip 1.0), random weights
                from the seed: micro-batches of 4 x 2048, 2 per update, 3
                updates; losses, ms per update and micro-batch, valid
                tokens/s (text and filled image slots), peak memory, the
                launches per micro-batch, and a profiled micro-batch; the frozen trunk unchanged, the LoRA
                B factors unchanged by the first update (lr 0) and moved by
                the third;
  train_parity  one micro-batch with the trunk cut to 2 layers, through
                the kernels and through the plain versions on the card:
                losses and the LoRA and projector gradients; beside them,
                to read the gap, the plain route again, the plain route
                with its score sums in another order, each direction's
                kernels alone, and a planted fault (delta dropped) that the
                gradient bar must catch;
  train_setok   stage-1 SeTok training at full width through the stage-1
                CLI's own `build` (scripts/train_setok.py: base_tokenizer /
                base_detokenizer, ViT-B/16 @256, batch 24, lr 1e-3, clip 1.0,
                warm-up 100, bf16 compute over float32 parameters, frozen
                backbone, structured synthetic images with their frozen
                caption table) with disc_start 0, so that the GAN terms
                carry weight: 3 updates, every count reset just before them
                and read just after; ms per update, images/s, peak memory,
                the losses, the launches of the clustering kernel per update
                (one tokenize: cluster_dpc.LAUNCHES_PER_CALL), the frozen
                ViT bit for bit unchanged, the generator unchanged by update
                1 (lr 0) and moved by update 3, the discriminator moved by
                update 1; then a profiled update (device ms by kind, busy
                share);
  train_setok_parity  ViT depth 2, Q-Former 2 layers, decoder depth 2 at
                full width, float32 compute, dropout 0, LPIPS on, the GAN
                factor at 1: the same weights and batch (B=4) on the card
                and on the CPU; the clusters, the metrics of one step's
                terms (no update), and the gradients of the pixel head and
                the inner Block.

Then the kernels summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs no JAX: it imports setok_tpu_torch only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager, nullcontext
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.kernels import _build, cluster_dpc
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import flash_attention as fa
from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (quant4_matmul_plain,
                                           quant_matmul_plain, quant_rows,
                                           quantize_weight,
                                           quantize_weight_int4,
                                           unpack_nibbles)
from setok_tpu_torch.diffusion.gaussian import create_diffusion
from setok_tpu_torch.losses.diffloss import SampleDraws
from setok_tpu_torch.losses.gan import discriminator_loss
from setok_tpu_torch.models.llama import (TRUNK_LINEARS, make_attention_mask,
                                          valid_quant_group)
from setok_tpu_torch.models.setok import SeTok, expected_calls
from setok_tpu_torch.models.generate import (find_image_spans,
                                             generate_image, generate_text)
from setok_tpu_torch.models.setokim import ImageDraws, Setokim, splice_layout
from setok_tpu_torch.ops.blocks import Quant4Dense, QuantDense
from setok_tpu_torch.ops.clustering import (ClusterResult, cluster_dpc_knn,
                                            same_cluster_mask, segment_mean)
from setok_tpu_torch.scripts import train_setok
from setok_tpu_torch.scripts.train_setokim import synthetic_batch
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.train.stage1 import Stage1Trainer
from setok_tpu_torch.train.stage2 import Stage2Trainer, warmup_cosine
from setok_tpu_torch.utils.init import init_random_, init_setokim_random_
from setok_tpu_torch.utils.profiling import device_time_breakdown

SEED = 0
# H100 SXM data sheet: f32 on the CUDA cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
FWD_REL_TOL = 1e-4          # TF32 off: float32 products on card and CPU
NEAR_TIE_REL = 1e-5
# int8 kernels against their plain versions on the card. Without attention
# (the MLPs) both compute the same float32 operations on the same exact
# integer products: 1e-5, and not one element may differ (rows 3, 5 and 6).
# With attention, PV sums in another order, and a last-bit change can flip a
# bf16 cast of P or an int8 step of the attention output: max-rel 2e-3, with
# >= 99 % of the elements within 1e-5 of the largest. Rows 2, 4 and 7 take
# their scores as the float64 product rounded once, as their plain versions
# do; beside each share the check reports the share of the plain version
# with float32 scores (the yardstick of a legal reordering of those sums),
# and beside row 7's (whose kernel and plain version also take P.V as a
# float64 product) the kernel's share against a plain version with a
# float32 P.V, the JAX kernel's.
INT8_MLP_TOL = 1e-5
INT8_ATTN_TOL = 2e-3
INT8_ATTN_SHARE = 0.99
# the int8 forward, card vs CPU, stage by stage: one flipped int8 step moves
# a row by ~1 %; the JAX package's own int8 forward moves by 1.8e-2 under
# 2e-7 relative input noise (tests/test_torch_int8.py)
FWD_INT8_TOL = 5e-2
INT8_KERNELS = ("attn_sublayer_int8", "mlp_sublayer_int8",
                "fused_bert_attention_int8", "mlp_postnorm_int8")
# the kernels whose attention is attn_mma.cuh's, and their libraries
ATTN_MMA = {"attn_sublayer_int8": "fused_sublayer",
            "fused_bert_attention_int8": "fused_bert_attention_int8",
            "fused_attention_int8": "fused_attention_int8"}
# CUDA launches of one call: rows 2 and 5 the row pass, two GEMMs, the
# attention or the hidden pass, and the attention's o pass or the post-norm;
# row 3 four; row 4 the row pass, three GEMMs (q, k, v), the attention, the
# o pass, the out GEMM and the LayerNorm, nine with a key mask (kv's own row
# pass)
INT8_STEPS = {"attn_sublayer_int8": 5, "mlp_sublayer_int8": 4,
              "mlp_postnorm_int8": 5, "fused_bert_attention_int8": 8}
BIT_EXACT = ("mlp_sublayer_int8", "mlp_postnorm_int8", "fused_mlp_int8")
INT8_SOURCES = {
    "attn_sublayer_int8": ("setok_tpu_torch/csrc/fused_sublayer.cu",
                           "setok_tpu/kernels/fused_sublayer.py:196"),
    "mlp_sublayer_int8": ("setok_tpu_torch/csrc/fused_sublayer.cu",
                          "setok_tpu/kernels/fused_sublayer.py:347"),
    "fused_bert_attention_int8": (
        "setok_tpu_torch/csrc/fused_bert_attention_int8.cu",
        "setok_tpu/kernels/fused_bert_attention_int8.py:100"),
    "mlp_postnorm_int8": ("setok_tpu_torch/csrc/fused_sublayer.cu",
                          "setok_tpu/kernels/fused_sublayer.py:304"),
    "fused_mlp_int8": ("setok_tpu_torch/csrc/fused_mlp.cu",
                       "setok_tpu/kernels/fused_mlp.py:46"),
    "fused_attention_int8": ("setok_tpu_torch/csrc/fused_attention_int8.cu",
                             "setok_tpu/kernels/fused_attention_int8.py:84"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def clustered(seed: int, n: int, c: int, n_blobs: int = 5,
              spread: float = 0.05) -> np.ndarray:
    """Well separated blobs (the data of tests/test_clustering.py, with
    unit-scale centers so that every blob's peak clears the threshold)."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_blobs, c)
    labels = rs.randint(0, n_blobs, size=n)
    return (centers[labels] + rs.randn(n, c) * spread).astype(np.float32)


# ----------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load_library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})


def phase_kernels() -> dict:
    """dpc_density_parent against its plain version at the main paths'
    shapes (base @256: N=256, C=768; @384: N=576; so400m: N=729, C=1152;
    k=64) and one uneven case (N=50, k=8); its time and device split at the
    throughput batch."""
    threshold = 0.55
    errs = []
    for b, n, c, k, k_max, min_cn in ((4, 256, 768, 64, 80, 64),
                                      (2, 576, 768, 64, 80, 64),
                                      (2, 729, 1152, 64, 80, 64),
                                      (2, 50, 768, 8, 16, 4)):
        x = torch.from_numpy(np.stack([clustered(SEED + i, n, c)
                                       for i in range(b)])).cuda()
        dens, parent, rowmax = cluster_dpc.dpc_density_parent(x, k)
        torch.cuda.synchronize()
        rd, rp, rr = cluster_dpc.dpc_density_parent_reference(x, k)
        dens_rel = float(((dens - rd).abs() / rd.abs()).max())
        rowmax_rel = float(((rowmax - rr).abs() / rr.abs().clamp_min(1e-30))
                           .max())
        got_s, ref_s = dens * parent, rd * rp
        close = torch.isclose(got_s, ref_s, rtol=1e-3, atol=1e-3)
        peaks = ref_s > threshold
        peak_rel = float(((got_s - ref_s).abs() / ref_s.abs())[peaks].max())
        got = cluster_dpc.cluster_dpc_knn_kernel(x, k, k_max, min_cn,
                                                 threshold)
        ref = cluster_dpc.select_and_assign(x, ref_s, k_max, min_cn,
                                            threshold)
        same = (torch.equal(got.num_clusters, ref.num_clusters)
                and torch.equal(got.center_idx, ref.center_idx)
                and torch.equal(got.idx_cluster, ref.idx_cluster))
        case = {"B": b, "N": n, "C": c, "k": k, "density_max_rel": dens_rel,
                "rowmax_max_rel": rowmax_rel,
                "density_max_abs": float((dens - rd).abs().max()),
                "score_close_frac": float(close.float().mean()),
                "peaks": int(peaks.sum()), "peak_score_max_rel": peak_rel,
                "num_clusters": got.num_clusters.tolist(),
                "clusters_identical": same}
        emit({"phase": "kernels", "kernel": "dpc_density_parent", **case})
        check(dens_rel <= 1e-5, f"density rel err {dens_rel} > 1e-5")
        check(rowmax_rel <= 1e-5, f"rowmax rel err {rowmax_rel} > 1e-5")
        check(bool(peaks.any()) and peak_rel <= 1e-4,
              f"peak score rel err {peak_rel} > 1e-4")
        check(case["score_close_frac"] >= 0.9, "scores close on < 90 %")
        check(same, "cluster_dpc_knn_kernel differs from the plain route")
        errs.append(case["density_max_abs"])

    # time at the throughput batch: B=64 images of N=256, C=768
    b, n, c, k = 64, 256, 768, 64
    x = torch.from_numpy(np.stack([clustered(SEED + i, n, c)
                                   for i in range(b)])).cuda()
    ms = time_ms(lambda: cluster_dpc.dpc_density_parent(x, k))
    plain_ms = time_ms(lambda: cluster_dpc.dpc_density_parent_reference(x, k))
    by = device_time_breakdown(
        lambda: [cluster_dpc.dpc_density_parent(x, k) for _ in range(5)])
    flops = 1.0 * b * n * (n + 1) * c    # the symmetric Gram product, i <= j
    nbytes = 4.0 * (b * n * c + 3 * b * n)          # x in, three outputs
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    entry = {"name": "dpc_density_parent", "route": "cuda",
             "source": "setok_tpu_torch/csrc/cluster_dpc.cu",
             "replaces": "setok_tpu/kernels/cluster_pallas.py:140",
             "launches": None, "max_abs_err": max(errs), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": None, "device_ms": by["device_ms"] / 5,
             "device_split_ms": {kk["name"][:60]: kk["ms"] / 5
                                 for kk in by["top_kernels"]}}
    emit({"phase": "kernels", "timing_shape": [b, n, c], "k": k,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": entry["bound_ms"],
          "device_ms": entry["device_ms"],
          "device_split_ms": entry["device_split_ms"]})
    return entry


# ----------------------------------------------------------------------------
# int8 kernels: cases at the main path's shapes


def _weight(rs, out: int, inp: int, device):
    w = torch.from_numpy((rs.randn(out, inp) / np.sqrt(inp))
                         .astype(np.float32))
    q = quantize_weight(w)
    return type(q)(q.values.to(device), q.scales.to(device))


def _vec(rs, n: int, device, scale=0.1, offset=0.0):
    return torch.from_numpy((offset + scale * rs.randn(n))
                            .astype(np.float32)).to(device)


def blob_masks(b: int, device, n: int = 256, c: int = 768, k_max: int = 80):
    """The inner Block's (B, N, N) same-cluster mask, the inter Block's
    (B, k_max, k_max) valid x valid mask and the (B, k_max) cluster validity,
    from DPC-KNN of blob features: a few clusters, so most of the k_max
    slots are empty and the inter mask has fully masked rows."""
    feats = torch.from_numpy(np.stack([clustered(SEED + 10 + i, n, c)
                                       for i in range(b)])).to(device)
    res = cluster_dpc_knn(feats, k=64, k_max=k_max, min_cluster_num=64,
                          threshold=0.55)
    _, counts = segment_mean(feats, res.idx_cluster, k_max)
    valid = counts > 0
    return (same_cluster_mask(res.idx_cluster),
            valid[:, None, :] & valid[:, :, None], valid)


def int8_cases(b: int, device, seed: int = SEED, shapes: str = "path"):
    """(name, label, kernel, plain version, args, kwargs) for each int8
    kernel at each shape of the base forward, B images: the ViT, decoder,
    inner and inter attention sublayers, the MLPs at N=256 and N=80 rows per
    image, the post-norm MLP, the Q-Former's self- and cross-attention.
    shapes="timing" gives one case per kernel, the unmasked N=256 one."""
    rs = np.random.RandomState(seed)
    c, hid = 768, 3072

    def x(n):
        return torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(device)

    def attn(label, n, heads, mask, eps):
        args = (x(n), _vec(rs, c, device, 0.1, 1.0), _vec(rs, c, device),
                _weight(rs, 3 * c, c, device), _vec(rs, 3 * c, device),
                _weight(rs, c, c, device), _vec(rs, c, device), heads)
        return ("attn_sublayer_int8", label, fs.attn_sublayer_int8,
                fs.attn_sublayer_int8_reference, args,
                {"mask": mask, "ln_eps": eps})

    def mlp(label, n, eps):
        args = (x(n), _vec(rs, c, device, 0.1, 1.0), _vec(rs, c, device),
                _weight(rs, hid, c, device), _vec(rs, hid, device),
                _weight(rs, c, hid, device), _vec(rs, c, device))
        return ("mlp_sublayer_int8", label, fs.mlp_sublayer_int8,
                fs.mlp_sublayer_int8_reference, args, {"ln_eps": eps})

    def post(label, n):
        args = (x(n), _weight(rs, hid, c, device), _vec(rs, hid, device),
                _weight(rs, c, hid, device), _vec(rs, c, device),
                _vec(rs, c, device, 0.1, 1.0), _vec(rs, c, device))
        return ("mlp_postnorm_int8", label, fs.mlp_postnorm_int8,
                fs.mlp_postnorm_int8_reference, args, {})

    def bert(label, n, m, kv_mask):
        q = x(n)
        kv = q if m is None else x(m)
        ws = []
        for _ in range(4):
            ws += [_weight(rs, c, c, device), _vec(rs, c, device)]
        args = (q, kv, *ws, _vec(rs, c, device, 0.1, 1.0),
                _vec(rs, c, device), 12)
        return ("fused_bert_attention_int8", label,
                fba.fused_bert_attention_int8,
                fba.fused_bert_attention_int8_reference, args,
                {"kv_mask": kv_mask})

    if shapes == "timing":
        return [attn("vit", 256, 12, None, 1e-6), mlp("vit", 256, 1e-6),
                bert("self", 256, None, None), post("mapper", 256)]
    inner, inter, valid = blob_masks(b, device)
    return [attn("vit", 256, 12, None, 1e-6),
            attn("decoder", 256, 16, None, 1e-5),
            attn("inner", 256, 2, inner, 1e-5),
            attn("inter", 80, 2, inter, 1e-5),
            mlp("vit", 256, 1e-6), mlp("inter", 80, 1e-5),
            post("mapper", 256),
            bert("self", 256, None, None),
            bert("cross", 256, 80, valid)]


def int8_bound(name: str, args) -> tuple:
    """(bound ms, bound_by) of one call: its int8 and bf16 operations over
    their peaks, against its bytes (f32 input and output, int8 weights, f32
    scales, biases and LayerNorm vectors, each read or written once)."""
    x = args[0]
    c = x.shape[-1]
    rows = x.numel() // c
    nbytes = 8.0 * rows * c
    bf16 = 0.0
    if name == "attn_sublayer_int8":
        b, n, _ = x.shape
        int8 = 2.0 * rows * c * 4 * c          # qkv (3C) and proj (C)
        bf16 = 4.0 * b * n * n * c             # scores and PV
        nbytes += 4 * c * c + 4.0 * 10 * c
    elif name == "fused_bert_attention_int8":
        b, n, _ = x.shape
        kv = args[1]
        m = kv.shape[1]
        int8 = 2.0 * c * c * (2 * rows + 2 * b * m)    # q, out; k, v
        bf16 = 4.0 * b * n * m * c
        nbytes += (0 if kv is x else 4.0 * b * m * c) + 4 * c * c + 40.0 * c
    else:
        w1 = args[3] if name == "mlp_sublayer_int8" else args[1]
        hid = w1.values.shape[0]
        int8 = 4.0 * rows * c * hid            # fc1 and fc2
        nbytes += 2 * c * hid + 4.0 * (2 * hid + 4 * c)
    t_ops = int8 / PEAK_INT8_OPS + bf16 / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def plain_twin(plain, args, kw, **attention_kw):
    """A plain version whose attention_reference takes attention_kw in place
    of the plain version's own keywords: exact_scores=False, its scores as
    a float32 product (the sums of the JAX kernel's float32 dot, in
    cuBLAS's order); exact_pv=False, its P.V as a float32 product."""
    mod = sys.modules[plain.__module__]
    reference = fs.attention_reference

    def twin(q, k, v, mask, **own):
        return reference(q, k, v, mask, **{**own, **attention_kw})

    with mock.patch.object(mod, "attention_reference", twin):
        return plain(*args, **kw)


def check_int8_case(name, label, kernel, plain, args, kw,
                    phase: str = "kernels") -> dict:
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    diff = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    case = {"phase": phase, "kernel": name, "shape": label,
            "input": list(args[0].shape), "max_rel": float(diff.max()) / scale,
            "max_abs": float(diff.max()),
            "share_within_1e-5": float((diff <= 1e-5 * scale).double().mean()),
            "elements_differing": int((got != want).sum()),
            "finite": bool(torch.isfinite(got).all())}
    if name in ATTN_MMA:
        case["f32_scores_share"] = share_within_1e5(
            plain_twin(plain, args, kw, exact_scores=False), want)
    if name == "fused_attention_int8":
        case["share_vs_f32_pv"] = share_within_1e5(
            got, plain_twin(plain, args, kw, exact_pv=False))
    emit(case)
    check(case["finite"], f"{name} {label}: output not finite")
    if name in BIT_EXACT:
        check(case["max_rel"] <= INT8_MLP_TOL,
              f"{name} {label}: max-rel {case['max_rel']} > {INT8_MLP_TOL}")
        check(case["elements_differing"] == 0,
              f"{name} {label}: {case['elements_differing']} elements "
              "differ from the plain version")
    else:
        check(case["max_rel"] <= INT8_ATTN_TOL
              and case["share_within_1e-5"] >= INT8_ATTN_SHARE,
              f"{name} {label}: max-rel {case['max_rel']}, share "
              f"{case['share_within_1e-5']}")
    return case


def bert_masked_query_check(name, label, kernel, plain, args, kw) -> dict:
    """Row 4 cross with every key of image 0 masked: each of its queries
    attends to nothing, o = 0, and its output is LN(bo + x), the plain
    version's value."""
    kv_mask = kw["kv_mask"].clone()
    kv_mask[0] = False
    got = kernel(*args, kv_mask=kv_mask)[0]
    torch.cuda.synchronize()
    x, bo, ln_g, ln_b = args[0], args[9], args[10], args[11]
    want = fs.layernorm(x[0] + bo, ln_g, ln_b, 1e-12)
    res = {"shape": "cross, image 0 all keys masked",
           "max_rel": max_rel(got, want),
           "elements_differing": int((got != want).sum()),
           "plain_differing": int((plain(*args, kv_mask=kv_mask)[0]
                                   != want).sum())}
    emit({"phase": "kernels", "kernel": name, **res})
    check(res["max_rel"] <= INT8_MLP_TOL,
          f"{name}: a query with every key masked is not LN(bo + x): "
          f"max-rel {res['max_rel']}")
    return res


def phase_int8_kernels(b_check: int = 4, b_time: int = 64) -> dict:
    """Each int8 kernel against its plain version at every path shape
    (B=b_check), with the launches of one call, then its time, its plain
    version's and its bound at the throughput batch (B=b_time). Returns the
    kernels-line entries."""
    dev = torch.device("cuda")
    errs = {name: 0.0 for name in INT8_KERNELS}
    per_call = {name: {} for name in INT8_KERNELS}
    checks = {name: [] for name in INT8_KERNELS}
    for case in int8_cases(b_check, dev):
        name, label = case[:2]
        before = int8_counts()[1][name]
        res = check_int8_case(*case)
        launched = int8_counts()[1][name] - before
        steps = INT8_STEPS[name] + (case[5].get("kv_mask") is not None)
        check(launched == steps,
              f"{name} {label}: {launched} launches for one call, not {steps}")
        per_call[name][label] = launched
        checks[name].append({k: res[k] for k in (
            "shape", "max_rel", "share_within_1e-5", "elements_differing",
            "f32_scores_share") if k in res})
        errs[name] = max(errs[name], res["max_abs"])
        if label == "cross":
            checks[name].append(bert_masked_query_check(*case))
    entries = {}
    for name, label, kernel, plain, args, kw in int8_cases(
            b_time, dev, shapes="timing"):
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
        bound_ms, bound_by = int8_bound(name, args)
        source, replaces = INT8_SOURCES[name]
        entries[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": None,
                         "max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "launches_per_call": per_call[name],
                         "checks": checks[name]}
        if name in ATTN_MMA:
            entries[name]["ptxas_attention"] = ptxas_of(
                ATTN_MMA[name], "attn_mma_kernel", "Lb0E")
        emit({"phase": "kernels", "kernel": name, "timing_shape": label,
              "input": list(args[0].shape), "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by})
        del args
    return entries


def _center_margins(score: torch.Tensor, k_max: int, min_cn: int,
                    threshold: float, tokens) -> list:
    """Relative distance of each token's score from the selection boundary:
    the threshold, or the score between the last chosen and first unchosen
    rank."""
    above = int((score > threshold).sum())
    if 0 < above <= k_max:
        boundary = threshold
    else:
        ranked = torch.sort(score, descending=True).values
        m = min_cn if above == 0 else k_max
        boundary = 0.5 * float(ranked[m - 1] + ranked[m])
    return [abs(float(score[t]) - boundary) / abs(boundary) for t in tokens]


def compare_clusters(got: ClusterResult, want: ClusterResult,
                     x: torch.Tensor, cfg) -> dict:
    """Identical, or differing only at printed near-ties (margin < 1e-5
    relative); anything else fails."""
    near_ties = []
    for i in range(x.shape[0]):
        gc = set(got.center_idx[i][got.center_valid[i]].tolist())
        wc = set(want.center_idx[i][want.center_valid[i]].tolist())
        if gc != wc:
            diff = sorted(gc ^ wc)
            margins = [max(a, b) for a, b in zip(
                _center_margins(got.score[i], cfg.k_max, cfg.min_cluster_num,
                                cfg.threshold, diff),
                _center_margins(want.score[i], cfg.k_max,
                                cfg.min_cluster_num, cfg.threshold, diff))]
            near_ties.append({"image": i, "centers": diff,
                              "score_margin": margins})
            check(max(margins) < NEAR_TIE_REL,
                  f"image {i}: centers {diff} differ beyond a near-tie "
                  f"(margins {margins})")
            continue
        moved = (got.idx_cluster[i] != want.idx_cluster[i]).nonzero()
        xi = x[i].double()
        for t in moved.flatten().tolist():
            cg = int(got.center_idx[i][got.idx_cluster[i][t]])
            cw = int(want.center_idx[i][want.idx_cluster[i][t]])
            dg = float((xi[t] - xi[cg]).norm())
            dw = float((xi[t] - xi[cw]).norm())
            margin = abs(dg - dw) / max(dg, dw, 1e-30)
            near_ties.append({"image": i, "token": t,
                              "distance_margin": margin})
            check(margin < NEAR_TIE_REL,
                  f"image {i} token {t}: assignment differs beyond a "
                  f"near-tie (margin {margin})")
    return {"identical": not near_ties, "near_ties": near_ties}


def reset_counts() -> None:
    cluster_dpc.LAUNCHES = 0
    fs.reset_counts()
    fba.reset_counts()
    fm.reset_counts()
    fai.reset_counts()
    qm.reset_counts()
    ca.reset_counts()
    fa.reset_counts()


def int8_counts() -> tuple:
    """(wrapper calls that launched, CUDA launches) per int8 kernel of the
    SeTok forward, `quant_matmul` included."""
    mods = (fs, fba, fm, fai)
    calls = {k: v for m in mods for k, v in m.CALLS.items()}
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    calls["quant_matmul"] = qm.CALLS["quant_matmul"]
    launches["quant_matmul"] = qm.LAUNCHES["quant_matmul"]
    return calls, launches


@torch.no_grad()          # the forward's stages, without a graph
def staged_forward(cpu_model: SeTok, gpu_model: SeTok, seed: int,
                   tol: float, name: str, batch: int = 4,
                   config: str = "base_tokenizer/base_detokenizer") -> dict:
    """The main path once on the card at B=batch, every count reset just
    before it and read just after, then card vs CPU stage by stage: (a)
    features;
    (b) the card's clustering of the card's features against the plain
    version on the same features on the CPU (and that plain route against
    ops.clustering's), held by the near-tie rule; (c) group encoding +
    decode given the card's clustering. Emits the phase line, checks every
    max-rel against `tol`, and returns the counts."""
    tok_cfg = gpu_model.tokenizer.cfg
    size = tok_cfg.vit.image_size
    images = np.random.RandomState(seed).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32)
    img_c = torch.from_numpy(images)
    img_g = img_c.cuda()

    reset_counts()
    out = gpu_model(img_g)
    torch.cuda.synchronize()
    calls, launches = int8_counts()
    launches["dpc_density_parent"] = cluster_dpc.LAUNCHES
    det_cfg = gpu_model.detokenizer.cfg
    det_size = det_cfg.grid * det_cfg.patch_size
    check(tuple(out.recon.shape) == (batch, det_size, det_size, 3)
          and bool(torch.isfinite(out.recon).all())
          and bool(torch.isfinite(out.tokens).all()),
          f"{name} output has the wrong shape or is not finite")

    f_g = gpu_model.tokenizer.encode_features(img_g)
    f_c = cpu_model.tokenizer.encode_features(img_c)
    res_g = gpu_model.tokenizer.cluster(f_g)
    f_gc = f_g.cpu()
    res_p = cluster_dpc.cluster_dpc_knn_kernel(
        f_gc, k=tok_cfg.knn, k_max=tok_cfg.k_max,
        min_cluster_num=tok_cfg.min_cluster_num, threshold=tok_cfg.threshold)
    res_gc = ClusterResult(*(t.cpu() for t in res_g))
    res_x = cluster_dpc_knn(f_gc, k=tok_cfg.knn, k_max=tok_cfg.k_max,
                            min_cluster_num=tok_cfg.min_cluster_num,
                            threshold=tok_cfg.threshold)
    tok_g = gpu_model.tokenizer.group_encode(f_g, res_g)
    det_g = gpu_model.detokenizer(tok_g.tokens, tok_g.token_valid)
    tok_c = cpu_model.tokenizer.group_encode(f_gc, res_gc)
    det_c = cpu_model.detokenizer(tok_c.tokens, tok_c.token_valid)
    rel = {"encode_features_max_rel": max_rel(f_g, f_c),
           "tokens_max_rel": max_rel(tok_g.tokens, tok_c.tokens),
           "recon_max_rel": max_rel(det_g.image, det_c.image),
           "forward_vs_staged_recon_max_rel": max_rel(out.recon,
                                                      det_g.image)}
    emit({"phase": name, "config": config,
          "params": sum(p.numel() for p in gpu_model.parameters()),
          "batch": batch, "calls": calls, "launches": launches,
          "clusters": compare_clusters(res_gc, res_p, f_gc, tok_cfg),
          "num_clusters": res_g.num_clusters.tolist(),
          "plain_vs_ops_route": compare_clusters(res_p, res_x, f_gc, tok_cfg),
          **rel})
    for key, value in rel.items():
        check(value <= tol, f"{name}: {key} {value} > {tol}")
    return {"calls": calls, "launches": launches}


def phase_forward(cpu_model: SeTok, gpu_model: SeTok) -> int:
    """The float forward: float32 products on both sides (TF32 off)."""
    counts = staged_forward(cpu_model, gpu_model, SEED, FWD_REL_TOL,
                            "forward")
    launches = counts["launches"]["dpc_density_parent"]
    check(launches >= 1, "the forward did not launch the cluster kernel")
    check(not any(counts["calls"].values()),
          "the float forward launched an int8 kernel")
    return launches


def phase_forward_int8(cpu_model: SeTok, gpu_model: SeTok) -> dict:
    """The int8 form (quant8=True) on the card against the same weights on
    the CPU, where the wrappers run their plain versions; the calls per
    forward of each int8 kernel against `expected_calls`."""
    counts = staged_forward(cpu_model, gpu_model, SEED + 1, FWD_INT8_TOL,
                            "forward_int8")
    want = expected_calls(gpu_model.tokenizer.cfg, gpu_model.detokenizer.cfg)
    check(counts["calls"] == want,
          f"int8 calls per forward {counts['calls']}, expected {want}")
    check(counts["launches"]["dpc_density_parent"]
          == cluster_dpc.LAUNCHES_PER_CALL,
          "the int8 forward did not launch the cluster kernels once")
    return counts


def images_per_sec(model: SeTok, images: torch.Tensor, n_small: int,
                   n_big: int) -> dict:
    """As bench.py: forwards chained through the clipped reconstruction
    (or, where its size differs from the input's, through its mean); the
    per-batch time is the slope between two chain lengths."""

    def chain(n):
        x = images
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = model(x)
            r = out.recon.clamp(-1, 1).to(images.dtype)
            # so400m: 384 px in, 252 px out; chain through a scalar there
            x = r if r.shape == x.shape else images + r.mean()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out

    chain(1)                                         # warm-up
    t_small = min(chain(n_small)[0] for _ in range(2))
    runs = [chain(n_big) for _ in range(2)]
    t_big = min(t for t, _ in runs)
    nc = runs[-1][1].num_clusters.float()
    batch = images.shape[0]
    return {"images_per_sec": batch * (n_big - n_small) / (t_big - t_small),
            "t_small_s": t_small, "t_big_s": t_big, "chain": [n_small, n_big],
            "num_clusters": {"min": int(nc.min()), "mean": float(nc.mean()),
                             "max": int(nc.max())}}


def phase_throughput(gpu_model: SeTok) -> None:
    """img/s at B=64 in float32, bf16 and int8 with bf16 glue (quant8=True,
    as bench.py runs the JAX package), then one profiled forward each:
    device time by kernel category and the device's busy share."""
    tok_cfg, det_cfg = gpu_model.tokenizer.cfg, gpu_model.detokenizer.cfg
    size, batch = tok_cfg.vit.image_size, 64
    images = torch.from_numpy(np.random.RandomState(SEED).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32)).cuda()
    bf16 = SeTok(tok_cfg, det_cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(gpu_model.state_dict())
    int8 = SeTok(tok_cfg, det_cfg, dtype=torch.bfloat16, quant8=True)
    int8.load_state_dict(gpu_model.state_dict())
    for name, model, n_small, n_big in (("float32", gpu_model, 1, 4),
                                        ("bfloat16", bf16, 2, 8),
                                        ("int8", int8, 2, 8)):
        res = images_per_sec(model, images, n_small, n_big)
        emit({"phase": "throughput", "dtype": name, "batch": batch, **res})
        check(res["images_per_sec"] > 0, "throughput slope is not positive")
        emit({"phase": "profile", "dtype": name, "batch": batch,
              **device_time_breakdown(lambda: model(images))})


# ----------------------------------------------------------------------------
# the unfused int8 route: base @384, a 4096-wide tokenizer MLP, so400m

UNFUSED_KERNELS = ("fused_mlp_int8", "fused_attention_int8")
# the Dense shapes of quant_matmul on these paths: (label, K, N)
DENSE_SHAPES = (("vit384 qkv", 768, 2304), ("vit384 proj", 768, 768),
                ("ff4096 fc1", 768, 4096), ("ff4096 fc2", 4096, 768),
                ("so400m qkv", 1152, 3456), ("so400m proj", 1152, 1152),
                ("so400m fc1", 1152, 4304), ("so400m fc2", 4304, 1152))
SO400M_BATCH = 8                 # bench.py's batch at that scale
# rows of a Dense call at the throughput batch: B=64 images of 576 and 256
# tokens, B=8 of 729
DENSE_ROWS = {"vit384": 64 * 576, "ff4096": 64 * 256,
              "so400m": SO400M_BATCH * 729}


def unfused_configs() -> dict:
    """The slice's three configurations, built as eval_recon.py and
    bench.py build them: base at 384 px (ViT and detokenizer image_size),
    base with the reference tokenizer's 4096-wide MLP, and so400m."""
    tok, det = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    return {
        "base384": (cfgs.replace(tok, vit=cfgs.replace(tok.vit,
                                                       image_size=384)),
                    cfgs.replace(det, image_size=384)),
        "ff4096": (cfgs.replace(tok, dim_feedforward=4096), det),
        "so400m": (cfgs.so400m_tokenizer(), cfgs.so400m_detokenizer()),
    }


def unfused_cases(b: int, device, seed: int = SEED, shapes: str = "path"):
    """(name, label, kernel, plain version, args, kwargs) for rows 6 and 7
    at their path shapes, B images: fused_mlp_int8 at 576 tokens of 768
    (the ViT, the inner Block and the decoder at 384 px), and
    fused_attention_int8 with 2 heads of 384 at the inner Block (N=256,
    the same-cluster mask) and the inter Block (N=80, the validity mask
    with fully masked rows). shapes="timing": the MLP and the inner
    attention."""
    rs = np.random.RandomState(seed + 5)
    c, hid = 768, 3072

    def x(n):
        return torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
            device)

    def mlp(label, n):
        args = (x(n), _weight(rs, hid, c, device), _vec(rs, hid, device),
                _weight(rs, c, hid, device), _vec(rs, c, device))
        return ("fused_mlp_int8", label, fm.fused_mlp_int8,
                fm.fused_mlp_int8_reference, args, {})

    def attn(label, n, mask):
        args = (x(n), _weight(rs, 3 * c, c, device), _vec(rs, 3 * c, device),
                _weight(rs, c, c, device), _vec(rs, c, device), 2)
        return ("fused_attention_int8", label, fai.fused_attention_int8,
                fai.fused_attention_int8_reference, args, {"mask": mask})

    inner, inter, _ = blob_masks(b, device)
    if shapes == "timing":
        return [mlp("384px", 576), attn("inner", 256, inner)]
    return [mlp("384px", 576), attn("inner", 256, inner),
            attn("inter", 80, inter), attn("unmasked", 256, None)]


def unfused_bound(name: str, args) -> tuple:
    """(bound ms, bound_by) of one call: int8 operations over the int8
    peak plus the f32 attention products over the f32 peak, against the
    bytes (f32 input and output, int8 weights, f32 scales and biases, the
    byte mask, each once). The products count only the unmasked score
    cells, as flash_bounds does: a masked cell adds an exact 0."""
    x = args[0]
    c = x.shape[-1]
    rows = x.numel() // c
    if name == "fused_mlp_int8":
        hid, c_out = args[1].values.shape[0], args[3].values.shape[0]
        int8, f32 = 2.0 * rows * hid * (c + c_out), 0.0
        nbytes = 4.0 * rows * (c + c_out) + hid * (c + c_out) \
            + 8.0 * (hid + c_out)
    else:
        b, n, _ = x.shape
        mask = args[6] if len(args) > 6 else None
        int8 = 8.0 * rows * c * c                 # qkv (3C) and proj (C)
        cells = float(b * n * n) if mask is None else float(mask.sum())
        f32 = 4.0 * cells * c                     # scores and PV, all heads
        nbytes = 8.0 * rows * c + 4 * c * c + 32.0 * c
        nbytes += 0 if mask is None else b * n * n
    t_ops = int8 / PEAK_INT8_OPS + f32 / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_unfused_kernels(b_check: int = 3, b_time: int = 64) -> dict:
    """Rows 6 and 7 against their plain versions at every path shape
    (B=b_check: 1728 rows, not a multiple of the 128-row tile), with the
    launches of one call; row 8 at the Dense shapes of these paths; then
    each kernel's time, plain time and bound at the throughput batch.
    Returns the kernels-line entries of rows 6 and 7 and row 8's timings
    at the Dense shapes."""
    dev = torch.device("cuda")
    errs = dict.fromkeys(UNFUSED_KERNELS, 0.0)
    # launches a call: row 6 the row pass, fc1, the hidden rows' pass and
    # fc2; row 7 the row pass, qkv, attention, the o pass and proj
    steps = {"fused_mlp_int8": 4, "fused_attention_int8": 5}
    differing = {}
    for case in unfused_cases(b_check, dev):
        name = case[0]
        before = int8_counts()[1][name]
        res = check_int8_case(*case, phase="unfused_kernels")
        launched = int8_counts()[1][name] - before
        check(launched == steps[name],
              f"{name}: {launched} launches for one call, not {steps[name]}")
        errs[name] = max(errs[name], res["max_abs"])
        if name == "fused_mlp_int8":
            # bit for bit, from float32 and from bf16 x read as it is
            args = case[4]
            for x_type in (torch.float32, torch.bfloat16):
                xa = (args[0].to(x_type), *args[1:])
                got = case[2](*xa)
                torch.cuda.synchronize()
                n_diff = int((got != case[3](*xa)).sum())
                differing[str(x_type).replace("torch.", "")] = n_diff
                check(n_diff == 0, f"{name} {x_type}: {n_diff} elements "
                      "differ from the plain version")
        if case[1] == "inter":
            # a fully masked query row attends to nothing: out = b_proj
            args, mask = case[4], case[5]["mask"]
            rows = ~mask.any(-1)
            got = case[2](*args, **case[5])
            check(bool(rows.any()) and torch.equal(
                got[rows], args[4].expand(int(rows.sum()), -1)),
                "fused_attention_int8: a fully masked row is not b_proj")

    entries = {}
    for name, label, kernel, plain, args, kw in unfused_cases(
            b_time, dev, shapes="timing"):
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
        bound_ms, bound_by = unfused_bound(name, (*args, kw.get("mask")))
        source, replaces = INT8_SOURCES[name]
        entries[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": None,
                         "max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None,
                         "timing": f"{label}, input "
                                   f"{list(args[0].shape)}"}
        if name in ATTN_MMA:
            entries[name]["ptxas_attention"] = ptxas_of(
                ATTN_MMA[name], "attn_mma_kernel", "Lb1E")
        if name == "fused_mlp_int8":
            xb = args[0].to(torch.bfloat16)
            entries[name].update(
                ms_bf16_x=time_ms(lambda: kernel(xb, *args[1:])),
                # device ms a call by kernel, over 5 calls
                device_split=[
                    {"name": k["name"], "ms": k["ms"] / 5}
                    for k in device_time_breakdown(
                        lambda: [kernel(*args) for _ in range(5)])[
                            "top_kernels"]],
                elements_differing=differing,
                ptxas={stage: ptxas_of("fused_mlp", "wgmma_gemm_kernel",
                                       "Li0ELb0", epi)
                       for stage, epi in (("fc1", "MlpFc1Epi"),
                                          ("fc2", "MlpFc2Epi"))})
            del xb
        emit({"phase": "unfused_kernels", "kernel": name,
              "timing_shape": label, "input": list(args[0].shape),
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              **{k: v for k, v in entries[name].items()
                 if k in ("ms_bf16_x", "device_split", "ptxas",
                          "ptxas_attention")}})
        del args

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    dense = []
    for label, k, n in DENSE_SHAPES:
        w = quantize_weight(torch.randn(n, k, generator=gen, device=dev)
                            * k ** -0.5)
        for m in (b_check * 243, DENSE_ROWS[label.split()[0]]):
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            # bf16 x, as under bf16 glue; bf16 out as Dense writes it, and
            # f32 out
            for out_dtype in (torch.bfloat16, torch.float32):
                got = qm.quant_matmul(x, w, out_dtype=out_dtype)
                torch.cuda.synchronize()
                want = quant_matmul_plain(x, w, out_dtype)
                case = check_close("quant_matmul", f"{label} M={m}", got,
                                   want, QUANT_TOL)
                case.update(phase="unfused_kernels",
                            out_dtype=str(out_dtype).replace("torch.", ""),
                            elements_differing=int((got != want).sum()))
                del got, want
                if m != b_check * 243 and out_dtype == torch.bfloat16:
                    case.update(dense_timing(x, w))
                    dense.append({"shape": case["shape"], "K": k, "N": n,
                                  **{key: case[key] for key in (
                                      "ms", "plain_ms", "library_ms",
                                      "gemm_ms", "rows_ms", "int_mm_ms",
                                      "bound_ms", "bound_by",
                                      "bound_ms_f32_counting", "max_abs",
                                      "elements_differing")}})
                emit(case)
    return {"entries": entries, "dense": dense}


def dense_timing(x, w) -> dict:
    """One Dense call's timings at bf16 in and out: the whole call by
    events, its device time split into the row pass and the GEMM (the
    profiler), the GEMM beside torch._int_mm on the same int8 operands
    (library_ms, int_mm_ms), the plain version, and the bound counted in
    the types the call moves beside the earlier float32 counting."""
    m, k = x.shape
    n = w.values.shape[0]
    t_bytes, t_ops = quant_bound(m, k, n, 8, 1, x_size=2, out_size=2)
    f32_bytes, _ = quant_bound(m, k, n, 8, 1, x_size=4, out_size=4)
    split = device_split(lambda: qm.quant_matmul(x, w))
    int_mm = time_ms(library_int_mm(x.float(), w.values))
    return {"ms": time_ms(lambda: qm.quant_matmul(x, w)),
            "plain_ms": time_ms(lambda: quant_matmul_plain(x, w), reps=5,
                                warmup=1),
            "library_ms": int_mm, "int_mm_ms": int_mm,
            "gemm_ms": split["product_ms"], "rows_ms": split["rows_ms"],
            "device_ms": split["device_ms"],
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_counting": 1e3 * max(f32_bytes, t_ops)}


def expect_calls(name: str, counts: dict, tok_cfg, det_cfg) -> None:
    want = expected_calls(tok_cfg, det_cfg)
    check(counts["calls"] == want,
          f"{name}: int8 calls per forward {counts['calls']}, expected "
          f"{want}")


def so400m_cut(tok_cfg, det_cfg):
    """so400m at full width with the depth cut for the CPU comparison: ViT
    depth 4 (select_layer -2: 3 blocks run), decoder depth 2."""
    return (cfgs.replace(tok_cfg, vit=cfgs.replace(tok_cfg.vit, depth=4)),
            cfgs.replace(det_cfg, decoder_depth=2))


def phase_forward_unfused() -> dict:
    """Each configuration's int8 forward (quant8=True) on the card against
    the same weights on the CPU, stage by stage, and its calls per forward
    against `expected_calls`: base @384 and ff4096 at full depth, so400m
    at full width with the depth cut; then the full-depth so400m forward
    on the card alone (shapes, finite output, calls). Returns each run's
    counts."""
    runs = {}
    for name, (tok_cfg, det_cfg) in unfused_configs().items():
        if name == "so400m":
            tok_cfg, det_cfg = so400m_cut(tok_cfg, det_cfg)
        cpu8 = init_random_(SeTok(tok_cfg, det_cfg, device="cpu",
                                  quant8=True), SEED)
        gpu8 = SeTok(tok_cfg, det_cfg, quant8=True)
        gpu8.load_state_dict(cpu8.state_dict())
        label = name if name != "so400m" else "so400m, ViT depth 4, decoder 2"
        counts = staged_forward(cpu8, gpu8, SEED + 2, FWD_INT8_TOL,
                                "forward_unfused", batch=2, config=label)
        expect_calls(name, counts, tok_cfg, det_cfg)
        runs[name] = counts
        del cpu8, gpu8
        torch.cuda.empty_cache()

    tok_cfg, det_cfg = unfused_configs()["so400m"]
    model = init_setokim_random_(SeTok(tok_cfg, det_cfg, quant8=True), SEED)
    size = tok_cfg.vit.image_size
    images = torch.rand(2, size, size, 3, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(SEED)) * 2 - 1
    reset_counts()
    out = model(images)
    torch.cuda.synchronize()
    calls, launches = int8_counts()
    det_size = det_cfg.grid * det_cfg.patch_size
    ok = (tuple(out.recon.shape) == (2, det_size, det_size, 3)
          and tuple(out.tokens.shape) == (2, tok_cfg.k_max,
                                          tok_cfg.token_feat_dim)
          and bool(torch.isfinite(out.recon).all())
          and bool(torch.isfinite(out.tokens).all()))
    emit({"phase": "forward_unfused", "config": "so400m, full depth",
          "params": sum(p.numel() for p in model.parameters()), "batch": 2,
          "calls": calls, "launches": launches,
          "num_clusters": out.num_clusters.tolist(),
          "recon_shape": list(out.recon.shape), "finite_and_shaped": ok})
    check(ok, "so400m: output has the wrong shape or is not finite")
    expect_calls("so400m", {"calls": calls}, tok_cfg, det_cfg)
    runs["so400m_full"] = {"calls": calls, "launches": launches}
    del model, out
    torch.cuda.empty_cache()
    return runs


def phase_throughput_unfused() -> None:
    """img/s by the slope method for each configuration, bf16 beside int8
    with bf16 glue, one profiled forward each and the peak memory: base
    @384 and ff4096 at B=64, so400m at B=8. Weights random from the seed,
    drawn on the card."""
    batches = {"base384": 64, "ff4096": 64, "so400m": SO400M_BATCH}
    for name, (tok_cfg, det_cfg) in unfused_configs().items():
        batch, size = batches[name], tok_cfg.vit.image_size
        images = torch.rand(batch, size, size, 3, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(SEED)) * 2 - 1
        for dtype_name, quant8 in (("bfloat16", False), ("int8", True)):
            # the same weights twice: the draw is a function of the seed
            model = init_setokim_random_(
                SeTok(tok_cfg, det_cfg, dtype=torch.bfloat16, quant8=quant8),
                SEED)
            torch.cuda.reset_peak_memory_stats()
            res = images_per_sec(model, images, 2, 8)
            emit({"phase": "throughput_unfused", "config": name,
                  "dtype": dtype_name, "batch": batch, **res,
                  "peak_memory_gb":
                      torch.cuda.max_memory_allocated() / 1e9})
            check(res["images_per_sec"] > 0,
                  "throughput slope is not positive")
            emit({"phase": "profile_unfused", "config": name,
                  "dtype": dtype_name, "batch": batch,
                  **device_time_breakdown(lambda: model(images))})
            del model
            torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# serving: Setokim over the Vicuna-7B trunk

SERVE_BATCH, PROMPT_LEN, MAX_LEN, NEW_TOKENS = 4, 128, 512, 32
QUANT_TOL = 1e-5            # exact int products, the same float epilogue
CACHE_ATTN_TOL = 2e-3       # sums in another order (as the attentions)
SERVE_PARITY_TOL = 2e-3     # prefill logits, kernels vs plain versions
SERVE_TIE_REL = 1e-3
PARITY_STEPS = 16


def trunk_shapes(cfg) -> dict:
    """(in, out) of each trunk linear of a LLaMA layer."""
    h, a = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv, i = cfg.num_kv_heads * cfg.head_dim, cfg.intermediate_size
    return {"q_proj": (h, a), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (a, h), "gate_proj": (h, i), "up_proj": (h, i),
            "down_proj": (i, h)}


def quant_bound(m: int, k: int, n: int, bits: int, n_scales: int,
                x_size: int, out_size: int) -> tuple:
    """(seconds at the memory rate, seconds at the int8 rate) of one call:
    x in, the weight and its scales, the output, each once and in the type
    the call moves (x_size and out_size bytes an element: 2 under bf16
    glue, 4 where x is float32); 2·M·N·K int8 operations."""
    nbytes = float(x_size) * m * k + n * k * bits / 8 + 4.0 * n * n_scales \
        + float(out_size) * m * n
    return nbytes / PEAK_BYTES, 2.0 * m * n * k / PEAK_INT8_OPS


def library_int_mm(x: torch.Tensor, w8: torch.Tensor):
    """torch._int_mm on the call's int8 operands (rows padded to 32: it
    takes more than 16)."""
    x8, _ = quant_rows(x)
    if x8.shape[0] <= 16:
        x8 = torch.cat([x8, x8.new_zeros(32 - x8.shape[0], x8.shape[1])])
    wt = w8.t()
    return lambda: torch._int_mm(x8, wt)


def device_split(fn, reps: int = 10) -> dict:
    """Device ms of one fn() from the profiler (the kernels' sum), and of
    its row pass and its product (GEMV or GEMM)."""
    by = device_time_breakdown(lambda: [fn() for _ in range(reps)])
    cats = by["by_category_ms"]
    return {"device_ms": by["device_ms"] / reps,
            "rows_ms": cats.get("quant_rows", 0.0) / reps,
            "product_ms": (cats.get("quant_gemm", 0.0)
                           + cats.get("quant_gemv", 0.0)) / reps,
            "kernels": sorted({k["name"] for k in by["top_kernels"]})}


def host_us_per_call(fn, device_ms: float, n: int = 200) -> tuple:
    """(host µs a call, wall ms a call): the wall time of a loop of n calls
    ended by a synchronize, minus the device time of a call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / n
    return 1e3 * (wall_ms - device_ms), wall_ms


def check_close(name: str, label: str, got, want, tol: float,
                share: float = 0.0) -> dict:
    diff = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max())
    case = {"phase": "serve_kernels", "kernel": name, "shape": label,
            "max_rel": float(diff.max()) / scale,
            "max_abs": float(diff.max()),
            "share_within_1e-5": float((diff <= 1e-5 * scale)
                                       .double().mean()),
            "finite": bool(torch.isfinite(got).all())}
    check(case["finite"], f"{name} {label}: output not finite")
    check(case["max_rel"] <= tol and case["share_within_1e-5"] >= share,
          f"{name} {label}: max-rel {case['max_rel']}, share "
          f"{case['share_within_1e-5']}")
    return case


def phase_serve_kernels() -> dict:
    """Each serving kernel against its plain version at the path's shapes;
    per format and M, the time of one layer's seven calls (ms, plain_ms,
    library_ms, bound_ms). Returns the kernels-line entries: decode
    (M = 4) of one layer, the path's w8 and w4-group-128 formats."""
    cfg = cfgs.vicuna_7b()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    group = valid_quant_group(cfg, 128)
    formats = ("w8", "w4", f"w4g{group}")
    totals = {}
    errs = {"quant_matmul": 0.0, "quant4_matmul": 0.0}
    for lin, (k, n) in trunk_shapes(cfg).items():
        w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
        weights = {"w8": quantize_weight(w),
                   "w4": quantize_weight_int4(w, None, 8),
                   formats[2]: quantize_weight_int4(w, group, 8)}
        unpacked = torch.cat(unpack_nibbles(weights["w4"].packed), dim=1)
        del w
        for m in (SERVE_BATCH, SERVE_BATCH * PROMPT_LEN):
            x = torch.randn(m, k, generator=gen, device=dev)
            for fmt, wq in weights.items():
                name = "quant_matmul" if fmt == "w8" else "quant4_matmul"
                kernel = qm.quant_matmul if fmt == "w8" else qm.quant4_matmul
                plain = (quant_matmul_plain if fmt == "w8"
                         else quant4_matmul_plain)
                got = kernel(x, wq)
                torch.cuda.synchronize()
                want = plain(x, wq)
                case = check_close(name, f"{lin} {fmt} M={m}", got, want,
                                   QUANT_TOL)
                case["elements_differing"] = int((got != want).sum())
                check(case["elements_differing"] == 0,
                      f"{name} {lin} {fmt} M={m}: "
                      f"{case['elements_differing']} elements differ from "
                      "the plain version")
                errs[name] = max(errs[name], case["max_abs"])
                lib = library_int_mm(x, wq.values if fmt == "w8"
                                     else unpacked)
                bits = 8 if fmt == "w8" else 4
                t_bytes, t_ops = quant_bound(m, k, n, bits,
                                             wq.scales.numel() // n,
                                             x_size=4, out_size=4)
                split = device_split(lambda: kernel(x, wq))
                case.update(
                    ms=time_ms(lambda: kernel(x, wq)),
                    device_ms=split["device_ms"], rows_ms=split["rows_ms"],
                    product_ms=split["product_ms"],
                    plain_ms=time_ms(lambda: plain(x, wq), reps=5,
                                     warmup=1),
                    library_ms=time_ms(lib), bound_ms=1e3 * max(t_bytes,
                                                                t_ops))
                case["host_us"], case["wall_ms"] = host_us_per_call(
                    lambda: kernel(x, wq), split["device_ms"])
                emit(case)
                tot = totals.setdefault((fmt, m), {
                    "ms": 0.0, "device_ms": 0.0, "rows_ms": 0.0,
                    "product_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "host_us": 0.0, "wall_ms": 0.0, "t_bytes": 0.0,
                    "t_ops": 0.0})
                for key in ("ms", "device_ms", "rows_ms", "product_ms",
                            "plain_ms", "library_ms", "host_us",
                            "wall_ms"):
                    tot[key] += case[key]
                tot["t_bytes"] += t_bytes
                tot["t_ops"] += t_ops
                tot["kernels"] = split["kernels"]   # the profiler's names
    for (fmt, m), tot in totals.items():
        emit({"phase": "serve_kernels", "format": fmt, "M": m,
              "one_layer_seven_linears": tot,
              "bound_ms": 1e3 * max(tot["t_bytes"], tot["t_ops"])})

    entries = {}
    for name, fmt, replaces in (
            ("quant_matmul", "w8", "setok_tpu/kernels/quant_matmul.py:54"),
            ("quant4_matmul", formats[2],
             "setok_tpu/kernels/quant_matmul.py:226")):
        tot = totals[(fmt, SERVE_BATCH)]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "setok_tpu_torch/csrc/quant_matmul.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": 1e3 * max(tot["t_bytes"], tot["t_ops"]),
            "bound_by": "bytes" if tot["t_bytes"] >= tot["t_ops"]
            else "operations",
            "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
            "rows_ms": tot["rows_ms"], "product_ms": tot["product_ms"],
            "host_us": tot["host_us"], "wall_ms": tot["wall_ms"],
            "timing": f"the seven trunk linears of one layer, {fmt}, "
                      f"M={SERVE_BATCH} (decode)"}
    # wgmma_gemm_kernel<B source, grouped, QuantEpi<out type, ...>>
    epi = {"bfloat16": "ENS_8QuantEpiI13__nv_bfloat16", "float32":
           "ENS_8QuantEpiIf"}
    entries["quant_matmul"]["wgmma_gemm_ptxas"] = {
        out: ptxas_of("quant_matmul", "wgmma_gemm_kernel", "Li0ELb0" + arg)
        for out, arg in epi.items()}
    # row 9: its prefill (M = 512) per format beside row 8's wgmma GEMM and
    # torch._int_mm, and ptxas's registers and spills of its kernels
    prefill = {}
    for fmt in formats:
        tot = totals[(fmt, SERVE_BATCH * PROMPT_LEN)]
        prefill[fmt] = {key: tot[key] for key in (
            "ms", "device_ms", "rows_ms", "product_ms", "library_ms",
            "plain_ms", "kernels")}
        prefill[fmt]["bound_ms"] = 1e3 * max(tot["t_bytes"], tot["t_ops"])
    entries["quant4_matmul"]["prefill_M512"] = prefill
    entries["quant4_matmul"]["ptxas"] = {
        "gemv w4g M<=4 f32": ptxas_of("quant_matmul", "gemv_kernel",
                                      "Li2ELi4EfE"),
        "gemv w4 M<=4 f32": ptxas_of("quant_matmul", "gemv_kernel",
                                     "Li1ELi4EfE"),
        **{f"wgmma {kind} {out}": ptxas_of(
            "quant_matmul", "wgmma_gemm_kernel", tmpl + arg)
           for kind, tmpl in (("w4", "Li1ELb0"), ("w4g", "Li1ELb1"))
           for out, arg in epi.items()}}
    entries["int8_cache_decode_attention"] = cache_attention_case(cfg, gen)
    return entries


def serving_mask(b: int, s: int, gen, device) -> torch.Tensor:
    """The serving layout of the key mask: each row's prompt (pad holes in
    it) and the tokens decoded so far, the tail of the cache masked: 160,
    128, 97 and 33 valid positions of 512, a tenth of them holes."""
    lengths = torch.tensor([PROMPT_LEN + NEW_TOKENS, PROMPT_LEN, 97, 33],
                           device=device)[torch.arange(b, device=device) % 4]
    valid = torch.arange(s, device=device)[None] < lengths[:, None]
    return valid & (torch.rand(b, s, generator=gen, device=device) >= 0.1)


def cache_attention_case(cfg, gen) -> dict:
    """The cache kernel at B=4, S=max_len, every head of the trunk, against
    its plain version: a key mask with holes (and a fully masked row), and
    the serving layout (bf16 q, the cache's tail masked): its time by
    events, device time, host µs a call, the tiles it skipped against
    `masked_tiles`, the elements that differ (0 at both: the same float64
    sums rounded once); its bound and SDPA's time on the dequantised K/V."""
    dev = torch.device("cuda")
    b, s = SERVE_BATCH, MAX_LEN
    kvh, h, d = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    q = torch.randn(b, h, d, generator=gen, device=dev)

    def int8(shape):
        f = torch.randn(shape, generator=gen, device=dev)
        sc = f.abs().amax(-1) / torch.full_like(f[..., 0], 127.0)
        return torch.round(f / sc[..., None]).clamp(-127, 127).to(
            torch.int8), sc

    k8, ks = int8((b, s, kvh, d))
    v8, vs = int8((b, s, kvh, d))
    holes = torch.rand(b, s, generator=gen, device=dev) > 0.3
    holes[-1] = False
    sm = d ** -0.5
    cases = {}
    for label, qq, valid in (("holes", q, holes),
                             ("serving", q.to(torch.bfloat16),
                              serving_mask(b, s, gen, dev))):
        args = (qq, k8, ks, v8, vs, valid)
        skipped = torch.zeros(1, dtype=torch.int32, device=dev)
        got = ca.int8_cache_decode_attention(*args, sm, skipped=skipped)
        torch.cuda.synchronize()
        want = ca.int8_cache_decode_attention_plain(*args, sm)
        case = check_close("int8_cache_decode_attention",
                           f"{label} B={b} S={s} KVH={kvh} G={h // kvh} "
                           f"D={d} {qq.dtype}", got, want, CACHE_ATTN_TOL,
                           INT8_ATTN_SHARE)
        case["elements_differing"] = int((got != want).sum())
        case["tiles_skipped"] = int(skipped)
        case["tiles_masked"] = ca.masked_tiles(valid, kvh)
        case["tiles"] = b * kvh * -(-s // ca.TILE)
        case["cluster"] = ca.CLUSTER
        check(got.dtype == qq.dtype, f"cache attention {label}: output "
              f"{got.dtype} for q {qq.dtype}")
        check(case["elements_differing"] == 0,
              f"cache attention {label}: {case['elements_differing']} "
              "elements differ from the plain version")
        check(case["tiles_skipped"] == case["tiles_masked"],
              f"cache attention {label}: {case['tiles_skipped']} tiles "
              f"skipped, {case['tiles_masked']} wholly masked")
        kd = (k8.float() * ks[..., None]).permute(0, 2, 1, 3)
        vd = (v8.float() * vs[..., None]).permute(0, 2, 1, 3)
        mask = valid[:, None, None, :]
        live = 1.0 - case["tiles_skipped"] / case["tiles"]
        nbytes = (2.0 * qq.element_size() * b * h * d       # q in, out
                  + live * (2.0 * b * s * kvh * d + 8.0 * b * s * kvh)
                  + b * s)
        t_bytes = nbytes / PEAK_BYTES
        t_ops = live * 4.0 * b * h * s * d / PEAK_F32_FLOPS
        device_ms = device_split(
            lambda: ca.int8_cache_decode_attention(*args, sm))["device_ms"]
        case.update(
            ms=time_ms(lambda: ca.int8_cache_decode_attention(*args, sm)),
            device_ms=device_ms,
            plain_ms=time_ms(lambda: ca.int8_cache_decode_attention_plain(
                *args, sm), reps=5, warmup=1),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qq.float()[:, :, None], kd, vd, attn_mask=mask)),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["host_us_per_call"], case["wall_ms"] = host_us_per_call(
            lambda: ca.int8_cache_decode_attention(*args, sm), device_ms)
        emit(case)
        cases[label] = case
    # G = 8 past the ~5,085 keys where a whole-row score buffer no longer
    # fits shared memory (a GQA trunk's long cache: 32 heads over 4)
    gk8, gks = int8((1, 8192, 4, d))
    gv8, gvs = int8((1, 8192, 4, d))
    gargs = (torch.randn(1, 32, d, generator=gen, device=dev).to(
        torch.bfloat16), gk8, gks, gv8, gvs,
        torch.rand(1, 8192, generator=gen, device=dev) > 0.3)
    got = ca.int8_cache_decode_attention(*gargs, sm)
    torch.cuda.synchronize()
    want = ca.int8_cache_decode_attention_plain(*gargs, sm)
    gcase = check_close("int8_cache_decode_attention",
                        "B=1 S=8192 KVH=4 G=8 D=128 bf16", got, want,
                        CACHE_ATTN_TOL, INT8_ATTN_SHARE)
    gcase["elements_differing"] = int((got != want).sum())
    gcase["cluster"] = ca.CLUSTER
    emit(gcase)
    main = cases["holes"]
    return {"name": "int8_cache_decode_attention", "route": "cuda",
            "source": "setok_tpu_torch/csrc/cache_attention.cu",
            "replaces": "setok_tpu/kernels/cache_attention.py:75",
            "launches": None, "max_abs_err": max(c["max_abs"]
                                                 for c in cases.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "device_ms": main["device_ms"],
            "host_us_per_call": main["host_us_per_call"],
            "serving_layout": {key: cases["serving"][key] for key in (
                "ms", "device_ms", "host_us_per_call", "bound_ms",
                "tiles_skipped", "tiles", "elements_differing",
                "library_ms")},
            "timing": f"one layer's decode step, B={b}, S={s}"}


def serve_counts() -> dict:
    return {"quant_matmul": dict(qm.CALLS), "quant_matmul_launches":
            dict(qm.LAUNCHES), "cache_attention": ca.LAUNCHES,
            "cluster": cluster_dpc.LAUNCHES}


def build_setokim(cfg, bits: int) -> Setokim:
    """Setokim on the card, random weights from the seed, the trunk
    quantised as scripts/serve.py does it (int4: group 128 where the widths
    allow, clip search 8), with the int8-cache decode kernel."""
    group = valid_quant_group(cfg.llama, 128) if bits == 4 else 0
    model = Setokim(cfg, target_token_id=3, weight_bits=bits,
                    quant_group=group, cache_kernel=True)
    return init_setokim_random_(model, SEED,
                                clip_search=8 if bits == 4 else 0)


def serve_requests(cfg, seed: int, n_image: int = 4, n_text: int = 4):
    """(prompt ids, image or None): image requests first (BOS, k_max image
    slots, text), then text-only ones."""
    rs = np.random.RandomState(seed)
    size, k_max = cfg.tokenizer.vit.image_size, cfg.tokenizer.k_max
    vocab = cfg.llama.vocab_size
    out = []
    for i in range(n_image + n_text):
        if i < n_image:
            text = rs.randint(10, vocab, rs.randint(8, PROMPT_LEN - k_max))
            ids = np.concatenate([[1], np.full(k_max, IMAGE_TOKEN_INDEX),
                                  text])
            image = rs.uniform(-1, 1, (size, size, 3)).astype(np.float32)
        else:
            ids = np.concatenate([[1], rs.randint(10, vocab,
                                                  rs.randint(16, PROMPT_LEN))])
            image = None
        out.append((ids.astype(np.int64), image))
    return out


def trunk_bytes(model: Setokim) -> int:
    return sum(t.numel() * t.element_size() for mod in model.modules()
               if isinstance(mod, (QuantDense, Quant4Dense))
               for t in mod.buffers())


def run_engine(model: Setokim, reqs, new_tokens: int, profile_step=None,
               submit_kw=None, **engine_kw):
    """The requests through a ServeEngine (`engine_kw` beside the serving
    configuration; `submit_kw` a dict of submit arguments per request);
    per step its wall time, its prefill calls and the launch counts it
    added. Renders left at the end are harvested before the check."""
    eng = ServeEngine(model, max_batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                      max_len=MAX_LEN, eos_id=-1, pad_id=0,
                      cache_dtype=torch.int8, **engine_kw)
    prefills = {"image": 0, "text": 0}

    def counted(kind, fn):
        def call(*args):
            prefills[kind] += 1
            return fn(*args)
        return call

    eng._prefill_impl = counted("image", eng._prefill_impl)
    eng._prefill_text_impl = counted("text", eng._prefill_text_impl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(ids, image=img, max_new_tokens=new_tokens,
                          **(submit_kw[i] if submit_kw else {}))
               for i, (ids, img) in enumerate(reqs)]
    steps, profile = [], None
    while True:
        before = (serve_counts(), sum(prefills.values()))
        t = time.perf_counter()
        if profile_step is not None and len(steps) == profile_step:
            profile = device_time_breakdown(eng.step)
            active = int(eng._active.sum())
        else:
            active = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = serve_counts()
        steps.append({
            "s": dt, "prefills": sum(prefills.values()) - before[1],
            "decode": after["cache_attention"]
            > before[0]["cache_attention"],
            "quant_calls": sum(after["quant_matmul"].values())
            - sum(before[0]["quant_matmul"].values()),
            "quant_launches": sum(after["quant_matmul_launches"].values())
            - sum(before[0]["quant_matmul_launches"].values()),
            "cache_launches": after["cache_attention"]
            - before[0]["cache_attention"]})
        if active == 0 and eng._queue.empty():
            break
    eng._harvest_renders()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done for r in handles), "a request did not finish")
    return eng, handles, steps, prefills, wall, profile


def phase_serve(cfg, bits: int, keep: bool = False):
    """The serving path at full width at `bits`, its counts from one run
    (and, with `keep`, the model, for the next phase)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_setokim(cfg, bits)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = serve_requests(cfg, SEED + bits)
    run_engine(model, reqs[3:5], 4)                     # warm-up
    layers = cfg.llama.num_layers
    per_call = len(TRUNK_LINEARS) * layers

    reset_counts()
    eng, handles, steps, prefills, wall, _ = run_engine(model, reqs,
                                                        NEW_TOKENS)
    torch.cuda.synchronize()
    counts = serve_counts()
    # a decode step under the profiler, in a run of its own: the profiler's
    # start costs a second, which the measured run must not carry
    profile = run_engine(model, reqs[:SERVE_BATCH], 8, profile_step=3)[-1]
    decode = [st for st in steps if st["decode"]]
    pure = [st for st in decode if not st["prefills"]]
    n_prefill = prefills["image"] + prefills["text"]
    name = "quant_matmul" if bits == 8 else "quant4_matmul"
    calls = counts["quant_matmul"][name]
    ntok = sum(len(r.tokens) for r in handles)
    trunk = trunk_bytes(model)
    lm_head = model.llama.lm_head.weight.numel() * 4
    cache_read = (2 * layers * SERVE_BATCH * MAX_LEN * cfg.llama.num_kv_heads
                  * (cfg.llama.head_dim + 4))
    decode_ms = [1e3 * st["s"] for st in pure]
    res = {"phase": "serve", "bits": bits, "config": "base_setokim",
           "trunk_layers": layers, "hidden": cfg.llama.hidden_size,
           "kv_cache": "int8", "cache_kernel": True,
           "requests": len(handles), "tokens": ntok,
           "new_tokens_each": NEW_TOKENS, "build_s": build_s,
           "wall_s": wall, "tokens_per_s": ntok / wall,
           "ttft_mean_ms": 1e3 * statistics.mean(r.ttft for r in handles),
           "ttft_ms": [1e3 * r.ttft for r in handles],
           "step_ms": [1e3 * st["s"] for st in steps],
           "latency_mean_ms": 1e3 * statistics.mean(r.latency
                                                    for r in handles),
           "decode_steps": len(decode), "pure_decode_steps": len(pure),
           "decode_ms_per_step_median": statistics.median(decode_ms),
           "decode_ms_per_step_min": min(decode_ms),
           "trunk_gb": trunk / 1e9,
           "weight_stream_bound_ms": 1e3 * trunk / PEAK_BYTES,
           "step_bound_ms": 1e3 * (trunk + lm_head + cache_read)
           / PEAK_BYTES,
           "prefill_calls": prefills,
           "launches_per_decode_step": {
               name: sorted({st["quant_launches"] for st in pure}),
               "int8_cache_decode_attention": sorted(
                   {st["cache_launches"] for st in pure})},
           "cluster_launches_per_image_admission":
               counts["cluster"] / max(prefills["image"], 1),
           "counts": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profiled_decode_step": profile, "stats": eng.stats()}
    emit(res)
    check(ntok == len(handles) * NEW_TOKENS, "a request stopped early")
    # a decode call (M = 4 rows) is one launch: the GEMV quantises x itself
    check(bool(pure) and all(st["quant_calls"] == per_call
                             and st["quant_launches"] == per_call
                             and st["cache_launches"] == layers
                             for st in pure),
          f"a decode step did not make {per_call} {name} calls of one launch "
          f"each and {layers} cache-attention launches")
    check(calls == per_call * (len(decode) + n_prefill),
          f"{name}: {calls} calls, expected {per_call} per decode step and "
          "per prefill")
    check(counts["cache_attention"] == layers * len(decode),
          "cache-attention launches are not one per layer and decode step")
    check(prefills["image"] >= 1
          and counts["cluster"]
          == cluster_dpc.LAUNCHES_PER_CALL * prefills["image"],
          "the clustering kernel did not launch once per image admission")
    check(not counts["quant_matmul"]["quant_matmul" if bits == 4
                                     else "quant4_matmul"],
          "the other weight format's kernel launched")
    out = {"calls": calls, "launches": counts["quant_matmul_launches"][name],
           "cache_launches": counts["cache_attention"],
           "decode_steps": len(decode)}
    if keep:
        return out, model
    del model, eng
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# generation: decode_block, per-request sampling, image generation

GEN_BLOCK = 4               # decode steps per dispatch, against 1
GEN_ITERS = 16              # MaskGIT iterations of a full render
GEN_CFG = 3.0               # the guided render's scale
GEN_CUT_ITERS, GEN_CUT_STEPS = 2, "10"     # the render held to the CPU
GEN_SAMPLED = {"temperature": 0.8, "top_p": 0.9}


def all_launches() -> dict:
    """Every kernel's launches since the last reset, by table row name."""
    out = {"dpc_density_parent": cluster_dpc.LAUNCHES,
           "int8_cache_decode_attention": ca.LAUNCHES, **qm.LAUNCHES,
           **fa.LAUNCHES}
    for mod in (fs, fba, fm, fai):
        out.update(mod.LAUNCHES)
    return out


def move_diffusion_head(model: Setokim) -> None:
    """The diffusion head's parameters moved by N(0, 0.02²) from the seed:
    its zero-initialised modulations and output layer would leave the
    sampler's model output at 0."""
    gen = torch.Generator(device=model.device).manual_seed(SEED + 13)
    with torch.no_grad():
        for p in model.diffloss.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen,
                                      device=p.device))


def span_markers(streams) -> tuple:
    """The pair of ids (start, end) of the first stream between which it
    holds a non-empty span, with the fewest spans over all the streams
    (each span is a full render)."""
    first = streams[0]
    pairs = {(start, end) for i, start in enumerate(first)
             for end in first[i + 2:]
             if end != start and spans_of(first, start, end)}
    if not pairs:
        raise SystemExit(f"chip_smoke: FAILED: no id pair of the greedy "
                         f"stream {first} holds a non-empty span")
    return min(sorted(pairs), key=lambda p: sum(
        len(spans_of(t, *p)) for t in streams))


def spans_of(tokens, start: int, end: int) -> list:
    return [(s, e) for s, e in find_image_spans(np.asarray(tokens), start,
                                                end) if e > s]


def fixed_image_draws(b: int, seq_len: int, c: int, num_iter: int,
                      steps: int, use_cfg: bool):
    """Draws of one sample_image_tokens made on the CPU from the seed, and
    a function that places them on a device."""
    gen = torch.Generator().manual_seed(SEED + 17)
    orders = torch.argsort(torch.rand((b, seq_len), generator=gen), dim=1)
    n = b * seq_len * (2 if use_cfg else 1)
    its = [(torch.randn((n // 2 if use_cfg else n, c), generator=gen),
            torch.randn((steps, n, c), generator=gen))
           for _ in range(num_iter)]

    def on(device) -> ImageDraws:
        placed = [SampleDraws(a.to(device), z.to(device).__getitem__)
                  for a, z in its]
        return ImageDraws(orders.to(device), placed.__getitem__)
    return on


def timed_render(model, span, scale: float) -> tuple:
    """One full render from the seed: (image, ms, every launch of the
    table's kernels it made)."""
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    image = generate_image(model, span, gen, GEN_ITERS, scale)
    torch.cuda.synchronize()
    return image, 1e3 * (time.perf_counter() - t), all_launches()


def engine_run_summary(handles, steps, wall, profile, block: int) -> dict:
    decode = [st for st in steps if st["decode"]]
    pure = [st for st in decode if not st["prefills"]]
    ntok = sum(len(r.tokens) for r in handles)
    return {"decode_block": block, "tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall, "steps": len(steps),
            "decode_dispatches": len(decode),
            "pure_dispatch_ms_median": statistics.median(
                1e3 * st["s"] for st in pure),
            "ttft_mean_ms": 1e3 * statistics.mean(r.ttft for r in handles),
            "profiled_dispatch": profile,
            "busy_share": profile["busy_share"],
            "device_ms_per_token_step": profile["device_ms"] / block}


def phase_generate(cfg, model: Setokim) -> dict:
    """Generation at full width on the bits-8 model of phase_serve: the
    serving requests at decode_block 4 against single steps, a batch
    mixing greedy and sampled rows, full renders of an 80-token span of a
    real decode (cfg 1 and GEN_CFG), a render through the engine's
    retirement, and a cut render held to the CPU. Returns the launches of
    rows 8 and 11 in the decode_block run."""
    t0 = time.perf_counter()
    dev = model.device
    move_diffusion_head(model)
    layers = cfg.llama.num_layers
    per_call = len(TRUNK_LINEARS) * layers
    reqs = serve_requests(cfg, SEED + 8)
    runs, handles_of, block_counts = [], [], None
    # in turns: single steps, blocks, blocks, single steps
    for block in (1, GEN_BLOCK, GEN_BLOCK, 1):
        reset_counts()
        _, handles, steps, _, wall, _ = run_engine(
            model, reqs, NEW_TOKENS, decode_block=block)
        counts = serve_counts()
        # the profiled dispatch, in a run of its own: a pure decode one
        profile = run_engine(model, reqs[:SERVE_BATCH], 8 if block == 1
                             else 12, profile_step=3 if block == 1 else 1,
                             decode_block=block)[-1]
        runs.append(engine_run_summary(handles, steps, wall, profile, block))
        handles_of.append([r.tokens for r in handles])
        pure = [st for st in steps if st["decode"] and not st["prefills"]]
        check(bool(pure) and all(
            st["quant_launches"] == per_call * block
            and st["cache_launches"] == layers * block for st in pure),
            f"decode_block {block}: a dispatch did not launch "
            f"{per_call * block} quant_matmul and {layers * block} "
            "cache-attention kernels")
        check(all(len(r.tokens) == NEW_TOKENS for r in handles),
              f"decode_block {block}: a request stopped early")
        if block == GEN_BLOCK and block_counts is None:
            block_counts = counts
    greedy = handles_of[0]
    identical = all(tokens == greedy for tokens in handles_of)

    # greedy and sampled rows in one batch
    mixed_kw = [GEN_SAMPLED if i % 2 else {} for i in range(len(reqs))]
    mixed = run_engine(model, reqs, NEW_TOKENS, submit_kw=mixed_kw,
                       per_request_sampling=True)[1]
    greedy_rows_same = all(mixed[i].tokens == greedy[i]
                           for i in range(0, len(reqs), 2))
    sampled_rows_moved = sum(mixed[i].tokens != greedy[i]
                             for i in range(1, len(reqs), 2))

    # full renders of an 80-token span of a real decode
    ids, image = reqs[0]
    row = np.zeros((1, PROMPT_LEN), np.int64)
    row[0, :len(ids)] = ids
    out = generate_text(model, torch.from_numpy(row).to(dev),
                        torch.from_numpy(image)[None].to(dev),
                        cfg.target_num + 1, eos_id=-1)
    span = out.hidden[:, :cfg.target_num]
    renders = {}
    for scale in (1.0, GEN_CFG):
        img, ms, launches = timed_render(model, span, scale)
        renders[scale] = {"cfg_scale": scale, "shape": list(img.shape),
                          "finite": bool(torch.isfinite(img).all()),
                          "ms": ms, "launches": {
                              k: v for k, v in launches.items() if v}}
        check(tuple(img.shape) == (1, 256, 256, 3)
              and renders[scale]["finite"],
              f"render at cfg {scale}: shape {tuple(img.shape)}, finite "
              f"{renders[scale]['finite']}")
        check(not any(launches.values()),
              f"the render launched a kernel of the table: {launches}")
    profile = device_time_breakdown(lambda: generate_image(
        model, span, torch.Generator(device=dev).manual_seed(SEED),
        GEN_ITERS, 1.0))

    # a render through the engine's retirement: markers from the greedy run
    start, end = span_markers(greedy)
    want_spans = [len(spans_of(t, start, end)) for t in greedy]
    t = time.perf_counter()
    _, served, *_ = run_engine(model, reqs, NEW_TOKENS, im_start_id=start,
                               im_end_id=end, num_iter=GEN_ITERS)
    engine_render_s = time.perf_counter() - t
    engine_images = [len(r.images_out) for r in served]
    engine_ok = ([r.tokens for r in served] == greedy
                 and engine_images == want_spans
                 and all(im.shape == (256, 256, 3) and np.isfinite(im).all()
                         for r in served for im in r.images_out))

    # the cut render, card against CPU, on the same weights and draws
    cut = cfgs.replace(cfg, llama=cfgs.replace(cfg.llama, num_layers=0,
                                               vocab_size=32))
    cpu = Setokim(cut, target_token_id=3, device="cpu")
    for name in ("mm_out_projector", "diffloss", "vision_generator"):
        getattr(cpu, name).load_state_dict(getattr(model, name).state_dict())
    full_schedule = model.diffloss.gen_diffusion
    model.diffloss.gen_diffusion = cpu.diffloss.gen_diffusion = \
        create_diffusion(GEN_CUT_STEPS, noise_schedule="cosine")
    hidden = torch.from_numpy(np.random.RandomState(SEED).randn(
        1, cfg.target_num, cfg.llama.hidden_size).astype(np.float32))
    draws = fixed_image_draws(1, cfg.target_num,
                              cfg.diffloss.target_channels, GEN_CUT_ITERS,
                              int(GEN_CUT_STEPS), True)
    sides = {}
    for side, m, d in (("cpu", cpu, "cpu"), ("card", model, dev)):
        toks = m.sample_image_tokens(hidden.to(d), None, GEN_CUT_ITERS,
                                     GEN_CFG, draws=draws(d))
        sides[side] = (toks, m.render_image(toks).image)
    model.diffloss.gen_diffusion = full_schedule
    del cpu
    cut_rel = {"tokens": max_rel(sides["card"][0], sides["cpu"][0]),
               "image": max_rel(sides["card"][1], sides["cpu"][1])}

    res = {"phase": "generate", "config": "base_setokim", "bits": 8,
           "kv_cache": "int8", "cache_kernel": True,
           "requests": len(reqs), "new_tokens_each": NEW_TOKENS,
           "decode_block_runs_in_turns": runs,
           "decode_block_streams_identical": identical,
           "per_request": {"sampled_rows": GEN_SAMPLED,
                           "greedy_rows_unchanged": greedy_rows_same,
                           "sampled_rows_that_differ": sampled_rows_moved},
           "render": {"span_tokens": cfg.target_num, "num_iter": GEN_ITERS,
                      "sampling_steps": cfg.diffloss.num_sampling_steps,
                      "runs": list(renders.values()),
                      "profiled_render_cfg1": profile},
           "engine_render": {"im_start_id": start, "im_end_id": end,
                             "images_per_request": engine_images,
                             "seconds": engine_render_s, "ok": engine_ok},
           "cut_render_card_vs_cpu": {"num_iter": GEN_CUT_ITERS,
                                      "respacing": GEN_CUT_STEPS,
                                      "cfg_scale": GEN_CFG,
                                      "max_rel": cut_rel,
                                      "tol": FWD_REL_TOL},
           "seconds": time.perf_counter() - t0}
    emit(res)
    check(identical, "decode_block 4 streams differ from single steps")
    check(greedy_rows_same, "a greedy row changed beside sampled rows")
    check(engine_ok, f"the engine's retirement render: images "
          f"{engine_images}, spans {want_spans}")
    check(max(cut_rel.values()) <= FWD_REL_TOL,
          f"cut render card vs CPU: {cut_rel} > {FWD_REL_TOL}")
    return {"launches": block_counts["quant_matmul_launches"][
        "quant_matmul"], "cache_launches": block_counts["cache_attention"],
        "dispatches": runs[1]["decode_dispatches"],
        "decode_block": GEN_BLOCK}


@contextmanager
def plain_route():
    """The trunk's kernels replaced by their plain versions."""
    with mock.patch.object(qm, "quant_matmul", quant_matmul_plain), \
            mock.patch.object(qm, "quant4_matmul", quant4_matmul_plain), \
            mock.patch.object(ca, "int8_cache_decode_attention",
                              ca.int8_cache_decode_attention_plain), \
            mock.patch.object(fa, "flash_attention",
                              fa.flash_attention_plain):
        yield


def greedy_run(model: Setokim, ids, images):
    """Prefill (images, or text when None) and PARITY_STEPS greedy decode
    steps: the logits of every step and the (steps + 1, B) tokens."""
    if images is None:
        logits, _, cache, valid, _ = model.prefill_text(
            ids, MAX_LEN, cache_dtype=torch.int8)
    else:
        logits, _, cache, valid, _ = model.prefill(
            ids, images, MAX_LEN, cache_dtype=torch.int8)
    outs, toks = [logits], [logits.argmax(-1)]
    pos = valid.to(torch.int32).sum(dim=1)
    for _ in range(PARITY_STEPS):
        logits, _, cache, valid = model.decode_step(toks[-1][:, None], cache,
                                                    valid, pos)
        outs.append(logits)
        toks.append(logits.argmax(-1))
        pos = pos + 1
    return outs, torch.stack(toks).cpu()


def phase_serve_parity(cfg, bits: int) -> None:
    """The trunk cut to 2 layers at full width, greedy, through the kernels
    and through their plain versions on the card: the prefill logits
    within SERVE_PARITY_TOL, and the same tokens; where a row's tokens
    first differ, the plain logits' top-2 gap there must be a near-tie
    (< SERVE_TIE_REL of max|logits|), and it is printed."""
    small = cfgs.replace(cfg, llama=cfgs.replace(cfg.llama, num_layers=2))
    model = build_setokim(small, bits)
    reqs = serve_requests(small, SEED + 7 * bits)
    dev = torch.device("cuda")
    for kind, batch in (("image", reqs[:4]), ("text", reqs[4:])):
        ids = np.zeros((len(batch), PROMPT_LEN), np.int64)
        for i, (p, _) in enumerate(batch):
            ids[i, :len(p)] = p
        ids = torch.from_numpy(ids).to(dev)
        images = (None if kind == "text" else torch.from_numpy(
            np.stack([im for _, im in batch])).to(dev))
        reset_counts()
        with plain_route():
            want, want_toks = greedy_run(model, ids, images)
        check(not sum(qm.CALLS.values()) and not ca.LAUNCHES,
              "the plain route launched a kernel")
        got, got_toks = greedy_run(model, ids, images)
        check(sum(qm.CALLS.values()) > 0 and ca.LAUNCHES > 0,
              "the kernel route launched no kernel")
        # per row, the logits of the steps whose inputs were the same
        rels, ties = [], []
        for row in range(ids.shape[0]):
            differ = (got_toks[:, row] != want_toks[:, row]).nonzero()
            last = int(differ[0]) if len(differ) else PARITY_STEPS
            rels.append(max(max_rel(got[j][row], want[j][row])
                            for j in range(last + 1)))
            if len(differ):
                w = want[last][row].double()
                top = torch.topk(w, 2).values
                ties.append({"row": row, "step": last, "top2_gap_rel": float(
                    (top[0] - top[1]) / w.abs().max())})
        prefill_rel = max_rel(got[0], want[0])
        emit({"phase": "serve_parity", "bits": bits, "kind": kind,
              "trunk_layers": 2, "steps": PARITY_STEPS,
              "prefill_logits_max_rel": prefill_rel,
              "logits_max_rel_while_same_tokens": max(rels),
              "tokens_identical": not ties, "first_divergences": ties})
        check(prefill_rel <= SERVE_PARITY_TOL,
              f"serve_parity bits {bits} {kind}: prefill logits max-rel "
              f"{prefill_rel} > {SERVE_PARITY_TOL}")
        check(all(t["top2_gap_rel"] < SERVE_TIE_REL for t in ties),
              f"serve_parity bits {bits} {kind}: greedy tokens differ "
              f"beyond a near-tie: {ties}")
    del model
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# stage-2 training: the flash-attention kernels and the LoRA trainer

# flash kernels against their plain versions on the card: the forward rounds
# p to bf16 before P.V, so a last-bit change of a score can flip one such
# rounding (the bar of the other attentions); the lse and the gradients are
# float32 throughout, sums in another order
FLASH_FWD_TOL = 2e-3
FLASH_LSE_TOL = 1e-5
FLASH_GRAD_TOL = 1e-4
FLASH_KERNELS = (("flash_fwd", "setok_tpu/kernels/flash_attention.py:146"),
                 ("flash_dq", "setok_tpu/kernels/flash_attention.py:185"),
                 ("flash_dkv", "setok_tpu/kernels/flash_attention.py:208"))
TRAIN_BATCH, TRAIN_LEN, TRAIN_MIN_LEN = 4, 2048, 1024
TRAIN_ACCUM, TRAIN_UPDATES = 2, 3
# kernels vs plain versions through a 2-layer trunk in bf16: the losses,
# and gradients whose bf16 sums run in another order
TRAIN_PARITY_LOSS_TOL = 1e-3
TRAIN_PARITY_GRAD_TOL = 2e-2


def splice_mask(cfg, b: int, length: int, seed: int, device) -> torch.Tensor:
    """The trunk's (B, L, L) attention mask of a synthetic training batch
    through the splice (models/setokim.splice_layout): each image with a
    random cluster count (holes in its k_max slots), a pad tail per row
    (fully masked query rows), causal in position order."""
    rs = np.random.RandomState(seed)
    batch = synthetic_batch(cfg, b, length, rs, min_len=length // 2)
    k_max = cfg.tokenizer.k_max
    counts = rs.randint(k_max // 4, k_max + 1, b)
    img_valid = torch.from_numpy(np.arange(k_max)[None] < counts[:, None])
    ids = torch.from_numpy(batch["input_ids"])
    _, _, valid, positions = splice_layout(ids, img_valid, 0)
    return make_attention_mask(valid, positions)[:, 0].to(device)


def flash_inputs(b: int, h: int, lq: int, lk: int, d: int, dtype, device,
                 seed: int):
    """q, k, v and the upstream gradient do, normal draws from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d),
                               (b, h, lq, d)))


def flash_bwd_case(q, k, v, do, mask, po, plse) -> dict:
    """The dq and dk/dv kernels against their plain versions on the plain
    forward's o (cast to the input type) and lse. Checks the gradient bar,
    finite outputs and dq exactly 0 on fully masked query rows; returns the
    readings, with (o, delta) for timing under "inputs"."""
    sc = q.shape[-1] ** -0.5
    o_t = po.to(q.dtype)
    dq, delta = fa.flash_dq(q, k, v, mask, o_t, do, plse, sc)
    dk, dv = fa.flash_dkv(q, k, v, mask, do, plse, delta, sc)
    torch.cuda.synchronize()
    pdq = fa.flash_dq_plain(q, k, v, mask, o_t, do, plse, sc)
    pdk, pdv = fa.flash_dkv_plain(q, k, v, mask, o_t, do, plse, sc)
    rows = mask.any(-1)[:, None].expand_as(plse)
    case = {"dq_max_rel": max_rel(dq, pdq), "dk_max_rel": max_rel(dk, pdk),
            "dv_max_rel": max_rel(dv, pdv),
            "max_abs": {"flash_dq": float((dq - pdq).abs().max()),
                        "flash_dkv": max(float((dk - pdk).abs().max()),
                                         float((dv - pdv).abs().max()))},
            "finite": all(bool(torch.isfinite(t).all())
                          for t in (dq, dk, dv))}
    shape = [*q.shape[:3], k.shape[2], q.shape[3]]
    check(case["finite"], f"flash backward {shape}: output not finite")
    check(bool((dq[~rows] == 0).all()),
          f"flash_dq {shape}: a fully masked row is not zero")
    for key in ("dq_max_rel", "dk_max_rel", "dv_max_rel"):
        check(case[key] <= FLASH_GRAD_TOL,
              f"flash {shape}: {key} {case[key]} > {FLASH_GRAD_TOL}")
    case["inputs"] = (o_t, delta)
    return case


def share_within_1e5(got, want) -> float:
    """The share of elements within 1e-5 of the largest |want|."""
    diff = (got.double() - want.double()).abs()
    return float((diff <= 1e-5 * want.double().abs().max()).double().mean())


def flash_fwd_twin(q, k, v, mask, sm_scale):
    """The plain forward with its scores summed in float64 and rounded
    once: a legal reordering of the plain version's sums, the yardstick of
    the forward's share bar."""
    with mock.patch.object(fa, "_scores", scores_f64):
        return fa.flash_fwd_plain(q, k, v, mask, sm_scale)


def flash_fwd_check(q, k, v, mask, twin_bar: bool = False) -> dict:
    """The forward kernel against its plain version on one input, with the
    float64-score twin's share beside the kernel's. Bars: o max-rel 2e-3,
    o exactly 0 on fully masked rows, lse 1e-5 on the others, and a share
    of o within 1e-5 of the largest of at least 99 % or, with twin_bar
    where the twin falls under 99 %, no more than 0.01 under the twin's
    share. Over ~700 valid keys a row's largest |o| is ~0.45, and one
    flipped bf16 rounding of one p moves o by ~2^-8·|v|/700, the size of
    that threshold: a kernel whose score sums run in another order than
    the plain version's can miss 99 % there without being wrong, and so
    does the twin. Returns the readings, with (o, lse) of the plain
    version under "plain"."""
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, mask, sc)
    torch.cuda.synchronize()
    po, plse = fa.flash_fwd_plain(q, k, v, mask, sc)
    twin = flash_fwd_twin(q, k, v, mask, sc)[0]
    rows = mask.any(-1)[:, None].expand_as(plse)
    diff = (o.double() - po.double()).abs()
    case = {"o_max_rel": float(diff.max()) / float(po.double().abs().max()),
            "o_share_within_1e-5": share_within_1e5(o, po),
            "twin_share_within_1e-5": share_within_1e5(twin, po),
            "twin_max_rel": max_rel(twin, po),
            "lse_max_rel": max_rel(lse[rows], plse[rows]),
            "max_abs": float(diff.max()),
            "finite": bool(torch.isfinite(o).all())}
    share_bar = INT8_ATTN_SHARE
    if twin_bar:
        share_bar = min(share_bar, case["twin_share_within_1e-5"] - 0.01)
    case["share_bar"] = share_bar
    shape = [*q.shape[:3], k.shape[2], q.shape[3]]
    check(case["finite"], f"flash_fwd {shape}: output not finite")
    check(bool((o[~rows] == 0).all()),
          f"flash_fwd {shape}: a fully masked row is not zero")
    check(case["o_max_rel"] <= FLASH_FWD_TOL
          and case["o_share_within_1e-5"] >= share_bar
          and case["lse_max_rel"] <= FLASH_LSE_TOL,
          f"flash_fwd {shape}: o {case['o_max_rel']} (share "
          f"{case['o_share_within_1e-5']}, bar {share_bar}, twin "
          f"{case['twin_share_within_1e-5']}), lse {case['lse_max_rel']}")
    case["plain"] = (po, plse)
    return case


def flash_case(b: int, h: int, lq: int, lk: int, d: int, dtype, mask,
               seed: int) -> dict:
    """The three kernels against their plain versions on one input: the
    backward ones on the plain forward's o (cast) and lse. Checks the bars
    (the forward's share at 99 %) and returns the case (with its inputs,
    for timing)."""
    q, k, v, do = flash_inputs(b, h, lq, lk, d, dtype, mask.device, seed)
    fwd = flash_fwd_check(q, k, v, mask)
    po, plse = fwd.pop("plain")
    bwd = flash_bwd_case(q, k, v, do, mask, po, plse)
    o_t, delta = bwd.pop("inputs")
    case = {"phase": "flash_kernels", "shape": [b, h, lq, lk, d],
            "dtype": str(dtype).replace("torch.", ""),
            "mask_density": float(mask.double().mean()),
            "fully_masked_rows": int((~mask.any(-1)).sum()), **fwd, **bwd,
            "max_abs": {"flash_fwd": fwd["max_abs"], **bwd["max_abs"]},
            "finite": bwd["finite"] and fwd["finite"]}
    case["inputs"] = (q, k, v, do, o_t, plse, delta, d ** -0.5)
    return case


def flash_bounds(q, mask) -> dict:
    """(bound ms, bound_by) of each kernel on these inputs: the unmasked
    score cells times 2·D per product pass, against the bytes (q, k, v, o,
    do, dq, dk, dv in the input type, the mask, lse and delta read or
    written once). A product of two input-type operands is one pass at the
    input type's peak (bf16: the forward's S and P·V, the backward's S and
    dP). A product with a float32 operand (dS·K, dSᵀ·Q, Pᵀ·dO) is, for bf16
    inputs, two bf16 passes (the operand split hi/lo, the least the card
    can do for an f32-accurate product on its tensor cores) and, for
    float32 inputs, one pass at the f32 peak: dq 4 bf16 passes, dk/dv 6."""
    b, h, lq, d = q.shape
    lk = mask.shape[-1]
    cells = float(h) * float(mask.sum())
    el = q.element_size()
    qb, kb, mb = b * h * lq * d * el, b * h * lk * d * el, b * lq * lk
    rows = 4.0 * b * h * lq
    if q.dtype == torch.bfloat16:
        t_typed, t_f32 = 1 / PEAK_BF16_FLOPS, 2 / PEAK_BF16_FLOPS
    else:
        t_typed = t_f32 = 1 / PEAK_F32_FLOPS
    # (products of two input-type operands, products with an f32 one, bytes)
    work = {"flash_fwd": (2, 0, qb + 2 * kb + mb + qb + rows),
            "flash_dq": (2, 1, 3 * qb + 2 * kb + mb + rows + qb + rows),
            "flash_dkv": (2, 2, 2 * qb + 2 * kb + mb + 2 * rows + 2 * kb)}
    out = {}
    for name, (typed, f32, nbytes) in work.items():
        t_ops = 2.0 * d * cells * (typed * t_typed + f32 * t_f32)
        t_bytes = nbytes / PEAK_BYTES
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def tile_occupancy(mask, tile: int = 64) -> dict:
    """Shares of the (tile x tile) tiles of a (B, Lq, Lk) mask that are
    empty, full and mixed, as the bf16 backward kernels class them: cells
    past Lq or Lk count as masked."""
    b, lq, lk = mask.shape
    padded = F.pad(mask.bool(), (0, -lk % tile, 0, -lq % tile))
    tiles = padded.view(b, padded.shape[1] // tile, tile,
                        padded.shape[2] // tile, tile)
    valid = tiles.sum((2, 4))
    n = valid.numel()
    empty = int((valid == 0).sum())
    full = int((valid == tile * tile).sum())
    return {"empty": empty / n, "full": full / n,
            "mixed": (n - empty - full) / n, "tiles": n}


def ptxas_of(source: str, kernel: str, template_arg: str,
             contains: str = "") -> dict:
    """ptxas's registers and spills of `kernel<template_arg>` (its mangled
    name's prefix, and `contains` elsewhere in it) from the build's
    `-Xptxas -v` log of csrc/<source>.cu."""
    ptxas = _build.ptxas_usage(_build.build_log(source))
    mangled = [m for m in ptxas
               if f"{len(kernel)}{kernel}I{template_arg}" in m
               and contains in m]
    check(len(mangled) == 1, f"ptxas log: {kernel}<{template_arg}> found "
          f"{len(mangled)} times")
    return ptxas[mangled[0]]


def flash_kernel_usage(d: int, lq: int, lk: int) -> dict:
    """The bf16 forward, dq and dk/dv kernels at head_dim d: ptxas's
    registers and spills and the runtime's shared memory and resident
    blocks per SM."""
    out = {}
    for name, kernel, length in (("flash_fwd", "flash_fwd_mma_kernel", lk),
                                 ("flash_dq", "flash_dq_mma_kernel", lk),
                                 ("flash_dkv", "flash_dkv_mma_kernel", lq)):
        out[name] = {**ptxas_of("flash_attention", kernel, f"Li{d}E"),
                     **fa.kernel_info(name, d, length)}
    return out


def phase_flash_kernels(cfg) -> dict:
    """The flash kernels at the path shape and a ragged one; the times at
    the path shape. Returns the kernels-line entries."""
    dev = torch.device("cuda")
    lcfg = cfg.llama
    b, h, d = TRAIN_BATCH, lcfg.num_heads, lcfg.head_dim
    path_mask = splice_mask(cfg, b, TRAIN_LEN, SEED, dev)
    ragged = torch.rand(2, 1000, 1000, device=dev) > 0.4
    ragged[:, 17] = False
    ragged[1, 500:] = False
    errs = {name: 0.0 for name, _ in FLASH_KERNELS}
    path = None
    for args in ((b, h, TRAIN_LEN, TRAIN_LEN, d, torch.bfloat16, path_mask),
                 (2, 4, 1000, 1000, d, torch.bfloat16, ragged),
                 (2, 4, 1000, 1000, d, torch.float32, ragged)):
        case = flash_case(*args, seed=SEED + 3)
        for name in errs:
            errs[name] = max(errs[name], case["max_abs"][name])
        inputs = case.pop("inputs")
        emit(case)
        if path is None:
            path = inputs
    q, k, v, do, o_t, lse, delta, sc = path
    mask = path_mask
    bounds = flash_bounds(q, mask)
    emit({"phase": "flash_kernels", "path_mask_tiles": tile_occupancy(mask),
          "cell_density": float(mask.double().mean()),
          "bf16_kernels": flash_kernel_usage(d, TRAIN_LEN, TRAIN_LEN)})
    sdpa_mask = mask[:, None]
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask,
                                             scale=sc)
        out.backward(do)

    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, scale=sc), reps=10)
    lib_fwd_bwd = time_ms(sdpa_fwd_bwd, reps=10)
    runs = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, mask, sc),
                          lambda: fa.flash_fwd_plain(q, k, v, mask, sc)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, mask, o_t, do, lse, sc),
                         lambda: fa.flash_dq_plain(q, k, v, mask, o_t, do,
                                                   lse, sc)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, mask, do, lse, delta,
                                               sc),
                          lambda: fa.flash_dkv_plain(q, k, v, mask, o_t, do,
                                                     lse, sc))}
    entries = {}
    for name, replaces in FLASH_KERNELS:
        kernel, plain = runs[name]
        bound_ms, bound_by = bounds[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "setok_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": time_ms(kernel, reps=10),
            "plain_ms": time_ms(plain, reps=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_fwd_bwd,
            "library_call": ("SDPA forward" if name == "flash_fwd" else
                             "SDPA forward + backward (dq, dk and dv)"),
            "timing": f"B={b}, H={h}, L={TRAIN_LEN}, D={d}, bf16, the "
                      "splice mask"}
        emit({"phase": "flash_kernels", "kernel": name,
              **{key: entries[name][key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    emit({"phase": "flash_kernels", "sdpa_forward_ms": lib_fwd,
          "sdpa_forward_backward_ms": lib_fwd_bwd})
    # the bf16 kernels' fixed cost (no cell attends: the mask read and
    # classed, zeros written) and their dense rate (every cell attends)
    sweep = {}
    for label, m in (("no_cell_attends", torch.zeros_like(mask)),
                     ("every_cell_attends", torch.ones_like(mask))):
        o_m, lse_m = fa.flash_fwd(q, k, v, m, sc)
        o_m = o_m.to(q.dtype)
        delta_m = fa.flash_dq(q, k, v, m, o_m, do, lse_m, sc)[1]
        bounds_m = flash_bounds(q, m)
        sweep[label] = {
            "flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, m, sc),
                                 reps=10),
            "flash_dq": time_ms(lambda: fa.flash_dq(q, k, v, m, o_m, do,
                                                    lse_m, sc), reps=10),
            "flash_dkv": time_ms(lambda: fa.flash_dkv(q, k, v, m, do, lse_m,
                                                      delta_m, sc), reps=10),
            "bound_ms": {name: bounds_m[name][0]
                         for name in ("flash_fwd", "flash_dq",
                                      "flash_dkv")}}
    emit({"phase": "flash_kernels", "mask_sweep": sweep})
    del path, q, k, v, do, o_t, lse, delta, qg, kg, vg, m, o_m, lse_m, delta_m
    torch.cuda.empty_cache()
    return entries


def build_trainer(cfg) -> Stage2Trainer:
    """The finetune.sh configuration: LoRA r 128 / alpha 256 on every trunk
    linear, lr 2e-4 (warm-up 1 update), mm_in projector lr 2e-5, flash
    attention, remat, bf16 compute, clip 1.0; random weights from the seed."""
    tc = cfgs.TrainConfig(learning_rate=2e-4, max_grad_norm=1.0,
                          warmup_steps=1, total_steps=TRAIN_UPDATES,
                          batch_size=TRAIN_BATCH,
                          grad_accum_steps=TRAIN_ACCUM)
    tr = Stage2Trainer(cfg, train_cfg=tc, target_token_id=3,
                       lora_enable=True, lora_r=128, lora_alpha=256.0,
                       mm_in_projector_lr=2e-5, use_flash=True)
    init_setokim_random_(tr.model, SEED)
    tr.init_state(SEED + 1)
    return tr


def train_batches(cfg, n: int, seed: int) -> list:
    rs = np.random.RandomState(seed)
    return [{k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        cfg, TRAIN_BATCH, TRAIN_LEN, rs, min_len=TRAIN_MIN_LEN).items()}
        for _ in range(n)]


def frozen_checksum(tr: Stage2Trainer) -> float:
    return float(sum(p.detach().double().sum() for n, p in
                     tr.model.named_parameters() if not p.requires_grad))


def phase_train(cfg) -> dict:
    """Three updates of two micro-batches at full width, every count reset
    just before them and read just after; then one profiled micro-batch."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = build_trainer(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_micro = TRAIN_ACCUM * TRAIN_UPDATES
    batches = train_batches(cfg, n_micro + 1, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    frozen_before = frozen_checksum(tr)
    b_before = {n: b.detach().clone() for n, (_, b) in tr.lora.items()}
    b_after_1 = None
    losses, times = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(n_micro):
        t = time.perf_counter()
        metrics = tr.train_step(batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in metrics.items()})
        if tr.updates == 1 and b_after_1 is None:
            b_after_1 = all(torch.equal(b.detach(), b_before[n])
                            for n, (_, b) in tr.lora.items())
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, "dpc_density_parent": cluster_dpc.LAUNCHES}
    b_moved = sum(not torch.equal(b.detach(), b_before[n])
                  for n, (_, b) in tr.lora.items())
    frozen_after = frozen_checksum(tr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # valid tokens: the text's and the image slots the tower fills (the
    # rest of an image's k_max slots are holes)
    with torch.no_grad():
        tokens = [int((bt["input_ids"] > 0).sum()) + int(tr.model.tokenize(
            bt["comp_image"]).token_valid.sum()) for bt in batches[:n_micro]]
    profile = device_time_breakdown(lambda: tr.train_step(batches[-1], gen))
    per_update = [sum(times[i:i + TRAIN_ACCUM])
                  for i in range(0, n_micro, TRAIN_ACCUM)]
    steady = slice(TRAIN_ACCUM, n_micro)            # after the first update
    res = {"phase": "train", "config": "base_setokim", "trunk_layers":
           cfg.llama.num_layers, "hidden": cfg.llama.hidden_size,
           "lora": {"r": 128, "alpha": 256.0, "adapters": len(tr.lora),
                    "params": sum(a.numel() + b.numel()
                                  for a, b in tr.lora.values())},
           "trainable_params": sum(p.numel() for p in tr.trainable),
           "micro_batch": [TRAIN_BATCH, TRAIN_LEN],
           "grad_accum_steps": TRAIN_ACCUM, "updates": tr.updates,
           "build_s": build_s, "losses": losses,
           "ms_per_micro_batch": [1e3 * t for t in times],
           "ms_per_update": [1e3 * t for t in per_update],
           "valid_tokens_per_micro_batch": tokens,
           "valid_tokens_per_s_after_update_1": sum(tokens[steady])
           / sum(times[steady]),
           "lr_per_update": [warmup_cosine(i, tr.train_cfg.learning_rate,
                                           tr.warmup, TRAIN_UPDATES)
                             for i in range(TRAIN_UPDATES)],
           "launches": launches,
           "launches_per_micro_batch": {k: v / n_micro
                                        for k, v in launches.items()},
           "lora_b_unchanged_after_update_1": b_after_1,
           "lora_b_moved_after_update_3": b_moved,
           "frozen_checksum_before_after": [frozen_before, frozen_after],
           "peak_memory_gb": peak_gb, "profiled_micro_batch": profile}
    emit(res)
    layers = cfg.llama.num_layers
    want = {"flash_fwd": 2 * layers * fa.FWD_LAUNCHES_BF16,
            "flash_dq": layers,
            "flash_dkv": layers,
            "dpc_density_parent": 2 * cluster_dpc.LAUNCHES_PER_CALL}
    check(all(np.isfinite(v) for row in losses for v in row.values()),
          "a training loss is not finite")
    check(tr.updates == TRAIN_UPDATES, f"{tr.updates} updates")
    check(res["launches_per_micro_batch"] == want,
          f"launches per micro-batch {res['launches_per_micro_batch']}, "
          f"expected {want}")
    check(frozen_before == frozen_after, "a frozen parameter moved")
    check(bool(b_after_1), "the first update (lr 0) moved a LoRA B")
    check(b_moved == len(tr.lora), f"only {b_moved} of {len(tr.lora)} LoRA "
          "B factors moved by the third update")
    del tr, batches
    torch.cuda.empty_cache()
    return launches


def loss_and_grads(tr: Stage2Trainer, batch, seed: int):
    """One micro-batch's losses and the gradients of the LoRA factors and
    the projectors, with the draws of a generator seeded with `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = tr.model
    out = m(batch["input_ids"], batch["comp_image"], batch["labels"],
            batch["gen_image"], m.draw_forward(TRAIN_BATCH, gen))
    named = {f"lora.{n}.{f}": t for n, ab in tr.lora.items()
             for f, t in zip("ab", ab)}
    named.update({n: p for n, p in m.named_parameters()
                  if "projector" in n})
    grads = torch.autograd.grad(out.loss, list(named.values()),
                                allow_unused=True)
    return (float(out.lm_loss.detach()), float(out.diff_loss.detach()),
            {n: g for n, g in zip(named, grads) if g is not None})


def parity_gap(got, want) -> dict:
    """The losses' relative gaps and the gradients' largest max-rel gap
    (and where it is) of one route against the plain route."""
    rel = {n: max_rel(g, want[2][n]) for n, g in got[2].items()
           if float(want[2][n].abs().max()) > 0}
    worst = max(rel, key=rel.get)
    return {"lm_loss": got[0], "diff_loss": got[1],
            "lm_loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "diff_loss_rel": abs(got[1] - want[1]) / abs(want[1]),
            "grads_compared": len(rel), "grad_max_rel": rel[worst],
            "grad_worst": worst,
            "grad_max_rel_lora_a": max(v for n, v in rel.items()
                                       if n.endswith(".a")),
            "grad_max_rel_lora_b": max(v for n, v in rel.items()
                                       if n.endswith(".b"))}


def scores_f64(q, k, mask, scale):
    """The plain versions' masked scores summed in float64 and rounded
    once: the plain route with its score sums in another order."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    return torch.where(mask[:, None], s.float(), fa.NEG_INF)


def flash_bwd_plain(q, k, v, mask, o, do, lse, sm_scale):
    return (fa.flash_dq_plain(q, k, v, mask, o, do, lse, sm_scale),
            *fa.flash_dkv_plain(q, k, v, mask, o, do, lse, sm_scale))


FLASH_DQ = fa.flash_dq


def flash_dq_without_delta(q, k, v, mask, o, do, lse, sm_scale):
    """A planted fault: the dq kernel fed o = 0, so delta = rowsum(dO·o)
    drops out of dq and (through the delta it writes) of dk."""
    return FLASH_DQ(q, k, v, mask, torch.zeros_like(o), do, lse, sm_scale)


@contextmanager
def patched(*patches):
    with ExitStack() as stack:
        for name, fn in patches:
            stack.enter_context(mock.patch.object(fa, name, fn))
        yield


# the routes of train_parity besides the kernels', each against the plain
# route: (name, plain route?, patches of the flash module, launches)
FWD_2L = 4 * fa.FWD_LAUNCHES_BF16    # 2 layers, forward and recompute
PARITY_ROUTES = (
    ("plain_again", True, (), (0, 0, 0)),
    ("plain_scores_f64", True, (("_scores", scores_f64),), (0, 0, 0)),
    ("kernel_bwd_on_plain_o", False,
     (("flash_fwd", fa.flash_fwd_plain),), (0, 2, 2)),
    ("kernel_fwd_plain_bwd", False, (("flash_bwd", flash_bwd_plain),),
     (FWD_2L, 0, 0)),
    ("kernel", False, (), (FWD_2L, 2, 2)),
    ("fault_delta_dropped", False,
     (("flash_dq", flash_dq_without_delta),), (FWD_2L, 2, 2)),
)


def phase_train_parity(cfg) -> None:
    """The trunk cut to 2 layers, one micro-batch, through the kernels and
    through the plain versions (same weights, batch and draws). The LoRA B
    factors get small random values so that A's gradients flow. Beside the
    kernel route, to read its gap: the plain route again, the plain route
    with its score sums in another order, the kernels' backward on the
    plain forward's o, the kernel forward with the plain backward, and a
    planted fault (delta dropped) that the gradient bar must catch."""
    small = cfgs.replace(cfg, llama=cfgs.replace(cfg.llama, num_layers=2))
    tr = build_trainer(small)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with torch.no_grad():
        for _, b in tr.lora.values():
            b.copy_(1e-3 * torch.randn(b.shape, generator=gen, device="cuda"))
    batch = train_batches(small, 1, SEED + 7)[0]
    reset_counts()
    with plain_route():
        want = loss_and_grads(tr, batch, SEED + 9)
    check(not any(fa.LAUNCHES.values()), "the plain route launched a kernel")
    gaps = {}
    for name, plain, patches, launches in PARITY_ROUTES:
        reset_counts()
        with plain_route() if plain else nullcontext(), \
                patched(*patches):
            gaps[name] = parity_gap(loss_and_grads(tr, batch, SEED + 9),
                                    want)
        got = tuple(fa.LAUNCHES[k] for k, _ in FLASH_KERNELS)
        check(got == launches, f"train_parity {name}: launches {got}, "
              f"expected {launches}")
    res = {"phase": "train_parity", "trunk_layers": 2,
           "lm_loss": [gaps["kernel"]["lm_loss"], want[0]],
           "diff_loss": [gaps["kernel"]["diff_loss"], want[1]],
           **{k: v for k, v in gaps["kernel"].items()
              if k not in ("lm_loss", "diff_loss")},
           "routes": gaps}
    emit(res)
    check(res["lm_loss_rel"] <= TRAIN_PARITY_LOSS_TOL
          and res["diff_loss_rel"] <= TRAIN_PARITY_LOSS_TOL,
          f"train_parity losses {res['lm_loss']}, {res['diff_loss']}")
    check(res["grad_max_rel"] <= TRAIN_PARITY_GRAD_TOL,
          f"train_parity gradient {res['grad_worst']}: "
          f"{res['grad_max_rel']} > {TRAIN_PARITY_GRAD_TOL}")
    fault = gaps["fault_delta_dropped"]["grad_max_rel"]
    check(fault > TRAIN_PARITY_GRAD_TOL,
          f"train_parity: a dropped delta moved the gradients by {fault}, "
          f"within the bar {TRAIN_PARITY_GRAD_TOL}")
    del tr
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# stage-1 SeTok training

SETOK_TRAIN_UPDATES = 3
SETOK_PARITY_BATCH = 4
# card against CPU in float32 (TF32 off): the bars of stage-2's parity
SETOK_PARITY_LOSS_TOL = TRAIN_PARITY_LOSS_TOL
SETOK_PARITY_GRAD_TOL = TRAIN_PARITY_GRAD_TOL


def setok_train_args(*extra: str):
    """The stage-1 CLI's flags of the chip phases: its defaults
    (train_setok.sh's configuration), structured synthetic data, and
    disc_start 0."""
    return train_setok.parse_args(
        ["--synthetic", "64", "--synthetic-structured", "--steps",
         str(SETOK_TRAIN_UPDATES), "--disc-start", "0", *extra])


def on_card(batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def moved(params, before) -> int:
    return sum(not torch.equal(p.detach(), b) for p, b in zip(params, before))


def phase_train_setok() -> int:
    """Three updates at full width, every count reset just before them and
    read just after; then one profiled update. Returns the clustering
    kernel's launches in the three."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = setok_train_args()
    tr, stream = train_setok.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = [on_card(next(stream)) for _ in range(SETOK_TRAIN_UPDATES + 1)]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    vit = list(tr.model.tokenizer.image_feature_encoder.parameters())
    vit_before = [p.detach().clone() for p in vit]
    gen_before = [p.detach().clone() for p in tr.gen_params]
    disc_names = [n for n, _ in tr.disc.named_parameters()]
    disc_before = [p.detach().clone() for p in tr.disc_params]
    losses, times = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(SETOK_TRAIN_UPDATES):
        t = time.perf_counter()
        metrics = tr.train_step(batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            gen_moved_1 = moved(tr.gen_params, gen_before)
            disc_moved_1 = [n for n, p, b in zip(disc_names, tr.disc_params,
                                                 disc_before)
                            if not torch.equal(p.detach(), b)]
    torch.cuda.synchronize()
    launches = cluster_dpc.LAUNCHES
    gen_moved_3 = moved(tr.gen_params, gen_before)
    vit_unchanged = moved(vit, vit_before) == 0
    checksum = float(sum(p.detach().double().sum() for p in vit))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del vit_before, gen_before, disc_before
    profile = device_time_breakdown(lambda: tr.train_step(batches[-1], gen))
    b = args.batch_size
    steady = times[1:]
    tok = tr.tokenizer_cfg
    res = {"phase": "train_setok",
           "config": "base_tokenizer/base_detokenizer (scripts/train_setok.sh)",
           "batch": b, "image_size": tok.vit.image_size,
           "compute_dtype": tr.train_cfg.compute_dtype,
           "disc_start": tr.gan_cfg.disc_start,
           "trainable_params": sum(p.numel() for p in tr.gen_params),
           "disc_params": sum(p.numel() for p in tr.disc_params),
           "frozen_params": sum(p.numel() for p in vit),
           "build_s": build_s, "updates": SETOK_TRAIN_UPDATES,
           "lr_per_update": [warmup_cosine(i, tr.train_cfg.learning_rate,
                                           tr.warmup, SETOK_TRAIN_UPDATES)
                             for i in range(SETOK_TRAIN_UPDATES)],
           "losses": losses, "ms_per_update": [1e3 * t for t in times],
           "ms_per_update_after_update_1": 1e3 * sum(steady) / len(steady),
           "images_per_s_after_update_1": b * len(steady) / sum(steady),
           "peak_memory_gb": peak_gb,
           "cluster_launches": launches,
           "cluster_launches_per_update": launches / SETOK_TRAIN_UPDATES,
           "frozen_vit_checksum": checksum,
           "frozen_vit_unchanged": vit_unchanged,
           "generator_params_moved_by_update_1": gen_moved_1,
           "generator_params_moved_by_update_3": [gen_moved_3,
                                                  len(tr.gen_params)],
           "disc_params_moved_by_update_1": [len(disc_moved_1),
                                             len(disc_names)],
           "profiled_update": profile,
           "phase_seconds": time.perf_counter() - t0}
    emit(res)
    check(all(np.isfinite(v) for row in losses for v in row.values()),
          "a stage-1 loss is not finite")
    check(tr.updates == SETOK_TRAIN_UPDATES + 1, f"{tr.updates} updates")
    check(launches == SETOK_TRAIN_UPDATES * cluster_dpc.LAUNCHES_PER_CALL,
          f"clustering launches {launches} in {SETOK_TRAIN_UPDATES} "
          f"updates, expected {cluster_dpc.LAUNCHES_PER_CALL} each")
    check(vit_unchanged, "the frozen ViT moved")
    check(gen_moved_1 == 0, f"the first update (lr 0) moved {gen_moved_1} "
          "generator parameters")
    check(gen_moved_3 >= 0.9 * len(tr.gen_params),
          f"only {gen_moved_3} of {len(tr.gen_params)} generator parameters "
          "moved by the third update")
    check(all(n in disc_moved_1 for n in disc_names if n.endswith("weight")),
          f"the first update moved only {disc_moved_1} of the discriminator")
    check(peak_gb < 80.0, f"peak memory {peak_gb} GB")
    del tr, batches
    torch.cuda.empty_cache()
    return launches


def setok_step_terms(tr: Stage1Trainer, batch) -> tuple:
    """One stage-1 step's terms without an update, in one pass: the
    generator's metrics and total, the discriminator's loss and mean
    logits, and the gradients of the pixel head and the inner Block."""
    total, metrics, recon = tr.generator_terms(batch)
    named = {"pixel_head.weight": tr.model.detokenizer.pixel_head.weight}
    named.update({f"inner_encoder.{n}": p for n, p in
                  tr.model.tokenizer.inner_encoder.named_parameters()})
    grads = torch.autograd.grad(total, list(named.values()))
    with torch.no_grad():
        real, fake = tr.disc(batch["gen_image"]), tr.disc(recon)
        metrics.update(total_loss=total, logits_real=real.mean(),
                       logits_fake=fake.mean(), d_loss=discriminator_loss(
                           real, fake, tr.step, tr.gan_cfg))
    return ({k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(named, grads)))


def phase_train_setok_parity() -> None:
    """The stage-1 step cut to ViT depth 2, Q-Former 2 and decoder depth 2
    at full width, float32, dropout 0, LPIPS on: the card against the CPU
    on the same weights and batch."""
    t0 = time.perf_counter()
    args = setok_train_args("--batch-size", str(SETOK_PARITY_BATCH),
                            "--lpips")
    tok, det = train_setok.configs(args)
    tok = cfgs.replace(tok, vit=cfgs.replace(tok.vit, depth=2),
                       proj_drop=0.0, attn_drop=0.0)
    det = cfgs.replace(det, decoder_depth=2, mapper_layers=2, proj_drop=0.0,
                       attn_drop=0.0)
    trainers = [Stage1Trainer(
        tok, det, gan_cfg=cfgs.GANLossConfig(disc_start=0, warm_up_end=0),
        contrastive_cfg=cfgs.ContrastiveLossConfig(
            text_embed_dim=tok.token_feat_dim),
        train_cfg=cfgs.TrainConfig(compute_dtype="float32"), use_lpips=True,
        device=dev) for dev in ("cuda", "cpu")]
    trainers[1].init_weights_(SEED + 3)
    for name in ("model", "disc", "contrastive", "lpips"):
        getattr(trainers[0], name).load_state_dict(
            getattr(trainers[1], name).state_dict())
    for tr in trainers:
        tr.init_state()
    host = next(train_setok.synthetic_batches(args, tok.token_feat_dim))
    batches = [on_card(host), {k: torch.from_numpy(v)
                               for k, v in host.items()}]
    with torch.no_grad():
        toks = [tr.model.tokenize(bt["comp_image"])
                for tr, bt in zip(trainers, batches)]
    same = (torch.equal(toks[0].idx_cluster.cpu(), toks[1].idx_cluster)
            and torch.equal(toks[0].num_clusters.cpu(), toks[1].num_clusters))
    (m_g, g_g), (m_c, g_c) = (setok_step_terms(tr, bt)
                              for tr, bt in zip(trainers, batches))
    metrics = {k: [m_g[k], m_c[k]] for k in m_c}
    loss_rel = {k: abs(a - b) / max(abs(b), 1e-6)
                for k, (a, b) in metrics.items()}
    grad_rel = {n: max_rel(g_g[n], g_c[n]) for n in g_c}
    worst = max(grad_rel, key=grad_rel.get)
    res = {"phase": "train_setok_parity", "vit_depth": 2, "mapper_layers": 2,
           "decoder_depth": 2, "batch": SETOK_PARITY_BATCH,
           "compute_dtype": "float32", "lpips": True,
           "clusters_identical": same,
           "num_clusters": toks[1].num_clusters.tolist(),
           "metrics_card_cpu": metrics,
           "metric_max_rel": max(loss_rel.values()),
           "metric_worst": max(loss_rel, key=loss_rel.get),
           "grads_compared": len(grad_rel), "grad_max_rel": grad_rel[worst],
           "grad_worst": worst,
           "pixel_head_grad_max_rel": grad_rel["pixel_head.weight"],
           "phase_seconds": time.perf_counter() - t0}
    emit(res)
    check(same, "train_setok_parity: the card's clusters differ from the "
          "CPU's")
    check(res["metric_max_rel"] <= SETOK_PARITY_LOSS_TOL,
          f"train_setok_parity: {res['metric_worst']} "
          f"{metrics[res['metric_worst']]}")
    check(res["grad_max_rel"] <= SETOK_PARITY_GRAD_TOL,
          f"train_setok_parity: gradient {worst} {grad_rel[worst]} > "
          f"{SETOK_PARITY_GRAD_TOL}")
    del trainers, batches
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = phase_device()
    phase_build()
    entry = phase_kernels()
    int8_entries = phase_int8_kernels()

    tok_cfg, det_cfg = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    cpu_model = init_random_(SeTok(tok_cfg, det_cfg, device="cpu"), SEED)
    gpu_model = SeTok(tok_cfg, det_cfg)              # device=None: the card
    gpu_model.load_state_dict(cpu_model.state_dict())
    entry["launches"] = phase_forward(cpu_model, gpu_model)
    entry["calls"] = 1

    cpu8 = SeTok(tok_cfg, det_cfg, device="cpu", quant8=True)
    cpu8.load_state_dict(cpu_model.state_dict())
    del cpu_model
    gpu8 = SeTok(tok_cfg, det_cfg, quant8=True)
    gpu8.load_state_dict(gpu_model.state_dict())
    counts = phase_forward_int8(cpu8, gpu8)
    del cpu8, gpu8
    for name, e in int8_entries.items():
        e["launches"] = counts["launches"][name]
        e["calls"] = counts["calls"][name]
    phase_throughput(gpu_model)
    del gpu_model
    torch.cuda.empty_cache()

    unfused = phase_unfused_kernels()
    runs = phase_forward_unfused()
    unfused_entries = unfused["entries"]
    for name, e in unfused_entries.items():
        run = runs["base384" if name == "fused_mlp_int8" else "ff4096"]
        e["launches"] = run["launches"][name]
        e["calls"] = run["calls"][name]
    phase_throughput_unfused()

    serve_entries = phase_serve_kernels()
    setokim = cfgs.base_setokim()
    for bits, name in ((8, "quant_matmul"), (4, "quant4_matmul")):
        if bits == 8:
            counts, model8 = phase_serve(setokim, bits, keep=True)
            gen = phase_generate(setokim, model8)
            del model8
            torch.cuda.empty_cache()
            serve_entries[name]["generate_launches"] = {
                "decode_block": gen["decode_block"],
                "dispatches": gen["dispatches"],
                "launches": gen["launches"]}
            serve_entries["int8_cache_decode_attention"][
                "generate_launches"] = {"decode_block": gen["decode_block"],
                                        "dispatches": gen["dispatches"],
                                        "launches": gen["cache_launches"]}
        else:
            counts = phase_serve(setokim, bits)
        serve_entries[name]["launches"] = counts["launches"]
        serve_entries[name]["calls"] = counts["calls"]
        if bits == 8:
            # the int8 SeTok's Dense route, beside the serving trunk's
            serve_entries[name]["unfused_launches"] = {
                cfg: run["launches"]["quant_matmul"]
                for cfg, run in runs.items()}
            serve_entries[name]["unfused_dense"] = unfused["dense"]
            cache_entry = serve_entries["int8_cache_decode_attention"]
            cache_entry["launches"] = cache_entry["calls"] = \
                counts["cache_launches"]
    for bits in (8, 4):
        phase_serve_parity(setokim, bits)

    flash_entries = phase_flash_kernels(setokim)
    launches = phase_train(setokim)
    for name, e in flash_entries.items():
        e["launches"] = launches[name]
    phase_train_parity(setokim)
    entry["train_setok_launches"] = phase_train_setok()
    entry["train_setok_launches_per_update"] = \
        entry["train_setok_launches"] / SETOK_TRAIN_UPDATES
    phase_train_setok_parity()

    emit({"kernels": [entry, *int8_entries.values(),
                      *unfused_entries.values(), *serve_entries.values(),
                      *flash_entries.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
