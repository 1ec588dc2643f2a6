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
                on the card, at every shape the main paths give it, and its
                time at the throughput batch;
  forward       the float SeTok forward at the base config (ViT-B/16 @256,
                random weights from a seed) on the card, its launch counts,
                and a stage-by-stage comparison with the same model on the
                CPU: encode_features, clustering, group encoding + decode;
  forward_int8  the same for the int8 form (quant8=True), with the calls
                per forward of each int8 kernel;
  throughput    the full forward in images/s at B=64: float32, bf16, and
                int8 with bf16 glue (the form bench.py times on the TPU),
                and one profiled forward each (device time by kernel kind).

Then the kernels summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs no JAX: it imports setok_tpu_torch only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import _build, cluster_dpc
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels.quant import quantize_weight
from setok_tpu_torch.models.setok import SeTok, expected_calls
from setok_tpu_torch.ops.clustering import (ClusterResult, cluster_dpc_knn,
                                            same_cluster_mask, segment_mean)
from setok_tpu_torch.utils.init import init_random_
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
# integer products: 1e-5. With attention, the scores and PV sum in another
# order, and a last-bit change can flip a bf16 cast of P or an int8 step of
# the attention output: max-rel 2e-3, with >= 99 % of the elements within
# 1e-5 of the largest.
INT8_MLP_TOL = 1e-5
INT8_ATTN_TOL = 2e-3
INT8_ATTN_SHARE = 0.99
# the int8 forward, card vs CPU, stage by stage: one flipped int8 step moves
# a row by ~1 %; the JAX package's own int8 forward moves by 1.8e-2 under
# 2e-7 relative input noise (tests/test_torch_int8.py)
FWD_INT8_TOL = 5e-2
INT8_KERNELS = ("attn_sublayer_int8", "mlp_sublayer_int8",
                "fused_bert_attention_int8", "mlp_postnorm_int8")
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
    """dpc_density_parent against its plain version at the main path's
    shape (N=256, C=768, k=64) and one uneven case (N=50, k=8)."""
    threshold = 0.55
    errs = []
    for b, n, c, k, k_max, min_cn in ((4, 256, 768, 64, 80, 64),
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
    flops = 1.0 * b * n * (n + 1) * c    # the symmetric Gram product, i <= j
    nbytes = 4.0 * (b * n * c + 3 * b * n)          # x in, three outputs
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    entry = {"name": "dpc_density_parent", "route": "cuda",
             "source": "setok_tpu_torch/csrc/cluster_dpc.cu",
             "replaces": "setok_tpu/kernels/cluster_pallas.py:140",
             "launches": None, "max_abs_err": max(errs), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": None}
    emit({"phase": "kernels", "timing_shape": [b, n, c], "k": k,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": entry["bound_ms"]})
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


def check_int8_case(name, label, kernel, plain, args, kw) -> dict:
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    diff = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    case = {"phase": "kernels", "kernel": name, "shape": label,
            "input": list(args[0].shape), "max_rel": float(diff.max()) / scale,
            "max_abs": float(diff.max()),
            "share_within_1e-5": float((diff <= 1e-5 * scale).double().mean()),
            "finite": bool(torch.isfinite(got).all())}
    emit(case)
    check(case["finite"], f"{name} {label}: output not finite")
    if name in ("mlp_sublayer_int8", "mlp_postnorm_int8"):
        check(case["max_rel"] <= INT8_MLP_TOL,
              f"{name} {label}: max-rel {case['max_rel']} > {INT8_MLP_TOL}")
    else:
        check(case["max_rel"] <= INT8_ATTN_TOL
              and case["share_within_1e-5"] >= INT8_ATTN_SHARE,
              f"{name} {label}: max-rel {case['max_rel']}, share "
              f"{case['share_within_1e-5']}")
    return case


def phase_int8_kernels(b_check: int = 4, b_time: int = 64) -> dict:
    """Each int8 kernel against its plain version at every path shape
    (B=b_check), then its time, its plain version's and its bound at the
    throughput batch (B=b_time). Returns the kernels-line entries."""
    dev = torch.device("cuda")
    errs = {name: 0.0 for name in INT8_KERNELS}
    for case in int8_cases(b_check, dev):
        res = check_int8_case(*case)
        errs[case[0]] = max(errs[case[0]], res["max_abs"])
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
                         "bound_by": bound_by, "library_ms": None}
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


def int8_counts() -> tuple:
    """(wrapper calls that launched, CUDA launches) per int8 kernel."""
    return ({**fs.CALLS, **fba.CALLS}, {**fs.LAUNCHES, **fba.LAUNCHES})


def staged_forward(cpu_model: SeTok, gpu_model: SeTok, seed: int,
                   tol: float, name: str) -> dict:
    """The main path once on the card at B=4, every count reset just before
    it and read just after, then card vs CPU stage by stage: (a) features;
    (b) the card's clustering of the card's features against the plain
    version on the same features on the CPU (and that plain route against
    ops.clustering's), held by the near-tie rule; (c) group encoding +
    decode given the card's clustering. Emits the phase line, checks every
    max-rel against `tol`, and returns the counts."""
    tok_cfg = gpu_model.tokenizer.cfg
    size = tok_cfg.vit.image_size
    images = np.random.RandomState(seed).uniform(
        -1.0, 1.0, (4, size, size, 3)).astype(np.float32)
    img_c = torch.from_numpy(images)
    img_g = img_c.cuda()

    reset_counts()
    out = gpu_model(img_g)
    torch.cuda.synchronize()
    calls, launches = int8_counts()
    launches["dpc_density_parent"] = cluster_dpc.LAUNCHES
    check(tuple(out.recon.shape) == (4, size, size, 3)
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
    emit({"phase": name, "config": "base_tokenizer/base_detokenizer",
          "params": sum(p.numel() for p in gpu_model.parameters()),
          "batch": 4, "calls": calls, "launches": launches,
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
    check(counts["launches"]["dpc_density_parent"] == 3,
          "the int8 forward did not launch the three cluster kernels")
    return counts


def images_per_sec(model: SeTok, images: torch.Tensor, n_small: int,
                   n_big: int) -> dict:
    """As bench.py: forwards chained through the clipped reconstruction;
    the per-batch time is the slope between two chain lengths."""

    def chain(n):
        x = images
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = model(x)
            x = out.recon.clamp(-1, 1).to(images.dtype)
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

    emit({"kernels": [entry, *int8_entries.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
