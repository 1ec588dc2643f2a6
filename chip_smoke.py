#!/usr/bin/env python3
"""Drive the PyTorch port of SeTok on one CUDA card and hold it to its plain
versions.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero before
the last line:

  device      the card's name, and its name and power limit from nvidia-smi;
  build       nvcc builds every setok_tpu_torch/csrc/*.cu (one nvcc each,
              in parallel) into build/torch_kernels/;
  kernels     each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes, and its time;
  forward     the float SeTok forward at the base config (ViT-B/16 @256,
              random weights from a seed) on the card, its launch counts,
              and a stage-by-stage comparison with the same model on the
              CPU: encode_features, clustering, group encoding + decode;
  throughput  the full forward in images/s at B=64, float32 and bf16,
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
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.ops.clustering import ClusterResult, cluster_dpc_knn
from setok_tpu_torch.utils.init import init_random_
from setok_tpu_torch.utils.profiling import device_time_breakdown

SEED = 0
# H100 SXM data sheet: f32 on the CUDA cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FWD_REL_TOL = 1e-4          # TF32 off: float32 products on card and CPU
NEAR_TIE_REL = 1e-5


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


def phase_forward(cpu_model: SeTok, gpu_model: SeTok) -> int:
    tok_cfg = gpu_model.tokenizer.cfg
    size = tok_cfg.vit.image_size
    images = np.random.RandomState(SEED).uniform(
        -1.0, 1.0, (4, size, size, 3)).astype(np.float32)
    img_c = torch.from_numpy(images)
    img_g = img_c.cuda()

    # the main path, with the launch count read around it alone
    cluster_dpc.LAUNCHES = 0
    out = gpu_model(img_g)
    torch.cuda.synchronize()
    launches = cluster_dpc.LAUNCHES
    check(launches >= 1, "the forward did not launch the cluster kernel")
    check(tuple(out.recon.shape) == (4, size, size, 3)
          and bool(torch.isfinite(out.recon).all())
          and bool(torch.isfinite(out.tokens).all()),
          "forward output has the wrong shape or is not finite")

    # (a) features
    f_g = gpu_model.tokenizer.encode_features(img_g)
    f_c = cpu_model.tokenizer.encode_features(img_c)
    feat_rel = max_rel(f_g, f_c)
    # (b) the kernel route on the card's features against the plain
    # version on the same features on the CPU
    res_g = gpu_model.tokenizer.cluster(f_g)
    f_gc = f_g.cpu()
    res_p = cluster_dpc.cluster_dpc_knn_kernel(
        f_gc, k=tok_cfg.knn, k_max=tok_cfg.k_max,
        min_cluster_num=tok_cfg.min_cluster_num, threshold=tok_cfg.threshold)
    res_gc = ClusterResult(*(t.cpu() for t in res_g))
    clusters = compare_clusters(res_gc, res_p, f_gc, tok_cfg)
    # the kernel module's plain route against ops.clustering's, same rule
    res_x = cluster_dpc_knn(f_gc, k=tok_cfg.knn, k_max=tok_cfg.k_max,
                            min_cluster_num=tok_cfg.min_cluster_num,
                            threshold=tok_cfg.threshold)
    plain_routes = compare_clusters(res_p, res_x, f_gc, tok_cfg)
    # (c) group encoding + decode given the card's clustering
    tok_g = gpu_model.tokenizer.group_encode(f_g, res_g)
    det_g = gpu_model.detokenizer(tok_g.tokens, tok_g.token_valid)
    tok_c = cpu_model.tokenizer.group_encode(f_gc, res_gc)
    det_c = cpu_model.detokenizer(tok_c.tokens, tok_c.token_valid)
    tokens_rel = max_rel(tok_g.tokens, tok_c.tokens)
    recon_rel = max_rel(det_g.image, det_c.image)
    staged_rel = max_rel(out.recon, det_g.image)

    emit({"phase": "forward", "config": "base_tokenizer/base_detokenizer",
          "params": sum(p.numel() for p in gpu_model.parameters()),
          "batch": 4, "launches": {"dpc_density_parent": launches},
          "encode_features_max_rel": feat_rel,
          "clusters": clusters,
          "num_clusters": res_g.num_clusters.tolist(),
          "plain_vs_ops_route": plain_routes,
          "tokens_max_rel": tokens_rel, "recon_max_rel": recon_rel,
          "forward_vs_staged_recon_max_rel": staged_rel})
    check(feat_rel <= FWD_REL_TOL, f"encode_features rel err {feat_rel}")
    check(tokens_rel <= FWD_REL_TOL, f"tokens rel err {tokens_rel}")
    check(recon_rel <= FWD_REL_TOL, f"recon rel err {recon_rel}")
    check(staged_rel <= FWD_REL_TOL, f"forward vs staged rel {staged_rel}")
    return launches


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
    """img/s at B=64 in float32 and bf16, then one profiled forward each:
    device time by kernel category and the device's busy share."""
    tok_cfg, det_cfg = gpu_model.tokenizer.cfg, gpu_model.detokenizer.cfg
    size, batch = tok_cfg.vit.image_size, 64
    images = torch.from_numpy(np.random.RandomState(SEED).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32)).cuda()
    bf16 = SeTok(tok_cfg, det_cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(gpu_model.state_dict())
    for name, model, n_small, n_big in (("float32", gpu_model, 1, 4),
                                        ("bfloat16", bf16, 2, 8)):
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

    tok_cfg, det_cfg = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    cpu_model = init_random_(SeTok(tok_cfg, det_cfg, device="cpu"), SEED)
    gpu_model = SeTok(tok_cfg, det_cfg)              # device=None: the card
    gpu_model.load_state_dict(cpu_model.state_dict())
    entry["launches"] = phase_forward(cpu_model, gpu_model)
    del cpu_model
    phase_throughput(gpu_model)

    emit({"kernels": [entry]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
