#!/usr/bin/env python3
"""Time the int8 / int4 matmul kernels, the int8 MLP, the int8
whole-sublayer kernels, the int8 attentions, the int8-cache decode
attention and the DPC-KNN density/parent kernel of the checkout it runs
from, and its int8 SeTok forward, on one CUDA card, so that two checkouts
compare in one call:

    python3 chip_kernel_times.py TAG [PARTS]   # from the root of each checkout

PARTS, comma-separated, picks what runs (default all): trunk, row6, dense,
sublayers, attention, cache, cluster, forward, serve, vit_attention. Prints
one JSON line tagged TAG:
  trunk   per format (w8, w4, w4g128: int4 with groups of 128) and rows M
          (4: a decode step; 512: a prefill) the seven Vicuna-7B trunk
          linears of one layer, summed: time by CUDA events, device time
          (profiler, 10 calls) and wall time a call (a loop of calls ended
          by a synchronise), and the count of elements that differ from the
          plain version;
  row6    fused_mlp_int8 at B=64 images of 576 tokens, 768 -> 3072 -> 768:
          time from float32 x and, where the checkout takes it, from bf16 x
          (else from bf16 x cast to float32 first), and the elements that
          differ from the plain version;
  dense   quant_matmul at the int8 SeTok's Dense shapes (bf16 x and out):
          time by events (50 calls) and the GEMM's device time (20 calls);
  sublayers  rows 2 (attn_sublayer_int8 at the ViT, decoder and inner
          Block shapes), 3 (mlp_sublayer_int8) and 5 (mlp_postnorm_int8)
          at B=64 images of 256 tokens of 768: time by events, device time
          and its split by kernel (5 calls), the elements that differ from
          the plain version and the share within 1e-5 of the largest;
  attention  rows 4 (fused_bert_attention_int8: the Q-Former's
          self-attention, and its cross-attention over 80 keys with their
          key mask) and 7 (fused_attention_int8, 2 heads of 384: the inner
          Block's cluster mask at N=256, the inter Block's validity mask
          with fully masked rows at N=80) at B=64, as sublayers reports;
  cache   row 11 (int8_cache_decode_attention) at the serving shape, B=4,
          S=512, 32 heads of 128: f32 q with holes in the key mask, and
          bf16 q with the serving layout (the tail of the cache masked), as
          sublayers reports;
  cluster row 1 (dpc_density_parent, k=64) at B=64 images of 256 and 576
          tokens of 768, and 8 of 729 of 1152; past the 1024 rows held in
          registers at B=8 of 1296 (ViT-B/16 at 576 px) and 2 of 2304 of
          768, and 1 of 19370 of 64, those three beside the plain version's
          time: time by events, device time and its split by kernel (5
          calls), the largest relative error of density and row max against
          the plain version;
  forward  the int8 SeTok forward with bf16 glue at B=64 (base @256, and
          base with the 4096-wide tokenizer MLP), and bf16 beside it: img/s
          by chip_smoke's slope method and one profiled int8 forward's
          device time by kernel category;
  serve   chip_smoke's serving phase at bits 8 and 4 (base_setokim, 8
          requests): tokens/s, mean TTFT and the median and least decode
          step;
  vit_attention  the bf16 attention kernel (attention_bf16) at the so400m
          ViT's call (B=32, 16 heads of 72, N=729), the base ViT's (B=64,
          12 heads of 64, N=256) and the base pixel decoder's (B=64, 16
          heads of 48, N=256), q, k and v read from one qkv output: time
          by events, device time, its bound (operations at 989 TFLOP/s or
          bytes at 3.35 TB/s, the larger), the float chain it replaces from
          qkv to the (B, N, C) output (`softmax_attention` and the head
          transposes), the plain version's time, PyTorch's
          scaled_dot_product_attention as `library_ms` (a yardstick only),
          the largest error of the kernel and of the chain against a
          float32 reference, and the kernel's registers and spills.
Weights are random from a seed and quantised without clip search. Run the
checkouts in turns (parent, change, change, parent): a card's numbers drift
within a call. Exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import _build
from setok_tpu_torch.kernels import attention_bf16 as ab
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import cluster_dpc
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (quant4_matmul_plain,
                                           quant_matmul_plain,
                                           quantize_weight,
                                           quantize_weight_int4)
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.ops.blocks import softmax_attention
from setok_tpu_torch.utils.init import init_setokim_random_
from setok_tpu_torch.utils.profiling import device_time_breakdown


def trunk(dev, gen) -> dict:
    totals = {}
    for k, n in cs.trunk_shapes(cfgs.vicuna_7b()).values():
        w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
        weights = {"w8": quantize_weight(w),
                   "w4": quantize_weight_int4(w, None, 0),
                   "w4g128": quantize_weight_int4(w, 128, 0)}
        for m in (4, 512):
            x = torch.randn(m, k, generator=gen, device=dev)
            for fmt, wq in weights.items():
                kernel = qm.quant_matmul if fmt == "w8" else qm.quant4_matmul
                plain = (quant_matmul_plain if fmt == "w8"
                         else quant4_matmul_plain)
                differ = int((kernel(x, wq) != plain(x, wq)).sum())
                device = device_time_breakdown(
                    lambda: [kernel(x, wq) for _ in range(10)])["device_ms"]
                t = totals.setdefault(f"{fmt} M={m}", {
                    "ms": 0.0, "device_ms": 0.0, "wall_ms": 0.0,
                    "differ": 0})
                t["ms"] += cs.time_ms(lambda: kernel(x, wq), reps=50)
                t["device_ms"] += device / 10
                t["wall_ms"] += cs.host_us_per_call(lambda: kernel(x, wq),
                                                    0.0)[1]
                t["differ"] += differ
    return totals


def row6(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(5)
    c, hid, rows = 768, 3072, 64 * 576
    x = torch.randn(rows, c, generator=gen, device=dev)
    w1 = quantize_weight(torch.randn(hid, c, generator=gen, device=dev)
                         * c ** -0.5)
    w2 = quantize_weight(torch.randn(c, hid, generator=gen, device=dev)
                         * hid ** -0.5)
    b1 = torch.randn(hid, generator=gen, device=dev) * 0.1
    b2 = torch.randn(c, generator=gen, device=dev) * 0.1
    args = (w1, b1, w2, b2)
    res = {"f32_ms": cs.time_ms(lambda: fm.fused_mlp_int8(x, *args)),
           "differ": int((fm.fused_mlp_int8(x, *args)
                          != fm.fused_mlp_int8_reference(x, *args)).sum())}
    xb = x.to(torch.bfloat16)
    try:
        res["bf16_ms"] = cs.time_ms(lambda: fm.fused_mlp_int8(xb, *args))
    except TypeError:            # a checkout whose kernel takes f32 only
        res["bf16_cast_ms"] = cs.time_ms(
            lambda: fm.fused_mlp_int8(xb.float().contiguous(), *args))
    return res


def dense(dev, gen) -> dict:
    res = {}
    for label, k, n in cs.DENSE_SHAPES:
        m = cs.DENSE_ROWS[label.split()[0]]
        w = quantize_weight(torch.randn(n, k, generator=gen, device=dev)
                            * k ** -0.5)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        by = device_time_breakdown(
            lambda: [qm.quant_matmul(x, w) for _ in range(20)])
        res[label] = {
            "ms": cs.time_ms(lambda: qm.quant_matmul(x, w), reps=50),
            "gemm_ms": by["by_category_ms"].get("quant_gemm", 0.0) / 20}
    return res


SUBLAYER_ROWS = {"attn_sublayer_int8": "row2", "mlp_sublayer_int8": "row3",
                 "mlp_postnorm_int8": "row5"}


def timed(kernel, plain, args, kw) -> dict:
    """One case: time by events, device time and its split by kernel (5
    calls), the elements that differ from the plain version, the share
    within 1e-5 of the largest, and a hash of the output's bytes (two
    checkouts whose kernels agree to the bit print the same)."""
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    diff = (got.double() - want.double()).abs()
    by = device_time_breakdown(lambda: [kernel(*args, **kw) for _ in range(5)])
    return {"ms": cs.time_ms(lambda: kernel(*args, **kw)),
            "device_ms": by["device_ms"] / 5,
            "split": [{"name": k["name"][:60], "ms": k["ms"] / 5}
                      for k in by["top_kernels"]],
            "differ": int((got != want).sum()),
            "share": float((diff <= 1e-5 * want.abs().max()).double().mean()),
            "sha256": hashlib.sha256(got.cpu().contiguous().view(
                torch.uint8).numpy().tobytes()).hexdigest()[:16]}


def sublayers(dev) -> dict:
    res = {}
    for name, label, kernel, plain, args, kw in cs.int8_cases(64, dev):
        row = SUBLAYER_ROWS.get(name)
        if row is None or label == "inter":
            continue
        res[f"{row} {label}"] = timed(kernel, plain, args, kw)
    return res


def attention(dev) -> dict:
    res = {}
    cases = [c for c in cs.int8_cases(64, dev)
             if c[0] == "fused_bert_attention_int8"]
    cases += [c for c in cs.unfused_cases(64, dev)
              if c[0] == "fused_attention_int8" and c[1] != "unmasked"]
    for name, label, kernel, plain, args, kw in cases:
        row = "row4" if name == "fused_bert_attention_int8" else "row7"
        res[f"{row} {label}"] = timed(kernel, plain, args, kw)
    return res


def cache(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(11)
    b, s, kvh, d = 4, 512, 32, 128

    def int8():
        f = torch.randn(b, s, kvh, d, generator=gen, device=dev)
        sc = f.abs().amax(-1) / torch.full_like(f[..., 0], 127.0)
        return (torch.round(f / sc[..., None]).clamp(-127, 127)
                .to(torch.int8), sc)

    (k8, ks), (v8, vs) = int8(), int8()
    q = torch.randn(b, kvh, d, generator=gen, device=dev)
    holes = torch.rand(b, s, generator=gen, device=dev) > 0.3
    holes[-1] = False
    # the serving layout: 160, 128, 97 and 33 valid keys, a tenth holes
    lengths = torch.tensor([160, 128, 97, 33], device=dev)
    serving = ((torch.arange(s, device=dev)[None] < lengths[:, None])
               & (torch.rand(b, s, generator=gen, device=dev) >= 0.1))
    return {label: timed(ca.int8_cache_decode_attention,
                         ca.int8_cache_decode_attention_plain,
                         (qq, k8, ks, v8, vs, valid),
                         {"sm_scale": d ** -0.5})
            for label, qq, valid in (("holes f32", q, holes),
                                     ("serving bf16", q.to(torch.bfloat16),
                                      serving))}


def cluster(dev) -> dict:
    res = {}
    for b, n, c in ((64, 256, 768), (64, 576, 768), (8, 729, 1152),
                    (8, 1296, 768), (2, 2304, 768), (1, 19370, 64)):
        x = torch.from_numpy(np.stack([cs.clustered(cs.SEED + i, n, c)
                                       for i in range(b)])).to(dev)
        got = cluster_dpc.dpc_density_parent(x, 64)
        want = cluster_dpc.dpc_density_parent_reference(x, 64)
        rel = [float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
               for g, w in zip(got, want)]
        by = device_time_breakdown(
            lambda: [cluster_dpc.dpc_density_parent(x, 64) for _ in range(5)])
        res[f"B={b} N={n} C={c}"] = {
            "ms": cs.time_ms(lambda: cluster_dpc.dpc_density_parent(x, 64)),
            "device_ms": by["device_ms"] / 5,
            "split": [{"name": k["name"][:60], "ms": k["ms"] / 5}
                      for k in by["top_kernels"]],
            "density_max_rel": rel[0], "rowmax_max_rel": rel[2]}
        if n > 1024:
            res[f"B={b} N={n} C={c}"]["plain_ms"] = cs.time_ms(
                lambda: cluster_dpc.dpc_density_parent_reference(x, 64))
        del x
        torch.cuda.empty_cache()
    return res


def forward() -> dict:
    tok, det = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    configs = {"base256": (tok, det),
               "ff4096": (cfgs.replace(tok, dim_feedforward=4096), det)}
    res = {}
    for name, (tok_cfg, det_cfg) in configs.items():
        size = tok_cfg.vit.image_size
        images = torch.rand(64, size, size, 3, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(cs.SEED)) * 2 - 1
        for dtype_name, quant8 in (("bfloat16", False), ("int8", True)):
            model = init_setokim_random_(
                SeTok(tok_cfg, det_cfg, dtype=torch.bfloat16, quant8=quant8),
                cs.SEED)
            run = cs.images_per_sec(model, images, 2, 8)
            entry = {"images_per_sec": run["images_per_sec"]}
            if quant8:
                by = device_time_breakdown(lambda: model(images), top=12)
                entry.update(device_ms=by["device_ms"],
                             busy_share=by["busy_share"],
                             by_category_ms=by["by_category_ms"],
                             top=[{"name": k["name"][:60], "ms": k["ms"],
                                   "calls": k.get("calls")}
                                  for k in by["top_kernels"]])
            res[f"{name} {dtype_name}"] = entry
            del model
            torch.cuda.empty_cache()
    return res


def serve() -> dict:
    res = {}
    for bits in (8, 4):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            cs.phase_serve(cfgs.base_setokim(), bits)
        for line in log.getvalue().splitlines():
            if line.startswith('{"phase": "serve"'):
                run = json.loads(line)
                res[f"bits{bits}"] = {k: run[k] for k in (
                    "tokens_per_s", "ttft_mean_ms",
                    "decode_ms_per_step_median", "decode_ms_per_step_min")}
        torch.cuda.empty_cache()
    return res


def vit_attention(dev) -> dict:
    res = {}
    usage = _build.ptxas_usage(_build.build_log("attention_bf16"))
    for label, (b, h, n, d) in (("so400m B=32", (32, 16, 729, 72)),
                                ("base256 B=64", (64, 12, 256, 64)),
                                ("base decoder B=64", (64, 16, 256, 48))):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        qkv = torch.randn(b, n, 3, h, d, generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        scale = d ** -0.5

        def chain():
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out = softmax_attention(qt, kt, vt, scale, None, torch.bfloat16)
            return out.transpose(1, 2).reshape(b, n, h * d)

        def library():
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=scale)

        qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
        ref = torch.matmul(torch.softmax(
            torch.matmul(qf, kf.transpose(-1, -2)) * scale, -1), vf)
        ref = ref.transpose(1, 2).reshape(b, n, h * d)
        del qf, kf, vf
        got = ab.attention_bf16(q, k, v, scale).reshape(b, n, h * d)
        kernel_err = float((got.float() - ref).abs().max())
        chain_err = float((chain().float() - ref).abs().max())
        del ref, got
        by = device_time_breakdown(
            lambda: [ab.attention_bf16(q, k, v, scale) for _ in range(5)])
        ops = 4.0 * b * h * n * n * d
        nbytes = 2.0 * 4 * b * n * h * d      # q, k, v read, o written
        name = next(key for key in usage if f"ILi{d}E" in key)
        res[label] = {
            "ms": cs.time_ms(lambda: ab.attention_bf16(q, k, v, scale)),
            "device_ms": by["device_ms"] / 5,
            "bound_ms": max(ops / 989e12, nbytes / 3.35e12) * 1e3,
            "chain_ms": cs.time_ms(chain),
            "plain_ms": cs.time_ms(
                lambda: ab.attention_bf16_plain(q, k, v, scale)),
            "library_ms": cs.time_ms(library),
            "max_err": kernel_err, "chain_max_err": chain_err,
            "vmax": float(v.float().abs().max()),
            "ptxas": usage[name]}
        del qkv, q, k, v
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    parts = (sys.argv[2].split(",") if len(sys.argv) > 2
             else ["trunk", "row6", "dense", "sublayers", "attention",
                   "cache", "cluster", "forward", "serve", "vit_attention"])
    out = {"tree": tag, "device": torch.cuda.get_device_name(0)}
    for part in parts:
        if part == "trunk":
            out["trunk"] = trunk(dev, gen)
        elif part == "row6":
            out["row6"] = row6(dev)
        elif part == "dense":
            out["dense"] = dense(dev, gen)
        elif part == "sublayers":
            out["sublayers"] = sublayers(dev)
        elif part == "attention":
            out["attention"] = attention(dev)
        elif part == "cache":
            out["cache"] = cache(dev)
        elif part == "cluster":
            out["cluster"] = cluster(dev)
        elif part == "forward":
            out["forward"] = forward()
        elif part == "serve":
            out["serve"] = serve()
        elif part == "vit_attention":
            out["vit_attention"] = vit_attention(dev)
        else:
            print(f"chip_kernel_times: no part {part!r}", file=sys.stderr)
            return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
