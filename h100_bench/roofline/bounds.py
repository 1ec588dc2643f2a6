"""The chip's peaks and the kernels' least times, frozen for the benchmark.

Frozen copies of `chip_smoke.py`'s bound arithmetic (`cluster_bound`,
`int8_bound` and its peaks), taking shapes in place of tensors. Peaks: the
NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit; each
input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Optional, Tuple

PEAK_F32_FLOPS = 67e12        # CUDA cores; also the FP64 tensor cores' rate
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def cluster_bound_ms(b: int, n: int, c: int) -> float:
    """Row 1 (`cluster_dpc`): the symmetric Gram product (i <= j) at the
    FP64 tensor cores' rate against the bytes of x in and the three
    (B, N) outputs, whichever is larger."""
    flops = 1.0 * b * n * (n + 1) * c
    nbytes = 4.0 * (b * n * c + 3 * b * n)
    return 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def int8_bound_ms(name: str, b: int, n: int, c: int, hidden: int = 0,
                  m: Optional[int] = None) -> Tuple[float, str]:
    """(least ms, what bounds it) of one call of a whole-sublayer int8
    kernel on x (b, n, c): int8 products at the int8 rate and the
    attention's bf16 products at the bf16 rate, against the bytes (f32
    input and output, int8 weights, f32 scales, biases and LayerNorm
    vectors). `hidden`: the MLPs' hidden width; `m`: the BERT attention's
    key count, None for self-attention."""
    rows = b * n
    nbytes = 8.0 * rows * c
    bf16 = 0.0
    if name == "attn_sublayer_int8":
        int8 = 2.0 * rows * c * 4 * c          # qkv (3C) and proj (C)
        bf16 = 4.0 * b * n * n * c             # scores and PV
        nbytes += 4 * c * c + 4.0 * 10 * c
    elif name == "fused_bert_attention_int8":
        keys = n if m is None else m
        int8 = 2.0 * c * c * (2 * rows + 2 * b * keys)    # q, out; k, v
        bf16 = 4.0 * b * n * keys * c
        nbytes += (0 if m is None else 4.0 * b * m * c) + 4 * c * c + 40.0 * c
    elif name in ("mlp_sublayer_int8", "mlp_postnorm_int8"):
        int8 = 4.0 * rows * c * hidden         # fc1 and fc2
        nbytes += 2 * c * hidden + 4.0 * (2 * hidden + 4 * c)
    else:
        raise ValueError(f"no bound for {name!r}")
    t_ops = int8 / PEAK_INT8_OPS + bf16 / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def int8_sublayer_calls(cfg: dict, batch: int) -> list:
    """[(kernel, b, n, c, hidden, m)] of one SeTok forward whose blocks all
    take the whole-sublayer int8 kernels (rows 2-5), from the shapes of a
    configuration (the benchmark's JSON): the ViT blocks up to the tap,
    the inner and inter Blocks, the Q-Former's self- and cross-attention
    and FFN, the decoder blocks."""
    v, t, d = cfg["vit"], cfg["tokenizer"], cfg["detokenizer"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    w = v["width"]
    calls = []
    for _ in range(v["select_layer"] % v["depth"] + 1):
        calls += [("attn_sublayer_int8", batch, n, w, 0, None),
                  ("mlp_sublayer_int8", batch, n, w, int(w * v["mlp_ratio"]),
                   None)]
    h, ff, k = t["hidden_dim"], t["dim_feedforward"], t["k_max"]
    for rows, depth in ((n, t["inner_cluster_layers"]),
                        (k, t["intra_cluster_layers"])):
        calls += [("attn_sublayer_int8", batch, rows, h, 0, None)] * depth
        calls.append(("mlp_sublayer_int8", batch, rows, h, ff, None))
    q = (d["image_size"] // d["patch_size"]) ** 2
    hq = d["hidden_dim"]
    for i in range(d["mapper_layers"]):
        calls.append(("fused_bert_attention_int8", batch, q, hq, 0, None))
        if i % d["cross_attention_freq"] == 0:
            calls.append(("fused_bert_attention_int8", batch, q, hq, 0, k))
        calls.append(("mlp_postnorm_int8", batch, q, hq, 4 * hq, None))
    dd = d["decoder_embed_dim"]
    for _ in range(d["decoder_depth"]):
        calls += [("attn_sublayer_int8", batch, q, dd, 0, None),
                  ("mlp_sublayer_int8", batch, q, dd,
                   int(dd * d["mlp_ratio"]), None)]
    return calls
