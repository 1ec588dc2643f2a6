"""The floating-point work of SeTok's parts, counted from a configuration.

Every matrix product and attention product that the model defines, for
one image: the ViT's patch embedding and blocks up to the tap, the
tokenizer's projection, row 1's Gram product (2 N^2 C), the inner Block
over all N^2 pairs, the inter Block, the output linear, the Q-Former, the
decoder and the pixel head. Attention counts every pair (QK^T and PV,
2 n m d each). A product counts 2 operations a multiply-add. The cluster
mean (N C additions) and the elementwise work are left out.

`int8` holds the products that a configuration run in its int8 form
declares int8: the linears of the ViT's, the tokenizer's, the Q-Former's
and the decoder's blocks. The rest, attention products included, is
`float`. The count is the same whatever kernel computes it. A traffic
mode sums the parts that its step runs (modes/<mode>.py `flops`).
"""

from __future__ import annotations

from typing import Dict


def _block(rows: int, c: int, hidden: int, keys: int, attn_layers: int = 1):
    """(linear ops, attention ops) of a transformer block over `rows`
    tokens of width c attending over `keys` keys."""
    lin = attn_layers * 2.0 * rows * c * 4 * c + 2.0 * 2 * rows * c * hidden
    att = attn_layers * 4.0 * rows * keys * c
    return lin, att


def tokenizer_flops(cfg: dict) -> Dict[str, float]:
    """{"int8": ..., "float": ...} operations of one image through the
    tokenizer: the ViT to the tap, the projection, the Gram, the Blocks and
    the output linear."""
    v, t = cfg["vit"], cfg["tokenizer"]
    p, w = v["patch_size"], v["width"]
    n = (v["image_size"] // p) ** 2
    block_lin, other = 0.0, 2.0 * n * p * p * 3 * w
    for _ in range(v["select_layer"] % v["depth"] + 1):
        lin, att = _block(n, w, int(w * v["mlp_ratio"]), n)
        block_lin, other = block_lin + lin, other + att
    h, k = t["hidden_dim"], t["k_max"]
    if w != h:
        other += 2.0 * n * w * h
    other += 2.0 * n * n * h                                   # the Gram
    for rows, layers in ((n, t["inner_cluster_layers"]),
                         (k, t["intra_cluster_layers"])):
        lin, att = _block(rows, h, t["dim_feedforward"], rows, layers)
        block_lin, other = block_lin + lin, other + att
    other += 2.0 * k * h * t["token_feat_dim"]
    return {"int8": block_lin, "float": other}


def detokenizer_flops(cfg: dict) -> Dict[str, float]:
    """{"int8": ..., "float": ...} operations of one image's k_max tokens
    through the detokenizer: the Q-Former, the decoder and the pixel head."""
    d, k = cfg["detokenizer"], cfg["tokenizer"]["k_max"]
    q, hq, dd = ((d["image_size"] // d["patch_size"]) ** 2, d["hidden_dim"],
                 d["decoder_embed_dim"])
    block_lin, other = 0.0, 2.0 * k * d["token_feat_dim"] * hq
    for i in range(d["mapper_layers"]):
        block_lin += 2.0 * q * hq * 4 * hq + 2.0 * 2 * q * hq * 4 * hq
        other += 4.0 * q * q * hq
        if i % d["cross_attention_freq"] == 0:
            block_lin += 2.0 * 2 * q * hq * hq + 2.0 * 2 * k * hq * hq
            other += 4.0 * q * k * hq
    other += 2.0 * q * hq * dd
    for _ in range(d["decoder_depth"]):
        lin, att = _block(q, dd, int(dd * d["mlp_ratio"]), q)
        block_lin, other = block_lin + lin, other + att
    other += 2.0 * q * dd * d["patch_size"] ** 2 * 3
    return {"int8": block_lin, "float": other}


def total(*parts: Dict[str, float]) -> Dict[str, float]:
    """The sum of parts' counts."""
    return {k: sum(p[k] for p in parts) for k in ("int8", "float")}
