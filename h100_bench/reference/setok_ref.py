"""SeTok's mathematics in plain PyTorch, float32, for the benchmark's check.

A frozen, independent copy: it imports nothing of the program
(`setok_tpu_torch`), of the JAX package or of JAX. It reads a
configuration as the benchmark's JSON file states it (`vit`, `tokenizer`,
`detokenizer`) and its weights as a dict of float32 tensors in the port's
parameter names (`param_spec` lists them; weights.py draws them).

What it computes, for images (B, H, W, 3) in [-1, 1]:

  * ViT (SigLIP layout): patches of p x p x 3 in (row, column, channel)
    order, a linear patch embedding plus a learned position embedding,
    pre-norm blocks (LayerNorm eps 1e-6, fused qkv, softmax(q k^T / sqrt(d)),
    tanh GELU) up to the tapped block (`select_layer`, -1 the last);
  * the tokenizer: a projection to `hidden_dim` where the widths differ,
    plus the 2-D sin-cos encoding (PositionalEncoding2D); DPC-KNN
    (`cluster`); the inner Block (`inner_cluster_layers` attention
    sublayers sharing one pre-norm, LayerNorm eps 1e-5, exact GELU) under
    the same-cluster mask; the mean of each cluster; the inter Block over
    the valid clusters; the output linear, zero on invalid slots;
  * the detokenizer: the mask-token queries through the query-only
    Q-Former (BERT post-norm layers, eps 1e-12, cross-attention to the
    tokens every `cross_attention_freq` layers under the validity mask,
    exact GELU), a linear to the decoder width plus the 2-D encoding,
    pre-norm ViT blocks (eps 1e-5, exact GELU), the final LayerNorm and the
    pixel head, unpatchified.

A masked score is -1e30 before the softmax, so a row with every key masked
averages them all (the reference SeTok's `masked_fill`). Products run in
float32 with TF32 off (`no_tf32`); the clustering's distances in float64.

`quant` computes it in a lower precision, the control of a cell whose
program states int8 linears, one step below: "w4a8", every
transformer-block linear (the ViT's, the Blocks', the Q-Former's and the
decoder's) on weights rounded to int4 per output channel and inputs rounded
to int8 per row. `fp8` rounds features to float8 e4m3, the control of the
clustering stage (check.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
# the modules whose linears the int8 form computes in int8: the blocks of
# the ViT, the tokenizer, the Q-Former and the decoder
_BLOCKS = ("image_feature_encoder.block_", "inner_encoder.", "inter_encoder.",
           "mapper.layer_", "pixel_decoder_")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (cuBLAS and cuDNN), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# parameters


def _linear(name: str, n_in: int, n_out: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))]


def _norm(name: str, c: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _mlp(name: str, c: int, hidden: int) -> list:
    return _linear(f"{name}.fc1", c, hidden) + _linear(f"{name}.fc2", hidden, c)


def _vit_block(name: str, c: int, hidden: int) -> list:
    return (_norm(f"{name}.norm1", c) + _linear(f"{name}.attn.qkv", c, 3 * c)
            + _linear(f"{name}.attn.proj", c, c) + _norm(f"{name}.norm2", c)
            + _mlp(f"{name}.mlp", c, hidden))


def _block(name: str, c: int, hidden: int, depth: int) -> list:
    out = _norm(f"{name}.norm1", c)
    for i in range(depth):
        out += (_linear(f"{name}.attn_{i}.qkv", c, 3 * c)
                + _linear(f"{name}.attn_{i}.proj", c, c))
    return out + _norm(f"{name}.norm2", c) + _mlp(f"{name}.mlp", c, hidden)


def _bert_attn(name: str, c: int) -> list:
    return sum((_linear(f"{name}.{k}", c, c)
                for k in ("query", "key", "value", "out")), []) + _norm(
        f"{name}.out_norm", c)


def mlp_hidden(width: int, ratio: float) -> int:
    return int(width * ratio)


def param_spec(cfg: dict) -> Dict[str, List[Tuple[str, tuple]]]:
    """{part: [(name, shape)]}: every parameter of the tokenizer and the
    detokenizer, named as the port's state dicts of `SetokTokenizer` and
    `SetokDeTokenizer` name them."""
    v, t, d = cfg["vit"], cfg["tokenizer"], cfg["detokenizer"]
    w, p = v["width"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    enc = "image_feature_encoder"
    tok = [(f"{enc}.pos_embed", (1, n, w))] + _linear(
        f"{enc}.patch_embed", p * p * 3, w)
    for i in range(v["depth"]):
        tok += _vit_block(f"{enc}.block_{i}", w, mlp_hidden(w, v["mlp_ratio"]))
    h = t["hidden_dim"]
    if w != h:
        tok += _linear("feat_proj", w, h)
    tok += _block("inner_encoder", h, t["dim_feedforward"],
                  t["inner_cluster_layers"])
    tok += _block("inter_encoder", h, t["dim_feedforward"],
                  t["intra_cluster_layers"])
    tok += _linear("out", h, t["token_feat_dim"])

    q, hq, dd = (d["image_size"] // d["patch_size"]) ** 2, d["hidden_dim"], \
        d["decoder_embed_dim"]
    det = [("mask_tokens", (1, q, hq))]
    det += _linear("mapper_fc_in", d["token_feat_dim"], hq)
    det += _norm("mapper.embed_norm", hq)
    for i in range(d["mapper_layers"]):
        name = f"mapper.layer_{i}"
        det += _bert_attn(f"{name}.self_attn", hq)
        if i % d["cross_attention_freq"] == 0:
            det += _bert_attn(f"{name}.cross_attn", hq)
        det += (_linear(f"{name}.ffn_in", hq, 4 * hq)
                + _linear(f"{name}.ffn_out", 4 * hq, hq)
                + _norm(f"{name}.ffn_norm", hq))
    det += _linear("decoder_fc_in", hq, dd)
    for i in range(d["decoder_depth"]):
        det += _vit_block(f"pixel_decoder_{i}", dd,
                          mlp_hidden(dd, d["mlp_ratio"]))
    det += _norm("decoder_norm", dd) + _linear(
        "pixel_head", dd, d["patch_size"] ** 2 * 3)
    return {"tokenizer": tok, "detokenizer": det}


# ---------------------------------------------------------------------------
# layers


def int4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to the 15 levels of symmetric int4 with one scale per
    slice along `dim` (its largest magnitude to 7), back in float32."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / 7.0
    return (x / s).round().clamp(-7, 7) * s


def int8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to the 255 levels of symmetric int8 with one scale per
    slice along `dim` (its largest magnitude to 127), back in float32."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / 127.0
    return (x / s).round().clamp(-127, 127) * s


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim` (its
    largest magnitude to 448), back in float32."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ref:
    """The plain model over one part's float32 weights `w` (names without
    the part's prefix). `quant`: None, or a control's precision."""

    def __init__(self, w: Dict[str, torch.Tensor], quant: Optional[str] = None):
        if quant not in (None, "w4a8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.w = w
        self.quant = quant

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        wt, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        if self.quant == "w4a8" and name.startswith(_BLOCKS):
            return int8(x, -1) @ int4(wt, 1).t() + b
        return x @ wt.t() + b

    def norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], eps)

    @staticmethod
    def attend(q, k, v, heads: int, mask=None) -> torch.Tensor:
        """softmax(q k^T / sqrt(d)) v over `heads` heads; mask (B, Nq, Nk)
        or (B, 1, Nk), True = attend."""
        b, nq, c = q.shape
        nk, hd = k.shape[1], c // heads
        q = q.reshape(b, nq, heads, hd).transpose(1, 2)
        k = k.reshape(b, nk, heads, hd).transpose(1, 2)
        v = v.reshape(b, nk, heads, hd).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            s = torch.where(mask[:, None], s, torch.full_like(s, NEG))
        o = s.softmax(-1) @ v
        return o.transpose(1, 2).reshape(b, nq, c)

    def self_attn(self, x, name: str, heads: int, mask=None):
        c = x.shape[-1]
        qkv = self.linear(x, f"{name}.qkv")
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        return self.linear(self.attend(q, k, v, heads, mask), f"{name}.proj")

    def mlp(self, x, name: str, tanh: bool) -> torch.Tensor:
        h = F.gelu(self.linear(x, f"{name}.fc1"),
                   approximate="tanh" if tanh else "none")
        return self.linear(h, f"{name}.fc2")

    def vit_block(self, x, name: str, heads: int, eps: float, tanh: bool):
        x = x + self.self_attn(self.norm(x, f"{name}.norm1", eps),
                               f"{name}.attn", heads)
        return x + self.mlp(self.norm(x, f"{name}.norm2", eps), f"{name}.mlp",
                            tanh)

    def block(self, x, name: str, heads: int, depth: int, mask):
        for i in range(depth):
            x = x + self.self_attn(self.norm(x, f"{name}.norm1", 1e-5),
                                   f"{name}.attn_{i}", heads, mask)
        return x + self.mlp(self.norm(x, f"{name}.norm2", 1e-5),
                            f"{name}.mlp", False)

    def bert_attn(self, x, kv, name: str, heads: int, kv_mask=None):
        mask = None if kv_mask is None else kv_mask[:, None, :]
        o = self.attend(self.linear(x, f"{name}.query"),
                        self.linear(kv, f"{name}.key"),
                        self.linear(kv, f"{name}.value"), heads, mask)
        return self.norm(self.linear(o, f"{name}.out") + x,
                         f"{name}.out_norm", 1e-12)


def posenc_2d(h: int, w: int, channels: int, device) -> torch.Tensor:
    """PositionalEncoding2D of the reference SeTok, (h*w, channels): the
    first ch = 2*ceil(channels/4) channels sin/cos (interleaved) of the
    row index times inv_freq, the next ch of the column index; inv_freq a
    float32 buffer there, so rounded through float32 here."""
    ch = int(math.ceil(channels / 4) * 2)
    inv = (1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))
           ).astype(np.float32).astype(np.float64)

    def axis(n):
        a = np.arange(n, dtype=np.float64)[:, None] * inv[None]
        return np.stack([np.sin(a), np.cos(a)], -1).reshape(n, ch)

    emb = np.concatenate([np.repeat(axis(h)[:, None], w, 1),
                          np.repeat(axis(w)[None], h, 0)], -1)
    return torch.tensor(emb[..., :channels].reshape(h * w, channels),
                        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the tokenizer


def vit_features(r: Ref, v: dict, images: torch.Tensor) -> torch.Tensor:
    p, g = v["patch_size"], v["image_size"] // v["patch_size"]
    b = images.shape[0]
    x = images[:, :g * p, :g * p].reshape(b, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    enc = "image_feature_encoder"
    x = r.linear(x, f"{enc}.patch_embed") + r.w[f"{enc}.pos_embed"]
    for i in range(v["select_layer"] % v["depth"] + 1):
        x = r.vit_block(x, f"{enc}.block_{i}", v["num_heads"], 1e-6, True)
    return x


def features(r: Ref, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """The tokenizer's input to the clustering, (B, N, hidden_dim)."""
    v, t = cfg["vit"], cfg["tokenizer"]
    if v.get("merge_layer") is not None or v.get("use_class_token"):
        raise NotImplementedError("the reference has no token merge and no "
                                  "class token")
    x = vit_features(r, v, images)
    if v["width"] != t["hidden_dim"]:
        x = r.linear(x, "feat_proj")
    g = v["image_size"] // v["patch_size"]
    return x + posenc_2d(g, g, t["hidden_dim"], x.device)


def cluster(x: torch.Tensor, t: dict) -> Dict[str, torch.Tensor]:
    """DPC-KNN of features (B, N, C), distances in float64:

        d_ij     = ||x_i - x_j|| / sqrt(C)
        rho_i    = exp(-mean of the k smallest d_ij^2) + (i + 0.5)/N 1e-6
        delta_i  = min_j (rho_j > rho_i ? d_ij : max_l d_jl)
        score_i  = delta_i rho_i

    Centers: the scores above `threshold` (at most k_max, highest first), or
    the `min_cluster_num` highest when none is; slots in index order of the
    centers; each token joins its nearest center (the first on a tie), a
    center its own slot. Returns idx (B, N), score (B, N), num (B,) and the
    distances (B, N, N)."""
    xd = x.double()
    b, n, c = xd.shape
    sq = (xd * xd).sum(-1)
    d2 = (sq[:, :, None] + sq[:, None, :] - 2 * xd @ xd.transpose(1, 2))
    d2 = d2.clamp_min(0) * (1 - torch.eye(n, dtype=xd.dtype, device=x.device))
    dist = d2.sqrt() / math.sqrt(c)
    k = min(t["knn"], n)
    near = dist.topk(k, -1, largest=False).values
    rho = (-(near * near).mean(-1)).exp() + (
        torch.arange(n, dtype=xd.dtype, device=x.device) + 0.5) / n * 1e-6
    rowmax = dist.amax(-1)
    higher = rho[:, None, :] > rho[:, :, None]
    delta = torch.where(higher, dist, rowmax[:, None, :].expand_as(dist)).amin(-1)
    score = delta * rho
    idx = torch.empty(b, n, dtype=torch.long, device=x.device)
    num = torch.empty(b, dtype=torch.long, device=x.device)
    for i in range(b):
        centers = select_centers(score[i], t)
        idx[i] = dist[i, centers].argmin(0)
        idx[i, centers] = torch.arange(centers.numel(), device=x.device)
        num[i] = centers.numel()
    return {"idx": idx, "score": score.float(), "num": num, "dist": dist}


def select_centers(score: torch.Tensor, t: dict) -> torch.Tensor:
    """The centers of one image from its scores (N,), ascending: those
    above `threshold`, at most k_max of them, highest first (index order on
    ties), or else the `min_cluster_num` highest."""
    n = score.shape[0]
    above = torch.nonzero(score > t["threshold"]).flatten()
    if above.numel() == 0:
        cand, count = torch.arange(n, device=score.device), t["min_cluster_num"]
    else:
        cand, count = above, min(above.numel(), t["k_max"])
    order = torch.sort(score[cand], descending=True, stable=True).indices
    return torch.sort(cand[order[:count]]).values


def tokens_given(r: Ref, cfg: dict, x: torch.Tensor, idx: torch.Tensor):
    """The tokenizer's stages past the clustering, for features x (B, N, C)
    and a clustering idx (B, N): tokens (B, k_max, F), valid (B, k_max)."""
    t = cfg["tokenizer"]
    k_max, heads = t["k_max"], t["nheads"]
    same = idx[:, :, None] == idx[:, None, :]
    grouped = r.block(x, "inner_encoder", heads, t["inner_cluster_layers"],
                      same)
    onehot = F.one_hot(idx, k_max).to(x.dtype)              # (B, N, K)
    counts = onehot.sum(1)
    pooled = (onehot.transpose(1, 2) @ grouped) / counts.clamp_min(1)[..., None]
    valid = counts > 0
    inter = r.block(pooled, "inter_encoder", heads, t["intra_cluster_layers"],
                    valid[:, None, :] & valid[:, :, None])
    return r.linear(inter, "out") * valid[..., None].to(x.dtype), valid


# ---------------------------------------------------------------------------
# the detokenizer


def reconstruct(r: Ref, d: dict, tokens: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Concept tokens (B, K, F) and their validity → image (B, H, W, 3)."""
    b = tokens.shape[0]
    enc = r.linear(tokens, "mapper_fc_in")
    h = r.norm(r.w["mask_tokens"].expand(b, -1, -1), "mapper.embed_norm",
               1e-12)
    heads = d["mapper_heads"]
    for i in range(d["mapper_layers"]):
        name = f"mapper.layer_{i}"
        h = r.bert_attn(h, h, f"{name}.self_attn", heads)
        if i % d["cross_attention_freq"] == 0:
            h = r.bert_attn(h, enc, f"{name}.cross_attn", heads, valid)
        y = r.linear(F.gelu(r.linear(h, f"{name}.ffn_in")), f"{name}.ffn_out")
        h = r.norm(y + h, f"{name}.ffn_norm", 1e-12)
    g, p = d["image_size"] // d["patch_size"], d["patch_size"]
    x = r.linear(h, "decoder_fc_in") + posenc_2d(g, g, d["decoder_embed_dim"],
                                                 h.device)
    for i in range(d["decoder_depth"]):
        x = r.vit_block(x, f"pixel_decoder_{i}", d["decoder_nheads"], 1e-5,
                        False)
    pix = r.linear(r.norm(x, "decoder_norm", 1e-5), "pixel_head")
    pix = pix.reshape(b, g, g, p, p, 3).permute(0, 1, 3, 2, 4, 5)
    return pix.reshape(b, g * p, g * p, 3)
