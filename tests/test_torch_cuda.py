"""Card-only checks of the port's CUDA kernels, held to their plain
versions. They skip without a card; on one, run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not need). This file imports no JAX.

Bars: density and row max rtol 1e-5 (float32, summation order only);
scores rtol 1e-4 on the peaks and within 1e-3 on ≥ 90 % of tokens, because a
parent can flip between same-blob density near-ties. The int8 kernels at
every shape of the base forward, and the unfused route's fused_mlp_int8
and fused_attention_int8 at theirs, with chip_smoke.py's bars: the MLPs
(rows 3, 5 and 6) 1e-5 max-rel and 0 elements differing from the plain
versions; the attentions 2e-3 max-rel with ≥ 99 % of the elements within
1e-5 of the largest (PV sums in another order than the plain version's,
which can flip a bf16 or int8 rounding step; the scores of rows 2, 4 and 7
are the float64 product rounded once on both sides); rows 2, 3, 4 and 7
also at 240 rows (B=3 images of 80, not a multiple of the GEMM's 128-row
tile), row 4 with every key of an image masked (LN(bo + x), 0 elements
differing) and row 7 with fully masked query rows (b_proj exactly), and
each raising on a shape its chain does not take (rows 4 and 7: more than
768 keys, a head width not a multiple of 16), rows 2 and 4 at the
token-merge recipe's single key tile (B=64: 64 tokens, 64 keys), equal
to the bit over repeated calls; an int8 Block at the
4096-wide MLP's shape, card against
CPU, 5e-2 (chip_smoke.py's FWD_INT8_TOL). The serving kernels:
quant_matmul and quant4_matmul 1e-5 max-rel (exact int products, the same
float epilogue); the int8-cache decode attention 2e-3 max-rel with ≥ 99 %
of the elements within 1e-5 of the largest, with q in f32, bf16 and f16
(one launch, the output in q's type, the serving mask's wholly masked
tiles skipped and counted) and at G = 8 past S = 5,085 (up to 8192, where
the first kernel's shared memory ran out), printing the elements that
differ from the plain version (expected 0: the same float64 sums rounded
once). The DPC-KNN kernel also at N = 576, 729 (C = 1152) and 1024, and
past 1024, where a warp takes a row and selects by histogram (N = 1025,
1296, ViT-B/16 at 576 px, 2304, at 768 px, 4096, past the rows held in
shared memory, and 19370 at C = 64), its centers and assignments the plain
route's, and at B = 8, N = 1296 equal to the bit over repeated calls. The flash-attention kernels,
with chip_smoke.flash_case's bars: the forward's o 2e-3 max-rel with ≥ 99 %
within 1e-5 of the largest (p rounds to the input type before P.V), lse
1e-5, dq/dk/dv 1e-4 (float32, sums in another order; bf16's f32 operands
split in two bf16 terms); a fully masked query row gives zeros. The
backward and the forward alone also on masks of empty, full and mixed
64 x 64 tiles and at Lk = 1000 and 1001; there the forward's share bar is
no more than 0.01 under the share of the plain version's float64-score
twin where that falls under 99 % (chip_smoke.flash_fwd_check says why).
quant_matmul also at K = 4304 and N = 4304 with bf16 x and bf16 or f32
output, through the wgmma GEMM (printing the count of elements that
differ from the plain version, expected 0). quant4_matmul at the serving
trunk's widths (K, N = 4096, 11008 and 11008, 4096) through the one-launch
GEMV (M <= 8) and the wgmma GEMM over unpacked nibbles (M > 8), per channel
and group 128, and fused_mlp_int8 at 1,728 and 36,864 rows of 768 with
float32 and bfloat16 x: 0 elements may differ from the plain versions
(exact int products, the same float epilogue in the same order).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import cluster_dpc
from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import flash_attention as fa
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (quant4_matmul_plain,
                                           quant_matmul_plain,
                                           quantize_weight,
                                           quantize_weight_int4)
from setok_tpu_torch.models.setok import SeTok, expected_calls
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.utils.init import init_random_, init_setokim_random_

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blobs(seed, n, c, n_blobs=5):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_blobs, c)
    labels = rs.randint(0, n_blobs, size=n)
    return (centers[labels] + rs.randn(n, c) * 0.05).astype(np.float32)


@pytest.mark.parametrize("b,n,c,k", [
    (2, 50, 100, 8),        # ragged row tile, C not a multiple of the chunk
    (2, 50, 99, 8),         # C not a multiple of 4: the scalar loads
    (1, 1024, 64, 1024),    # the largest N held in registers, k=N
    (1, 1024, 768, 64),     # the same N at the base width
    (3, 256, 768, 64),      # the base configuration
    (2, 576, 768, 64),      # base @384
    (1, 729, 1152, 64),     # so400m's token count
    (2, 729, 1152, 64),     # so400m's token count and width
    (2, 1025, 768, 64),     # the first N past the registers: a warp a row
    (2, 1296, 768, 64),     # ViT-B/16 at 576 px: rows in shared memory
    (1, 2304, 768, 64),     # ViT-B/16 at 768 px
    (1, 4096, 768, 64),     # past 3072: each pass reads the row from G
    (1, 19370, 64, 64),     # the largest N (MAX_N)
])
def test_kernel_matches_reference(card, b, n, c, k):
    x = torch.from_numpy(np.stack([_blobs(s, n, c) for s in range(b)])).to(card)
    before = cluster_dpc.LAUNCHES
    dens, parent, rowmax = cluster_dpc.dpc_density_parent(x, k)
    torch.cuda.synchronize()
    # the Gram product and the density/parent pass; past 1024 the Gram,
    # the densities and the parents
    assert cluster_dpc.LAUNCHES == before + cluster_dpc.launches_per_call(n) \
        == before + (2 if n <= 1024 else 3)
    rd, rp, rr = cluster_dpc.dpc_density_parent_reference(x, k)
    torch.testing.assert_close(dens, rd, rtol=1e-5, atol=0)
    torch.testing.assert_close(rowmax, rr, rtol=1e-5, atol=0)
    got, want = (dens * parent).cpu(), (rd * rp).cpu()
    assert torch.isclose(got, want, rtol=1e-3, atol=1e-3).float().mean() >= 0.9
    peaks = want > 0.55
    torch.testing.assert_close(got[peaks], want[peaks], rtol=1e-4, atol=0)
    # the kernel route's centers and assignments are the plain route's
    kw = dict(k_max=min(64, n), min_cluster_num=min(8, n), threshold=0.55)
    res = cluster_dpc.cluster_dpc_knn_kernel(x, k, **kw)
    ref = cluster_dpc.select_and_assign(x, rd * rp, **kw)
    assert torch.equal(res.num_clusters, ref.num_clusters)
    assert torch.equal(res.center_idx, ref.center_idx)
    assert torch.equal(res.idx_cluster, ref.idx_cluster)


def test_kernel_repeats_to_the_bit_at_the_576px_path(card):
    """Row 1 at the shape eval_recon --image-size 576 gives it (B=8 of N =
    1296, C = 768): three calls, equal to the bit (the counts of the
    histogram select are integer atomics; nothing else is ordered by the
    schedule)."""
    x = torch.from_numpy(np.stack([_blobs(s, 1296, 768)
                                   for s in range(8)])).to(card)
    first = cluster_dpc.dpc_density_parent(x, 64)
    for _ in range(2):
        again = cluster_dpc.dpc_density_parent(x, 64)
        assert all(torch.equal(a, b) for a, b in zip(first, again))

def test_tokenizer_routes_to_the_kernel(card):
    model = init_random_(SeTok(cfgs.tiny_tokenizer(), cfgs.tiny_detokenizer(),
                               device=card), 0)
    images = torch.rand(2, 32, 32, 3, device=card) * 2 - 1
    before = cluster_dpc.LAUNCHES
    out = model(images)
    torch.cuda.synchronize()
    assert cluster_dpc.LAUNCHES == before + 2
    assert torch.isfinite(out.recon).all()
    # a token mask takes the plain path, as in the JAX package
    feats = model.tokenizer.encode_features(images)
    model.tokenizer.cluster(feats, token_mask=torch.ones(2, 16, device=card))
    assert cluster_dpc.LAUNCHES == before + 2


# the cases of chip_smoke.int8_cases, and the CUDA launches of one call:
# rows 2 and 5 the row pass, two wgmma GEMMs and the attention or hidden
# pass, then the o pass or the post-norm; row 3 the row pass, two GEMMs and
# the hidden pass; row 4 its eight, nine with a key mask
INT8_CASES = [("attn_sublayer_int8", "vit", 5),
              ("attn_sublayer_int8", "decoder", 5),
              ("attn_sublayer_int8", "inner", 5),
              ("attn_sublayer_int8", "inter", 5),
              ("mlp_sublayer_int8", "vit", 4),
              ("mlp_sublayer_int8", "inter", 4),
              ("mlp_postnorm_int8", "mapper", 5),
              ("fused_bert_attention_int8", "self", 8),
              ("fused_bert_attention_int8", "cross", 9)]


@pytest.mark.parametrize("index", range(len(INT8_CASES)),
                         ids=[f"{n}-{s}" for n, s, _ in INT8_CASES])
def test_int8_kernel_matches_reference(card, index):
    name, label, steps = INT8_CASES[index]
    case = chip_smoke.int8_cases(2, card)[index]
    assert case[:2] == (name, label)
    launches = {**fs.LAUNCHES, **fba.LAUNCHES}
    calls = {**fs.CALLS, **fba.CALLS}
    res = chip_smoke.check_int8_case(*case)    # raises SystemExit on a miss
    assert {**fs.LAUNCHES, **fba.LAUNCHES}[name] == launches[name] + steps
    assert {**fs.CALLS, **fba.CALLS}[name] == calls[name] + 1
    if name in chip_smoke.BIT_EXACT:
        assert res["elements_differing"] == 0
    print(name, label, {k: res[k] for k in ("share_within_1e-5",
                                            "f32_scores_share") if k in res})


@pytest.mark.parametrize("name", ["attn_sublayer_int8", "mlp_sublayer_int8"])
def test_int8_sublayer_at_ragged_rows(card, name):
    """Rows 2 and 3 at B=3 images of N=80 (M = 240 rows, not a multiple of
    the wgmma GEMM's 128-row tile: TMA zero-fills the last tile's rows),
    row 2 with the inter Block's mask, against their plain versions."""
    case = next(c for c in chip_smoke.int8_cases(3, card)
                if c[:2] == (name, "inter"))
    assert tuple(case[4][0].shape[:2]) == (3, 80)
    res = chip_smoke.check_int8_case(*case)    # raises SystemExit on a miss
    if name == "mlp_sublayer_int8":
        assert res["elements_differing"] == 0


def test_attn_sublayer_with_a_one_stage_ring(card):
    """Row 2 at N=361 (the 19 x 19 patches of a 304-px image, which the
    JAX gate still routes here) with 2 heads of 384 and a same-cluster
    mask: 384 keys of scores leave room for one K/V tile in shared memory,
    so the attention's ring is one stage deep."""
    rs = np.random.RandomState(361)
    b, n, c = 2, 361, 768
    assert fs.attn_fits_vmem(n, c)
    x = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(card)
    labels = torch.from_numpy(rs.randint(0, 4, (b, n))).to(card)
    mask = labels[:, :, None] == labels[:, None, :]
    vec, weight = chip_smoke._vec, chip_smoke._weight
    args = (x, vec(rs, c, card, 0.1, 1.0), vec(rs, c, card),
            weight(rs, 3 * c, c, card), vec(rs, 3 * c, card),
            weight(rs, c, c, card), vec(rs, c, card), 2)
    chip_smoke.check_int8_case("attn_sublayer_int8", "n361",
                               fs.attn_sublayer_int8,
                               fs.attn_sublayer_int8_reference, args,
                               {"mask": mask, "ln_eps": 1e-5})


def test_int8_sublayers_raise_on_shapes_they_do_not_take(card):
    """A head width that is not a multiple of 16, and a width that is not
    one of 16, raise: the C entry refuses them and launches nothing."""
    rs = np.random.RandomState(4)

    def vec(n, offset=0.0):
        return torch.from_numpy((offset + 0.1 * rs.randn(n)).astype(
            np.float32)).to(card)

    def weight(out, inp):
        return quantize_weight(torch.from_numpy(
            (rs.randn(out, inp) / np.sqrt(inp)).astype(np.float32)).to(card))

    c = 96                                  # 8 heads of 12
    x = torch.from_numpy(rs.randn(2, 16, c).astype(np.float32)).to(card)
    launches = fs.LAUNCHES["attn_sublayer_int8"]
    with pytest.raises(RuntimeError, match="after 0 launches"):
        fs.attn_sublayer_int8(x, vec(c, 1.0), vec(c), weight(3 * c, c),
                              vec(3 * c), weight(c, c), vec(c), 8)
    assert fs.LAUNCHES["attn_sublayer_int8"] == launches
    c = 40
    x = torch.from_numpy(rs.randn(2, 16, c).astype(np.float32)).to(card)
    with pytest.raises(RuntimeError, match="after 0 launches"):
        fs.mlp_sublayer_int8(x, vec(c, 1.0), vec(c), weight(64, c), vec(64),
                             weight(c, 64), vec(c))


# rows 4 and 7 at B=3: row 4's cross-attention over 240 key rows, row 7 at
# 240 rows (the inter Block, 2 heads of 384, N=80, fully masked rows) and
# at 768 (the inner Block's cluster mask)
RAGGED_ATTENTION = [("int8", "fused_bert_attention_int8", "cross"),
                    ("unfused", "fused_attention_int8", "inter"),
                    ("unfused", "fused_attention_int8", "inner")]


@pytest.mark.parametrize("kind,name,label", RAGGED_ATTENTION,
                         ids=[f"{n}-{s}" for _, n, s in RAGGED_ATTENTION])
def test_int8_attention_at_ragged_rows(card, kind, name, label):
    cases = (chip_smoke.int8_cases(3, card) if kind == "int8"
             else chip_smoke.unfused_cases(3, card))
    case = next(c for c in cases if c[:2] == (name, label))
    res = chip_smoke.check_int8_case(*case)    # raises SystemExit on a miss
    print(name, label, {k: res[k] for k in (
        "share_within_1e-5", "f32_scores_share", "share_vs_f32_pv")
        if k in res})
    if label == "inter":
        args, mask = case[4], case[5]["mask"]
        assert tuple(args[0].shape[:2]) == (3, 80)
        rows = ~mask.any(-1)
        got = case[2](*args, **case[5])
        assert bool(rows.any()) and torch.equal(
            got[rows], args[4].expand(int(rows.sum()), -1))


@pytest.mark.parametrize("label", ["vit merged", "cross merged"])
def test_int8_attention_at_one_key_tile(card, label):
    """Rows 2 and 4 at the token-merge recipe's shapes, B=64: a ViT block
    of 64 tokens (12 heads of 64) and the Q-Former's cross-attention over
    64 keys, each a single key tile, so the attention has 2 units of work
    for a ring of up to 4 stages. Against their plain versions, and two
    more calls equal to the first to the bit (the ring once waited on too
    few copy groups there, and read tiles still in flight)."""
    case = next(c for c in chip_smoke.int8_cases(64, card, shapes="merged")
                if c[1] == label)
    chip_smoke.check_int8_case(*case)          # raises SystemExit on a miss
    _, _, kernel, _, args, kw = case
    first = kernel(*args, **kw)
    assert torch.equal(first, kernel(*args, **kw))
    assert torch.equal(first, kernel(*args, **kw))


def test_bert_cross_with_every_key_of_an_image_masked(card):
    """Row 4 cross-attention (M=80 keys) with the key mask of image 0 all
    False: its queries attend to nothing, and their output is LN(bo + x)."""
    case = next(c for c in chip_smoke.int8_cases(3, card)
                if c[:2] == ("fused_bert_attention_int8", "cross"))
    assert case[4][1].shape[1] == 80
    res = chip_smoke.bert_masked_query_check(*case)
    assert res["elements_differing"] == 0


def test_int8_attentions_raise_on_shapes_they_do_not_take(card):
    """More than 768 keys, and a head width that is not a multiple of 16,
    raise: the C entries refuse them and launch nothing."""
    rs = np.random.RandomState(5)
    vec, weight = chip_smoke._vec, chip_smoke._weight

    def x(b, n, c):
        return torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
            card)

    def bert(q, kv, c, heads):
        ws = [t for _ in range(4)
              for t in (weight(rs, c, c, card), vec(rs, c, card))]
        return fba.fused_bert_attention_int8(
            q, kv, *ws, vec(rs, c, card, 0.1, 1.0), vec(rs, c, card), heads)

    def unfused(q, c, heads):
        return fai.fused_attention_int8(
            q, weight(rs, 3 * c, c, card), vec(rs, 3 * c, card),
            weight(rs, c, c, card), vec(rs, c, card), heads)

    launches = (fba.LAUNCHES["fused_bert_attention_int8"],
                fai.LAUNCHES["fused_attention_int8"])
    q = x(2, 16, 64)
    with pytest.raises(RuntimeError, match="after 0 launches"):
        bert(q, x(2, 769, 64), 64, 4)          # 769 keys
    q96 = x(2, 16, 96)
    with pytest.raises(RuntimeError, match="after 0 launches"):
        bert(q96, q96, 96, 8)                  # 8 heads of 12
    with pytest.raises(RuntimeError, match="after 0 launches"):
        unfused(x(2, 769, 64), 64, 4)          # 769 keys
    with pytest.raises(RuntimeError, match="after 0 launches"):
        unfused(q96, 96, 8)
    assert (fba.LAUNCHES["fused_bert_attention_int8"],
            fai.LAUNCHES["fused_attention_int8"]) == launches


# the cases of chip_smoke.unfused_cases, and the CUDA launches of one call
UNFUSED_CASES = [("fused_mlp_int8", "384px", 4),
                 ("fused_attention_int8", "inner", 5),
                 ("fused_attention_int8", "inter", 5),
                 ("fused_attention_int8", "unmasked", 5),
                 ("fused_mlp_int8", "576px", 4)]


@pytest.mark.parametrize("index", range(len(UNFUSED_CASES)),
                         ids=[f"{n}-{s}" for n, s, _ in UNFUSED_CASES])
def test_unfused_kernel_matches_reference(card, index):
    """Rows 6 and 7 against their plain versions at the path shapes (the
    MLP at 576 and 1296 tokens of 768, the attention with 2 heads of
    384)."""
    name, label, steps = UNFUSED_CASES[index]
    case = chip_smoke.unfused_cases(1, card)[index]
    assert case[:2] == (name, label)
    mod = fm if name == "fused_mlp_int8" else fai
    launches, calls = mod.LAUNCHES[name], mod.CALLS[name]
    chip_smoke.check_int8_case(*case)          # raises SystemExit on a miss
    assert mod.LAUNCHES[name] == launches + steps
    assert mod.CALLS[name] == calls + 1


def test_int8_block_at_ff4096_takes_the_fused_attention(card):
    """An int8 tokenizer Block at the 4096-wide MLP's shape (N=256,
    C=768, 2 heads, a cluster mask) takes fused_attention_int8 for its
    attention sublayers and quant_matmul for its MLP, and matches the same
    block on the CPU."""
    from setok_tpu_torch.ops.blocks import Block

    tok = cfgs.replace(cfgs.base_tokenizer(), dim_feedforward=4096)
    c, hidden = tok.hidden_dim, tok.dim_feedforward
    cpu = init_random_(Block(c, tok.nheads, hidden, depth=2, norm_eps=1e-5,
                             quant8=True, device="cpu"), 0)
    gpu = Block(c, tok.nheads, hidden, depth=2, norm_eps=1e-5, quant8=True,
                device=card)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 256, c).astype(np.float32))
    mask = torch.from_numpy(rs.randint(0, 4, (2, 256)))
    mask = mask[:, :, None] == mask[:, None, :]
    chip_smoke.reset_counts()
    qm.reset_counts()
    with torch.inference_mode():
        got = gpu(x.to(card), mask.to(card))
        torch.cuda.synchronize()
        want = cpu(x, mask)
    assert fai.CALLS["fused_attention_int8"] == 2
    assert fai.LAUNCHES["fused_attention_int8"] == 10
    assert qm.CALLS["quant_matmul"] == 2
    assert fs.CALLS["attn_sublayer_int8"] == 0
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 5e-2


def test_int8_forward_routes_to_the_kernels(card):
    tok, det = cfgs.tiny_tokenizer(), cfgs.tiny_detokenizer()
    model = init_random_(SeTok(tok, det, device=card, quant8=True), 0)
    images = torch.rand(2, 32, 32, 3, device=card) * 2 - 1
    chip_smoke.reset_counts()
    out = model(images)
    torch.cuda.synchronize()
    assert chip_smoke.int8_counts()[0] == chip_smoke.expected_calls(tok, det)
    assert cluster_dpc.LAUNCHES == 2
    assert torch.isfinite(out.recon).all()


# (format, M, K, N, x's type, out_dtype): the serving formats at small
# widths in float32, and w8 at so400m's ragged K = 4304 (16 mod 32) and N =
# 4304 with bf16 x, as the int8 SeTok's Dense takes it, M past and inside
# the wgmma GEMM's 128-row tile edges (9, 129, 5832 = so400m's rows)
QUANT_CASES = ([(fmt, m, 256, 384, "float32", None)
                for fmt in ("w8", "w4", "w4g64") for m in (1, 4, 40)]
               + [("w8", m, 4304, 4304, "bfloat16", out)
                  for m in (9, 129, 5832) for out in ("bfloat16", "float32")])


@pytest.mark.parametrize(
    "fmt,m,k,n,x_dtype,out_dtype", QUANT_CASES,
    ids=[f"{c[0]}-M{c[1]}-K{c[2]}-{c[4]}-{c[5] or c[4]}" for c in QUANT_CASES])
def test_quant_matmul_kernels_match_plain(card, fmt, m, k, n, x_dtype,
                                          out_dtype):
    """The kernel reads x in its type and writes out_dtype itself: the
    int products are exact and the epilogue's order is the plain
    version's, so the count of elements that differ is expected to be 0
    (printed); the bar stays max-rel 1e-5."""
    gen = torch.Generator(device=card).manual_seed(m)
    w = torch.randn(n, k, generator=gen, device=card) * k ** -0.5
    x = torch.randn(m, k, generator=gen, device=card).to(
        getattr(torch, x_dtype))
    out_dtype = getattr(torch, out_dtype) if out_dtype else None
    if fmt == "w8":
        wq, kernel, plain, name = (quantize_weight(w), qm.quant_matmul,
                                   quant_matmul_plain, "quant_matmul")
    else:
        wq = quantize_weight_int4(w, 64 if fmt == "w4g64" else None, 8)
        kernel, plain, name = (qm.quant4_matmul, quant4_matmul_plain,
                               "quant4_matmul")
    calls, launches = qm.CALLS[name], qm.LAUNCHES[name]
    got = kernel(x, wq, out_dtype)
    torch.cuda.synchronize()
    # M <= 8: the GEMV quantises the rows itself; above: rows, then GEMM
    assert qm.CALLS[name] == calls + 1
    assert qm.LAUNCHES[name] == launches + (1 if m <= 8 else 2)
    want = plain(x, wq, out_dtype)
    assert got.dtype == want.dtype == (out_dtype or x.dtype)
    print(f"{name} {fmt} M={m} K={k} N={n} {x_dtype} -> {got.dtype}: "
          f"{int((got != want).sum())} of {got.numel()} elements differ")
    assert float((got.double() - want.double()).abs().max()
                 / want.double().abs().max()) <= 1e-5


# quant4_matmul at the serving trunk's widths: (format, M, K, N, x's type,
# output type); M on both sides of the GEMV / GEMM rule and of the GEMM's
# 64-row tile
QUANT4_CASES = [(fmt, m, k, n, dt, dt)
                for fmt in ("w4", "w4g128")
                for m in (1, 4, 8, 9, 130, 512)
                for k, n in ((4096, 11008), (11008, 4096))
                for dt in ("float32", "bfloat16")]


@functools.cache
def _trunk_int4(fmt: str, k: int, n: int):
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    return quantize_weight_int4(w, 128 if fmt == "w4g128" else None, 8)


@pytest.mark.parametrize(
    "fmt,m,k,n,x_dtype,out_dtype", QUANT4_CASES,
    ids=[f"{c[0]}-M{c[1]}-K{c[2]}-{c[4]}" for c in QUANT4_CASES])
def test_quant4_matmul_at_trunk_widths_matches_plain(card, fmt, m, k, n,
                                                     x_dtype, out_dtype):
    """One launch at M <= 8, two above (rows, then the wgmma GEMM over
    unpacked nibbles); not one element differs from the plain version."""
    wq = _trunk_int4(fmt, k, n)
    gen = torch.Generator(device=card).manual_seed(m)
    x = torch.randn(m, k, generator=gen, device=card).to(
        getattr(torch, x_dtype))
    out_dtype = getattr(torch, out_dtype)
    calls, launches = qm.CALLS["quant4_matmul"], qm.LAUNCHES["quant4_matmul"]
    got = qm.quant4_matmul(x, wq, out_dtype)
    torch.cuda.synchronize()
    assert qm.CALLS["quant4_matmul"] == calls + 1
    assert qm.LAUNCHES["quant4_matmul"] == launches + (1 if m <= 8 else 2)
    want = quant4_matmul_plain(x, wq, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    assert torch.isfinite(got).all()
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("rows", [3 * 576, 64 * 576])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_fused_mlp_at_path_rows_matches_plain(card, rows, x_dtype):
    """Row 6 at 768 -> 3072 -> 768: 4 launches a call (rows, fc1, hidden
    quantisation, fc2), float32 out; a bf16 x is read as it is and gives
    the plain version of x.float(); not one element differs."""
    rs = np.random.RandomState(rows)
    c, hid = 768, 3072
    x = torch.from_numpy(rs.randn(rows, c).astype(np.float32)).to(card)
    x = x.to(getattr(torch, x_dtype))
    w1 = quantize_weight(torch.from_numpy(
        (rs.randn(hid, c) / np.sqrt(c)).astype(np.float32)).to(card))
    w2 = quantize_weight(torch.from_numpy(
        (rs.randn(c, hid) / np.sqrt(hid)).astype(np.float32)).to(card))
    b1 = torch.from_numpy((rs.randn(hid) * 0.1).astype(np.float32)).to(card)
    b2 = torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32)).to(card)
    calls, launches = fm.CALLS[fm.NAME], fm.LAUNCHES[fm.NAME]
    got = fm.fused_mlp_int8(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fm.CALLS[fm.NAME] == calls + 1
    assert fm.LAUNCHES[fm.NAME] == launches + 4
    want = fm.fused_mlp_int8_reference(x.float(), w1, b1, w2, b2)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert int((got != want).sum()) == 0


def test_int8_forward_at_384_routes_to_the_kernels(card):
    """The int8 SeTok forward at 384 px (one image) takes fused_mlp_int8
    and quant_matmul as often as expected_calls says, 4 launches a row-6
    call."""
    tok, det = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    tok = cfgs.replace(tok, vit=cfgs.replace(tok.vit, image_size=384))
    det = cfgs.replace(det, image_size=384)
    model = init_random_(SeTok(tok, det, device=card, quant8=True), 0)
    images = torch.rand(1, 384, 384, 3, device=card) * 2 - 1
    chip_smoke.reset_counts()
    with torch.inference_mode():
        out = model(images)
    torch.cuda.synchronize()
    calls, launches = chip_smoke.int8_counts()
    want = expected_calls(tok, det)
    assert calls == want and want["fused_mlp_int8"] > 0
    assert launches["fused_mlp_int8"] == 4 * want["fused_mlp_int8"]
    assert torch.isfinite(out.recon).all()


def test_cache_attention_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(0)
    b, s, kvh, g, d = 3, 100, 4, 2, 64
    q = torch.randn(b, kvh * g, d, generator=gen, device=card)

    def int8():
        f = torch.randn(b, s, kvh, d, generator=gen, device=card)
        sc = f.abs().amax(-1) / 127
        return torch.round(f / sc[..., None]).clamp(-127, 127).to(
            torch.int8), sc

    (k8, ks), (v8, vs) = int8(), int8()
    valid = torch.rand(b, s, generator=gen, device=card) > 0.3
    valid[-1] = False                          # the uniform average
    before = ca.LAUNCHES
    got = ca.int8_cache_decode_attention(q, k8, ks, v8, vs, valid)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 1
    want = ca.int8_cache_decode_attention_plain(q, k8, ks, v8, vs, valid,
                                                d ** -0.5)
    diff = (got - want).abs()
    scale = want.abs().max()
    assert float(diff.max() / scale) <= 2e-3
    assert float((diff <= 1e-5 * scale).float().mean()) >= 0.99


def _cache_case(card, b, s, kvh, g, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, kvh * g, d, generator=gen, device=card).to(dtype)

    def int8():
        f = torch.randn(b, s, kvh, d, generator=gen, device=card)
        sc = f.abs().amax(-1) / 127
        return torch.round(f / sc[..., None]).clamp(-127, 127).to(
            torch.int8), sc

    (k8, ks), (v8, vs) = int8(), int8()
    return gen, q, k8, ks, v8, vs


def _serving_mask(card, b, s, gen):
    """The serving layout: a prompt with pad holes and the decoded tokens,
    the tail of the cache masked (up to 160 of 512 keys valid)."""
    valid = torch.zeros(b, s, dtype=torch.bool, device=card)
    lengths = (128, 160, 97, 33)
    for i in range(b):
        valid[i, :lengths[i % len(lengths)]] = True
    holes = torch.rand(b, s, generator=gen, device=card) < 0.1
    return valid & ~holes


def _check_cache(card, got, q, args, skipped=None):
    want = ca.int8_cache_decode_attention_plain(q, *args,
                                                q.shape[-1] ** -0.5)
    assert got.dtype == q.dtype and got.shape == q.shape
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().max()
    assert float(diff.max() / scale) <= 2e-3
    assert float((diff <= 1e-5 * scale).double().mean()) >= 0.99
    print(f"cache attention {tuple(q.shape)} {q.dtype}: "
          f"{int((got != want).sum())} elements differ from the plain "
          f"version, cluster {ca.CLUSTER}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16],
                         ids=["bf16", "f32", "f16"])
def test_cache_attention_reads_q_in_its_type(card, dtype):
    """The serving shape (B=4, S=512, 32 heads of 128): q in and out in its
    own type, one launch a call, the serving mask's wholly masked tiles
    skipped and counted."""
    b, s, kvh, g, d = 4, 512, 32, 1, 128
    gen, q, k8, ks, v8, vs = _cache_case(card, b, s, kvh, g, d, dtype)
    valid = _serving_mask(card, b, s, gen)
    skipped = torch.zeros(1, dtype=torch.int32, device=card)
    before = ca.LAUNCHES
    args = (k8, ks, v8, vs, valid)
    got = ca.int8_cache_decode_attention(q, *args, skipped=skipped)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 1
    assert int(skipped) == ca.masked_tiles(valid, kvh) > 0
    assert ca.CLUSTER >= 2                     # S split over a cluster
    _check_cache(card, got, q, args)


@pytest.mark.parametrize("s,kvh,g,d", [(8192, 4, 8, 128), (5000, 2, 8, 128),
                                       (1000, 3, 5, 64), (8192, 1, 8, 512),
                                       (77, 2, 2, 16), (1, 1, 1, 128)])
def test_cache_attention_at_long_caches_and_wide_groups(card, s, kvh, g, d):
    """G = 8 past S ~ 5,085 (where a whole-row score buffer no longer fits
    shared memory), an odd G, D at its limits, S not a multiple of the tile,
    with holes, a prefix and a fully masked row."""
    b = 3
    gen, q, k8, ks, v8, vs = _cache_case(card, b, s, kvh, g, d,
                                         torch.bfloat16)
    valid = torch.rand(b, s, generator=gen, device=card) > 0.3
    valid[0, 0] = True
    valid[1] = False
    valid[1, : max(1, s // 3)] = True          # a prefix
    valid[2] = False                           # the uniform average
    before = ca.LAUNCHES
    args = (k8, ks, v8, vs, valid)
    got = ca.int8_cache_decode_attention(q, *args)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 1
    _check_cache(card, got, q, args)
    uniform = (v8[2].float() * vs[2][..., None]).mean(0)     # (KVH, D)
    torch.testing.assert_close(
        got[2].float(), uniform.repeat_interleave(g, 0).to(q.dtype).float(),
        rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("bits", [8, 4])
def test_serving_routes_to_the_kernels(card, bits):
    cfg = cfgs.tiny_setokim()
    model = init_setokim_random_(Setokim(
        cfg, weight_bits=bits, quant_group=32 if bits == 4 else 0,
        cache_kernel=True, device=card), 0, clip_search=8)
    eng = ServeEngine(model, max_batch=2, prompt_len=24, max_len=40,
                      eos_id=-1, cache_dtype=torch.int8)
    rs = np.random.RandomState(0)
    ids = np.concatenate([[1], np.full(8, -200), rs.randint(10, 400, 6)])
    image = rs.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    chip_smoke.reset_counts()
    reqs = [eng.submit(ids, image=image, max_new_tokens=4),
            eng.submit(ids[9:], max_new_tokens=4)]
    eng.run()
    name = "quant_matmul" if bits == 8 else "quant4_matmul"
    layers = cfg.llama.num_layers
    assert all(len(r.tokens) == 4 for r in reqs)
    # two prefills and three decode steps, seven linears per layer; a
    # prefill call launches the row pass and the GEMM, a decode call (2
    # rows) the GEMV alone
    assert qm.CALLS[name] == 7 * layers * (2 + 3)
    assert qm.LAUNCHES[name] == 7 * layers * (2 * 2 + 3)
    assert ca.LAUNCHES == layers * 3
    assert cluster_dpc.LAUNCHES == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(37, 37, 64), (70, 130, 128)])
def test_flash_kernels_match_plain(card, dtype, lq, lk, d):
    gen = torch.Generator(device=card).manual_seed(lq)
    mask = torch.rand(2, lq, lk, generator=gen, device=card) > 0.3
    mask[0, 5] = False                       # a fully masked query row
    before = dict(fa.LAUNCHES)
    chip_smoke.flash_case(2, 3, lq, lk, d, dtype, mask, seed=lq)
    fwd = fa.FWD_LAUNCHES_BF16 if dtype == torch.bfloat16 else 1
    assert fa.LAUNCHES == {"flash_fwd": before["flash_fwd"] + fwd,
                           "flash_dq": before["flash_dq"] + 1,
                           "flash_dkv": before["flash_dkv"] + 1}


def tiled_mask(b: int, lq: int, lk: int, gen, tile: int = 64):
    """A (b, lq, lk) mask of (tile x tile) tiles that are, in turn along
    each batch row and tile row, empty, full and random (half the cells):
    the three classes of the bf16 backward."""
    dev = gen.device
    kind = (torch.arange(b, device=dev)[:, None, None]
            + torch.arange(lq, device=dev)[None, :, None] // tile
            + torch.arange(lk, device=dev)[None, None, :] // tile
            + int(torch.randint(3, (1,), generator=gen, device=dev))) % 3
    cells = torch.rand(b, lq, lk, generator=gen, device=dev) > 0.5
    return (kind == 1) | ((kind == 2) & cells)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(70, 130, 128), (200, 1000, 64),
                                     (130, 1000, 128), (67, 1001, 64)])
@pytest.mark.parametrize("kind", ["random", "tiles"])
def test_flash_backward_kernels_match_plain(card, kind, dtype, lq, lk, d):
    """dq and dk/dv on the plain forward's o and lse. Random masks leave
    every 64 x 64 tile mixed; tiled ones have empty, full and mixed tiles,
    which the bf16 kernels skip, run without a mask test and test per
    cell. Lk = 1000 and 1001 are not multiples of 16: the bf16 kernels read
    the mask 8 bytes and 1 byte a load there."""
    gen = torch.Generator(device=card).manual_seed(lq)
    if kind == "random":
        mask = torch.rand(2, lq, lk, generator=gen, device=card) > 0.3
    else:
        mask = tiled_mask(2, lq, lk, gen)
        occ = chip_smoke.tile_occupancy(mask)
        assert min(occ["empty"], occ["full"], occ["mixed"]) > 0
    mask[0, 5] = False                       # a fully masked query row
    q, k, v, do = chip_smoke.flash_inputs(2, 3, lq, lk, d, dtype, card, lq)
    po, plse = fa.flash_fwd_plain(q, k, v, mask, d ** -0.5)
    before = dict(fa.LAUNCHES)
    chip_smoke.flash_bwd_case(q, k, v, do, mask, po, plse)
    assert fa.LAUNCHES == {**before, "flash_dq": before["flash_dq"] + 1,
                           "flash_dkv": before["flash_dkv"] + 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(70, 130, 128), (200, 1000, 64),
                                     (130, 1000, 128), (67, 1001, 64)])
@pytest.mark.parametrize("kind", ["random", "tiles"])
def test_flash_forward_kernel_matches_plain(card, kind, dtype, lq, lk, d):
    """The forward at the backward's grid: o max-rel 2e-3, o exactly 0 on
    a fully masked row, lse 1e-5, and ≥ 99 % of o within 1e-5 of the
    largest or, where the plain version's float64-score twin (the same
    formula with its score sums in another order) falls under 99 %, no
    more than 0.01 under the twin's share: with dense masks a row averages
    ~700 keys, and one flipped bf16 rounding of p moves o by about that
    threshold (chip_smoke.flash_fwd_check). Tiled masks have empty, full
    and mixed tiles; Lk = 1000 and 1001 read the mask 8 bytes and 1 byte
    a load."""
    gen = torch.Generator(device=card).manual_seed(lq)
    if kind == "random":
        mask = torch.rand(2, lq, lk, generator=gen, device=card) > 0.3
    else:
        mask = tiled_mask(2, lq, lk, gen)
    mask[0, 5] = False                       # a fully masked query row
    q, k, v, _ = chip_smoke.flash_inputs(2, 3, lq, lk, d, dtype, card, lq)
    before = dict(fa.LAUNCHES)
    case = chip_smoke.flash_fwd_check(q, k, v, mask, twin_bar=True)
    print(f"flash_fwd {kind} {lq}x{lk} D={d} {dtype}: share "
          f"{case['o_share_within_1e-5']:.6f} (twin "
          f"{case['twin_share_within_1e-5']:.6f}, bar {case['share_bar']:.6f}"
          f"), max-rel {case['o_max_rel']:.3e}, lse {case['lse_max_rel']:.3e}")
    fwd = fa.FWD_LAUNCHES_BF16 if dtype == torch.bfloat16 else 1
    assert fa.LAUNCHES == {**before, "flash_fwd": before["flash_fwd"] + fwd}


def test_flash_trunk_trains_through_the_kernels(card):
    """A 2-layer trunk with use_flash and remat: the kernels launch once
    per layer for dq and dk/dv, twice for the forward (the recompute), and
    the gradients agree with the plain route's."""
    from setok_tpu_torch.models.llama import LlamaForCausalLM, \
        make_attention_mask

    cfg = cfgs.LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=2,
                           num_kv_heads=2, head_dim=64)
    model = init_random_(LlamaForCausalLM(cfg, use_flash=True, remat=True,
                                          device=card), 0)
    ids = torch.randint(1, 512, (2, 50), device=card)
    valid = torch.ones_like(ids, dtype=torch.bool)
    valid[1, 40:] = False
    positions = torch.cumsum(valid.int(), 1) - 1
    mask = make_attention_mask(valid, positions)

    def grads():
        hidden, _ = model.model(model.embed(ids), mask, positions)
        loss = model.logits(hidden)[valid].float().logsumexp(-1).mean()
        return torch.autograd.grad(loss, [model.model.layer_0.attn.q_proj
                                          .weight])[0]

    chip_smoke.reset_counts()
    got = grads()
    assert fa.LAUNCHES == {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
    with chip_smoke.plain_route():
        want = grads()
    assert fa.LAUNCHES["flash_fwd"] == 4
    assert chip_smoke.max_rel(got, want) <= 1e-4


def test_device_loader_delivers_exactly_under_a_busy_consumer(card):
    """The data pipeline's copy stream: while the consumer's stream is
    kept busy, every batch the DeviceLoader hands out, read on that stream
    after the busy work and then dropped, equals the host's arrays (a
    missing wait or record_stream would let a copy, or a later batch's
    allocation, race the read)."""
    from setok_tpu_torch.data.loader import DeviceLoader

    rs = np.random.RandomState(0)
    host = [{"x": rs.rand(1024, 1024).astype(np.float32),
             "ids": rs.randint(0, 32000, (64, 2048)),
             "mask": rs.rand(64, 2048) > 0.5} for _ in range(24)]
    busy = torch.randn(2048, 2048, device=card)
    outs = []
    for batch in DeviceLoader(iter(host), card, prefetch=2):
        for _ in range(8):
            busy = torch.tanh(busy @ busy)
        outs.append({k: v.clone() for k, v in batch.items()})
        del batch
    torch.cuda.synchronize()
    assert len(outs) == len(host)
    for got, want in zip(outs, host):
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
