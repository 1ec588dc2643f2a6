"""The w4a8 `quant4_matmul` kernels' schedules, modelled in plain PyTorch,
against the plain version and the JAX kernel.

`design_gemm` computes what the wgmma GEMM of `csrc/wgmma_s8.cuh` computes
above 8 rows: x row-quantised (`quant_rows`); the packed nibbles unpacked
as unsigned bytes n ^ 8 (the signed value + 8) into 128-column k-slices,
zeros past the plane's end; the k walk plane by plane (the low nibbles'
K/2 rows first) in k32 products of exact integers, each group's sum
started from zero at its first step (scale-d = 0) and folded at its last,
acc_f = acc_f + float(dot_u - 8 * rowsum_g) * s[g], in float32 (the
kernel converts the exact int by the bits of 1.5 * 2^23 + int, the same
float); per channel one sum over all of K, float(dot_u - 8 * rowsum) * xs
* ws.

`design_gemv` computes what the one-launch GEMV does at M <= 8: each lane
of a warp takes 16-byte chunks c = b0 + 32 u + lane of two channels' rows;
a chunk's exact int dots go through the warp's shuffles exactly as the
kernel routes them (`reduce_scatter` over aligned runs of lanes, a
butterfly, or a segmented scan where a group's chunks are not an aligned
run), the writer lanes add into the warp's (channel, row, group) sums, and
lane r * MR + m folds row m of channel r in the group order.

Bars: the design equals the plain version `quant4_matmul_plain` bit for
bit (the int products are exact, and the float operations are the same
in the same order), and the JAX kernel (`quant_matmul.quant4_matmul`,
interpret mode) within its own bar in tests/test_torch_quant.py, 1e-5
max-rel. Cases: group 32, 64, 128 and per channel; ragged M and N; K =
11,008 (the trunk's down_proj, 43 whole slices a plane) and K = 4,160 (a
partial last slice in each plane, groups of 160 across slices); a
non-aligned group (96 rows) for the GEMV's segmented scan.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu_torch.kernels.quant import (Quant4Weight, int_dot,
                                           quant4_matmul_plain, quant_rows,
                                           quantize_weight_int4,
                                           unpack_nibbles)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jqm = importlib.import_module("setok_tpu.kernels.quant_matmul")

JAX_TOL = 1e-5
SLICE = 128        # k columns a slice of the GEMM
LANES = 32


def unsigned_planes(packed: torch.Tensor):
    """(low, high) nibble planes as the GEMM's B tiles hold them: n ^ 8."""
    p = packed.to(torch.int32) & 0xFF
    return ((p & 0xF) ^ 8).double(), (((p >> 4) & 0xF) ^ 8).double()


def design_gemm(x: torch.Tensor, w: Quant4Weight) -> torch.Tensor:
    m, k = x.shape
    kh = k // 2
    x8, xs = quant_rows(x.float())
    lo_u, hi_u = unsigned_planes(w.packed)
    n_scales = w.scales.shape[0]
    grouped = n_scales > 1
    n_half = n_scales // 2
    g = kh // n_half if grouped else k
    # the row pass's sums of x8 over each group (or all of K)
    rs = x8.double().reshape(m, k // g, g).sum(-1)
    # x8 as TMA gives it: zeros past K
    a_all = torch.cat([x8.double(), x8.new_zeros(m, SLICE).double()], 1)
    d = torch.zeros(m, w.packed.shape[0], dtype=torch.float64)
    accf = torch.zeros(m, w.packed.shape[0])
    for plane, b_plane in ((0, lo_u), (1, hi_u)):
        for pk in range(0, kh, SLICE):
            b = torch.zeros(b_plane.shape[0], SLICE, dtype=torch.float64)
            valid = min(SLICE, kh - pk)          # the unpack's zeros past it
            b[:, :valid] = b_plane[:, pk:pk + valid]
            a = a_all[:, plane * kh + pk:plane * kh + pk + SLICE]
            for kk in range(SLICE // 32):
                t = pk // 32 + kk
                prod = a[:, 32 * kk:32 * kk + 32] @ b[:, 32 * kk:32 * kk + 32].t()
                if grouped and (t * 32) % g == 0:
                    d = prod                      # scale-d = 0
                else:
                    d = d + prod
                if grouped and t < kh // 32 and ((t + 1) * 32) % g == 0:
                    gi = plane * n_half + t * 32 // g
                    accf = accf + (d - 8 * rs[:, gi:gi + 1]).float() \
                        * w.scales[gi]
    if grouped:
        return accf * xs
    return (d - 8 * rs).float() * xs * w.scales[0]


def reduce_scatter(vals, span):
    """The kernel's `reduce_scatter` over the 32 lanes' value lists (V
    each, a power of two <= span): the shuffles' arithmetic, lane by lane."""
    val = [list(v) for v in vals]
    o, cnt = span >> 1, len(vals[0])
    while cnt > 1:
        h = cnt // 2
        new = []
        for lane in range(LANES):
            upper = bool(lane & o)
            partner = val[lane ^ o]
            keep = val[lane][h:cnt] if upper else val[lane][:h]
            got = partner[h:cnt] if upper else partner[:h]
            new.append([keep[i] + got[i] for i in range(h)])
        val, cnt, o = new, h, o >> 1
    v = [x[0] for x in val]
    while o > 0:
        v = [v[lane] + v[lane ^ o] for lane in range(LANES)]
        o >>= 1
    return v


def segmented_scan(vals, gids, span):
    """The kernel's segmented inclusive scan (shfl_up) over one value."""
    v = list(vals)
    o = 1
    while o < span:
        v = [v[lane] + v[lane - o] if lane >= o and gids[lane] is not None
             and gids[lane - o] == gids[lane] else v[lane]
             for lane in range(LANES)]
        o <<= 1
    return v


def design_gemv(x: torch.Tensor, w: Quant4Weight, mr: int) -> torch.Tensor:
    m, k = x.shape
    kh = k // 2
    assert m <= mr
    r_ch = 2 if mr <= 4 else 1          # channels a warp streams at once
    x8, xs = quant_rows(x.float())
    lo, hi = (p.long() for p in unpack_nibbles(w.packed))
    x8 = x8.long()
    n = w.packed.shape[0]
    nch = kh // 16
    n_scales = w.scales.shape[0]
    grouped = n_scales > 1
    n_half = n_scales // 2
    g = kh // n_half if grouped else 0
    cpg = g // 16
    aligned = grouped and ((cpg & (cpg - 1)) == 0 or cpg % 32 == 0)
    span = min(cpg, 32)
    out = torch.zeros(m, n)

    def dots(ch, c, plane):
        cols = slice(16 * c, 16 * c + 16)
        wv = (lo if plane == 0 else hi)[ch, cols]
        xo = plane * kh
        return [int((x8[mm, xo + 16 * c:xo + 16 * c + 16] * wv).sum())
                if mm < m else 0 for mm in range(mr)]

    for unit in range((n + r_ch - 1) // r_ch):
        chans = [unit * r_ch + r for r in range(r_ch)]
        sums = [[[0] * n_scales for _ in range(mr)] for _ in range(r_ch)]
        acc = [[0] * mr for _ in range(r_ch)]
        for b0 in range(0, nch, LANES):
            cs = [b0 + lane for lane in range(LANES)]
            for r, ch in enumerate(chans):
                lane_d = [[0] * (2 * mr) if c >= nch or ch >= n else
                          dots(ch, c, 0) + dots(ch, c, 1) for c in cs]
                if not grouped:
                    for lane in range(LANES):
                        for mm in range(mr):
                            acc[r][mm] += lane_d[lane][mm] \
                                + lane_d[lane][mr + mm]
                    continue
                gids = [c // cpg if c < nch else None for c in cs]
                if aligned and span >= 2 * mr:
                    v = reduce_scatter(lane_d, span)
                    per = span // (2 * mr)
                    for lane in range(LANES):
                        idx = (lane & (span - 1)) // per
                        mm, plane = idx % mr, idx // mr
                        if (gids[lane] is not None and lane & (per - 1) == 0
                                and mm < m):
                            sums[r][mm][plane * n_half + gids[lane]] += v[lane]
                elif aligned:
                    for i in range(2 * mr):
                        v = [lane_d[lane][i] for lane in range(LANES)]
                        o = span >> 1
                        while o > 0:
                            v = [v[lane] + v[lane ^ o] for lane in range(LANES)]
                            o >>= 1
                        mm, plane = i % mr, i // mr
                        for lane in range(0, LANES, span):
                            if gids[lane] is not None and mm < m:
                                sums[r][mm][plane * n_half + gids[lane]] += v[lane]
                else:
                    scanned = [segmented_scan([d[i] for d in lane_d], gids, span)
                               for i in range(2 * mr)]
                    for lane in range(LANES):
                        c = cs[lane]
                        if gids[lane] is None:
                            continue
                        if lane == LANES - 1 or c + 1 >= nch \
                                or (c + 1) // cpg != gids[lane]:
                            for i in range(2 * mr):
                                mm, plane = i % mr, i // mr
                                if mm < m:
                                    sums[r][mm][plane * n_half + gids[lane]] \
                                        += scanned[i][lane]
        for r, ch in enumerate(chans):
            if ch >= n:
                continue
            for mm in range(m):
                if grouped:
                    accf = torch.zeros((), dtype=torch.float32)
                    for gi in range(n_scales):
                        accf = accf + torch.tensor(float(sums[r][mm][gi]),
                                                   dtype=torch.float32) \
                            * w.scales[gi, ch]
                    out[mm, ch] = accf * xs[mm, 0]
                else:
                    out[mm, ch] = (torch.tensor(float(acc[r][mm]),
                                                dtype=torch.float32)
                                   * xs[mm, 0]) * w.scales[0, ch]
    return out


def _case(seed, m, k, n, group):
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, k) * rs.uniform(0.5, 2.0, (m, 1))).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)      # flax (K, N)
    jw = jqm.quantize_weight_int4(jnp.asarray(w), group_size=group)
    pw = Quant4Weight(torch.from_numpy(np.asarray(jw.packed).T.copy()),
                      torch.from_numpy(np.asarray(jw.scales).copy()))
    return x, jw, pw


def _jax(x, jw):
    return np.asarray(jqm.quant4_matmul(jnp.asarray(x), jw, interpret=True))


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,k,n,group", [
    (9, 512, 96, None),          # per channel, M one past the GEMV
    (13, 512, 70, 32),           # four groups a slice, ragged N
    (21, 512, 96, 64),
    (17, 1024, 64, 128),         # whole slices a group (the served G)
    (11, 4160, 40, 160),         # a partial last slice in each plane,
                                 # groups across slices
    (12, 4160, 40, None),
    (10, 11008, 36, 128),        # the trunk's down_proj K
    (10, 11008, 36, None),
], ids=["ch-M9", "g32", "g64", "g128", "partial-g160", "partial-ch",
        "K11008-g128", "K11008-ch"])
def test_gemm_design_equals_plain_and_jax(m, k, n, group):
    x, jw, pw = _case(m + k + n, m, k, n, group)
    got = design_gemm(torch.from_numpy(x), pw)
    want = quant4_matmul_plain(torch.from_numpy(x), pw)
    assert torch.equal(got, want)
    assert _max_rel(got.numpy(), _jax(x, jw)) <= JAX_TOL


@pytest.mark.parametrize("m,mr,k,n,group", [
    (4, 4, 512, 5, 128),         # the served M and G: 8-lane runs, V = 8
    (3, 4, 512, 6, 64),          # 4-lane runs, V = 8: a butterfly
    (1, 1, 2048, 3, 1024),       # whole-warp runs over two steps
    (8, 8, 512, 3, 128),         # V = 16 > 8 lanes: a butterfly
    (2, 2, 768, 4, 96),          # 6-chunk groups: the segmented scan
    (4, 4, 11008, 3, 128),       # the trunk's down_proj K
    (4, 4, 512, 5, None),        # per channel: one reduce-scatter a unit
], ids=["g128-M4", "g64-M3", "g1024-M1", "g128-M8", "g96-scan",
        "K11008-g128", "ch-M4"])
def test_gemv_design_equals_plain_and_jax(m, mr, k, n, group):
    x, jw, pw = _case(7 * m + k + n, m, k, n, group)
    got = design_gemv(torch.from_numpy(x), pw, mr)
    want = quant4_matmul_plain(torch.from_numpy(x), pw)
    assert torch.equal(got, want)
    assert _max_rel(got.numpy(), _jax(x, jw)) <= JAX_TOL


@pytest.mark.parametrize("span,v", [(8, 8), (8, 2), (32, 8), (16, 4),
                                    (32, 1)])
def test_reduce_scatter_leaves_each_sum_on_its_writer_lane(span, v):
    """The index the kernel gives writer lane l, (l & (span - 1)) / (span
    / V), holds the exact sum of that value over its run of span lanes."""
    rs = np.random.RandomState(span * 7 + v)
    vals = rs.randint(-2 ** 20, 2 ** 20, size=(LANES, v)).tolist()
    got = reduce_scatter(vals, span)
    per = span // v
    for lane in range(0, LANES, per):
        run = lane - (lane & (span - 1))
        idx = (lane & (span - 1)) // per
        assert got[lane] == sum(vals[i][idx] for i in range(run, run + span))


def test_magic_conversion_is_the_float_of_the_int():
    """The fold's float(dot): the bits of dot + 1.5 * 2^23, less 1.5 *
    2^23, for every |dot| < 2^22 (127 * 8 * G for G <= 4096)."""
    dots = torch.tensor([0, 1, -1, 2 ** 22 - 1, -(2 ** 22 - 1), 123457,
                         -98765, 127 * 8 * 4096 - 1], dtype=torch.int32)
    magic = (dots + 0x4B400000).view(torch.float32) - 12582912.0
    assert torch.equal(magic, dots.float())


def test_int4_unsigned_nibbles_with_row_sums_are_the_signed_product():
    """dot(x8, n ^ 8) - 8 * sum(x8) = dot(x8, signed n): the GEMM's B tile
    is unsigned and its correction exact."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(5, 256).astype(np.float32))
    w = quantize_weight_int4(torch.from_numpy(
        rs.randn(7, 256).astype(np.float32)), None, 0)
    x8, _ = quant_rows(x)
    lo, hi = unpack_nibbles(w.packed)
    lo_u, hi_u = unsigned_planes(w.packed)
    signed = int_dot(x8[:, :128], lo) + int_dot(x8[:, 128:], hi)
    unsigned = (x8[:, :128].double() @ lo_u.t() + x8[:, 128:].double()
                @ hi_u.t()) - 8 * x8.double().sum(-1, keepdim=True)
    assert torch.equal(signed, unsigned.float())
