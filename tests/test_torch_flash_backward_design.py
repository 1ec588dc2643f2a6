"""The bf16 flash-attention backward's numerics, modelled in plain PyTorch,
against the JAX backward; and chip_smoke's costing of the kernels.

`design_backward` computes dq, dk and dv as the bf16 kernels of
`csrc/flash_attention.cu` do: S = Q·Kᵀ and dP = dO·Vᵀ from bf16 operands
with float32 sums; P and dS split into hi = bf16(x) and lo = bf16(x - hi),
each multiplied by the bf16 operand; dq, dk and dv summed tile by tile
over (tile × tile) tiles of the mask, the empty ones dropped. It is held to
the JAX backward (`setok_tpu/kernels/flash_attention.py`, interpret mode,
`jax.vjp`) on inputs rounded to bf16, at the gradient bar of
tests/test_flash_attention.py (rtol = atol = 2e-4): the split keeps P and
dS to 2⁻¹⁶ relative. Cases: those of tests/test_torch_flash_attention.py
and a causal mask with holes and a pad tail at D=128, L=256. Dropping the
empty tiles changes no bit.

`chip_smoke.flash_bounds` costs dq at four bf16 passes over the unmasked
cells and dk/dv at six; `chip_smoke.tile_occupancy` gives the shares of
empty, full and mixed tiles, which at the training path's splice mask are
67.6 %, 24.9 % and 7.5 %.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from setok_tpu.kernels.flash_attention import _fwd as j_fwd
from setok_tpu.kernels.flash_attention import flash_attention as j_flash
from setok_tpu_torch import config as cfgs
from tests.test_torch_flash_attention import CASES, holes_mask, qkv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAD_TOL = 2e-4


def causal_pad_tail(b, length, seed, tail):
    """Causal with holes; in batch row 1 the last `tail` positions are pad
    (their query rows and key columns fully masked)."""
    m = holes_mask(b, length, length, seed)
    m[1, length - tail:] = False
    m[1, :, length - tail:] = False
    return m


DESIGN_CASES = {**CASES,
                "causal_pad_tail_d128": (2, 2, 256, 256, 128,
                                         lambda: causal_pad_tail(2, 256, 5,
                                                                 72))}


def bf16(x):
    return x.to(torch.bfloat16).float()


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def design_backward(q, k, v, mask, o, do, lse, scale, tile=64,
                    drop_empty=True):
    """(dq, dk, dv, tiles dropped) as the bf16 kernels compute them; q, k,
    v, do are bf16-exact float32, o and lse the forward's."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    dropped = 0
    for bi in range(b):
        for i0 in range(0, lq, tile):
            rows = slice(i0, min(i0 + tile, lq))
            for j0 in range(0, lk, tile):
                cols = slice(j0, min(j0 + tile, lk))
                m = mask[bi, rows, cols]
                if drop_empty and not bool(m.any()):
                    dropped += 1
                    continue
                qt, dot = q[bi, :, rows], do[bi, :, rows]
                kt, vt = k[bi, :, cols], v[bi, :, cols]
                s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
                p = torch.where(m, torch.exp(s - lse[bi, :, rows, None]), 0.0)
                dp = torch.matmul(dot, vt.transpose(-1, -2))
                ds = p * (dp - delta[bi, :, rows, None]) * scale
                (ds_hi, ds_lo), (p_hi, p_lo) = split(ds), split(p)
                dq[bi, :, rows] += (torch.matmul(ds_hi, kt)
                                    + torch.matmul(ds_lo, kt))
                dk[bi, :, cols] += (torch.matmul(ds_hi.transpose(-1, -2), qt)
                                    + torch.matmul(ds_lo.transpose(-1, -2), qt))
                dv[bi, :, cols] += (torch.matmul(p_hi.transpose(-1, -2), dot)
                                    + torch.matmul(p_lo.transpose(-1, -2), dot))
    return dq, dk, dv, dropped


@functools.cache
def jax_case(case):
    """The case's bf16-rounded inputs, mask, and the JAX kernels' o, lse
    and gradients (interpret mode)."""
    b, h, lq, lk, d, make_mask = DESIGN_CASES[case]
    arrays = tuple(bf16(torch.from_numpy(a)).numpy()
                   for a in qkv(b, h, lq, lk, d, seed=20 + len(case)))
    mask = make_mask()
    jq, jk, jv, jdo, jm = (jnp.asarray(a) for a in (*arrays, mask))
    o, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, jm, None, 64, True),
                     jq, jk, jv)
    grads = vjp(jdo)
    lse = np.array(j_fwd(jq, jk, jv, jm, None, 64, True)[1])[:, :, 0]
    return (arrays, mask, np.array(o), lse,
            tuple(np.array(g) for g in grads))


def design_inputs(case):
    arrays, mask, o, lse, _ = jax_case(case)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    d = q.shape[-1]
    return (q, k, v, torch.from_numpy(mask), torch.from_numpy(o), do,
            torch.from_numpy(lse), d ** -0.5)


@pytest.mark.parametrize("tile", [64, 16])
@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_design_matches_jax_backward(case, tile):
    want = jax_case(case)[4]
    inputs = design_inputs(case)
    *got, _ = design_backward(*inputs, tile=tile)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL)
    mask = inputs[3]
    # a query row without a valid key gets dq exactly 0
    assert bool((got[0][(~mask.any(-1))[:, None].expand(got[0].shape[:3])]
                 == 0).all())


@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_dropping_empty_tiles_changes_nothing(case):
    inputs = design_inputs(case)
    tile = 64 if case == "causal_pad_tail_d128" else 8
    *kept, none_dropped = design_backward(*inputs, tile=tile,
                                          drop_empty=False)
    *dropped, n_dropped = design_backward(*inputs, tile=tile)
    assert none_dropped == 0
    assert n_dropped > 0
    for a, b in zip(dropped, kept):
        assert torch.equal(a, b)


def test_tile_occupancy_of_the_training_mask():
    """The splice mask of the training path (B=4, L=2048, seed 0): the
    shares the bf16 backward skips (empty), runs without a mask test
    (full) and tests per cell (mixed)."""
    mask = chip_smoke.splice_mask(cfgs.base_setokim(), 4, 2048, 0, "cpu")
    occ = chip_smoke.tile_occupancy(mask)
    assert occ["tiles"] == 4 * 32 * 32
    assert round(occ["empty"], 3) == 0.676
    assert round(occ["full"], 3) == 0.249
    assert round(occ["mixed"], 3) == 0.075
    assert round(float(mask.double().mean()), 3) == 0.296


def test_tile_occupancy_counts_ragged_edges_as_masked():
    mask = torch.zeros(1, 100, 130, dtype=torch.bool)
    mask[0, :64, :64] = True                 # full
    mask[0, :64, 64:128] = True              # full
    mask[0, :64, 128:] = True                # edge tile: cells past 130 masked
    mask[0, 64:, :1] = True                  # mixed
    occ = chip_smoke.tile_occupancy(mask)
    assert occ["tiles"] == 6
    assert occ["full"] == pytest.approx(2 / 6)
    assert occ["mixed"] == pytest.approx(2 / 6)
    assert occ["empty"] == pytest.approx(2 / 6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_bounds_cost_the_products_as_the_kernels_do(dtype):
    """dq: S and dP, and dS·K as two bf16 passes; dk/dv: Sᵀ and dPᵀ, and
    Pᵀ·dO and dSᵀ·Q as two passes each; all at the bf16 peak for bf16
    inputs, one pass each at the f32 peak for float32 inputs; the forward
    by its bytes in bf16."""
    b, h, length, d = 4, 32, 2048, 128
    mask = chip_smoke.splice_mask(cfgs.base_setokim(), b, length, 0, "cpu")
    q = torch.empty((b, h, length, d), dtype=dtype, device="meta")
    bounds = chip_smoke.flash_bounds(q, mask)
    per_pass = 2.0 * d * h * float(mask.sum())
    if dtype == torch.bfloat16:
        peak = chip_smoke.PEAK_BF16_FLOPS
        passes = {"flash_dq": 4, "flash_dkv": 6}
        assert bounds["flash_fwd"][1] == "bytes"
        assert bounds["flash_dq"][0] == pytest.approx(0.1643, abs=1e-4)
        assert bounds["flash_dkv"][0] == pytest.approx(0.2464, abs=1e-4)
    else:
        peak = chip_smoke.PEAK_F32_FLOPS
        passes = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
    for name, n in passes.items():
        ms, by = bounds[name]
        assert by == "operations"
        assert ms == pytest.approx(1e3 * n * per_pass / peak, rel=1e-12)


def test_ptxas_usage_reads_registers_and_spills():
    """The build keeps nvcc's `-Xptxas -v` output; chip_smoke reports the
    backward kernels' registers and spills from it."""
    from setok_tpu_torch.kernels._build import NVCC_FLAGS, ptxas_usage

    name = "_ZN12_GLOBAL__N_119flash_dq_mma_kernelILi128EEEvPK13__nv_bf16"
    log = (f"ptxas info    : 0 bytes gmem\n"
           f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           f"    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
           f"loads\n"
           f"ptxas info    : Used 255 registers, used 1 barriers, 400 bytes "
           f"cmem[0]\n")
    assert ptxas_usage(log) == {name: {"stack": 8, "spill_stores": 4,
                                       "spill_loads": 12, "registers": 255}}
    assert "-v" in NVCC_FLAGS[NVCC_FLAGS.index("-Xptxas") + 1:]
