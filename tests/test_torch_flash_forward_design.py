"""The bf16 flash-attention forward's numerics, modelled in plain PyTorch,
against the JAX forward.

`design_forward` computes o and lse as the bf16 forward kernel of
`csrc/flash_attention.cu` does: the mask cut into (tile × tile) tiles, the
empty ones dropped; the scores summed over each 16-wide slice of D on its
own and the slices added in float32; sweep 1 takes the exact row max m of
the masked scores tile by tile; sweep 2 recomputes the scores, sums l over
the unrounded p = exp(s - m), rounds p to bf16 and adds P·V tile by tile,
products of bf16-exact operands with float32 sums; o = acc / l, zero on a
row without a valid key, lse = m + log(l). It is held to the JAX `_fwd`
(`setok_tpu/kernels/flash_attention.py`, interpret mode) run with q and k
bf16-rounded in float32 and v in bfloat16, so that the JAX kernel rounds p
to bf16 (`p.astype(v.dtype)`) and writes o in float32. Bar: the JAX
forward's own, rtol = atol = 1e-5 on o, and on lse where a row has a valid
key (tests/test_flash_attention.py), wherever the plain version's
float64-score twin (`chip_smoke.flash_fwd_twin`: the same formula with
its score sums in another order) holds it; where that reordering flips
bf16 roundings of p (at D=128), no more elements of o outside 1e-5 than
the twin, and max-rel 2e-3. Cases: those of
tests/test_torch_flash_attention.py and a causal mask with holes and a pad
tail at D=128, L=256. Dropping the empty tiles changes no bit.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from setok_tpu.kernels.flash_attention import _fwd as j_fwd
from setok_tpu_torch.kernels.flash_attention import NEG_INF
from tests.test_torch_flash_attention import qkv
from tests.test_torch_flash_backward_design import DESIGN_CASES, bf16
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FWD_TOL = 1e-5


def slice_scores(q, k, width=16):
    """Q·Kᵀ as the kernel sums it: each `width`-wide slice of D on its own,
    the slice sums added in float32 in order."""
    s = None
    for c in range(0, q.shape[-1], width):
        part = torch.matmul(q[..., c:c + width],
                            k[..., c:c + width].transpose(-1, -2))
        s = part if s is None else s + part
    return s


def design_forward(q, k, v, mask, scale, tile=64, drop_empty=True,
                   round_p=True):
    """(o, lse, tiles dropped) as the bf16 forward kernel computes them;
    q, k, v bf16-exact float32. round_p=False keeps p in float32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    o = torch.zeros_like(q)
    lse = torch.empty(b, h, lq)
    dropped = 0
    for bi in range(b):
        for i0 in range(0, lq, tile):
            rows = slice(i0, min(i0 + tile, lq))
            n = rows.stop - rows.start
            qt = q[bi, :, rows]
            tiles = []
            for j0 in range(0, lk, tile):
                cols = slice(j0, min(j0 + tile, lk))
                mt = mask[bi, rows, cols]
                if drop_empty and not bool(mt.any()):
                    dropped += 1
                    continue
                tiles.append((cols, mt))
            m = torch.full((h, n), NEG_INF)
            for cols, mt in tiles:
                s = slice_scores(qt, k[bi, :, cols]) * scale
                m = torch.maximum(m, torch.where(mt, s, NEG_INF).amax(-1))
            l = torch.zeros(h, n)
            acc = torch.zeros(h, n, d)
            for cols, mt in tiles:
                s = slice_scores(qt, k[bi, :, cols]) * scale
                p = torch.where(mt, torch.exp(s - m[..., None]), 0.0)
                l = l + p.sum(-1)
                acc = acc + torch.matmul(bf16(p) if round_p else p,
                                         v[bi, :, cols])
            lr = l.clamp_min(1e-30)
            valid = mask[bi, rows].any(-1)
            o[bi, :, rows] = acc / lr[..., None] * valid[None, :, None]
            lse[bi, :, rows] = m + torch.log(lr)
    return o, lse, dropped


@functools.cache
def jax_case(case):
    """The case's bf16-rounded q, k, v, its mask, and the JAX forward's o
    and lse (v in bfloat16, so that p is rounded to it)."""
    b, h, lq, lk, d, make_mask = DESIGN_CASES[case]
    q, k, v, _ = (bf16(torch.from_numpy(a)).numpy()
                  for a in qkv(b, h, lq, lk, d, seed=30 + len(case)))
    mask = make_mask()
    o, lse = j_fwd(jnp.asarray(q), jnp.asarray(k),
                   jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(mask),
                   None, 64, True)
    return (q, k, v), mask, np.array(o), np.array(lse)[:, :, 0]


def design_inputs(case):
    (q, k, v), mask, _, _ = jax_case(case)
    return (*(torch.from_numpy(a) for a in (q, k, v)),
            torch.from_numpy(mask), q.shape[-1] ** -0.5)


def over_tol(got, want) -> int:
    """Elements of o outside rtol = atol = 1e-5 of the JAX forward's."""
    return int((~torch.isclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)).sum())


@pytest.mark.parametrize("tile", [64, 16])
@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_design_matches_jax_forward(case, tile):
    """o at 1e-5 wherever the plain version's float64-score twin holds
    1e-5 against JAX; where a reordering of the score sums flips bf16
    roundings of p (at D=128 the twin has elements outside 1e-5), no more
    elements outside 1e-5 than the twin and max-rel 2e-3 (the card's bar
    of the forward). lse at 1e-5 throughout."""
    _, mask, want_o, want_lse = jax_case(case)
    q, k, v, tmask, scale = design_inputs(case)
    o, lse, _ = design_forward(q, k, v, tmask, scale, tile=tile)
    want = torch.from_numpy(want_o)
    twin = chip_smoke.flash_fwd_twin(q, k, v.to(torch.bfloat16), tmask,
                                     scale)[0]
    assert want_o.dtype == np.float32
    assert torch.isfinite(o).all()
    assert over_tol(o, want) <= over_tol(twin, want)
    assert chip_smoke.max_rel(o, want) <= chip_smoke.FLASH_FWD_TOL
    rows = np.broadcast_to(mask.any(-1)[:, None], lse.shape)
    np.testing.assert_allclose(lse.numpy()[rows], want_lse[rows],
                               rtol=FWD_TOL, atol=FWD_TOL)
    # a query row without a valid key gets o exactly 0
    assert bool((o[torch.from_numpy(~rows)] == 0).all())


@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_dropping_empty_tiles_changes_nothing(case):
    inputs = design_inputs(case)
    tile = 64 if case == "causal_pad_tail_d128" else 8
    *kept, none_dropped = design_forward(*inputs, tile=tile,
                                         drop_empty=False)
    *dropped, n_dropped = design_forward(*inputs, tile=tile)
    assert none_dropped == 0
    assert n_dropped > 0
    for a, b in zip(dropped, kept):
        assert torch.equal(a, b)


def test_the_jax_forward_rounds_p_as_the_kernel_does():
    """Without p's rounding to bf16 the model leaves the JAX forward by far
    more than the bar: the comparison above does hold the rounding."""
    _, _, want_o, _ = jax_case("causal_pad_tail_d128")
    o, _, _ = design_forward(*design_inputs("causal_pad_tail_d128"),
                             round_p=False)
    gap = float(np.abs(o.numpy() - want_o).max() / np.abs(want_o).max())
    assert gap > 10 * FWD_TOL
