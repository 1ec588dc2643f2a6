"""The flash-attention plain versions against the JAX Pallas kernels.

`setok_tpu/kernels/flash_attention.py` runs in interpret mode, as
tests/test_flash_attention.py runs it, on the same numpy inputs (float32,
made from a seed); its gradient comes from `jax.vjp` fed the same upstream
gradient `do`. Bars, those of tests/test_flash_attention.py: the forward
(o, and lse on rows with a valid key) rtol = atol = 1e-5; dq, dk, dv
rtol = atol = 2e-4. Masks: causal with holes, ragged lengths, fully masked
query rows, everything masked. The CPU route of the autograd Function is
held to `torch.autograd` through `attention_reference` with the same bars.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.flash_attention import _fwd as j_fwd
from setok_tpu.kernels.flash_attention import flash_attention as j_flash
from setok_tpu_torch.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4


def qkv(b, h, lq, lk, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(np.float32) for shape in (
        (b, h, lq, d), (b, h, lk, d), (b, h, lk, d), (b, h, lq, d)))


def holes_mask(b, lq, lk, seed, masked_rows=()):
    """Causal in position order over the valid keys; rows in `masked_rows`
    attend to nothing (a pad query)."""
    rs = np.random.RandomState(seed)
    valid = rs.rand(b, max(lq, lk)) > 0.2
    pos = np.where(valid, np.cumsum(valid, 1) - 1, max(lq, lk) + 1)
    m = ((pos[:, :lq, None] >= pos[:, None, :lk]) & valid[:, :lq, None]
         & valid[:, None, :lk])
    m[:, list(masked_rows)] = False
    return m


CASES = {
    # b, h, lq, lk, d, mask
    "holes": (2, 2, 16, 16, 8, lambda: holes_mask(2, 16, 16, 1)),
    "ragged": (2, 3, 13, 21, 8, lambda: holes_mask(2, 13, 21, 2)),
    "masked_rows": (1, 2, 19, 19, 16,
                    lambda: holes_mask(1, 19, 19, 3, masked_rows=(0, 7, 18))),
    "all_masked": (2, 1, 9, 9, 8, lambda: np.zeros((2, 9, 9), bool)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_jax_kernels(case):
    b, h, lq, lk, d, make_mask = CASES[case]
    q, k, v, do = qkv(b, h, lq, lk, d, seed=len(case))
    mask = make_mask()
    scale = d ** -0.5
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    w_o, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, jm, None, 8, True),
                       jq, jk, jv)
    w_dq, w_dk, w_dv = vjp(jnp.asarray(do))
    w_lse = np.asarray(j_fwd(jq, jk, jv, jm, None, 8, True)[1])[:, :, 0]

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = torch.from_numpy(mask)
    o, lse = fa.flash_fwd_plain(tq, tk, tv, tm, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(w_o), rtol=FWD_TOL,
                               atol=FWD_TOL)
    rows = np.broadcast_to(mask.any(-1)[:, None], lse.shape)
    np.testing.assert_allclose(lse.numpy()[rows], w_lse[rows], rtol=FWD_TOL,
                               atol=FWD_TOL)
    dq = fa.flash_dq_plain(tq, tk, tv, tm, o, tdo, lse, scale)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tm, o, tdo, lse, scale)
    for got, want in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("case", ["holes", "ragged", "masked_rows"])
def test_autograd_function_matches_reference(case):
    """The Function's CPU route (forward and backward through the plain
    versions) against autograd through the materialised reference."""
    b, h, lq, lk, d, make_mask = CASES[case]
    arrays = qkv(b, h, lq, lk, d, seed=10 + len(case))
    mask = torch.from_numpy(make_mask())
    outs = []
    for fn in (fa.flash_attention, fa.attention_reference):
        q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays[:3])
        o = fn(q, k, v, mask)
        (o * torch.cos(o)).sum().backward()
        outs.append((o.detach(), q.grad, k.grad, v.grad))
    (o, *grads), (w_o, *w_grads) = outs
    torch.testing.assert_close(o, w_o, rtol=FWD_TOL, atol=FWD_TOL)
    for got, want in zip(grads, w_grads):
        torch.testing.assert_close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_function_counts_no_launch_on_cpu_and_checks_inputs():
    q, k, v, _ = (torch.from_numpy(a) for a in qkv(1, 2, 5, 7, 8, 0))
    mask = torch.ones(1, 5, 7, dtype=torch.bool)
    fa.reset_counts()
    fa.flash_attention(q, k, v, mask)
    assert not any(fa.LAUNCHES.values())
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention(q, k, v, mask.float())
    with pytest.raises(ValueError, match="k/v"):
        fa.flash_attention(q, k[:, :1], v, mask)
