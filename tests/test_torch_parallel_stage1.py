"""`Stage1Trainer` over two gloo processes (FSDP over `data`, the global
batch 2 split in two) against its one-process path (which
tests/test_torch_stage1.py holds to the JAX trainer), at the tiny
configuration in float32 without dropout, the GAN terms on from step 0
and the contrastive loss with the multi-label branch, whose negatives are
gathered from both ranks; with 8-bit moments too. And
`offload_optimizer` (both optimizers' moments in host memory between
steps): the same updates as without it, to the bit.

Bars, tests/test_torch_stage1.py's against the JAX trainer: every
metric of two steps within 1e-4 relative; every Adam first moment
within 1e-4 of its tensor's largest; the parameters after two updates
within 1e-5 (1 % of the learning rate) of one process's, all but one
element in 10,000 (the attention key biases held apart: their gradient is
zero in exact arithmetic, so both sides' are rounding noise that Adam
scales into steps of up to the learning rate), and every element within
Adam's bound of 2·lr an update.
"""

import torch

from tests import torch_parallel_workers as W

CASES = [dict(), dict(optim_bits=8, multi_label=0), dict(offload=True)]
LR, UPDATES = 1e-3, 2
REL, PARAM_TOL, PARAM_SHARE, MOMENT_REL = 1e-4, 1e-5, 1e-4, 1e-4


def key_bias(name, shape):
    """The elements of a parameter that are attention key biases."""
    mask = torch.zeros(shape, dtype=torch.bool)
    if name.endswith("key.bias"):
        mask[:] = True
    elif name.endswith("qkv.bias"):
        mask[shape[0] // 3:2 * shape[0] // 3] = True
    return mask


def check_params(got, want):
    n = beyond = 0
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        gap = (got[k] - w).abs()
        kb = key_bias(k, gap.shape)
        assert not gap.numel() or float(gap.max()) <= 2 * LR * UPDATES, k
        n += int((~kb).sum())
        beyond += int((gap[~kb] > PARAM_TOL).sum())
    assert beyond <= PARAM_SHARE * n, (beyond, n)


def check_moments(got, want):
    """Each first moment within MOMENT_REL of its tensor's largest; a
    tensor of rounding noise (a key bias: under a millionth of the largest
    moment of all) within a millionth of that largest."""
    mus = {i: st["exp_avg"] for i, st in want["gen_opt"]["state"].items()
           if "exp_avg" in st}          # 8-bit moments: held by the params
    top = max((float(m.abs().max()) for m in mus.values()), default=0.0)
    for i, m in mus.items():
        gap = float((got["gen_opt"]["state"][i]["exp_avg"] - m).abs().max())
        assert gap <= MOMENT_REL * float(m.abs().max()) or \
            gap <= 1e-6 * top, i


def test_stage1_dp_matches_one_process(tmp_path):
    got, wants = W.spawn(W.stage1_cases, 2, tmp_path, CASES, meanwhile=(
        lambda: [W.stage1_run(1, **kw) for kw in CASES[:2]]))
    for rank in range(2):
        # offload_optimizer: the same updates, bit for bit
        plain, off = got[rank][0], got[rank][2]
        for k, v in plain["params"].items():
            assert torch.equal(off["params"][k], v), k
        for a, b in zip(plain["metrics"], off["metrics"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    for i, kw in enumerate(CASES[:2]):
        want = wants[i]
        for rank in range(2):
            g = got[rank][i]
            for step, (gm, wm) in enumerate(zip(g["metrics"],
                                                want["metrics"])):
                assert set(gm) == set(wm)
                for k in wm:
                    rel = abs(float(gm[k]) - float(wm[k])) / max(
                        abs(float(wm[k])), 1e-6)
                    assert rel <= REL, (kw, step, k, gm[k], wm[k])
            check_params(g["params"], want["params"])
            check_moments(g["train"], want["train"])
