"""`Stage2Trainer` over two gloo processes against its one-process path
(which tests/test_torch_stage2_trainer.py holds to the JAX trainer), at
`tiny_setokim()` in float32: LoRA r 4 on a (2, 1) FSDP mesh (remat on, so
that each block gathers its parameters again in the backward), on a
(1, 2) tensor-parallel mesh and on a (1, 2) ring-attention mesh; QLoRA on
the TP mesh; a full fine-tune with 8-bit moments under FSDP. Two updates
of the global batch 2 (the first at lr 0 for the scheduled groups), the
projectors at their own rates. Bars, the flash bars: each micro-batch's losses within 1e-5
max-rel, the last update's gradient norm within 2e-4, every parameter,
adapter and moment within 2e-4 of its tensor's largest magnitude.

8-bit moments: the FSDP rule slices such a parameter on its flax leading
dimension into whole blocks, so that a rank's payloads are the one-process
payloads of its blocks: exact on the same gradient (the rule's slices,
each through `Adam8bit`). Over the processes the gradients are sums in
another order (a rank's rows, then the ranks), which moves a payload
across a rounding step now and then: at most 1 element in 2,000 differs.
"""

import numpy as np
import pytest
import torch
from torch import nn

from setok_tpu_torch.parallel.sharding import fsdp_dim
from setok_tpu_torch.train.opt8 import Adam8bit, flax_perm
from tests import torch_parallel_workers as W

LORA = dict(lora_enable=True, lora_r=4, lora_alpha=8.0,
            mm_in_projector_lr=2e-3, mm_out_projector_lr=5e-4)
CASES = [("dp", dict(LORA, remat=True)), ("tp", LORA), ("sp", LORA),
         ("tp", dict(LORA, quant_base=True)), ("dp", dict(optim_bits=8))]


def _close(got, want, path=""):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
        return
    if not isinstance(want, torch.Tensor) or not want.dim():
        return
    assert got.shape == want.shape, path
    if want.dtype == torch.int8:
        # 8-bit payloads: see the module docstring
        diff = int((got != want).sum())
        assert diff <= max(1, want.numel() // 2000), (path, diff)
        return
    scale = float(want.float().abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-4 * scale, (path, err, scale)


def test_stage2_on_meshes_matches_one_process(tmp_path):
    got, wants = W.spawn(W.stage2_modes, 2, tmp_path, CASES, meanwhile=(
        lambda: [W.stage2_run("one", kw) for _, kw in CASES]))
    for i, (mode, kw) in enumerate(CASES):
        want = wants[i]
        for rank in range(2):
            g = got[rank][i]
            rel = ((g["losses"] - want["losses"]).abs()
                   / want["losses"].abs().clamp_min(1e-30)).max()
            assert rel <= 1e-5, (mode, kw, g["losses"], want["losses"])
            assert abs(float(g["norm"]) - float(want["norm"])) <= \
                2e-4 * float(want["norm"]), (mode, kw)
            for part in ("params", "lora"):
                _close(g[part], want[part], part)
            _close(g["train"]["optimizers"], want["train"]["optimizers"],
                   "optimizers")


class Kernel(nn.Module):
    def __init__(self, k, n):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, k))


@pytest.mark.parametrize("k,n,ranks", [(64, 512, 2), (96, 1024, 4),
                                       (1024, 64, 4), (48, 1000, 2)])
def test_eight_bit_slices_keep_whole_blocks(k, n, ranks):
    """Adam8bit over the FSDP rule's slices of a (n, k) weight equals
    Adam8bit over the whole weight, payloads and scales bit for bit; a
    weight whose slices would split blocks stays whole."""
    gen = torch.Generator().manual_seed(k + n)
    mod = Kernel(k, n)
    dim = fsdp_dim(mod, "weight", mod.weight, ranks, min_shard_elems=1,
                   blocked=True)
    if (n * k // ranks) % 256:
        assert dim is None
        return
    assert dim == flax_perm(mod, "weight", mod.weight)[0]
    w0 = torch.randn((n, k), generator=gen)
    grads = [torch.randn((n, k), generator=gen) for _ in range(2)]
    perm = flax_perm(mod, "weight", mod.weight)

    def run(w, gs):
        p = nn.Parameter(w.clone())
        opt = Adam8bit([{"params": [p], "flax_perms": [perm]}], lr=1e-2)
        for g in gs:
            p.grad = g.clone()
            opt.step()
        return p.detach(), opt.state[p]

    want_p, want = run(w0, grads)
    parts = [run(w0.chunk(ranks, dim)[r], [g.chunk(ranks, dim)[r]
                                             for g in grads])
             for r in range(ranks)]
    assert torch.equal(torch.cat([q for q, _ in parts], dim), want_p)
    for key in ("m_q", "m_s", "v_q", "v_s"):
        assert torch.equal(torch.cat([st[key] for _, st in parts]),
                           want[key]), key
