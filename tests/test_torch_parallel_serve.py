"""Tensor-parallel serving (`ServeEngine(mesh=...)`) over gloo processes
against the one-process engine on the same weights: greedy streams
identical, request by request, at bits 8 and 4 (in groups of 16; per
channel over four processes) with the int8 KV cache and the cache kernel's route, single
shot and chunked prefill (an image request in the single-shot runs); over
four processes a GQA variant (2 kv heads: each rank keeps the one its
query heads read).

A row-parallel int8 or per-channel int4 layer gives the one-card output
bit for bit (x quantised with the whole row's scale, the ranks' exact
integer dots summed, then the kernel's epilogue); a grouped int4 one
stays whole on each rank, its input gathered.
"""

import pytest
import torch

from tests import torch_parallel_workers as W
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TWO = [dict(bits=8), dict(bits=4, group=16), dict(bits=8, chunk=8),
       dict(bits=4, group=16, chunk=8)]
FOUR = [dict(bits=4, variant="gqa4"), dict(bits=8, variant="gqa4")]


LAYERS = [(8, 0), (4, 0), (4, 16)]


@pytest.mark.parametrize("world,cases", [(2, TWO), (4, FOUR)],
                         ids=["tp2", "tp4"])
def test_tp_streams_match_one_process(world, cases, tmp_path):
    """The streams; and each row-parallel layer of LAYERS over the same
    ranks gives the whole layer's output, bit for bit."""
    got, wants = W.spawn(W.serve_cases, world, tmp_path, cases, LAYERS,
                         meanwhile=lambda: [W.serve_run(**kw)
                                            for kw in cases])
    for i, kw in enumerate(cases):
        want = wants[i]
        assert all(len(s) == W.NEW_TOKENS for s in want)
        for r in range(world):
            assert got[r][0][i] == want, (kw, r)
    for i, (bits, group) in enumerate(LAYERS):
        layer, x = W.row_layer(bits, group)
        want = layer(x)
        for r in range(world):
            assert torch.equal(got[r][1][i], want), (bits, group, r)
