"""Card-only checks of the port's CUDA kernels, held to their plain
versions. They skip without a card; on one, run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's machine
does not need). This file imports no JAX.

Bars: density and row max rtol 1e-5 (float32, summation order only);
scores rtol 1e-4 on the peaks and within 1e-3 on ≥ 90 % of tokens, because a
parent can flip between same-blob density near-ties. The int8 kernels at
every shape of the base forward, with chip_smoke.py's bars: the MLPs 1e-5
max-rel; the attentions 2e-3 max-rel with ≥ 99 % of the elements within
1e-5 of the largest (scores sum in another order than the plain version's,
which can flip a bf16 or int8 rounding step).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import cluster_dpc
from setok_tpu_torch.kernels import fused_bert_attention_int8 as fba
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.utils.init import init_random_

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
    (1, 1024, 64, 1024),    # the largest N (shared memory above 48 KB), k=N
    (3, 256, 768, 64),      # the base configuration
    (1, 729, 1152, 64),     # so400m's token count
])
def test_kernel_matches_reference(card, b, n, c, k):
    x = torch.from_numpy(np.stack([_blobs(s, n, c) for s in range(b)])).to(card)
    before = cluster_dpc.LAUNCHES
    dens, parent, rowmax = cluster_dpc.dpc_density_parent(x, k)
    torch.cuda.synchronize()
    assert cluster_dpc.LAUNCHES == before + 3      # sqnorm, density, parent
    rd, rp, rr = cluster_dpc.dpc_density_parent_reference(x, k)
    torch.testing.assert_close(dens, rd, rtol=1e-5, atol=0)
    torch.testing.assert_close(rowmax, rr, rtol=1e-5, atol=0)
    got, want = (dens * parent).cpu(), (rd * rp).cpu()
    assert torch.isclose(got, want, rtol=1e-3, atol=1e-3).float().mean() >= 0.9
    peaks = want > 0.55
    torch.testing.assert_close(got[peaks], want[peaks], rtol=1e-4, atol=0)


def test_tokenizer_routes_to_the_kernel(card):
    model = init_random_(SeTok(cfgs.tiny_tokenizer(), cfgs.tiny_detokenizer(),
                               device=card), 0)
    images = torch.rand(2, 32, 32, 3, device=card) * 2 - 1
    before = cluster_dpc.LAUNCHES
    out = model(images)
    torch.cuda.synchronize()
    assert cluster_dpc.LAUNCHES == before + 3
    assert torch.isfinite(out.recon).all()
    # a token mask takes the plain path, as in the JAX package
    feats = model.tokenizer.encode_features(images)
    model.tokenizer.cluster(feats, token_mask=torch.ones(2, 16, device=card))
    assert cluster_dpc.LAUNCHES == before + 3


# the cases of chip_smoke.int8_cases, and the CUDA launches of one call
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
    chip_smoke.check_int8_case(*case)          # raises SystemExit on a miss
    assert {**fs.LAUNCHES, **fba.LAUNCHES}[name] == launches[name] + steps
    assert {**fs.CALLS, **fba.CALLS}[name] == calls[name] + 1


def test_int8_forward_routes_to_the_kernels(card):
    tok, det = cfgs.tiny_tokenizer(), cfgs.tiny_detokenizer()
    model = init_random_(SeTok(tok, det, device=card, quant8=True), 0)
    images = torch.rand(2, 32, 32, 3, device=card) * 2 - 1
    chip_smoke.reset_counts()
    out = model(images)
    torch.cuda.synchronize()
    assert chip_smoke.int8_counts()[0] == chip_smoke.expected_calls(tok, det)
    assert cluster_dpc.LAUNCHES == 3
    assert torch.isfinite(out.recon).all()
