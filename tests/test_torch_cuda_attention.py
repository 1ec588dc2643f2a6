"""Card-only checks of the bf16 attention kernel (`kernels/attention_bf16.py`,
`csrc/attention_bf16.cu`), held to its plain version and to a float32
reference. They skip without a card; on one, run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_attention.py

This file imports no JAX.

Bars. Against the float32 reference the kernel's error is at most 2^-8 of
the largest |v| (p rounds to bf16, 2^-9 of each p, and o to bf16, 2^-9 of
|o|), as the plain version's is, so the two agree within 2^-7 of it. At the
path's shapes its error, the largest and the mean, is no larger than that of
the float chain it replaces (`ops/blocks.softmax_attention` in bf16, which
rounds the scores and the scaled scores to bf16 besides). The kernel has no
atomics: a second call gives the same bits. One so400m tokenizer forward
launches it once for each of the 26 ViT blocks up to the tap; a base int8
SeTok forward never; a base bf16 SeTok forward once for each of its 12 ViT
and 16 pixel-decoder blocks.
"""

import pytest
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import attention_bf16 as ab
from setok_tpu_torch.models.setok import SeTok, attention_bf16_launches
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.ops.blocks import softmax_attention
from setok_tpu_torch.utils.init import init_random_

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, n, h, d, layout, seed=0):
    """q, k, v (B, N, H, D) bf16: views of one (B, N, 3, H, D) qkv output
    (`layout` "qkv", as `Attention.forward` hands them over) or three
    contiguous tensors. Logits of about unit spread, as a trained ViT's."""
    gen = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=gen, device=card).to(BF16)
    if layout == "qkv":
        return qkv.unbind(2)
    return [t.contiguous() for t in qkv.unbind(2)]


def _reference(q, k, v, scale):
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2)


def _chain(q, k, v, scale):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return softmax_attention(qt, kt, vt, scale, None, BF16).transpose(1, 2)


def _check(q, k, v, chain_too: bool):
    d = q.shape[-1]
    scale = d ** -0.5
    before = ab.LAUNCHES
    got = ab.attention_bf16(q, k, v, scale)
    torch.cuda.synchronize()
    assert ab.LAUNCHES == before + 1
    assert got.shape == q.shape and got.dtype == BF16 and got.is_contiguous()
    twin = ab.attention_bf16_plain(q, k, v, scale)
    ref = _reference(q, k, v, scale)
    vmax = float(v.float().abs().max())
    err = (got.float() - ref).abs()
    assert float(err.max()) <= 2 ** -8 * vmax
    assert float((got.float() - twin.float()).abs().max()) <= 2 ** -7 * vmax
    if chain_too:
        err_chain = (_chain(q, k, v, scale).float() - ref).abs()
        print(f"{tuple(q.shape)}: max {float(err.max()):.3e} (chain "
              f"{float(err_chain.max()):.3e}), mean {float(err.mean()):.3e} "
              f"(chain {float(err_chain.mean()):.3e})")
        assert float(err.max()) <= float(err_chain.max())
        assert float(err.mean()) <= float(err_chain.mean())
    assert torch.equal(ab.attention_bf16(q, k, v, scale), got)
    return got


# (B, H, N, D, layout): the so400m ViT's call, the base ViT's (@256), the
# base pixel decoder's (768 wide, 16 heads of 48), one key, one key past a
# tile, and the so400m call from contiguous tensors
PATH_CASES = [(2, 16, 729, 72, "qkv"), (2, 12, 256, 64, "qkv"),
              (2, 16, 256, 48, "qkv"),
              (2, 4, 1, 72, "qkv"), (2, 4, 65, 72, "qkv"),
              (2, 4, 65, 64, "qkv"), (2, 16, 729, 72, "contiguous")]


@pytest.mark.parametrize("b,h,n,d,layout", PATH_CASES)
def test_kernel_against_plain_reference_and_chain(card, b, h, n, d, layout):
    q, k, v = _inputs(card, b, n, h, d, layout)
    _check(q, k, v, chain_too=n > 1)


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_kernel_at_every_head_width(card, d):
    q, k, v = _inputs(card, 1, 130, 2, d, "qkv", seed=d)
    _check(q, k, v, chain_too=False)


def test_kernel_raises_on_rows_it_cannot_copy(card):
    q, k, v = _inputs(card, 1, 20, 2, 64, "contiguous")
    wide = torch.zeros(1, 20, 2, 72, dtype=BF16, device=card)
    wide[..., 1:65] = q
    with pytest.raises(ValueError):
        ab.attention_bf16(wide[..., 1:65], k, v, 0.125)   # 2-byte start


def test_so400m_tokenizer_launches_once_a_vit_block(card):
    tok = cfgs.so400m_tokenizer()
    model = init_random_(SetokTokenizer(tok, dtype=BF16, param_dtype=BF16,
                                        device=card), 0)
    size = tok.vit.image_size
    images = torch.rand(1, size, size, 3, device=card) * 2 - 1
    before = ab.LAUNCHES
    with torch.inference_mode():
        out = model(images)
    torch.cuda.synchronize()
    assert ab.LAUNCHES == before + 26
    assert torch.isfinite(out.tokens.float()).all()


def test_base_bf16_setok_launches_once_a_vit_and_decoder_block(card):
    tok, det = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    model = init_random_(SeTok(tok, det, dtype=BF16, device=card), 0)
    images = torch.rand(1, 256, 256, 3, device=card) * 2 - 1
    before = ab.LAUNCHES
    out = model(images)
    torch.cuda.synchronize()
    assert ab.LAUNCHES - before == attention_bf16_launches(
        tok, det, dtype=BF16) == 12 + 16
    assert torch.isfinite(out.recon.float()).all()


def test_base_int8_setok_never_launches(card):
    model = init_random_(SeTok(cfgs.base_tokenizer(), cfgs.base_detokenizer(),
                               dtype=BF16, quant8=True, device=card), 0)
    images = torch.rand(1, 256, 256, 3, device=card) * 2 - 1
    before = ab.LAUNCHES
    with torch.inference_mode():
        out = model(images)
    torch.cuda.synchronize()
    assert ab.LAUNCHES == before
    assert torch.isfinite(out.recon.float()).all()
