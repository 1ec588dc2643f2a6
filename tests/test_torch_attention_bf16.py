"""The bf16 attention kernel's module on the CPU: its plain version against
a float64 softmax attention and against `Attention.forward`'s float chain,
the wrapper's checks, and the gate `Attention.forward` applies.

Bars, from the bf16 roundings each side makes: the plain version rounds p
to bf16 (2^-9 of each p) and o to bf16 (2^-9 of |o|), so its error is at
most 2^-8 of the largest |v|; the chain rounds the scores and the scaled
scores to bf16 besides, so its mean error is no smaller than the plain
version's, and the two agree within the logit error those roundings make
(2^-8 of a logit of up to ~5 here: 2^-5 of the largest |v|).
"""

import pytest
import torch
from torch import nn

import chip_smoke as cs

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.kernels import attention_bf16 as ab
from setok_tpu_torch.models.setok import SeTok, attention_bf16_launches
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.ops.blocks import Attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16


def _qkv(b, n, h, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, h, d, generator=gen).to(BF16) for _ in range(3)]


def _float64_attention(q, k, v, scale):
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(qd @ kd.transpose(-1, -2) * scale, dim=-1)
    return (p @ vd).transpose(1, 2)


class _Fixed(nn.Module):
    """Stands in for `Attention.qkv`: returns a given projection output."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, x):
        return self.out


def _chain(q, k, v):
    """`Attention.forward`'s float chain on the CPU over given q, k, v, its
    proj the identity (exact in bf16)."""
    b, n, h, d = q.shape
    c = h * d
    attn = Attention(c, h, dtype=BF16, param_dtype=BF16, device="cpu")
    with torch.no_grad():
        attn.proj.weight.copy_(torch.eye(c))
        attn.proj.bias.zero_()
    attn.qkv = _Fixed(torch.stack([q, k, v], dim=2).reshape(b, n, 3 * c))
    with torch.inference_mode():
        out = attn(torch.zeros(b, n, c, dtype=BF16))
    return out.reshape(b, n, h, d), attn.scale


@pytest.mark.parametrize("n", [1, 37, 65])
@pytest.mark.parametrize("d", [72, 64])
def test_plain_against_float64_and_the_chain(d, n):
    q, k, v = _qkv(2, n, 3, d, seed=n + d)
    chain, scale = _chain(q, k, v)
    twin = ab.attention_bf16_plain(q, k, v, scale)
    assert twin.shape == (2, n, 3, d) and twin.dtype == BF16
    assert twin.is_contiguous()
    # the wrapper runs the plain version for a CPU tensor, and counts nothing
    before = ab.LAUNCHES
    assert torch.equal(ab.attention_bf16(q, k, v, scale), twin)
    assert ab.LAUNCHES == before

    ref = _float64_attention(q, k, v, scale)
    vmax = float(v.double().abs().max())
    err_twin = (twin.double() - ref).abs()
    err_chain = (chain.double() - ref).abs()
    assert float(err_twin.max()) <= 2 ** -8 * vmax
    assert float(err_twin.mean()) <= float(err_chain.mean())
    assert float((twin.double() - chain.double()).abs().max()) <= 2 ** -5 * vmax
    if n == 1:                    # one key: p = 1, o = v exactly
        assert torch.equal(twin, v)


def _online_model(q, k, v, scale, tile=64):
    """The kernel's schedule in float32: 64-key tiles, the running max and
    sum, P.V and l rescaled by exp(m_old - m_new) as the max grows, p
    rounded to bf16 against the running max, one division at the end."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    n = qf.shape[-2]
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, n, tile):
        s = torch.matmul(qf, kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(BF16).float(),
                                         vf[..., k0:k0 + tile, :])
        m = m_new
    return (acc / l).transpose(1, 2).to(BF16)


@pytest.mark.parametrize("n,d", [(729, 72), (256, 64), (65, 72), (1, 64)])
def test_online_schedule_differs_from_the_plain_version_by_rounding(n, d):
    """The kernel's online softmax (modelled tile by tile) holds the plain
    version's bars: within 2^-8 of the largest |v| of float64, within 2^-7
    of the plain version, and a mean error no larger than the chain's."""
    q, k, v = _qkv(1, n, 2, d, seed=n)
    scale = d ** -0.5
    online = _online_model(q, k, v, scale)
    twin = ab.attention_bf16_plain(q, k, v, scale)
    ref = _float64_attention(q, k, v, scale)
    vmax = float(v.double().abs().max())
    err = (online.double() - ref).abs()
    assert float(err.max()) <= 2 ** -8 * vmax
    assert float((online.double() - twin.double()).abs().max()) <= 2 ** -7 * vmax
    if n > 1:
        chain, _ = _chain(q, k, v)
        assert float(err.mean()) <= float((chain.double() - ref).abs().mean())


def test_plain_reads_the_qkv_views():
    """q, k, v as `unbind` makes them from a (B, N, 3, H, D) qkv output
    give what their contiguous copies give."""
    q, k, v = _qkv(2, 20, 4, 72, seed=3)
    qkv = torch.stack([q, k, v], dim=2)
    views = qkv.unbind(2)
    assert not views[0].is_contiguous()
    assert torch.equal(ab.attention_bf16(*views, 72 ** -0.5),
                       ab.attention_bf16_plain(q, k, v, 72 ** -0.5))


@pytest.mark.parametrize("change,error", [
    (lambda q: q.float(), TypeError),
    (lambda q: q[:, :, :, :60], ValueError),       # not one shape
    (lambda q: q[..., :0], ValueError),
    (lambda q: q[0], ValueError),                  # not (B, N, H, D)
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, error):
    q, k, v = _qkv(1, 5, 2, 64, seed=0)
    with pytest.raises(error):
        ab.attention_bf16(change(q), k, v, 0.125)


def test_wrapper_raises_on_a_head_width_past_the_kernel():
    q, k, v = _qkv(1, 5, 1, 136, seed=0)
    with pytest.raises(ValueError):
        ab.attention_bf16(q, k, v, 0.125)


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_wrapper_raises_on_a_scale_that_is_not_positive(scale):
    """The kernel's row max is over the unscaled scores: the max of the
    scaled ones only where the scale is positive."""
    q, k, v = _qkv(1, 5, 2, 64, seed=0)
    with pytest.raises(ValueError):
        ab.attention_bf16(q, k, v, scale)


@pytest.mark.parametrize("device_type,dtype,head_dim,kw,takes", [
    ("cuda", BF16, 72, {}, True),                  # the so400m ViT
    ("cuda", BF16, 64, {}, True),                  # base ViT, decoder
    ("cuda", BF16, 8, {}, True),
    ("cuda", BF16, 128, {}, True),
    ("cpu", BF16, 72, {}, False),
    ("cuda", torch.float32, 72, {}, False),
    ("cuda", torch.float16, 72, {}, False),
    ("cuda", BF16, 2048, {}, False),               # so400m's 4096-wide Blocks
    ("cuda", BF16, 12, {}, False),
    ("cuda", BF16, 136, {}, False),
    ("cuda", BF16, 72, {"masked": True}, False),
    ("cuda", BF16, 72, {"dropout": True}, False),
    ("cuda", BF16, 72, {"builds_graph": True}, False),
    ("cuda", BF16, 72, {"scale": 0.0}, False),
    ("cuda", BF16, 72, {"scale": -72 ** -0.5}, False),   # a user qk_scale
])
def test_gate(device_type, dtype, head_dim, kw, takes):
    flags = {"masked": False, "dropout": False, "builds_graph": False,
             "scale": head_dim ** -0.5, **kw}
    assert ab.takes_kernel(device_type, dtype, head_dim, **flags) is takes


@pytest.fixture
def gate_calls(monkeypatch):
    """The arguments of every `takes_kernel` call, answered as usual."""
    calls = []

    def spy(device_type, dtype, head_dim, **kw):
        calls.append((device_type, dtype, head_dim, kw))
        return GATE(device_type, dtype, head_dim, **kw)

    monkeypatch.setattr(ab, "takes_kernel", spy)
    return calls


GATE = ab.takes_kernel


def _on_card(call):
    _, dtype, head_dim, kw = call
    return GATE("cuda", dtype, head_dim, **kw)


def test_gate_at_the_so400m_vit_call(gate_calls):
    """The so400m ViT's attention (1152 wide, 16 heads of 72, bf16, under
    inference mode, as the tokenize cell runs it) would take the kernel on
    the card; on the CPU it runs the chain."""
    vit = cfgs.so400m_tokenizer().vit
    attn = Attention(vit.width, vit.num_heads, dtype=BF16, param_dtype=BF16,
                     device="cpu")
    x = torch.randn(1, 9, vit.width).to(BF16)
    with torch.inference_mode():
        attn(x)
    assert len(gate_calls) == 1
    device_type, dtype, head_dim, kw = gate_calls[0]
    assert (device_type, dtype, head_dim) == ("cpu", BF16, 72)
    assert _on_card(gate_calls[0])
    assert not GATE(*gate_calls[0][:3], **kw)
    # so400m's cluster Blocks are 4096 wide with 2 heads
    tok = cfgs.so400m_tokenizer()
    assert not GATE("cuda", BF16, tok.hidden_dim // tok.nheads,
                    masked=False, dropout=False, builds_graph=False,
                    scale=(tok.hidden_dim // tok.nheads) ** -0.5)


def test_gate_bypasses_masked_grad_and_dropout_calls(gate_calls):
    attn = Attention(64, 2, attn_drop=0.1, dtype=BF16, param_dtype=BF16,
                     device="cpu")
    x = torch.randn(2, 5, 64).to(BF16)
    mask = torch.ones(2, 5, 5, dtype=torch.bool)
    with torch.inference_mode():
        attn(x, mask)                                        # masked
        attn(x, generator=torch.Generator().manual_seed(0))  # dropout drawn
        attn(x)                                              # neither
    attn(x)                                                  # grad enabled
    s = attn.scale
    assert [c[3] for c in gate_calls] == [
        {"masked": True, "dropout": False, "builds_graph": False, "scale": s},
        {"masked": False, "dropout": True, "builds_graph": False, "scale": s},
        {"masked": False, "dropout": False, "builds_graph": False, "scale": s},
        {"masked": False, "dropout": False, "builds_graph": True, "scale": s}]
    assert [_on_card(c) for c in gate_calls] == [False, False, True, False]


def test_gate_in_a_bf16_tokenizer_forward(gate_calls):
    """In `SetokTokenizer.forward` the ViT's attentions would take the
    kernel on the card and the cluster Blocks' masked ones would not."""
    tok = cfgs.tiny_tokenizer()
    model = SetokTokenizer(tok, dtype=BF16, param_dtype=BF16, device="cpu")
    images = torch.rand(2, 32, 32, 3) * 2 - 1
    with torch.inference_mode():
        model(images)
    unmasked = [c for c in gate_calls if not c[3]["masked"]]
    masked = [c for c in gate_calls if c[3]["masked"]]
    assert len(unmasked) == tok.vit.depth and masked
    assert all(_on_card(c) for c in unmasked)
    assert not any(_on_card(c) for c in masked)


@pytest.mark.parametrize("dtype,quant8", [(BF16, False), (BF16, True),
                                          (torch.float32, False)])
def test_launch_count_is_the_gate_passes_of_a_setok_forward(gate_calls,
                                                             dtype, quant8):
    """`attention_bf16_launches` counts, from the configurations, the
    attentions of one `SeTok.forward` that pass the gate on the card."""
    tok, det = cfgs.tiny_tokenizer(), cfgs.tiny_detokenizer()
    model = SeTok(tok, det, dtype=dtype, quant8=quant8, device="cpu")
    model(torch.rand(2, 32, 32, 3) * 2 - 1)
    assert sum(_on_card(c) for c in gate_calls) == attention_bf16_launches(
        tok, det, dtype=dtype, quant8=quant8)
    # chip_smoke.py reads the form from the model as it was built
    assert cs.model_attention_launches(model) == attention_bf16_launches(
        tok, det, dtype=dtype, quant8=quant8)


def test_launch_counts_at_the_path_configurations():
    base = cfgs.base_tokenizer(), cfgs.base_detokenizer()
    so400m = cfgs.so400m_tokenizer(), cfgs.so400m_detokenizer()
    assert attention_bf16_launches(*base, dtype=BF16) == 12 + 16
    assert attention_bf16_launches(*base, dtype=BF16, quant8=True) == 0
    assert attention_bf16_launches(*base, dtype=torch.float32) == 0
    assert attention_bf16_launches(so400m[0], dtype=BF16) == 26
    assert attention_bf16_launches(*so400m, dtype=BF16) == 26
