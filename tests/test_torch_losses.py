"""The port's stage-1 losses and quality metrics against the JAX package.

The same numpy inputs and flax parameters (carried by `from_flax`) go
through `setok_tpu/losses`, `setok_tpu/models/text_encoder.py`,
`setok_tpu/utils/metrics.py` and `setok_tpu/utils/synthetic.py` and their
counterparts in the port, on the CPU. Bars: 1e-5 relative to the largest
output element in float32 (the convolutions and products sum in other
orders; the discriminator, LPIPS and the text tower stack several), exact
for the step-function schedules and the numpy images.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.losses import contrastive as jcon
from setok_tpu.losses import gan as jgan
from setok_tpu.losses import lpips as jlp
from setok_tpu.losses import mse as jmse
from setok_tpu.models.text_encoder import TextEncoder as JText
from setok_tpu.utils import metrics as jmet
from setok_tpu.utils import synthetic as jsyn
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.losses import contrastive as tcon
from setok_tpu_torch.losses import gan as tgan
from setok_tpu_torch.losses import lpips as tlp
from setok_tpu_torch.losses import mse as tmse
from setok_tpu_torch.models.text_encoder import TextEncoder
from setok_tpu_torch.utils import metrics as tmet
from setok_tpu_torch.utils import synthetic as tsyn
from setok_tpu_torch.utils.from_flax import load_flax_params

TOL = 1e-5


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def max_rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def images(seed, b=2, size=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_discriminator_matches_jax(n_layers):
    x = images(0, size=64)
    jm = jgan.NLayerDiscriminator(n_layers=n_layers)
    params = jm.init(jax.random.PRNGKey(n_layers), x)
    want = np.asarray(jm.apply(params, x))
    tm = load_flax_params(tgan.NLayerDiscriminator(n_layers=n_layers,
                                                   device="cpu"),
                          to_np(params))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert max_rel(got, want) <= TOL


def test_discriminator_bf16_follows_jax():
    """bf16 compute over float32 parameters, as the trainer runs it: the
    logits within bf16's resolution of JAX's."""
    x = images(1, size=64)
    jm = jgan.NLayerDiscriminator(n_layers=2, dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(params, x).astype(jnp.float32))
    tm = load_flax_params(tgan.NLayerDiscriminator(
        n_layers=2, dtype=torch.bfloat16, device="cpu"), to_np(params))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert max_rel(got.float(), want) <= 2e-2


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_discriminator_losses_match_jax(name):
    rs = np.random.RandomState(2)
    real, fake = (rs.randn(2, 7, 7, 1).astype(np.float32) for _ in range(2))
    want = float(getattr(jgan, name)(real, fake))
    got = float(getattr(tgan, name)(torch.from_numpy(real),
                                    torch.from_numpy(fake)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(tgan.generator_loss(torch.from_numpy(fake))) == \
        pytest.approx(float(jgan.generator_loss(fake)), rel=1e-6)


@pytest.mark.parametrize("threshold,warm_up_end",
                         [(0, 0), (0, 200), (5, 9), (10, 4)])
def test_adopt_weight_schedule_matches_jax(threshold, warm_up_end):
    for step in [0, 1, 3, 4, 5, 7, 9, 10, 11, 250]:
        want = float(jgan.adopt_weight(0.7, jnp.asarray(step), threshold,
                                       warm_up_end))
        got = tgan.adopt_weight(0.7, step, threshold, warm_up_end)
        assert got.dtype == torch.float32
        assert float(got) == want, (step, float(got), want)


def test_discriminator_loss_has_no_warm_up():
    cfg = (jcfg.GANLossConfig(disc_start=3, warm_up_end=50),
           tcfg.GANLossConfig(disc_start=3, warm_up_end=50))
    rs = np.random.RandomState(3)
    real, fake = rs.randn(2, 5).astype(np.float32), rs.randn(2, 5).astype(
        np.float32)
    for step in (0, 2, 3, 10):
        want = float(jgan.discriminator_loss(real, fake, jnp.asarray(step),
                                             cfg[0]))
        got = float(tgan.discriminator_loss(torch.from_numpy(real),
                                            torch.from_numpy(fake), step,
                                            cfg[1]))
        assert got == pytest.approx(want, rel=1e-6)


def test_adaptive_weight_matches_jax():
    rs = np.random.RandomState(4)
    rec = rs.randn(8, 5).astype(np.float32)
    g = rs.randn(8, 5).astype(np.float32) * 1e-3
    want = float(jgan.adaptive_weight(rec, g, 0.5))
    got = tgan.adaptive_weight(torch.from_numpy(rec), torch.from_numpy(g),
                               0.5)
    assert not got.requires_grad
    assert float(got) == pytest.approx(want, rel=1e-6)
    # clipped at 1e4 (times the weight)
    big = tgan.adaptive_weight(torch.ones(4), torch.zeros(4), 2.0)
    assert float(big) == pytest.approx(2e4)


@pytest.mark.parametrize("multi_label,share", [(0, False), (1, False),
                                               (1, True)])
def test_contrastive_matches_jax(multi_label, share):
    cfg = dict(multi_label=multi_label, share_temperature=share,
               multi_label_loss_weight=0.3, text_embed_dim=16)
    rs = np.random.RandomState(5)
    img, txt = rs.randn(6, 16).astype(np.float32), rs.randn(6, 16).astype(
        np.float32)
    jm = jcon.ContrastiveLoss(jcfg.ContrastiveLossConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0), img, txt)
    params = jax.tree.map(lambda p: p + 0.25, params)   # away from init
    want_loss, want_m = jm.apply(params, img, txt)
    tm = load_flax_params(tcon.ContrastiveLoss(
        tcfg.ContrastiveLossConfig(**cfg), device="cpu"), to_np(params))
    with torch.no_grad():
        loss, metrics = tm(torch.from_numpy(img), torch.from_numpy(txt))
    assert set(metrics) == set(want_m)
    assert float(loss) == pytest.approx(float(want_loss), rel=TOL)
    for k in want_m:
        assert float(metrics[k]) == pytest.approx(float(want_m[k]), rel=TOL)


@pytest.mark.parametrize("l1,l2", [(1, 1), (2, 3)])
def test_multi_label_loss_over_sets_matches_jax(l1, l2):
    cfg = dict(multi_label=1, text_embed_dim=8)
    rs = np.random.RandomState(6)
    img = rs.randn(3, l1, 8).astype(np.float32)
    txt = rs.randn(3, l2, 8).astype(np.float32)
    jm = jcon.ContrastiveLoss(jcfg.ContrastiveLossConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0), img[:, 0], txt[:, 0])
    want = float(jm.apply(params, img, txt, method=jm.multi_label_loss))
    tm = load_flax_params(tcon.ContrastiveLoss(
        tcfg.ContrastiveLossConfig(**cfg), device="cpu"), to_np(params))
    with torch.no_grad():
        got = float(tm.multi_label_loss(torch.from_numpy(img),
                                        torch.from_numpy(txt)))
    assert got == pytest.approx(want, rel=TOL)


def test_contrastive_temperature_init_and_clamp():
    tm = tcon.ContrastiveLoss(tcfg.ContrastiveLossConfig(
        contrast_temperature=0.07, multi_label=1), device="cpu")
    scale, ml_scale = (float(p.detach()) for p in tm.parameters())
    assert scale == pytest.approx(np.log(1 / 0.07)) and ml_scale == scale
    with torch.no_grad():
        tm.logit_scale.fill_(10.0)
        assert float(tm._scale()) == 100.0


def test_lpips_structure_matches_jax():
    """Random VGG-16 and heads (no weights here): the five taps, the
    scaling layer, the unit normalisation and the heads, against JAX."""
    a, b = images(7), images(8)
    jm = jlp.LPIPS()
    params = jm.init(jax.random.PRNGKey(0), a, b)
    # heads positive, as trained LPIPS heads are
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.abs(p) if "lin_" in str(path) else p, params)
    want = float(jm.apply(params, a, b))
    tm = load_flax_params(tlp.LPIPS(device="cpu"), to_np(params))
    with torch.no_grad():
        got = float(tm(torch.from_numpy(a), torch.from_numpy(b)))
        same = float(tm(torch.from_numpy(a), torch.from_numpy(a)))
    assert got == pytest.approx(want, rel=TOL)
    assert same == 0.0
    names = [n for n, _ in tm.named_parameters()]
    assert len([n for n in names if n.startswith("vgg.conv_")]) == 26
    assert [n for n in names if n.startswith("lin_")] == [
        f"lin_{i}.weight" for i in range(5)]


@pytest.mark.parametrize("masked", [False, True])
def test_reconstruction_losses_match_jax(masked):
    rs = np.random.RandomState(9)
    pred, target = (rs.randn(2, 3, 6, 6).astype(np.float32)
                    for _ in range(2))
    mask = (rs.rand(2, 1, 6, 6) > 0.5).astype(np.float32) if masked else None
    want = float(jmse.weighted_mse_loss(pred, target, mask, weight=0.5))
    got = float(tmse.weighted_mse_loss(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask), weight=0.5))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(tmse.l1_loss(torch.from_numpy(pred),
                              torch.from_numpy(target))) == \
        pytest.approx(float(jmse.l1_loss(pred, target)), rel=1e-6)


def test_text_encoder_matches_jax():
    rs = np.random.RandomState(10)
    ids = rs.randint(1, 64, size=(3, 9))
    ids[1, 6:] = 0                       # padding
    kw = dict(vocab_size=64, width=32, depth=2, num_heads=2, max_len=16,
              embed_dim=24)
    jm = JText(**kw)
    params = jm.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(jm.apply(params, ids))
    tm = load_flax_params(TextEncoder(**kw, device="cpu"), to_np(params))
    got = tm(torch.from_numpy(ids))
    assert got.shape == want.shape == (3, 24)
    assert max_rel(got, want) <= TOL


def test_psnr_and_ssim_match_jax():
    a = images(11, size=40)
    b = np.clip(a + np.random.RandomState(12).randn(*a.shape).astype(
        np.float32) * 0.2, -1, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(tmet.psnr(ta, tb)) == pytest.approx(
        float(jmet.psnr(a, b)), rel=1e-6)
    assert float(tmet.ssim(ta, tb)) == pytest.approx(
        float(jmet.ssim(a, b)), rel=1e-5)
    assert float(tmet.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    # bf16 inputs: every product in float32, as the JAX function does
    want = float(jmet.ssim(jnp.asarray(a, jnp.bfloat16),
                           jnp.asarray(b, jnp.bfloat16)))
    got = float(tmet.ssim(ta.bfloat16(), tb.bfloat16()))
    assert got == pytest.approx(want, rel=1e-5)


def test_structured_images_equal_jax():
    np.testing.assert_array_equal(tsyn.structured_images(3, 24, seed=5),
                                  jsyn.structured_images(3, 24, seed=5))
