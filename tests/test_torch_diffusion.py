"""The port's diffusion schedule, training loss and MAR denoiser against the
JAX package on the CPU.

  * the float64 schedule tables of `create_diffusion` (cosine and linear,
    respaced and not) are identical;
  * `training_losses` on the same timesteps, noise (the JAX draws) and
    model output: every term within 1e-6 max-rel (float32, the same
    operations);
  * the timestep embedding, `SimpleMLPAdaLN` and the `DiffLoss` forward
    on the same flax weights, timesteps and noise: 1e-5 max-rel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.config import DiffLossConfig as JDiffLossConfig
from setok_tpu.diffusion import gaussian as jg
from setok_tpu.losses.diffloss import DiffLoss as JDiffLoss
from setok_tpu.models.diffmlp import SimpleMLPAdaLN as JMLP
from setok_tpu.models.diffmlp import timestep_embedding as j_temb
from setok_tpu_torch.config import DiffLossConfig
from setok_tpu_torch.diffusion import gaussian as tg
from setok_tpu_torch.losses.diffloss import DiffLoss
from setok_tpu_torch.models.diffmlp import SimpleMLPAdaLN, timestep_embedding
from setok_tpu_torch.utils.from_flax import load_flax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2", "timestep_map")


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("respacing,schedule", [
    ("", "cosine"), ("100", "cosine"), ("ddim25", "cosine"),
    ("10,20", "linear"), ("", "linear")])
def test_schedule_tables_identical(respacing, schedule):
    want = jg.create_diffusion(respacing, noise_schedule=schedule)
    got = tg.create_diffusion(respacing, noise_schedule=schedule)
    assert got.num_timesteps == want.num_timesteps
    for name in TABLES:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_training_losses_match_jax():
    n, c = 64, 12
    rs = np.random.RandomState(0)
    x_start = rs.uniform(-1.2, 1.2, (n, c)).astype(np.float32)
    out = (rs.randn(n, 2 * c) * 0.5).astype(np.float32)
    t = rs.randint(0, 1000, n)
    t[:3] = 0                                      # the decoder-NLL branch
    diff_j = jg.create_diffusion("", noise_schedule="cosine")
    diff_t = tg.create_diffusion("", noise_schedule="cosine")
    key = jax.random.PRNGKey(3)
    want = diff_j.training_losses(lambda x, tt: jnp.asarray(out),
                                  jnp.asarray(x_start), jnp.asarray(t), key)
    noise = jax.random.normal(key, x_start.shape, jnp.float32)
    got = diff_t.training_losses(lambda x, tt: torch.from_numpy(out),
                                 torch.from_numpy(x_start),
                                 torch.from_numpy(t),
                                 torch.tensor(np.asarray(noise)))
    for term in ("mse", "vb", "loss"):
        assert max_rel(got[term], want[term]) <= 1e-6, term
    got_xt = diff_t.q_sample(torch.from_numpy(x_start), torch.from_numpy(t),
                             torch.tensor(np.asarray(noise)))
    want_xt = diff_j.q_sample(jnp.asarray(x_start), jnp.asarray(t), noise)
    assert max_rel(got_xt, want_xt) <= 1e-6


def test_timestep_embedding_matches_jax():
    """1e-5: cos and sin of float32 arguments up to 1e3, where the two
    libraries reduce the range differently."""
    t = np.arange(0, 1000, 37)
    for dim in (64, 65):
        want = j_temb(jnp.asarray(t), dim)
        got = timestep_embedding(torch.from_numpy(t), dim)
        assert max_rel(got, want) <= 1e-5


def _flax_mlp(seed):
    jm = JMLP(in_channels=12, model_channels=32, out_channels=24,
              z_channels=16, num_res_blocks=2)
    rs = np.random.RandomState(seed)
    x = rs.randn(10, 12).astype(np.float32)
    t = rs.randint(0, 1000, 10)
    c = rs.randn(10, 16).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), x, t, c)
    # the zero-initialised modulations and output would hide every path
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*np.shape(a)).astype(
            np.float32), params)
    return jm, params, (x, t, c)


def test_simple_mlp_adaln_matches_jax():
    jm, params, (x, t, c) = _flax_mlp(1)
    want = jm.apply(params, x, t, c)
    tm = load_flax_params(SimpleMLPAdaLN(12, 32, 24, 16, 2), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c))
    assert max_rel(got.detach(), want) <= 1e-5


def test_diffloss_forward_matches_jax():
    """DiffLoss with the JAX draws: t and noise from the same key split."""
    cfg_j = JDiffLossConfig(target_channels=12, z_channels=16, width=32,
                            depth=2, diffusion_batch_mul=1)
    cfg_t = DiffLossConfig(target_channels=12, z_channels=16, width=32,
                           depth=2, diffusion_batch_mul=1)
    rs = np.random.RandomState(2)
    target = rs.randn(20, 12).astype(np.float32)
    z = rs.randn(20, 16).astype(np.float32)
    mask = (rs.rand(20) > 0.3).astype(np.float32)
    jm = JDiffLoss(cfg_j)
    key = jax.random.PRNGKey(5)
    params = jm.init(jax.random.PRNGKey(0), target, z, key, mask)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*np.shape(a)).astype(
            np.float32), params)
    want = jm.apply(params, target, z, key, mask)
    t_key, noise_key = jax.random.split(key)
    t = jax.random.randint(t_key, (20,), 0, 1000)
    noise = jax.random.normal(noise_key, target.shape, jnp.float32)
    tm = load_flax_params(DiffLoss(cfg_t, device="cpu"), params)
    got = tm(torch.from_numpy(target), torch.from_numpy(z),
             torch.from_numpy(mask), t=torch.tensor(np.asarray(t)),
             noise=torch.tensor(np.asarray(noise)))
    assert max_rel(got.detach(), want) <= 1e-5
    # the sampler (held to JAX in tests/test_torch_generate_image.py)
    with torch.no_grad():
        sampled = tm.sample(torch.from_numpy(z),
                            generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (20, 12) and bool(torch.isfinite(sampled).all())
