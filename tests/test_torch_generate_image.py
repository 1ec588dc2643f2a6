"""The port's image generation against the JAX package on the CPU, on the
JAX package's own draws.

The JAX samplers draw from `jax.random` keys; the tests rebuild exactly
those draws (`jax_sample_draws`, `jax_image_draws`: the same key splits and
shapes) and replay them through the port's `SampleDraws` / `ImageDraws`.
The weights are the same flax tree, the diffusion head's parameters moved
off their zero initialisation (zero modulations and a zero output layer
would leave every path but the schedule untested). Bars, max-rel =
max|got - want| / max|want|:

  * one `p_sample` step 1e-5; `p_sample_loop` (temperature 1.0 and 0.7)
    and `ddim_sample_loop` (eta 0 and 0.5) 1e-4;
  * `forward_with_cfg` 1e-5; `DiffLoss.sample`, with and without guidance
    (a float scale and a 0-dim tensor scale), 1e-4;
  * `sample_image_tokens` at cfg_scale 1.0 and 2.0: the tokens 1e-4, and
    the masks exact: with the sampler replaced by one that returns its
    iteration's number, each token holds the iteration that unmasked it,
    which fixes every iteration's mask; the Muse guidance scale of every
    iteration 1e-6;
  * `generate_image`: the image within the max-abs `TOL` (1e-4) of
    tests/test_torch_models.py;
  * `generate`: the same spans as the JAX `generate`, one image of the
    detokenizer's shape per span.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.config import DiffLossConfig as JDiffLossConfig
from setok_tpu.diffusion import gaussian as jg
from setok_tpu.losses.diffloss import DiffLoss as JDiffLoss
from setok_tpu.models import generate as jgen
from setok_tpu.models.diffmlp import SimpleMLPAdaLN as JMLP
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu_torch.config import DiffLossConfig
from setok_tpu_torch.diffusion import gaussian as tg
from setok_tpu_torch.losses.diffloss import DiffLoss, SampleDraws
from setok_tpu_torch.models import generate as tgen
from setok_tpu_torch.models.diffmlp import SimpleMLPAdaLN
from setok_tpu_torch.models.setokim import ImageDraws
from setok_tpu_torch.utils.from_flax import load_flax_params
from test_torch_models import TOL
from test_torch_setokim import flax_params, port_model, prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

__all__ = ["flax_params"]          # the shared module-scoped fixture

C, Z, N = 12, 16, 10               # latent and condition widths, rows


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def moved(params, seed, scale=0.05):
    """The tree with every leaf moved by N(0, scale²) noise."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rs.randn(
        *np.shape(a)).astype(np.float32), params)


@pytest.fixture(scope="module")
def setokim_params(flax_params):
    """The tiny Setokim tree, its diffusion head moved off zero."""
    params = jax.tree.map(np.asarray, flax_params)
    inner = dict(params["params"])
    inner["diffloss"] = moved(inner["diffloss"], 3)
    return {"params": inner}


@pytest.fixture(scope="module")
def mlp():
    jm = JMLP(in_channels=C, model_channels=32, out_channels=2 * C,
              z_channels=Z, num_res_blocks=2)
    rs = np.random.RandomState(1)
    params = jm.init(jax.random.PRNGKey(1), rs.randn(N, C).astype(
        np.float32), np.zeros(N, np.int32), rs.randn(N, Z).astype(np.float32))
    params = moved(params, 2)
    tm = load_flax_params(SimpleMLPAdaLN(C, 32, 2 * C, Z, 2), params)
    return jm, params, tm


def jax_step_noise(loop_rng, steps: int, shape) -> torch.Tensor:
    """(steps, *shape): the noise a JAX sampling loop draws at each step."""
    keys = jax.random.split(loop_rng, steps)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        k, shape, jnp.float32)) for k in keys]))


def jax_sample_draws(rk, n: int, c: int, steps: int,
                     use_cfg: bool) -> SampleDraws:
    """The draws of the JAX `DiffLoss.sample(z (n, ·), rk, ...)`."""
    noise_rng, loop_rng = jax.random.split(rk)
    noise = jax.random.normal(noise_rng, (n // 2 if use_cfg else n, c))
    step = jax_step_noise(loop_rng, steps, (n, c))
    return SampleDraws(torch.from_numpy(np.asarray(noise)), step.__getitem__)


def jax_orders(r_orders, b: int, seq_len: int) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.permutation(
        r_orders, jnp.broadcast_to(jnp.arange(seq_len), (b, seq_len)),
        axis=1, independent=True))).long()


def jax_image_draws(key, b: int, seq_len: int, c: int, num_iter: int,
                    steps: int, use_cfg: bool) -> ImageDraws:
    """The draws of the JAX `Setokim.sample_image_tokens(cond, key, ...)`."""
    r_orders, rng = jax.random.split(key)
    n = b * seq_len * (2 if use_cfg else 1)
    iterations = []
    for _ in range(num_iter):
        rng, rk = jax.random.split(rng)
        iterations.append(jax_sample_draws(rk, n, c, steps, use_cfg))
    return ImageDraws(jax_orders(r_orders, b, seq_len),
                      iterations.__getitem__)


def jax_model(jm, params):
    return lambda x, t, c: jm.apply(params, x, t, c)


# ----------------------------------------------------------------------------
# the samplers


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_p_sample_matches_jax(mlp, temperature):
    jm, params, tm = mlp
    rs = np.random.RandomState(4)
    x = rs.randn(N, C).astype(np.float32)
    c = rs.randn(N, Z).astype(np.float32)
    t = rs.randint(0, 10, N).astype(np.int32)
    t[:2] = 0                                   # no noise at t = 0
    jd = jg.create_diffusion("10", noise_schedule="cosine")
    td = tg.create_diffusion("10", noise_schedule="cosine")
    key = jax.random.PRNGKey(7)
    want = jd.p_sample(jax_model(jm, params), jnp.asarray(x), jnp.asarray(t),
                       key, model_kwargs={"c": jnp.asarray(c)},
                       temperature=temperature)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        key, x.shape, jnp.float32)))
    with torch.no_grad():
        got = td.p_sample(tm, torch.from_numpy(x),
                          torch.from_numpy(t), noise,
                          model_kwargs={"c": torch.from_numpy(c)},
                          temperature=temperature)
    assert max_rel(got, want) <= 1e-5


@pytest.mark.parametrize("loop,knob", [("p", 1.0), ("p", 0.7), ("ddim", 0.0),
                                       ("ddim", 0.5)])
def test_sample_loops_match_jax(mlp, loop, knob):
    """The loops from the same initial noise and the per-step noise of the
    JAX loop's key splits (knob: the temperature, or DDIM's eta)."""
    jm, params, tm = mlp
    rs = np.random.RandomState(5)
    c = rs.randn(N, Z).astype(np.float32)
    noise = rs.randn(N, C).astype(np.float32)
    jd = jg.create_diffusion("10", noise_schedule="cosine")
    td = tg.create_diffusion("10", noise_schedule="cosine")
    key = jax.random.PRNGKey(8)
    kw = ({"temperature": knob} if loop == "p" else {"eta": knob})
    jfn = jd.p_sample_loop if loop == "p" else jd.ddim_sample_loop
    tfn = td.p_sample_loop if loop == "p" else td.ddim_sample_loop
    want = jfn(jax_model(jm, params), noise.shape, jnp.asarray(noise), key,
               model_kwargs={"c": jnp.asarray(c)}, **kw)
    step = jax_step_noise(key, td.num_timesteps, noise.shape)
    with torch.no_grad():
        got = tfn(tm, noise.shape, torch.from_numpy(noise),
                  step.__getitem__, model_kwargs={"c": torch.from_numpy(c)},
                  **kw)
    assert max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("scale", [1.5, 4.0])
def test_forward_with_cfg_matches_jax(mlp, scale):
    jm, params, tm = mlp
    rs = np.random.RandomState(6)
    x = rs.randn(N, C).astype(np.float32)
    t = rs.randint(0, 1000, N).astype(np.int32)
    c = np.concatenate([rs.randn(N // 2, Z), np.zeros((N // 2, Z))]).astype(
        np.float32)
    want = jm.apply(params, x, t, c, scale, method=jm.forward_with_cfg)
    with torch.no_grad():
        got = tm.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(c), scale)
    assert max_rel(got, want) <= 1e-5


@pytest.mark.parametrize("cfg,tensor", [(1.0, False), (3.0, False),
                                        (2.5, True)])
def test_diffloss_sample_matches_jax(cfg, tensor):
    """Without guidance, and with it: z = [cond; 0], the initial noise
    drawn for half the rows and shared by both halves."""
    kw = dict(target_channels=C, z_channels=Z, width=32, depth=2,
              num_sampling_steps="8")
    jm = JDiffLoss(JDiffLossConfig(**kw))
    rs = np.random.RandomState(9)
    z = rs.randn(N, Z).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), rs.randn(N, C).astype(
        np.float32), z, jax.random.PRNGKey(1))
    params = moved(params, 10)
    use_cfg = cfg != 1.0
    if use_cfg:
        z[N // 2:] = 0.0
    key = jax.random.PRNGKey(11)
    jcfg_ = jnp.float32(cfg) if tensor else cfg
    want = jm.apply(params, jnp.asarray(z), key, 0.9, jcfg_,
                    use_cfg=use_cfg if tensor else None, method=jm.sample)
    tm = load_flax_params(DiffLoss(DiffLossConfig(**kw), device="cpu"),
                          params)
    draws = jax_sample_draws(key, N, C, tm.gen_diffusion.num_timesteps,
                             use_cfg)
    tcfg_ = torch.tensor(cfg) if tensor else cfg
    with torch.no_grad():
        got = tm.sample(torch.from_numpy(z), 0.9, tcfg_,
                        use_cfg if tensor else None, draws=draws)
    assert got.shape == (N, C)
    assert max_rel(got, want) <= 1e-4


# ----------------------------------------------------------------------------
# the MaskGIT loop, the render and generate


def span(seed: int, b: int, seq_len: int, hidden: int = 64) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, seq_len, hidden).astype(
        np.float32)


@pytest.mark.parametrize("seq_len,num_iter", [(8, 4), (80, 16), (37, 3)])
@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_sample_image_token_masks_exact(setokim_params, monkeypatch, seq_len,
                                        num_iter, cfg_scale):
    """The sampler of both packages replaced by one that returns its
    iteration's number (1, 2, ...): each token then holds the iteration
    that unmasked it, the same in both, and the guidance scales agree."""
    from setok_tpu.losses import diffloss as jdl
    from setok_tpu_torch.losses import diffloss as tdl

    seen = {"jax": [], "port": []}

    def fake(kind):
        def sample(self, z, *args, **kwargs):
            cfg = args[2] if kind == "jax" else args[1]
            seen[kind].append(float(cfg))
            c = self.cfg.target_channels
            value = float(len(seen[kind]))
            if kind == "jax":
                return jnp.full((z.shape[0], c), value)
            return torch.full((z.shape[0], c), value)
        return sample

    monkeypatch.setattr(jdl.DiffLoss, "sample", fake("jax"))
    monkeypatch.setattr(tdl.DiffLoss, "sample", fake("port"))
    cond = span(12, 2, seq_len)
    key = jax.random.PRNGKey(13)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    want = jm.apply(setokim_params, jnp.asarray(cond), key, num_iter,
                    cfg_scale, method=jm.sample_image_tokens)
    draws = ImageDraws(jax_orders(jax.random.split(key)[0], 2, seq_len),
                       lambda k: None)
    got = port_model(setokim_params).sample_image_tokens(
        torch.from_numpy(cond), None, num_iter, cfg_scale, draws=draws)
    written = got[..., 0].numpy()
    np.testing.assert_array_equal(written, np.asarray(want)[..., 0])
    assert written.min() >= 1                   # every token was written
    assert len(seen["port"]) == len(seen["jax"]) == num_iter
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-6)


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_sample_image_tokens_match_jax(setokim_params, cfg_scale):
    num_iter, seq_len = 4, 8
    cond = span(14, 2, seq_len)
    key = jax.random.PRNGKey(15)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    want = jax.jit(lambda p, c, k: jm.apply(
        p, c, k, num_iter, cfg_scale, 0.8,
        method=jm.sample_image_tokens))(setokim_params, jnp.asarray(cond),
                                        key)
    model = port_model(setokim_params)
    steps = model.diffloss.gen_diffusion.num_timesteps
    draws = jax_image_draws(key, 2, seq_len, 32, num_iter, steps,
                            cfg_scale != 1.0)
    got = model.sample_image_tokens(torch.from_numpy(cond), None, num_iter,
                                    cfg_scale, 0.8, draws=draws)
    assert got.shape == (2, seq_len, 32)
    assert max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_image_matches_jax(setokim_params, cfg_scale):
    """generate_image first splits its key (k1, _) and samples from k1."""
    num_iter, seq_len = 3, 8
    cond = span(16, 1, seq_len)
    rng = jax.random.PRNGKey(17)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    want = jgen.generate_image(jm, setokim_params, jnp.asarray(cond), rng,
                               num_iter, cfg_scale)
    model = port_model(setokim_params)
    k1, _ = jax.random.split(rng)
    draws = jax_image_draws(k1, 1, seq_len, 32, num_iter,
                            model.diffloss.gen_diffusion.num_timesteps,
                            cfg_scale != 1.0)
    got = tgen.generate_image(model, torch.from_numpy(cond), None, num_iter,
                              cfg_scale, draws=draws)
    assert got.shape == (1, 32, 32, 3) == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


def test_generate_renders_every_span_as_jax(setokim_params):
    """Greedy generate with markers taken from the stream itself: the same
    ids and spans as the JAX generate, and one image of the detokenizer's
    shape for each non-empty span, in order."""
    ids, images = prompts(21)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    args = (jnp.asarray(ids), jnp.asarray(images))
    first, _ = jgen.generate(jm, setokim_params, *args, max_new_tokens=10,
                             eos_id=-1)
    start, end = int(first[0, 1]), int(first[0, 4])
    assert start != end
    want_ids, want_imgs = jgen.generate(
        jm, setokim_params, *args, max_new_tokens=10, eos_id=-1,
        im_start_id=start, im_end_id=end, num_iter=2)
    model = port_model(setokim_params)
    got_ids, got_imgs = tgen.generate(
        model, torch.from_numpy(ids), torch.from_numpy(images),
        max_new_tokens=10, eos_id=-1, im_start_id=start, im_end_id=end,
        num_iter=2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    spans = [[(s, e) for s, e in jgen.find_image_spans(row, start, end)
              if e > s] for row in got_ids]
    assert spans[0], "no span to render"
    assert [len(r) for r in got_imgs] == [len(r) for r in want_imgs] == [
        len(s) for s in spans]
    for got_row, want_row in zip(got_imgs, want_imgs):
        for g, w in zip(got_row, want_row):
            assert g.shape == np.asarray(w).shape == (32, 32, 3)
            assert np.isfinite(g).all()


def test_generation_adds_no_parameters(setokim_params):
    """The sampling schedule is a table, not a parameter: the tree of a
    Setokim that sampled image tokens still loads strictly, and the port's
    state holds nothing of `gen_diffusion`."""
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    _, state = jm.apply(setokim_params, jnp.asarray(span(18, 1, 4)),
                        jax.random.PRNGKey(0), 2, 2.0,
                        method=jm.sample_image_tokens, mutable=True)
    assert set(state) <= {"params"}
    model = port_model(setokim_params)
    assert not [k for k in model.state_dict() if "gen_diffusion" in k]
    assert model.diffloss.gen_diffusion.num_timesteps == 4
