"""Gaussian diffusion (IDDPM/DiT lineage): the schedule and the training
loss of the MAR head.

The counterpart of `setok_tpu/diffusion/gaussian.py`: the schedule tables
in numpy float64 (`betas_for_alpha_bar`, `get_named_beta_schedule`,
`space_timesteps`, `create_diffusion`, respacing included), `q_sample`,
`q_posterior_mean_variance`, `training_losses` (epsilon prediction, MSE
plus the variational-bound term of the learned-range variance) and the
samplers `p_sample`, `p_sample_loop` and `ddim_sample_loop`.

The noise is always an argument: the caller draws it (losses/diffloss.py),
so that the same draws give the same result in both packages. A sampling
loop takes its initial noise and `step_noise(i)`, the noise of its i-th
step (timestep T-1-i), which may draw on the fly from a generator or read
a tensor of replayed draws. Where the JAX package scans, the loops here are
Python loops over the respaced steps; each step reads the tables from a
per-device copy made once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]  # (x_t, t, cond) -> model output
StepNoise = Callable[[int], torch.Tensor]  # loop step i -> noise like x


def betas_for_alpha_bar(num_steps: int, alpha_bar,
                        max_beta=0.999) -> np.ndarray:
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name in ("cosine", "squaredcos_cap_v2"):
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The subset of the original timesteps a respaced schedule keeps."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer "
                "stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into "
                             f"{count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of data scaled to [-1, 1] under a discretised
    Gaussian (bins of 2/255)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


@dataclass
class GaussianDiffusion:
    """Epsilon-prediction diffusion with learned-range variance; with
    `timestep_map` (respaced) model timesteps map back to the original
    scale."""

    betas: np.ndarray
    learn_sigma: bool = True
    timestep_map: Optional[np.ndarray] = None

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        assert (betas > 0).all() and (betas <= 1).all()
        self.num_timesteps = len(betas)

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod
                                                   - 1)
        self.posterior_variance = (betas * (1.0 - self.alphas_cumprod_prev)
                                   / (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.posterior_mean_coef1 = (betas * np.sqrt(self.alphas_cumprod_prev)
                                     / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = ((1.0 - self.alphas_cumprod_prev)
                                     * np.sqrt(alphas)
                                     / (1.0 - self.alphas_cumprod))
        self._betas = betas
        self._log_betas = np.log(betas)
        self._fixed_large_variance = np.append(self.posterior_variance[1],
                                               betas[1:])
        # (id(table), dtype, device) -> (table, its tensor on that device)
        self._on_device: Dict[Tuple, Tuple[np.ndarray, torch.Tensor]] = {}

    # -- helpers ------------------------------------------------------------
    def _table(self, arr: np.ndarray, dtype, device) -> torch.Tensor:
        """A table as a tensor on `device`, copied there once (the entry
        holds the array, so its id stays its own)."""
        key = (id(arr), dtype, torch.device(device))
        hit = self._on_device.get(key)
        if hit is None:
            hit = (arr, torch.as_tensor(arr, dtype=dtype, device=device))
            self._on_device[key] = hit
        return hit[1]

    def _extract(self, arr: np.ndarray, t: torch.Tensor,
                 ndim: int) -> torch.Tensor:
        """The float32 table entries of the (N,) timesteps, shaped to
        broadcast over (N, ...)."""
        out = self._table(arr, torch.float32, t.device)[t]
        return out.reshape(t.shape[0], *([1] * (ndim - 1)))

    def _model_t(self, t: torch.Tensor) -> torch.Tensor:
        if self.timestep_map is None:
            return t
        return self._table(self.timestep_map, t.dtype, t.device)[t]

    # -- q distributions ----------------------------------------------------
    def q_sample(self, x_start, t, noise):
        nd = x_start.dim()
        return (self._extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + self._extract(self.sqrt_one_minus_alphas_cumprod, t, nd)
                * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.dim()
        mean = (self._extract(self.posterior_mean_coef1, t, nd) * x_start
                + self._extract(self.posterior_mean_coef2, t, nd) * x_t)
        var = self._extract(self.posterior_variance, t, nd)
        log_var = self._extract(self.posterior_log_variance_clipped, t, nd)
        return mean, var, log_var

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.dim()
        return (self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd)
                * eps)

    # -- p distribution -----------------------------------------------------
    def p_mean_variance(self, model: ModelFn, x, t, clip_denoised=False,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        """Mean and variance of p(x_{t-1} | x_t) from the model output."""
        model_kwargs = model_kwargs or {}
        nd = x.dim()
        out = model(x, self._model_t(t), **model_kwargs)
        if self.learn_sigma:
            eps, var_values = out.chunk(2, dim=1)
            min_log = self._extract(self.posterior_log_variance_clipped, t,
                                    nd)
            max_log = self._extract(self._log_betas, t, nd)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            eps = out
            model_variance = self._extract(self._fixed_large_variance, t, nd)
            model_log_variance = torch.log(model_variance)
        pred_xstart = self._predict_xstart_from_eps(x, t, eps)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": mean, "variance": model_variance,
                "log_variance": model_log_variance,
                "pred_xstart": pred_xstart, "eps": eps}

    def p_sample(self, model: ModelFn, x, t, noise, clip_denoised=False,
                 model_kwargs=None, temperature=1.0):
        """One step x_t → x_{t-1} with the given noise (like x), scaled by
        `temperature`; rows at t = 0 take the mean."""
        out = self.p_mean_variance(model, x, t, clip_denoised, model_kwargs)
        nonzero = (t != 0).to(x.dtype).reshape(
            t.shape[0], *([1] * (x.dim() - 1)))
        return (out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"])
                * noise * temperature)

    def _loop(self, shape, noise: torch.Tensor, step_noise: StepNoise,
              step) -> torch.Tensor:
        """x from `noise`, then step(x, t, step_noise(i)) for t = T-1 .. 0."""
        x = noise
        for i in range(self.num_timesteps):
            t = torch.full((shape[0],), self.num_timesteps - 1 - i,
                           dtype=torch.int32, device=x.device)
            x = step(x, t, step_noise(i))
        return x

    def p_sample_loop(self, model: ModelFn, shape, noise: torch.Tensor,
                      step_noise: StepNoise, clip_denoised=False,
                      model_kwargs=None, temperature=1.0) -> torch.Tensor:
        """Ancestral sampling over every (respaced) step from `noise`."""
        return self._loop(shape, noise, step_noise, lambda x, t, z: (
            self.p_sample(model, x, t, z, clip_denoised, model_kwargs,
                          temperature)))

    def ddim_sample_loop(self, model: ModelFn, shape, noise: torch.Tensor,
                         step_noise: StepNoise, clip_denoised=False,
                         model_kwargs=None, eta=0.0) -> torch.Tensor:
        """DDIM sampling over every (respaced) step; `eta` scales its
        noise (0: deterministic)."""
        def step(x, t, z):
            out = self.p_mean_variance(model, x, t, clip_denoised,
                                       model_kwargs)
            eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
            nd = x.dim()
            alpha_bar = self._extract(self.alphas_cumprod, t, nd)
            alpha_bar_prev = self._extract(self.alphas_cumprod_prev, t, nd)
            sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
            nonzero = (t != 0).to(x.dtype).reshape(
                t.shape[0], *([1] * (nd - 1)))
            return mean_pred + nonzero * sigma * z
        return self._loop(shape, noise, step_noise, step)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.dim()
        return ((self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                 - pred_xstart)
                / self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    # -- training -----------------------------------------------------------
    def _vb_terms_bpd(self, frozen_out, x_start, x_t, t):
        """The variational-bound term in bits per dimension, from a
        precomputed model output."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(
            x_start, x_t, t)
        out = self.p_mean_variance(lambda *a, **k: frozen_out, x_t, t,
                                   clip_denoised=False)
        kl = _mean_flat(_normal_kl(true_mean, true_log_var, out["mean"],
                                   out["log_variance"])) / np.log(2.0)
        decoder_nll = _mean_flat(-_discretized_gaussian_log_likelihood(
            x_start, means=out["mean"],
            log_scales=0.5 * out["log_variance"])) / np.log(2.0)
        return torch.where(t == 0, decoder_nll, kl)

    def training_losses(self, model: ModelFn, x_start, t, noise,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        """Per-sample loss terms (N,) at timesteps t with the given noise:
        MSE on epsilon, plus the variational bound (through the variance
        only) for a learned sigma."""
        model_kwargs = model_kwargs or {}
        x_t = self.q_sample(x_start, t, noise)
        out = model(x_t, self._model_t(t), **model_kwargs)
        terms: Dict[str, torch.Tensor] = {}
        if self.learn_sigma:
            eps, var_values = out.chunk(2, dim=1)
            frozen = torch.cat([eps.detach(), var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(frozen, x_start, x_t, t)
        else:
            eps = out
        terms["mse"] = _mean_flat((noise - eps) ** 2)
        terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        return terms


def create_diffusion(timestep_respacing: Union[str, Sequence[int], None],
                     noise_schedule: str = "linear",
                     learn_sigma: bool = True,
                     diffusion_steps: int = 1000) -> GaussianDiffusion:
    """The configurations the reference uses: MSE loss, epsilon
    prediction, optional respacing."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        return GaussianDiffusion(betas=betas, learn_sigma=learn_sigma)
    use_timesteps = sorted(space_timesteps(diffusion_steps,
                                           timestep_respacing))
    last_alpha_cumprod = 1.0
    alphas_cumprod = np.cumprod(1.0 - betas)
    new_betas = []
    for i in use_timesteps:
        new_betas.append(1 - alphas_cumprod[i] / last_alpha_cumprod)
        last_alpha_cumprod = alphas_cumprod[i]
    return GaussianDiffusion(betas=np.array(new_betas),
                             learn_sigma=learn_sigma,
                             timestep_map=np.array(use_timesteps))
