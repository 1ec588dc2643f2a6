"""DiffLoss: the MAR diffusion head's per-token denoising loss and its
sampler.

The counterpart of `setok_tpu/losses/diffloss.py`: `SimpleMLPAdaLN` under
the 1000-step cosine schedule with a learned-range variance for training
(`train_diffusion`), and the same schedule respaced to
`cfg.num_sampling_steps` for sampling (`gen_diffusion`). Each random
function is split in two: `draw` / `draw_sample` make the draws from an
explicit `torch.Generator`, and `forward(target, z, mask, t=, noise=)` /
`sample(z, ..., draws=)` compute on those draws (the tests feed them the
JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from setok_tpu_torch.config import DiffLossConfig
from setok_tpu_torch.diffusion.gaussian import (GaussianDiffusion, StepNoise,
                                                create_diffusion)
from setok_tpu_torch.models.diffmlp import SimpleMLPAdaLN
from setok_tpu_torch.parallel import comm


class SampleDraws(NamedTuple):
    """The draws of one `DiffLoss.sample` over N rows: `noise` the initial
    noise, (N, C), or (N/2, C) under guidance, where both halves share it;
    `step_noise(i)` the (N, C) noise of the sampler's i-th step."""
    noise: torch.Tensor
    step_noise: StepNoise


class DiffLoss(nn.Module):
    def __init__(self, cfg: DiffLossConfig, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.net = SimpleMLPAdaLN(cfg.target_channels, cfg.width,
                                  cfg.target_channels * 2, cfg.z_channels,
                                  cfg.depth, dtype=dtype,
                                  param_dtype=param_dtype, device=device)
        self.train_diffusion: GaussianDiffusion = create_diffusion(
            timestep_respacing="", noise_schedule="cosine")
        self.gen_diffusion: GaussianDiffusion = create_diffusion(
            timestep_respacing=cfg.num_sampling_steps,
            noise_schedule="cosine")

    def draw(self, n: int, generator: torch.Generator,
             device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t (N,) int64 in [0, T), noise (N, target_channels) float32)."""
        t = torch.randint(0, self.train_diffusion.num_timesteps, (n,),
                          generator=generator, device=device)
        noise = torch.randn((n, self.cfg.target_channels),
                            generator=generator, device=device)
        return t, noise

    def forward(self, target: torch.Tensor, z: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *, t: torch.Tensor,
                noise: torch.Tensor, count_group=None) -> torch.Tensor:
        """target/z: (N, C)/(N, Z); mask: (N,) weights → the scalar loss,
        the mask-weighted mean of the per-token terms (the mask's sum taken
        over the data ranks of `count_group`, where given)."""
        terms = self.train_diffusion.training_losses(
            self.net, target.float(), t, noise, model_kwargs={"c": z})
        loss = terms["loss"]
        if mask is not None:
            denom = comm.all_reduce_(mask.sum(), count_group)
            loss = (loss * mask).sum() / denom.clamp_min(1.0)
        return loss.mean()

    def draw_sample(self, n: int, use_cfg: bool,
                    generator: Optional[torch.Generator],
                    device) -> SampleDraws:
        """The draws of one `sample` over n rows from `generator`: the
        initial noise now, each step's noise when the sampler asks for it
        (a whole render's step noise is never held at once)."""
        c = self.cfg.target_channels
        noise = torch.randn((n // 2 if use_cfg else n, c),
                            generator=generator, device=device)
        return SampleDraws(noise, lambda i: torch.randn(
            (n, c), generator=generator, device=device))

    def sample(self, z: torch.Tensor, temperature: float = 1.0, cfg=1.0,
               use_cfg: Optional[bool] = None,
               draws: Optional[SampleDraws] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token latents conditioned on z: (N, Z) → (N, C), by ancestral
        sampling over `gen_diffusion`'s steps. Under guidance z is
        [cond; uncond] (the caller duplicates it) and the initial noise is
        shared by both halves. `cfg` may be a 0-dim tensor (a per-iteration
        scale); `use_cfg` then says whether to guide. Without `draws`, they
        are drawn from `generator`."""
        if use_cfg is None:
            use_cfg = not (isinstance(cfg, (int, float)) and cfg == 1.0)
        if draws is None:
            draws = self.draw_sample(z.shape[0], use_cfg, generator,
                                     z.device)
        noise = draws.noise
        if use_cfg:
            noise = torch.cat([noise, noise], dim=0)
            model = lambda x, t, c: self.net.forward_with_cfg(x, t, c, cfg)
        else:
            model = self.net
        return self.gen_diffusion.p_sample_loop(
            model, noise.shape, noise, draws.step_noise,
            clip_denoised=False, model_kwargs={"c": z},
            temperature=temperature)
