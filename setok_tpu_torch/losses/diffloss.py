"""DiffLoss: the MAR diffusion head's per-token denoising loss.

The counterpart of `setok_tpu/losses/diffloss.py`: `SimpleMLPAdaLN` under
the 1000-step cosine schedule with a learned-range variance. Each random
function is split in two: `draw` makes the timesteps and the noise from an
explicit `torch.Generator`, and `forward(target, z, mask, t=, noise=)` is
the pure compute on those draws (the tests feed it the JAX package's draws).

`sample` (the respaced sampler with classifier-free guidance) waits with
image generation: ROADMAP.md, Queue A (image rendering through the
diffusion head).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from setok_tpu_torch.config import DiffLossConfig
from setok_tpu_torch.diffusion.gaussian import GaussianDiffusion, create_diffusion
from setok_tpu_torch.models.diffmlp import SimpleMLPAdaLN


class DiffLoss(nn.Module):
    def __init__(self, cfg: DiffLossConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.net = SimpleMLPAdaLN(cfg.target_channels, cfg.width,
                                  cfg.target_channels * 2, cfg.z_channels,
                                  cfg.depth, dtype=dtype, device=device)
        self.train_diffusion: GaussianDiffusion = create_diffusion(
            timestep_respacing="", noise_schedule="cosine")

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
                noise: torch.Tensor) -> torch.Tensor:
        """target/z: (N, C)/(N, Z); mask: (N,) weights → the scalar loss,
        the mask-weighted mean of the per-token terms."""
        terms = self.train_diffusion.training_losses(
            self.net, target.float(), t, noise, model_kwargs={"c": z})
        loss = terms["loss"]
        if mask is not None:
            loss = (loss * mask).sum() / mask.sum().clamp_min(1.0)
        return loss.mean()

    def sample(self, *args, **kwargs):
        raise NotImplementedError(
            "DiffLoss.sample: ROADMAP.md, Queue A (image rendering through "
            "the diffusion head)")
