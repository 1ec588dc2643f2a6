"""PatchGAN adversarial loss with the adaptive generator weight.

The counterpart of `setok_tpu/losses/gan.py`: `NLayerDiscriminator` (4×4
convolutions of stride 2 from 64 channels, then a stride-1 one and the
1-channel logit map; GroupNorm with one group and eps 1e-6 where the
pix2pix stack has BatchNorm; leaky ReLU 0.2), in the compute type with
float32 parameters; the hinge and vanilla discriminator losses;
`adopt_weight`, the warm-up factor; `generator_loss`; and
`adaptive_weight`, ‖∇rec‖ / (‖∇g‖ + 1e-4) clipped to [0, 1e4] and
detached, from the two gradients with respect to the decoder's last layer
(train/stage1.py takes them with `torch.autograd.grad` on the pixel head's
weight alone).

Images are NHWC, as everywhere in the port; the convolutions run on NCHW
(`F.conv2d`, no TF32 unless the caller allows it). The flax tree's
convolutions (HWIO kernels, padding 1) carry over through
`utils/from_flax.py`.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.config import GANLossConfig
from setok_tpu_torch.utils.device import resolve_device

GROUP_NORM_EPS = 1e-6         # flax nn.GroupNorm's default


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that computes in `dtype` (float32 parameters)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding)


class GroupNorm(nn.GroupNorm):
    """One-group GroupNorm: statistics in float32, output in `dtype`."""

    def __init__(self, channels: int, *, dtype=torch.float32, device=None):
        super().__init__(1, channels, eps=GROUP_NORM_EPS, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), 1, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: (B, H, W, C) images → (B, h, w, 1) logits.

    Modules as in the flax tree: `conv_in`, then `conv_n` / `norm_n` for
    n = 1 .. n_layers (stride 2, the last stride 1), then `conv_out`."""

    def __init__(self, n_layers: int = 3, ndf: int = 64, in_channels: int = 3,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_layers = n_layers
        self.dtype = dtype

        def conv(cin, cout, stride):
            return Conv2d(cin, cout, 4, stride=stride, padding=1, dtype=dtype,
                          device=device)

        self.conv_in = conv(in_channels, ndf, 2)
        prev = ndf
        for n in range(1, n_layers + 1):
            mult = min(2 ** n, 8)
            self.add_module(f"conv_{n}", conv(prev, ndf * mult,
                                              2 if n < n_layers else 1))
            self.add_module(f"norm_{n}", GroupNorm(ndf * mult, dtype=dtype,
                                                   device=device))
            prev = ndf * mult
        self.conv_out = conv(prev, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.leaky_relu(self.conv_in(x), 0.2)
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"conv_{n}")(x)
            x = F.leaky_relu(getattr(self, f"norm_{n}")(x), 0.2)
        return self.conv_out(x).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: Union[int, torch.Tensor],
                 threshold: int = 0, warm_up_end: int = 0,
                 value: float = 0.0) -> torch.Tensor:
    """The adversarial factor at `global_step`, a float32 scalar: `value`
    before `threshold`, then `weight`, ramped linearly from 0 between
    `threshold` and `warm_up_end` when warm_up_end > threshold."""
    step = torch.as_tensor(global_step, dtype=torch.float32)
    if step < threshold:
        return torch.full((), value, dtype=torch.float32)
    if step < warm_up_end and warm_up_end > threshold:
        return weight * (step - threshold) / max(warm_up_end - threshold, 1)
    return torch.full((), weight, dtype=torch.float32)


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)]."""
    return -logits_fake.mean()


def adaptive_weight(rec_grad: torch.Tensor, g_grad: torch.Tensor,
                    weight: float = 1.0) -> torch.Tensor:
    """‖rec_grad‖ / (‖g_grad‖ + 1e-4) of the two gradients with respect to
    the decoder's last layer, in at least float32, clipped to [0, 1e4],
    detached, times `weight`."""
    def norm(g):
        return g.to(torch.promote_types(g.dtype, torch.float32)).norm()

    w = norm(rec_grad) / (norm(g_grad) + 1e-4)
    return w.clamp(0.0, 1e4).detach() * weight


def discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                       global_step, cfg: GANLossConfig) -> torch.Tensor:
    """The discriminator's loss: its factor (no warm-up) times the hinge or
    vanilla loss."""
    loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    factor = adopt_weight(cfg.factor, global_step, threshold=cfg.disc_start)
    return factor * loss_fn(logits_real, logits_fake)
