"""LPIPS perceptual distance: VGG-16 feature taps and learned 1×1 heads.

The counterpart of `setok_tpu/losses/lpips.py`, built by hand (the port
has no torchvision and no weights): the VGG-16 `features` stack (3×3
convolutions with padding 1, ReLU, 2×2 max pools), tapped after relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3; the scaling layer's shift and scale;
each tap unit-normalised over its channels, the squared difference through
a bias-free 1×1 head, averaged over space and summed over the taps; the
batch mean. Inputs NHWC in [-1, 1], computed in float32 as the JAX package
does. The perceptual net is frozen: the stage-1 trainer gives it to no
optimizer. Weights come from a flax tree (`utils/from_flax.py`) or a seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.losses.gan import Conv2d
from setok_tpu_torch.utils.device import resolve_device

# torchvision vgg16.features; "M" = 2×2 max pool
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512)
# the taps, as counts of convolutions: relu1_2, 2_2, 3_3, 4_3, 5_3
SLICE_ENDS = (2, 4, 7, 10, 13)
CHANNELS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG-16 trunk (`conv_0` .. `conv_12`); NCHW in, the five taps
    out."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        cin, idx = 3, 0
        for v in VGG_CFG:
            if v != "M":
                self.add_module(f"conv_{idx}", Conv2d(
                    cin, v, 3, padding=1, dtype=dtype, device=device))
                cin, idx = v, idx + 1

    def forward(self, x: torch.Tensor) -> list:
        taps, idx = [], 0
        for v in VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{idx}")(x))
                idx += 1
                if idx in SLICE_ENDS:
                    taps.append(x)
        return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit norm over the channels (dim 1)."""
    return x / (torch.sqrt((x ** 2).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance of two (B, H, W, 3) batches → a scalar."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.vgg = VGG16Features(dtype=dtype, device=device)
        for i, c in enumerate(CHANNELS):
            self.add_module(f"lin_{i}", Conv2d(c, 1, 1, bias=False,
                                               dtype=dtype, device=device))
        self.register_buffer("shift", torch.tensor(
            SHIFT, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(
            SCALE, device=device).view(1, 3, 1, 1), persistent=False)

    def forward(self, pred: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        def taps(x):
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            return self.vgg((x - self.shift.to(self.dtype))
                            / self.scale.to(self.dtype))

        total = 0.0
        for i, (fp, ft) in enumerate(zip(taps(pred), taps(target))):
            diff = (_unit_normalize(fp) - _unit_normalize(ft)) ** 2
            total = total + getattr(self, f"lin_{i}")(diff).mean(
                dim=(1, 2, 3))
        return total.mean()
