"""Reconstruction quality: PSNR and SSIM.

The counterparts of `psnr` and `ssim` in `setok_tpu/utils/metrics.py`, for
NHWC images in [-1, 1] (data range 2). SSIM takes the standard 11×11
Gaussian window (sigma 1.5) over each channel, VALID. Its filter must not
run in a reduced precision: the variance terms filt(x·x) − mu² cancel, so
TF32 on the card (or bf16 passes on the TPU, where such a filter read
0.2249 against a true 0.3626) skews them. The filter sums in float64,
which no TF32 setting touches, and rounds once to float32.
The FID machinery waits with `scripts/eval_recon.py` (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    mse = ((pred.float() - target.float()) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def gaussian_window(size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    """(size, size) normalised Gaussian, the outer product of the 1-D
    window, in float32."""
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Each channel of (B, H, W, C) through the window, VALID → (B, C, h,
    w) float32, the sums in float64."""
    b, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    y = F.conv2d(x.double(), win.double()[None, None]).float()
    return y.reshape(b, c, *y.shape[2:])


def ssim(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM over a batch of (B, H, W, C) images; every product in
    float32, whatever the inputs' type."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = gaussian_window(device=pred.device)
    pred, target = pred.float(), target.float()
    mu_x, mu_y = _filter(pred, win), _filter(target, win)
    xx = _filter(pred * pred, win) - mu_x ** 2
    yy = _filter(target * target, win) - mu_y ** 2
    xy = _filter(pred * target, win) - mu_x * mu_y
    s = (((2 * mu_x * mu_y + c1) * (2 * xy + c2))
         / ((mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)))
    return s.mean()
