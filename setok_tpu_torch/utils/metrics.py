"""Reconstruction quality: PSNR, SSIM and FID.

The counterparts of `psnr` and `ssim` in `setok_tpu/utils/metrics.py`, for
NHWC images in [-1, 1] (data range 2). SSIM takes the standard 11×11
Gaussian window (sigma 1.5) over each channel, VALID. Its filter must not
run in a reduced precision: the variance terms filt(x·x) − mu² cancel, so
TF32 on the card (or bf16 passes on the TPU, where such a filter read
0.2249 against a true 0.3626) skews them. The filter sums in float64,
which no TF32 setting touches, and rounds once to float32.

`FIDStats`, `frechet_distance` and `compute_fid` are the JAX package's FID
machinery, in numpy float64 as there: streaming mean and covariance of any
feature extractor's vectors, and the Fréchet distance through the square
roots of symmetric matrices by `eigh`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# FID


class FIDStats:
    """Streaming mean/covariance accumulator for feature vectors."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, unbiased covariance)."""
        mu = self.sum / self.n
        cov = self.outer / self.n - np.outer(mu, mu)
        cov *= self.n / max(self.n - 1, 1)
        return mu, cov


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Square root of a (near-)PSD symmetric matrix via eigh, the negative
    eigenvalues of rounding clipped to 0."""
    vals, vecs = np.linalg.eigh((a + a.T) / 2)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID between two gaussians: ‖μ1−μ2‖² + Tr(C1+C2−2(C1C2)^½), the
    cross term as Tr((S1 C2 S1)^½) with S1 = C1^½."""
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1)
    cross = _sqrtm_psd(s1 @ cov2 @ s1)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(cross))


def compute_fid(real_images, fake_images,
                feature_fn: Callable[[np.ndarray], np.ndarray],
                batch_size: int = 32) -> float:
    """FID over two image sets with any feature extractor (numpy batches
    in, (B, D) features out)."""
    def stats(images):
        acc: Optional[FIDStats] = None
        for i in range(0, len(images), batch_size):
            f = np.asarray(feature_fn(images[i:i + batch_size]))
            if acc is None:
                acc = FIDStats(f.shape[1])
            acc.update(f)
        return acc.finalize()

    mu1, c1 = stats(real_images)
    mu2, c2 = stats(fake_images)
    return frechet_distance(mu1, c1, mu2, c2)
