"""Structured synthetic images for stage-1 runs without a dataset.

The counterpart of `setok_tpu/utils/synthetic.py`, the same numpy draws:
3-6 random rectangles and ellipses over a linear colour gradient, a
learnable structure (unlike uniform noise), deterministic per (n, seed).
"""

from __future__ import annotations

import numpy as np


def structured_image(size: int, rng: np.random.RandomState) -> np.ndarray:
    """One (size, size, 3) float32 image in [-1, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    c0, c1 = rng.rand(3), rng.rand(3)
    t = (xx * rng.uniform(-1, 1) + yy * rng.uniform(-1, 1) + 1.0) / 2.0
    img = c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]
    for _ in range(rng.randint(3, 7)):
        color = rng.rand(3)
        cx, cy = rng.uniform(0.1, 0.9, 2)
        w, h = rng.uniform(0.08, 0.4, 2)
        if rng.rand() < 0.5:       # rectangle
            m = (np.abs(xx - cx) < w / 2) & (np.abs(yy - cy) < h / 2)
        else:                      # ellipse
            m = (((xx - cx) / (w / 2)) ** 2
                 + ((yy - cy) / (h / 2)) ** 2) < 1.0
        img = np.where(m[..., None], color[None, None], img)
    return (img * 2.0 - 1.0).astype(np.float32)


def structured_images(n: int, size: int, seed: int = 0) -> np.ndarray:
    """(n, size, size, 3) float32 in [-1, 1]; image i from seed + i."""
    return np.stack([structured_image(size, np.random.RandomState(seed + i))
                     for i in range(n)])
