"""The benchmark's images: piecewise-flat structured images from a seed.

`structured_image` is a frozen copy of the port's synthetic generator
(`setok_tpu_torch/utils/synthetic.py`, itself the JAX package's numpy
draws): 3-6 random rectangles and ellipses over a linear colour gradient.
The benchmark keeps its own copy so that the traffic cannot change when
the program does. Each image gets its own RandomState, seeded from
(`seed`, image index) through a SeedSequence, so any whole-number seed
(also past 32 bits) gives the same pool on every machine.
"""

from __future__ import annotations

import numpy as np
import torch


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


def image_rng(seed: int, index: int) -> np.random.RandomState:
    """The RandomState of image `index` of the pool drawn from `seed`."""
    state = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return np.random.RandomState(int(state))


def image_pool(seed: int, n_batches: int, batch: int, size: int,
               pin: bool) -> list:
    """`n_batches` distinct batches of (batch, size, size, 3) float32 images,
    each a host tensor (pinned when `pin`, for asynchronous uploads)."""
    pool = []
    for j in range(n_batches):
        arr = np.stack([structured_image(size, image_rng(seed, j * batch + i))
                        for i in range(batch)])
        t = torch.from_numpy(arr)
        pool.append(t.pin_memory() if pin else t)
    return pool
