"""Fixed 2-D sin-cos positional encodings, built in numpy as constants.

The same encoding as `setok_tpu/ops/posenc.py` (PositionalEncoding2D of the
reference SeTok): the first `ch = 2*ceil(channels/4)` channels encode the
row axis, the next `ch` the column axis, truncated to `channels`.
"""

from __future__ import annotations

import numpy as np
import torch


def _interleave_sin_cos(x: np.ndarray) -> np.ndarray:
    """stack(sin, cos) on the last axis and flatten."""
    emb = np.stack([np.sin(x), np.cos(x)], axis=-1)
    return emb.reshape(*x.shape[:-1], -1)


def posenc_2d(h: int, w: int, channels: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """2-D sin-cos positional encoding of shape (h, w, channels)."""
    ch = int(np.ceil(channels / 4) * 2)
    # inv_freq is a float32 buffer in the reference; round through float32
    # so that float64 runs match it bit for bit
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))
    inv_freq = inv_freq.astype(np.float32).astype(np.float64)
    pos_x = np.arange(h, dtype=np.float64)
    pos_y = np.arange(w, dtype=np.float64)
    emb_x = _interleave_sin_cos(np.einsum("i,j->ij", pos_x, inv_freq))
    emb_y = _interleave_sin_cos(np.einsum("i,j->ij", pos_y, inv_freq))
    emb = np.zeros((h, w, 2 * ch), dtype=np.float64)
    emb[:, :, :ch] = emb_x[:, None, :]
    emb[:, :, ch:2 * ch] = emb_y[None, :, :]
    return torch.as_tensor(emb[:, :, :channels]).to(device=device,
                                                     dtype=dtype)


def posenc_2d_flat(h: int, w: int, channels: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """The same encoding flattened to (h*w, channels)."""
    return posenc_2d(h, w, channels, dtype=dtype,
                     device=device).reshape(h * w, channels)
