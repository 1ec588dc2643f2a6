"""Reconstruction losses: the weighted MSE and the L1.

The counterparts of `setok_tpu/losses/mse.py`. Both compute in at least
float32, whatever the inputs' type.
"""

from __future__ import annotations

from typing import Optional

import torch


def _promoted(pred: torch.Tensor, target: torch.Tensor):
    dt = torch.promote_types(torch.promote_types(pred.dtype, target.dtype),
                             torch.float32)
    return pred.to(dt), target.to(dt)


def weighted_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                      loss_mask: Optional[torch.Tensor] = None,
                      weight: float = 1.0) -> torch.Tensor:
    """Mean squared error per sample over its last three axes; with a
    spatial `loss_mask` (over the last two), the masked sum over the mask's
    area + 1. The batch mean, times `weight`."""
    pred, target = _promoted(pred, target)
    err = (pred - target) ** 2
    if loss_mask is not None:
        err = err * loss_mask
        per_sample = err.sum(dim=(-2, -1)) / (loss_mask.sum(dim=(-2, -1))
                                              + 1.0)
    else:
        per_sample = err.mean(dim=(-3, -2, -1))
    return per_sample.mean() * weight


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (the stage-1 reconstruction term)."""
    pred, target = _promoted(pred, target)
    return (pred - target).abs().mean()
