"""Seeded random weights, the same on every device."""

from __future__ import annotations

import torch
from torch import nn

# parameters drawn from N(0, 0.02²), as their flax initializers are
_EMBEDDINGS = ("pos_embed", "mask_tokens")


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter from a CPU generator seeded with `seed`:
    matrices LeCun-normal (std 1/sqrt(fan_in)), embeddings N(0, 0.02²),
    LayerNorm weights 1, biases 0. The draw does not depend on the device
    the model lies on, so a model on the card and one on the CPU get the
    same weights."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _EMBEDDINGS:
            value = torch.randn(p.shape, generator=gen) * 0.02
        elif p.dim() == 2:
            value = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
        elif name.endswith("weight"):
            value = torch.ones(p.shape)
        else:
            value = torch.zeros(p.shape)
        p.copy_(value)
    return model
