"""Multimodal projectors (vision ↔ language adapters).

The counterpart of `setok_tpu/models/projector.py`: 'linear', 'mlp{N}x_gelu'
and 'mlp', each with an optional '_Norm' LayerNorm prefix, and 'identity'.
The GELU between the layers is flax's default `nn.gelu`, the tanh form.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.ops.blocks import Dense, LayerNorm


class MLPProjector(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, depth: int = 2,
                 pre_norm: bool = False, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.depth = depth
        # torch's default eps, as the reference's LayerNorm has
        self.pre_norm = (LayerNorm(in_dim, eps=1e-5, dtype=dtype,
                                   device=device) if pre_norm else None)
        for i in range(depth):
            self.add_module(f"fc_{i}", Dense(in_dim if i == 0 else out_dim,
                                             out_dim, dtype=dtype,
                                             device=device))

    def forward(self, x):
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        for i in range(self.depth):
            if i > 0:
                x = F.gelu(x, approximate="tanh")
            x = getattr(self, f"fc_{i}")(x)
        return x


class IdentityProjector(nn.Module):
    def forward(self, x):
        return x


def build_projector(projector_type: str, in_dim: int, out_dim: int, *,
                    dtype=torch.float32, device=None) -> nn.Module:
    """The JAX package's dispatch on the projector type string."""
    t = projector_type
    pre_norm = t.startswith("_Norm") or t.endswith("_Norm")
    t = t.replace("_Norm", "")
    if t == "identity":
        return IdentityProjector()
    depth = {"linear": 1, "mlp": 2}.get(t)
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        depth = int(m.group(1))
    if depth is None:
        raise ValueError(f"Unknown projector type: {projector_type}")
    return MLPProjector(in_dim, out_dim, depth, pre_norm, dtype=dtype,
                        device=device)
