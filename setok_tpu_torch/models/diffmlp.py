"""SimpleMLPAdaLN: the MAR per-token diffusion denoiser.

The counterpart of `setok_tpu/models/diffmlp.py`, with its module names
(`input_proj`, `time_embed.fc1`, `cond_embed`, `res_{i}.adaLN`,
`res_{i}.in_ln`, `res_{i}.mlp_fc1`, `final_layer.linear`, ...) so that the
flax tree loads as a rename. It works on flat token vectors (N, C); each
linear computes in `dtype` on its `param_dtype` weight, the LayerNorms take
their statistics in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.ops.blocks import Dense, LayerNorm


def modulate(x, shift, scale):
    return x * (1 + scale) + shift


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of (N,) timesteps → (N, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 *, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = Dense(frequency_embedding_size, hidden_size, **kw)
        self.fc2 = Dense(hidden_size, hidden_size, **kw)

    def forward(self, t):
        x = timestep_embedding(t, self.frequency_embedding_size)
        return self.fc2(F.silu(self.fc1(x)))


class ResBlock(nn.Module):
    """AdaLN residual MLP block (the affine `in_ln`, eps 1e-6)."""

    def __init__(self, channels: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.adaLN = Dense(channels, 3 * channels, **kw)
        self.in_ln = LayerNorm(channels, eps=1e-6, **kw)
        self.mlp_fc1 = Dense(channels, channels, **kw)
        self.mlp_fc2 = Dense(channels, channels, **kw)

    def forward(self, x, y):
        shift, scale, gate = self.adaLN(F.silu(y)).chunk(3, dim=-1)
        h = modulate(self.in_ln(x), shift, scale)
        h = self.mlp_fc2(F.silu(self.mlp_fc1(h)))
        return x + gate * h


class FinalLayer(nn.Module):
    """DiT final layer: an affine-free LayerNorm (eps 1e-6), modulated."""

    def __init__(self, channels: int, out_channels: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.adaLN = Dense(channels, 2 * channels, **kw)
        self.linear = Dense(channels, out_channels, **kw)

    def forward(self, x, y):
        shift, scale = self.adaLN(F.silu(y)).chunk(2, dim=-1)
        x = F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(self.dtype)
        return self.linear(modulate(x, shift, scale))


class SimpleMLPAdaLN(nn.Module):
    """(N, in_channels) noisy tokens, (N,) timesteps, (N, z_channels)
    conditions → (N, out_channels) (2·in_channels: epsilon and the
    learned-range variance)."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, z_channels: int, num_res_blocks: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.in_channels = in_channels
        self.num_res_blocks = num_res_blocks
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.input_proj = Dense(in_channels, model_channels, **kw)
        self.time_embed = TimestepEmbedder(model_channels, **kw)
        self.cond_embed = Dense(z_channels, model_channels, **kw)
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", ResBlock(model_channels, **kw))
        self.final_layer = FinalLayer(model_channels, out_channels, **kw)

    def forward(self, x, t, c):
        x = self.input_proj(x)
        y = self.time_embed(t) + self.cond_embed(c)
        for i in range(self.num_res_blocks):
            x = getattr(self, f"res_{i}")(x, y)
        return self.final_layer(x, y)

    def forward_with_cfg(self, x, t, c, cfg_scale):
        """Classifier-free guidance: the batch is [cond; uncond] halves of
        the same latents (the first half of x is read for both), c the
        conditions of each half. The guided epsilon uncond + s·(cond −
        uncond) goes to both halves; the variance half passes through."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half], dim=0), t, c)
        eps, rest = out[:, :self.in_channels], out[:, self.in_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest],
                         dim=1)
