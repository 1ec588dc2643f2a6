"""Carry SeTok weights from the flax parameter tree into the port.

The port's modules carry the flax module names (`block_0`, `attn_1`,
`layer_0/cross_attn`, ...), so a flax path maps to a state-dict key by
joining it with dots, after these conversions:

  * a Dense `kernel (in, out)` becomes `weight = kernel.T`;
  * the patch-embed Conv `kernel (p, p, 3, C)` (HWIO) becomes the
    `(C, p·p·3)` weight of the patchify matmul;
  * a LayerNorm `scale` / `bias` becomes `weight` / `bias`;
  * `pos_embed` and `mask_tokens` copy as they are.

`load_flax_params` is strict: every flax leaf fills exactly one parameter,
and every parameter of the model is filled, with the same shape.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax tree of arrays (as from `jax.tree.map(np.asarray, params)`)
    → a state dict of float32 tensors."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        if path and path[0] == "params":
            path = path[1:]
        *mod, leaf = path
        if leaf == "kernel":
            leaf = "weight"
            if value.ndim == 4:                 # HWIO conv → patchify matmul
                value = value.reshape(-1, value.shape[-1])
            if value.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{value.shape}")
            value = value.T
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join([*mod, leaf])
        if key in state:
            raise KeyError(f"two flax leaves map to {key}")
        state[key] = torch.tensor(value, dtype=torch.float32)
    return state


def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Fill every parameter of `model` from the flax tree, strictly."""
    state = from_flax(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"flax tree and model differ: missing {missing[:8]} "
                       f"({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: flax shape {tuple(value.shape)} vs "
                             f"model {tuple(own[key].shape)}")
    model.load_state_dict(state, strict=True)
    return model
