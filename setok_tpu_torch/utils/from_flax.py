"""Carry SeTok and Setokim weights from the flax parameter tree into the port.

The port's modules carry the flax module names (`block_0`, `attn_1`,
`layer_0/cross_attn`, `llama/model/layer_0/attn/q_proj`, ...), so a flax
path maps to a state-dict key by joining it with dots, after these
conversions:

  * a Dense `kernel (in, out)` becomes `weight = kernel.T`;
  * the patch-embed Conv `kernel (p, p, 3, C)` (HWIO) becomes the
    `(C, p·p·3)` weight of the patchify matmul;
  * any other Conv `kernel (kh, kw, in, out)` (HWIO: the discriminator's,
    LPIPS') becomes the `(out, in, kh, kw)` weight of `F.conv2d`;
  * a LayerNorm, RMSNorm or GroupNorm `scale` becomes `weight`;
  * an Embed `embedding (vocab, C)` becomes the `nn.Embedding` weight;
  * a `QuantDense` `q (in, out)` int8 and a `Quant4Dense` `p (in/2, out)`
    int8 stay int8, transposed to the (out, in) layout of the port's
    kernels; their scales `s` (1 or groups, out) copy as they are;
  * `pos_embed` and `mask_tokens` copy as they are.

Floating leaves become float32; integer leaves keep their type.
`load_flax_params` is strict: every flax leaf fills exactly one parameter
or buffer, and every one of the model's is filled, with the same shape and
type. `skip` names top-level subtrees the model does not hold; any other
unused leaf raises.

`lora_from_flax` carries the JAX package's LoRA tree ({flax kernel path:
{'a': (in, r), 'b': (r, out)}}, paths such as
"['params']['llama']['model']['layer_0']['attn']['q_proj']['kernel']") into
the port's adapters ({module name: (A, B)}, the same layout), strictly.

`load_stage1_flax` fills a stage-1 trainer from the JAX `Stage1State`'s
trees: `gen_params` {'setok', 'contrastive'[, 'text_encoder']},
`disc_params` and `lpips_params`, each strictly.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.ops.blocks import Dense


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def flax_state_key(path) -> str:
    """The state-dict key of a flax leaf path (a tuple of names, with or
    without the leading 'params')."""
    path = tuple(path)
    if path and path[0] == "params":
        path = path[1:]
    *mod, leaf = path
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join([*mod, leaf])


def from_flax(params, skip: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """A flax tree of arrays (as from `jax.tree.map(np.asarray, params)`)
    → a state dict: float32 tensors, and int8 ones for quantised weights.
    Leaves under a top-level subtree named in `skip` are left out."""
    skip = set(skip)
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        if path and path[0] == "params":
            path = path[1:]
        if path[0] in skip:
            continue
        leaf = path[-1]
        if leaf == "kernel":
            if value.ndim == 4 and path[-2] != "patch_embed":
                value = value.transpose(3, 2, 0, 1)    # HWIO → OIHW
            elif value.ndim == 4:               # HWIO conv → patchify matmul
                value = value.reshape(-1, value.shape[-1]).T
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{value.shape}")
        elif leaf in ("q", "p"):                # int8 (in or in/2, out)
            if value.ndim != 2 or value.dtype != np.int8:
                raise ValueError(f"{'/'.join(path)}: int8 matrix expected, "
                                 f"got {value.dtype} {value.shape}")
            value = value.T
        key = flax_state_key(path)
        if key in state:
            raise KeyError(f"two flax leaves map to {key}")
        value = np.array(value, order="C")     # 0-d leaves stay 0-d
        state[key] = (torch.from_numpy(value.copy())
                      if np.issubdtype(value.dtype, np.integer)
                      else torch.tensor(value, dtype=torch.float32))
    return state


def lora_from_flax(lora, model: nn.Module) -> Dict[str, tuple]:
    """The JAX LoRA tree → {module name: (A, B)} float32 parameters on the
    model's device. Every path must name a kernel of a `Dense` of `model`
    and its factors fit that linear; anything else raises."""
    mods = dict(model.named_modules())
    out = {}
    for path, ab in lora.items():
        keys = re.findall(r"\['([^']*)'\]", path)
        if keys[:1] == ["params"]:
            keys = keys[1:]
        name = ".".join(keys[:-1])
        mod = mods.get(name)
        if keys[-1:] != ["kernel"] or not isinstance(mod, Dense):
            raise KeyError(f"LoRA path {path} names no Dense kernel of the "
                           "model")
        a, b = (np.asarray(ab[k], np.float32) for k in ("a", "b"))
        if a.shape[0] != mod.in_features or b.shape[1] != mod.out_features \
                or a.shape[1] != b.shape[0]:
            raise ValueError(f"{path}: LoRA shapes {a.shape}, {b.shape} for "
                             f"a {mod.in_features} → {mod.out_features} "
                             "linear")
        dev = mod.weight.device
        out[name] = (nn.Parameter(torch.tensor(a, device=dev)),
                     nn.Parameter(torch.tensor(b, device=dev)))
    return out


def load_flax_params(model: nn.Module, params,
                     skip: Iterable[str] = ()) -> nn.Module:
    """Fill every parameter and buffer of `model` from the flax tree,
    strictly; `skip`: top-level subtrees the model does not hold."""
    state = from_flax(params, skip)
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
        if own[key].dtype != value.dtype:
            raise ValueError(f"{key}: flax type {value.dtype} vs model "
                             f"{own[key].dtype}")
    model.load_state_dict(state, strict=True)
    return model


def load_stage1_flax(trainer, gen_params, disc_params,
                     lpips_params=None):
    """Fill a `train.stage1.Stage1Trainer`'s modules from the JAX
    `Stage1State` trees (numpy leaves). The generator tree must hold
    exactly the trainer's parts ('setok', 'contrastive', and
    'text_encoder' when the trainer has one), and `lpips_params` must be
    given exactly when it has an LPIPS net."""
    parts = {"setok": trainer.model, "contrastive": trainer.contrastive}
    if trainer.text_encoder is not None:
        parts["text_encoder"] = trainer.text_encoder
    if set(gen_params) != set(parts):
        raise KeyError(f"gen_params holds {sorted(gen_params)}, the "
                       f"trainer {sorted(parts)}")
    if (lpips_params is None) != (trainer.lpips is None):
        raise KeyError("lpips_params must be given exactly when the "
                       "trainer has an LPIPS net")
    for name, module in parts.items():
        load_flax_params(module, gen_params[name])
    load_flax_params(trainer.disc, disc_params)
    if trainer.lpips is not None:
        load_flax_params(trainer.lpips, lpips_params)
    return trainer
