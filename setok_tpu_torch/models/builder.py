"""Inference model loader: assemble a Setokim from checkpoints.

The counterpart of `setok_tpu/models/builder.py` `load_pretrained_model`,
with its signature and defaults, plus `device`. Its sources, in order:

  * `model_path`: a stage-2 checkpoint directory of the port's trainer
    (utils/checkpoint.py; `scripts/train_setokim.py --output-dir` writes
    `<dir>/checkpoints/<step>/`), given as that directory or as
    `<dir>/checkpoints`. Only the 'params' and 'lora' parts are read
    (`restore_lazy`): the optimizer's moments never leave the disk. Every
    parameter of the right shape is taken, as the JAX builder takes it,
    then the adapters are merged (W + alpha/r·(A@B)ᵀ);
  * `projector_path`: an `.npz` of flax-keyed arrays (`load_subtree`:
    a file written by either package's `save_subtree`), or a sequence of
    them loaded in turn (the six component files of
    `scripts/assemble_pretrained.py`: the JAX builder takes one);
  * `lora_path`: a flat {'<flax kernel path>/a', '.../b'} `.npz` in the
    JAX layout (`lora_from_flax`), merged at `lora_alpha / lora_r`;
  * `bits` 8 or 4: the trunk quantised at rest after every splice and
    merge (`quantize_trunk_weights`; int4 at group `quant_group` where the
    widths take it, with `clip_search` ratios), the model rebuilt with
    `weight_bits`.

`device` (None: the card) and `cache_kernel` (the int8-cache decode
kernel of the serving trunk, `Setokim(cache_kernel=)`) are the port's own
arguments.

Leaves that come from no file are drawn by `utils/init.init_setokim_random_`
from seed 0, not by flax's initialisers: a model assembled from partial
files differs from the JAX package's in those leaves. Returns the model
(its parameters live in it; the JAX builder returns (model, params)).

The component builders and weight helpers of the same JAX module, with its
names, arguments and errors: `build_vision_tower` (the SeTok tokenizer for
any SigLIP name, `ValueError` for every other), `build_vision_generator`
(the SeTok detokenizer), `get_obj_from_str` / `instantiate_from_config`
(the `{'target', 'params'}` contract), and `make_delta` / `apply_delta` /
`consolidate`, leaf by leaf over a state dict or any nested dict, list or
tuple of tensors (PyTorch's pytree `tree_map`, as the JAX functions map a
parameter tree with `jax.tree.map`).
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.models.llama import (quantize_trunk_weights,
                                          valid_quant_group)
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.train.lora import merge_lora
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import lora_from_flax
from setok_tpu_torch.utils.init import init_setokim_random_


def checkpoint_dir(model_path: str) -> str:
    """`model_path` when it holds steps, else `<model_path>/checkpoints`."""
    if ckpt.latest_step(model_path) is not None:
        return model_path
    return os.path.join(model_path, "checkpoints")


def lora_pairs(flat: dict) -> dict:
    """{'<module>.a': A, '<module>.b': B} → {module: (A, B)}."""
    out = {}
    for key, value in flat.items():
        name, ab = key.rsplit(".", 1)
        out.setdefault(name, {})[ab] = value
    return {name: (ab["a"], ab["b"]) for name, ab in out.items()}


def load_pretrained_model(model_path: str,
                          model_cfg: Optional[cfgs.SetokimConfig] = None,
                          lora_path: Optional[str] = None,
                          lora_r: int = 64, lora_alpha: float = 16.0,
                          projector_path=None,
                          target_token_id: int = 3,
                          pad_token_id: int = 0,
                          tiny: bool = False,
                          bits: int = 16,
                          quant_group: int = 128,
                          clip_search: int = 8,
                          device=None,
                          cache_kernel: bool = False) -> Setokim:
    """The Setokim of the given files (see the module docstring); '' or a
    path without checkpoints for `model_path` starts from the seed-0
    weights. `device`: None is the card."""
    cfg = model_cfg or (cfgs.tiny_setokim() if tiny else cfgs.base_setokim())
    model = Setokim(cfg, target_token_id=target_token_id,
                    pad_token_id=pad_token_id, cache_kernel=cache_kernel,
                    device=device)
    init_setokim_random_(model, seed=0)

    if model_path:
        ckpt_dir = checkpoint_dir(model_path)
        step = ckpt.latest_step(ckpt_dir)
        if step is not None:
            restored = ckpt.restore_lazy(
                ckpt_dir, ckpt.root_predicate("params", "lora"), step,
                map_location=model.device)
            own = model.state_dict()
            params = {k: v for k, v in restored.get("params", {}).items()
                      if k in own and v.shape == own[k].shape}
            model.load_state_dict(params, strict=False)
            lora = lora_pairs(restored.get("lora", {}))
            if lora:
                model.load_state_dict(merge_lora(model.state_dict(), lora,
                                                 lora_alpha, lora_r))

    paths = ([projector_path] if isinstance(projector_path, str)
             else projector_path or [])
    for path in paths:
        ckpt.load_subtree(path, model)

    if lora_path and os.path.exists(lora_path):
        data = np.load(lora_path)
        tree = {}
        for key in data.files:
            path, ab = key.rsplit("/", 1)
            tree.setdefault(path, {})[ab] = data[key]
        lora = {name: (a.detach(), b.detach())
                for name, (a, b) in lora_from_flax(tree, model).items()}
        model.load_state_dict(merge_lora(model.state_dict(), lora,
                                         lora_alpha, lora_r))

    if bits in (8, 4):
        group = valid_quant_group(cfg.llama, quant_group) if bits == 4 else 0
        state = quantize_trunk_weights(
            model.state_dict(), bits=bits, group_size=group,
            clip_search=clip_search if bits == 4 else 0)
        device = model.device
        del model
        model = Setokim(cfg, target_token_id=target_token_id,
                        pad_token_id=pad_token_id, weight_bits=bits,
                        quant_group=group, cache_kernel=cache_kernel,
                        device=device)
        model.load_state_dict(state)
    return model


def build_vision_tower(vision_tower_name: str,
                       tokenizer_cfg: Optional[cfgs.TokenizerConfig] = None,
                       **kw):
    """The SeTok tokenizer for a SigLIP-family name (`tokenizer_cfg`, else
    `base_tokenizer()`); `kw` goes to `SetokTokenizer` (`device`: None is
    the card). Any other name raises `ValueError`."""
    from setok_tpu_torch.models.tokenizer import SetokTokenizer
    if "siglip" in vision_tower_name.lower():
        return SetokTokenizer(tokenizer_cfg or cfgs.base_tokenizer(), **kw)
    raise ValueError(f"Unknown vision tower: {vision_tower_name}")


def build_vision_generator(detokenizer_cfg: Optional[
        cfgs.DetokenizerConfig] = None, **kw):
    """The SeTok detokenizer (`detokenizer_cfg`, else
    `base_detokenizer()`); `kw` goes to `SetokDeTokenizer`."""
    from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
    return SetokDeTokenizer(detokenizer_cfg or cfgs.base_detokenizer(), **kw)


def get_obj_from_str(string: str, reload: bool = False):
    """The object named by a dotted path, 'package.module.Name'."""
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: dict):
    """`target(**params)` of a {'target': ..., 'params': {...}} dict."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    return get_obj_from_str(config["target"])(**config.get("params", {}))


def make_delta(base_params: Any, target_params: Any) -> Any:
    """target - base, leaf by leaf (trees of another structure raise
    `ValueError`, as `jax.tree.map`'s do)."""
    return tree_map(lambda t, b: t - b, target_params, base_params)


def apply_delta(base_params: Any, delta: Any) -> Any:
    """base + delta, leaf by leaf."""
    return tree_map(lambda b, d: b + d, base_params, delta)


def consolidate(params: Any, dtype=torch.float16) -> Any:
    """Every array leaf (a tensor, or a numpy array, which becomes a
    tensor) cast to `dtype`, for a single-file export; other leaves as
    they are."""
    def cast(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dtype) if isinstance(x, torch.Tensor) else x
    return tree_map(cast, params)
