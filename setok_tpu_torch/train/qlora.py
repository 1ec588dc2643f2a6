"""QLoRA: an int8 frozen trunk under float LoRA adapters.

The counterpart of `setok_tpu/train/qlora.py`. `quantize_base` turns the
weight of every targeted trunk `Dense` (the linears `train/lora.py`
adapts) into int8 storage in place, quantised per output channel by
`kernels/quant.quantize_weight`, with its float32 scales in a (1, out)
buffer `qscale` beside it: the state dict keeps the names `from_flax` and
`utils/checkpoint` use ('<module>.weight', now int8, and
'<module>.qscale'), as the JAX package keeps its tree's structure and keys
the scales by path. At use the `Dense` forms `(q·s)` cast to the compute
type, plus the adapter product cast to that type (ops/blocks.Dense), the
JAX `dequantize` then `apply_lora`. The quantisation is weight-only: the
matmul is a float one and the gradients reach x and the adapters; the
w8a8 `quant_matmul` kernel (which also quantises activations) is not on
this path.

`dequantize` gives a state dict with float weights in place of the int8
ones (the merged, servable checkpoint of `Stage2Trainer.merged_params`).
`extract_overlay` / `apply_overlay` are the trainable float parameters by
name and their copy back into a model: here the optimizer updates the
model's parameters in place, so the overlay is a view of the model, not a
second tree.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from setok_tpu_torch.kernels.quant import quantize_weight
from setok_tpu_torch.train.lora import default_target_filter, lora_targets


@torch.no_grad()
def quantize_base(model: nn.Module,
                  target_filter: Callable[[str], bool] = default_target_filter
                  ) -> Dict[str, torch.Tensor]:
    """Quantise every targeted `Dense` weight to int8 in place (a frozen
    int8 parameter, its (1, out) float32 scales in the buffer `qscale`);
    returns {module name: scales}."""
    scales = {}
    for name, mod in lora_targets(model, target_filter).items():
        if mod.weight.dtype == torch.int8:
            raise ValueError(f"{name} is already quantised")
        qw = quantize_weight(mod.weight.detach())
        mod.weight = nn.Parameter(qw.values, requires_grad=False)
        mod.register_buffer("qscale", qw.scales[None].contiguous())
        scales[name] = mod.qscale
    return scales


def dequantize(state: Dict[str, torch.Tensor],
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A copy of the state dict with each int8 weight that has a `qscale`
    beside it replaced by `(q·s)` in `dtype`, and the scales left out."""
    out = {}
    for key, value in state.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "qscale":
            continue
        scale = state.get(f"{mod}.qscale")
        if leaf == "weight" and scale is not None:
            value = (value.float() * scale.t()).to(dtype)
        out[key] = value
    return out


def extract_overlay(model: nn.Module,
                    want: Callable[[str, torch.Tensor], bool]
                    ) -> Dict[str, nn.Parameter]:
    """The model's float parameters that `want(name, param)` selects, by
    name (the live parameters)."""
    return {name: p for name, p in model.named_parameters()
            if p.is_floating_point() and want(name, p)}


@torch.no_grad()
def apply_overlay(model: nn.Module,
                  overlay: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy the overlay's tensors into the model's parameters of the same
    names (strictly: each name must be a parameter of the model)."""
    params = dict(model.named_parameters())
    for name, value in overlay.items():
        params[name].copy_(value)
    return model
