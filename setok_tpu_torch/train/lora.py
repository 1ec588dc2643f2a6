"""LoRA adapters on the trunk's linears.

The counterpart of `setok_tpu/train/lora.py`. A LoRA tree is a dict
{module name: (A (in, r), B (r, out))} of parameters in the type of the
weight they adapt, in the JAX package's layout (its keys are the flax
kernel paths; `utils/from_flax.lora_from_flax` converts them). `init_lora`
draws A ~ N(0, 1)/√r and sets B = 0, so the adapted model starts at the
base.

`apply_lora` attaches the adapters to their `Dense` modules, which then form
`W + (alpha/r)·(A@B)ᵀ` at each use (ops/blocks.Dense), layer by layer; the
JAX package materialises the whole adapted tree before the forward instead.
The numerics are the same: the product cast to the weight's type and the
sum in that type (the dequantised compute type under QLoRA), then the cast
to the compute type. `merge_lora` writes the merged weights into a state
dict (a servable float checkpoint).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from setok_tpu_torch.ops.blocks import Dense

EXCLUDE_DEFAULT = ("vision_tower", "mm_in_projector", "mm_out_projector",
                   "vision_generator", "diffloss", "embed_tokens", "lm_head")

Lora = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def default_target_filter(name: str) -> bool:
    """Which linears get adapters: every one of the LLM trunk, none of the
    multimodal modules, the embeddings or the LM head."""
    return not any(ex in name for ex in EXCLUDE_DEFAULT)


def lora_targets(model: nn.Module,
                 target_filter: Callable[[str], bool] = default_target_filter
                 ) -> Dict[str, Dense]:
    """The `Dense` modules of `model` that the filter adapts, by name."""
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, Dense) and target_filter(name)}


def init_lora(model: nn.Module, generator: torch.Generator, rank: int,
              target_filter: Callable[[str], bool] = default_target_filter
              ) -> Lora:
    """A (in, r) ~ N(0, 1)/√r and B (r, out) = 0 for each target, on the
    model's device and in its weight's type (as the JAX `init_lora` draws
    them in the leaf's), drawn in module order from `generator`."""
    lora = {}
    for name, mod in lora_targets(model, target_filter).items():
        w = mod.weight
        a = (torch.randn((mod.in_features, rank), generator=generator,
                         device=w.device) / rank ** 0.5).to(w.dtype)
        b = torch.zeros((rank, mod.out_features), device=w.device,
                        dtype=w.dtype)
        lora[name] = (nn.Parameter(a), nn.Parameter(b))
    return lora


def apply_lora(model: nn.Module, lora: Lora, alpha: float,
               rank: int) -> nn.Module:
    """Attach each adapter to its `Dense` (scale alpha/rank); an empty
    `lora` detaches them all. Raises for a name that is no `Dense`."""
    mods = dict(model.named_modules())
    for mod in mods.values():
        if isinstance(mod, Dense):
            mod.__dict__["lora"] = None
    for name, (a, b) in lora.items():
        mod = mods.get(name)
        if not isinstance(mod, Dense):
            raise KeyError(f"LoRA target {name} is not a Dense of the model")
        if a.shape != (mod.in_features, rank) or b.shape != (
                rank, mod.out_features):
            raise ValueError(f"{name}: LoRA shapes {tuple(a.shape)}, "
                             f"{tuple(b.shape)} for a {mod.in_features} → "
                             f"{mod.out_features} linear at rank {rank}")
        mod.__dict__["lora"] = (a, b, alpha / rank)
    return model


@torch.no_grad()
def merge_lora(state: Dict[str, torch.Tensor], lora: Lora, alpha: float,
               rank: int) -> Dict[str, torch.Tensor]:
    """A copy of the state dict with W + (alpha/rank)·(A@B)ᵀ in place of
    each adapted weight, the product cast to W's type."""
    out = dict(state)
    for name, (a, b) in lora.items():
        key = f"{name}.weight"
        w = state[key]
        out[key] = w + (alpha / rank) * (a @ b).t().to(w.device, w.dtype)
    return out
