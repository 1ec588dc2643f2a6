"""Seeded random weights: the models' parameters and the LoRA adapters."""

from __future__ import annotations

import math

import torch
from torch import nn

from setok_tpu_torch.models.llama import quantize_linear
from setok_tpu_torch.ops.blocks import Quant4Dense, QuantDense
from setok_tpu_torch.train.lora import Lora, init_lora

# parameters drawn from N(0, 0.02²), as their flax initializers are
_EMBEDDINGS = ("pos_embed", "mask_tokens", "cls_token")
_NORMAL_002 = ("time_embed.fc1.weight", "time_embed.fc2.weight")
# the diffusion head's zero-initialised layers (its adaLN modulations and
# its final projection)
_ZEROS = ("adaLN.weight", "final_layer.linear.weight")


def _draw(name: str, shape, gen: torch.Generator, device,
          conv_std=None) -> torch.Tensor:
    """Matrices LeCun-normal (std 1/sqrt(fan_in)), convolution kernels
    (out, in, kh, kw) too (fan_in = in·kh·kw) unless `conv_std` is given
    (then N(0, conv_std²)), embeddings and the timestep MLP N(0, 0.02²),
    the diffusion head's modulations and final projection 0, norm weights 1,
    biases 0."""
    if name.endswith(_ZEROS):
        return torch.zeros(shape, device=device)
    if name.rsplit(".", 1)[-1] in _EMBEDDINGS or name.endswith(_NORMAL_002):
        return torch.randn(shape, generator=gen, device=device) * 0.02
    if len(shape) in (2, 4):
        std = (conv_std if conv_std is not None and len(shape) == 4
               else math.prod(shape[1:]) ** -0.5)
        return torch.randn(shape, generator=gen, device=device) * std
    if name.endswith("weight"):
        return torch.ones(shape, device=device)
    return torch.zeros(shape, device=device)


def _init_fixed(model: nn.Module) -> None:
    """The parameters a configuration fixes rather than draws (a pool-init
    merge projection, the contrastive temperatures): each module's
    `init_fixed_`, where it has one."""
    for mod in model.modules():
        if hasattr(mod, "init_fixed_"):
            mod.init_fixed_()


@torch.no_grad()
def init_random_(model: nn.Module, seed: int,
                 conv_std=None) -> nn.Module:
    """Overwrite every parameter from a CPU generator seeded with `seed`
    (then the fixed ones, `_init_fixed`). The draw does not depend on the
    device the model lies on, so a model on the card and one on the CPU get
    the same weights. `conv_std`: convolution kernels N(0, conv_std²) (the
    discriminator's flax initializer), else LeCun-normal."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        p.copy_(_draw(name, p.shape, gen, "cpu", conv_std))
    _init_fixed(model)
    return model


@torch.no_grad()
def init_setokim_random_(model: nn.Module, seed: int,
                         clip_search: int = 0) -> nn.Module:
    """Random weights for a Setokim (or any model) of any `weight_bits`,
    drawn on the model's device from a generator seeded with `seed`: the
    parameters as `init_random_` draws them, and each quantised trunk
    linear from a float (out, in) LeCun-normal draw, quantised at once
    (int4: with its group and `clip_search`). One linear's float weight at
    a time: the float trunk of a 7B model (27 GB at float32) is never
    held."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        p.copy_(_draw(name, p.shape, gen, device))
    _init_fixed(model)
    for name, mod in model.named_modules():
        if isinstance(mod, QuantDense):
            bits, group, out, inp = 8, 0, *mod.q.shape
        elif isinstance(mod, Quant4Dense):
            bits, group = 4, mod.quant_group
            out, inp = mod.p.shape[0], 2 * mod.p.shape[1]
        else:
            continue
        w = _draw(f"{name}.weight", (out, inp), gen, device)
        for key, t in quantize_linear(w, bits, group, clip_search).items():
            getattr(mod, key).copy_(t)
    return model


def init_lora_random(model: nn.Module, seed: int, rank: int) -> Lora:
    """LoRA adapters for `model`'s trunk linears (train/lora.init_lora),
    drawn on the model's device from a generator seeded with `seed`."""
    device = next(model.parameters()).device
    return init_lora(model, torch.Generator(device=device).manual_seed(seed),
                     rank)
