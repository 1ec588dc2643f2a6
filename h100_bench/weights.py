"""Seeded random weights in the port's parameter names, drawn on the device.

Both sides take their weights from here: the program through
`load_state_dict`, the plain reference (reference/setok_ref.py) as float32
tensors. The parameter names and shapes are the reference's own
(`reference.setok_ref.param_spec`); `load_into` holds the program's names
and shapes to them.

Each part of the model (the tokenizer, the detokenizer) has its own
generator, seeded from (seed, part), so a cell that builds the tokenizer
alone draws the same tokenizer as a cell that builds both. The leaves are
drawn in chunks of about `CHUNK` elements, one float32 `torch.randn` call
each, and cast to the parameter type; a chunk is handed over and freed
before the next, so the program never holds a second copy of its weights. The same seed on
the same device gives the same bits.

Leaves: matrices LeCun-normal (std 1/sqrt(fan_in)); `pos_embed` and
`mask_tokens` N(0, 0.02^2); biases N(0, 0.02^2); norm scales
1 + N(0, 0.1^2).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 26
PARTS = ("tokenizer", "detokenizer")
_EMBEDDINGS = ("pos_embed", "mask_tokens")


def part_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for one part, from the run's seed."""
    state = np.random.SeedSequence([seed, PARTS.index(part)]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def _scale(name: str, shape) -> Tuple[float, float]:
    """(std, mean) of a leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _EMBEDDINGS:
        return 0.02, 0.0
    if len(shape) == 2:
        return shape[1] ** -0.5, 0.0
    if leaf == "weight":
        return 0.1, 1.0
    return 0.02, 0.0


def chunks(spec: List[Tuple[str, tuple]], seed: int, part: str, dtype,
           device) -> Iterator[Dict[str, torch.Tensor]]:
    """The leaves of `spec` (name, shape) of one part, in order, as
    successive dicts of at most CHUNK elements, each leaf in `dtype`."""
    gen = torch.Generator(device=device).manual_seed(part_seed(seed, part))
    group, size = [], 0
    for name, shape in spec + [(None, ())]:
        n = math.prod(shape) if name is not None else 0
        if group and (name is None or size + n > CHUNK):
            z = torch.randn(size, generator=gen, device=device,
                            dtype=torch.float32)
            out, off = {}, 0
            for g_name, g_shape in group:
                k = math.prod(g_shape)
                std, mean = _scale(g_name, g_shape)
                out[g_name] = (z[off:off + k].view(g_shape) * std
                               + mean).to(dtype)
                off += k
            del z
            yield out
            group, size = [], 0
        if name is not None:
            group.append((name, tuple(shape)))
            size += n


def load_into(module: torch.nn.Module, spec, seed: int, part: str, dtype,
              device, prefix: str = "") -> int:
    """Draw one part into `module` through `load_state_dict`, chunk by
    chunk; every key of the module's state dict under `prefix` must be
    drawn once, and nothing else. Returns the number of elements drawn."""
    want = {k for k in module.state_dict() if k.startswith(prefix)}
    seen, total = set(), 0
    for chunk in chunks(spec, seed, part, dtype, device):
        named = {prefix + k: v for k, v in chunk.items()}
        result = module.load_state_dict(named, strict=False)
        if result.unexpected_keys:
            raise KeyError(f"not in the program: {result.unexpected_keys}")
        seen |= named.keys()
        total += sum(v.numel() for v in named.values())
        del named, chunk
    missing = want - seen
    if missing:
        raise KeyError(f"the program has leaves that were not drawn: "
                       f"{sorted(missing)[:8]}")
    return total


def draw_f32(spec, seed: int, part: str, dtype, device) -> dict:
    """One part's leaves as float32, each drawn in `dtype` first, so that
    the reference sees the program's values."""
    out = {}
    for chunk in chunks(spec, seed, part, dtype, device):
        out.update({k: v.float() for k, v in chunk.items()})
    return out
