"""Activation calibration for int4 serving.

The counterpart of `setok_tpu/serve/calibrate.py`. `quantize_weight_int4
(clip_search=R, row_weight=d)` minimises each linear's output error rather
than its weight error when it knows d_k = E[x_k²], the second moment of
each input feature (a diagonal Hessian: rows of W that activations never
excite may quantise coarsely). `collect_row_weights` gathers those moments
with forward pre-hooks on the float trunk's linears while a forward runs;
the JAX package uses a flax method interceptor for the same.

    rw = collect_row_weights(model, lambda: model.prefill_text(ids, 256))
    state = quantize_trunk_weights(model.state_dict(), bits=4,
                                   group_size=128, clip_search=8,
                                   row_weights=rw)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.models.llama import TRUNK_LINEARS
from setok_tpu_torch.ops.blocks import Dense

__all__ = ["collect_row_weights", "lookup_row_weight"]


def collect_row_weights(model: nn.Module, run: Callable[[], Any],
                        names: Tuple[str, ...] = TRUNK_LINEARS
                        ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Run `run()` with a forward pre-hook on every float linear (`Dense`)
    of `model` whose name is in `names`, and return {module path: (in,)
    float32 E[x_k²]}, the mean over every row of every call inside `run`.
    The sums stay on the model's device (float64) until the end."""
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    counts: Dict[Tuple[str, ...], int] = {}

    def hook_of(key):
        def hook(_module, args):
            flat = args[0].reshape(-1, args[0].shape[-1]).double()
            s = (flat * flat).sum(0)
            if key in sums:
                sums[key] += s
                counts[key] += flat.shape[0]
            else:
                sums[key], counts[key] = s, flat.shape[0]
        return hook

    handles = [mod.register_forward_pre_hook(hook_of(tuple(name.split("."))))
               for name, mod in model.named_modules()
               if isinstance(mod, Dense) and name.rsplit(".", 1)[-1] in names]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return {k: (v / max(counts[k], 1)).float().cpu().numpy()
            for k, v in sums.items()}


def lookup_row_weight(row_weights: Dict[Tuple[str, ...], np.ndarray],
                      path: Tuple[str, ...]) -> Optional[np.ndarray]:
    """The row weight of the module at `path`: an exact match first, then
    the one key that is a suffix of `path` or has `path` as its suffix (the
    state dict may be rooted elsewhere than the hooked model); else None."""
    if path in row_weights:
        return row_weights[path]
    hits = [v for k, v in row_weights.items()
            if k[-len(path):] == path or path[-len(k):] == k]
    return hits[0] if len(hits) == 1 else None
