"""Load flat weight files into a model, matching by path suffix.

The counterpart of `setok_tpu/utils/porting.py` `load_flat_into`: a flat
{key: array} dict (an `.npz`), its keys 'a/b/c' (the porter's form) or
flax `keystr` "['a']['b']['c']" (`save_subtree`'s), each array in the flax
layout. A model entry whose flax path (with or without the leading
'params') ends with a key's components takes that array, cast to the
entry's type; shapes must agree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.utils.from_flax import flax_entries, from_flax_leaf


def normalize_key(key: str) -> tuple:
    """'a/b/c' or "['a']['b']['c']" → ('a', 'b', 'c')."""
    if key.startswith("['"):
        return tuple(key[2:-2].split("']['"))
    return tuple(key.split("/"))


@torch.no_grad()
def load_flat_into(model: nn.Module, flat: Dict[str, np.ndarray],
                   strict: bool = False) -> List[str]:
    """Fill the model's entries from `flat`, in place. Returns the keys of
    `flat` that matched no entry (strict: raises for any)."""
    items = {normalize_key(k): v for k, v in flat.items()}
    state = model.state_dict()
    new, used = {}, set()
    for path, (key, _) in flax_entries(model).items():
        full = ("params",) + path
        for fk in items:
            if full[-len(fk):] == fk:
                try:
                    new[key] = from_flax_leaf(path[-1], items[fk],
                                              state[key])
                except ValueError as e:
                    raise ValueError(f"{'/'.join(path)}: {e}") from None
                used.add(fk)
                break
    model.load_state_dict(new, strict=False)
    unmatched = ["/".join(k) for k in items if k not in used]
    if strict and unmatched:
        raise KeyError(f"unmatched keys: {unmatched[:10]}")
    return unmatched
