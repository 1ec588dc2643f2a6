"""Batch collation into static-shaped numpy arrays.

A copy of `setok_tpu/data/collator.py`: pads input_ids / labels, builds
the attention mask, stacks comp / gen images and passes the contrastive
text ids through. Every batch has the same shapes (max_len, with the
k_max image slots already expanded by `mm_tokens.expand_image_slots`), so
the trainers see one layout for the whole run; the reference pads to the
longest sample of each batch. The collator returns numpy;
`data/loader.DeviceLoader` makes the tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np

from setok_tpu_torch.constants import IGNORE_INDEX
from setok_tpu_torch.data.mm_tokens import (expand_image_slots,
                                           pad_or_truncate)


@dataclasses.dataclass
class Collator:
    max_len: int
    k_max: int
    pad_token_id: int = 0
    expand_images: bool = True

    def __call__(self, instances: Sequence[Dict[str, Any]]
                 ) -> Dict[str, np.ndarray]:
        ids_batch, label_batch = [], []
        for inst in instances:
            ids = list(inst["input_ids"])
            labels = list(inst.get("labels", ids))
            if self.expand_images:
                ids, labels = expand_image_slots(ids, self.k_max, labels)
            ids_batch.append(pad_or_truncate(ids, self.max_len,
                                             self.pad_token_id))
            label_batch.append(pad_or_truncate(labels, self.max_len,
                                               IGNORE_INDEX))
        batch: Dict[str, np.ndarray] = {
            "input_ids": np.stack(ids_batch),
            "labels": np.stack(label_batch),
        }
        batch["attention_mask"] = (batch["input_ids"]
                                   != self.pad_token_id).astype(np.bool_)

        for key in ("comp_image", "gen_image"):
            if key in instances[0] and instances[0][key] is not None:
                batch[key] = np.stack(
                    [np.asarray(inst[key], np.float32)
                     for inst in instances])
        # contrastive branch ids (base_dataset.py:565-574)
        if "input_ids_for_contrastive" in instances[0]:
            batch["input_ids_for_contrastive"] = np.stack([
                pad_or_truncate(inst["input_ids_for_contrastive"],
                                self.max_len, self.pad_token_id)
                for inst in instances])
        # unknown keys pass through as lists (base_dataset.py:589-595)
        known = set(batch) | {"input_ids", "labels", "comp_image",
                              "gen_image", "input_ids_for_contrastive"}
        for key in instances[0]:
            if key not in known:
                batch[key] = [inst.get(key) for inst in instances]
        return batch
