"""Length-grouped batch sampling (modality-aware).

A copy of `setok_tpu/data/sampler.py`: a megabatch is world_size x
batch_size indices, sorted by length inside the megabatch and balanced
into per-rank chunks (`split_to_even_chunks`); the modality variant groups
multimodal (positive length) and text-only (negative length) samples
apart. The draws are the JAX package's, `np.random.default_rng(seed +
epoch)`, so the index streams are the same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Parity: setokim_trainer.py:41-60."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0] * num_chunks
    for idx in indices:
        shortest = int(np.argmin(chunk_lengths))
        chunks[shortest].append(idx)
        chunk_lengths[shortest] += lengths[idx]
        if len(chunks[shortest]) == num_per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               generator: Optional[np.random.Generator] = None,
                               merge: bool = True) -> List[int]:
    """Parity: setokim_trainer.py:91-99."""
    g = generator or np.random.default_rng(0)
    perm = g.permutation(len(lengths))
    mb = world_size * batch_size
    megabatches = [perm[i:i + mb].tolist() for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    if merge:
        return [i for mb_ in megabatches for chunk in mb_ for i in chunk]
    return megabatches


def get_modality_length_grouped_indices(
        lengths: Sequence[int], batch_size: int, world_size: int,
        generator: Optional[np.random.Generator] = None) -> List[int]:
    """Multimodal (length > 0) and text-only (length < 0) samples batch
    separately. Parity: setokim_trainer.py:63-88."""
    g = generator or np.random.default_rng(0)
    assert all(l != 0 for l in lengths), "should not have zero length"
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, g)

    mm_indices, mm_lengths = zip(*[(i, l) for i, l in enumerate(lengths)
                                   if l > 0])
    lang_indices, lang_lengths = zip(*[(i, -l) for i, l in enumerate(lengths)
                                       if l < 0])
    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, g, merge=True)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, g, merge=True)]
    mb = world_size * batch_size
    mm_mb = [mm_shuffle[i:i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_mb = [lang_shuffle[i:i + mb]
               for i in range(0, len(lang_shuffle), mb)]
    last_mm = mm_mb.pop() if mm_mb and len(mm_mb[-1]) < mb else []
    last_lang = lang_mb.pop() if lang_mb and len(lang_mb[-1]) < mb else []
    megabatches = mm_mb + lang_mb
    order = g.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    leftover = last_mm + last_lang
    if leftover:
        megabatches.append(leftover)
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterator over dataset indices, (modality-)length-grouped.

    Parity: the HF LengthGroupedSampler the reference plugs its index fns
    into (setok_trainer.py:138-151).
    """

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int],
                 group_by_modality: bool = False, seed: int = 0):
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.group_by_modality = group_by_modality
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        g = np.random.default_rng(self.seed + self._epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, g)
        else:
            idx = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, g)
        return iter(idx)
