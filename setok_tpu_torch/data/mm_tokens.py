"""Multimodal tokenization helpers: sentinel insertion and the static slot
layout.

A copy of `setok_tpu/data/mm_tokens.py`. `tokenizer_image_token` splits a
prompt on `<image>` and splices IMAGE_TOKEN_INDEX (-200) sentinels;
`tokenizer_target_token` does the same for `<target>` / -300 with the JAX
package's repair of the reference's loop guard (the reference's
`tokenizer_multiple_token` compares its index against the length of a
string, not of the chunk list); `expand_image_slots` turns each image
sentinel into the `k_max` reserved slots that the static splice of
`models/setokim.py` fills.

Tokenizers are any object with `encode(text) -> List[int]` and a
`bos_token_id` attribute (HF tokenizers qualify; tests use
`data/tokenizer.WordTokenizer`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from setok_tpu_torch.constants import (DEFAULT_IMAGE_TOKEN,
                                       DEFAULT_TARGET_TOKEN, IGNORE_INDEX,
                                       IMAGE_TOKEN_INDEX, TARGET_TOKEN_INDEX)


def _join_with_sentinel(chunks: List[List[int]], sentinel: int,
                        sentinel_count: int, bos_token_id: Optional[int]
                        ) -> List[int]:
    """Interleave chunk token lists with sentinel runs (mm_utils.py:190-203),
    keeping a single leading BOS if every chunk begins with it."""
    input_ids: List[int] = []
    offset = 0
    if (chunks and chunks[0] and bos_token_id is not None
            and chunks[0][0] == bos_token_id):
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [sentinel] * sentinel_count
    for i, chunk in enumerate(chunks):
        # every chunk re-tokenizes with its own BOS; strip it (the reference
        # does this with its insert_separator/[offset:] trick)
        input_ids.extend(chunk[offset:])
        if i < len(chunks) - 1:
            input_ids.extend(sep)
    return input_ids


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenize with `<image>` → one IMAGE_TOKEN_INDEX sentinel."""
    chunks = [tokenizer.encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    return _join_with_sentinel(chunks, image_token_index, 1,
                               getattr(tokenizer, "bos_token_id", None))


def tokenizer_target_token(prompt: str, tokenizer,
                           target_token_index: int = TARGET_TOKEN_INDEX
                           ) -> List[int]:
    """Tokenize with `<target>` → one TARGET_TOKEN_INDEX sentinel (fixes the
    reference's string-vs-list loop guard, mm_utils.py:214)."""
    chunks = [tokenizer.encode(c)
              for c in prompt.split(DEFAULT_TARGET_TOKEN)]
    return _join_with_sentinel(chunks, target_token_index, 1,
                               getattr(tokenizer, "bos_token_id", None))


def expand_image_slots(input_ids: Sequence[int], k_max: int,
                       labels: Optional[Sequence[int]] = None):
    """Expand each IMAGE_TOKEN_INDEX sentinel into k_max reserved slots.

    The reference splices variable-K image features at runtime
    (setokim_arch.py:262-338); the static recast reserves `k_max` sentinel
    slots per image here in the data pipeline, and the model masks the
    unused ones (SURVEY.md §7 decision 1/3). Labels get IGNORE over the
    expanded span (setokim_arch.py:296-299).
    """
    out_ids: List[int] = []
    out_labels: List[int] = []
    labels = list(labels) if labels is not None else None
    for i, tok in enumerate(input_ids):
        if tok == IMAGE_TOKEN_INDEX:
            out_ids.extend([IMAGE_TOKEN_INDEX] * k_max)
            out_labels.extend([IGNORE_INDEX] * k_max)
        else:
            out_ids.append(tok)
            out_labels.append(labels[i] if labels is not None else tok)
    if labels is None:
        return out_ids
    return out_ids, out_labels


def pad_or_truncate(ids: Sequence[int], max_len: int, pad_value: int = 0
                    ) -> np.ndarray:
    arr = np.full((max_len,), pad_value, dtype=np.int64)
    n = min(len(ids), max_len)
    arr[:n] = np.asarray(ids[:n], dtype=np.int64)
    return arr


class KeywordsStoppingCriteria:
    """Stop generation when any keyword's token suffix appears.

    Parity: mm_utils.py:232-264 (host-side utility used by the decode loop).
    """

    def __init__(self, keywords: List[str], tokenizer):
        self.keyword_ids = []
        for kw in keywords:
            ids = tokenizer.encode(kw)
            bos = getattr(tokenizer, "bos_token_id", None)
            if len(ids) > 1 and ids[0] == bos:
                ids = ids[1:]
            self.keyword_ids.append(ids)
        self.keywords = keywords
        self.tokenizer = tokenizer

    def should_stop(self, output_ids: Sequence[int]) -> bool:
        out = list(output_ids)
        for kw in self.keyword_ids:
            if len(out) >= len(kw) and out[-len(kw):] == kw:
                return True
        if hasattr(self.tokenizer, "decode"):
            text = self.tokenizer.decode(out)
            return any(k in text for k in self.keywords)
        return False


def get_model_name_from_path(model_path: str) -> str:
    """Parity: mm_utils.py:224-230."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
