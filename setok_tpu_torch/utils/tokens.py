"""Vocabulary growth for the multimodal special tokens.

The counterpart of `setok_tpu/utils/tokens.py` (the reference's
`initialize_vision_tokenizer`, setokim_arch.py:357-399): the special tokens
join the tokenizer, the embedding table and the LM head grow by as many
rows, and each new row is the mean of the existing ones (the LLaVA
convention, setokim_arch.py:374-386).

Both functions work on a state dict ({name: tensor}, such as
`Setokim.state_dict()` or `LlamaForCausalLM.state_dict()`), as the JAX
functions work on the parameter tree; a model of the grown vocabulary
(`cfgs.replace(cfg.llama, vocab_size=...)`) then loads the result. In the
port's (out, in) layout the LM head grows rows, where the JAX (in, out)
kernel grows columns.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from setok_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                       DEFAULT_IM_START_TOKEN,
                                       DEFAULT_IMAGE_PATCH_TOKEN,
                                       DEFAULT_TARGET_TOKEN)

SPECIAL_TOKENS = [DEFAULT_IMAGE_PATCH_TOKEN, DEFAULT_IM_START_TOKEN,
                  DEFAULT_IM_END_TOKEN, DEFAULT_TARGET_TOKEN]


def _grown(table: torch.Tensor, n: int) -> torch.Tensor:
    """`table` (vocab, width) with n rows appended, each the mean of its
    rows."""
    mean = table.mean(dim=0, keepdim=True)
    return torch.cat([table, mean.expand(n, -1)], dim=0)


def resize_token_embeddings(state: Dict[str, torch.Tensor],
                            num_new_tokens: int) -> Dict[str, torch.Tensor]:
    """A copy of `state` with `...embed_tokens.weight` and every float
    `...lm_head...weight` (both (vocab, width)) grown by `num_new_tokens`
    mean rows; the other entries are the same tensors."""
    if num_new_tokens <= 0:
        return state
    out = dict(state)
    for name, value in state.items():
        if name.endswith("embed_tokens.weight") or (
                "lm_head" in name and name.endswith(".weight")
                and value.dim() == 2 and value.is_floating_point()):
            out[name] = _grown(value, num_new_tokens)
    return out


def add_special_tokens(tokenizer, state: Dict[str, torch.Tensor],
                       mm_use_im_start_end: bool = True
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Register the special tokens on a tokenizer with `add_tokens` /
    `convert_tokens_to_ids` (HF-style) and grow the state's tables by the
    tokens it added. Returns (new state, {token: id})."""
    tokens: List[str] = [DEFAULT_IMAGE_PATCH_TOKEN, DEFAULT_TARGET_TOKEN]
    if mm_use_im_start_end:
        tokens += [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN]
    num_new = tokenizer.add_tokens(tokens, special_tokens=True) \
        if hasattr(tokenizer, "add_tokens") else 0
    state = resize_token_embeddings(state, num_new)
    ids = {t: tokenizer.convert_tokens_to_ids(t) for t in tokens} \
        if hasattr(tokenizer, "convert_tokens_to_ids") else {}
    return state, ids
