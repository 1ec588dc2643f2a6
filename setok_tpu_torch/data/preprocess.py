"""Conversation → (input_ids, labels) preprocessors with human-turn masking.

A copy of `setok_tpu/data/preprocess.py`: `preprocess_multimodal` (the
`<image>` placement, optional im_start / im_end wrapping, `<target>` →
target_num copies), `preprocess_plain`, `preprocess_v1` (vicuna TWO-style
round masking), `preprocess_llama_2`, `preprocess_mpt` and the dispatcher
`preprocess`. The spans that stay supervised are measured by tokenizing
the accumulated prefix of each round exactly (the reference's per-round
count arithmetic needs ±1 / ±2 corrections that depend on the HF
tokenizer's version); a sample whose rounds do not line up is ignored
whole, with a warning, as the reference does.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from setok_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                       DEFAULT_IM_START_TOKEN,
                                       DEFAULT_IMAGE_TOKEN,
                                       DEFAULT_TARGET_TOKEN, IGNORE_INDEX)
from setok_tpu_torch.data import conversation as conversation_lib
from setok_tpu_torch.data.mm_tokens import tokenizer_image_token

logger = logging.getLogger(__name__)

Source = List[Dict[str, str]]   # [{"from": "human"|"gpt", "value": ...}, ...]


def preprocess_multimodal(sources: Sequence[Source], *,
                          is_multimodal: bool = True,
                          mm_use_im_start_end: bool = False,
                          target_num: int = 64) -> Sequence[Source]:
    """Normalize `<image>` to the turn start; expand `<target>`.

    Parity: base_dataset.py:101-129.
    """
    if not is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = (
                    DEFAULT_IMAGE_TOKEN + "\n"
                    + sentence["value"].replace(DEFAULT_IMAGE_TOKEN,
                                                "").strip()).strip()
            replace_token = DEFAULT_IMAGE_TOKEN
            if mm_use_im_start_end:
                replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                                 + DEFAULT_IM_END_TOKEN)
            sentence["value"] = sentence["value"].replace(
                DEFAULT_IMAGE_TOKEN, replace_token)

            if DEFAULT_TARGET_TOKEN in sentence["value"]:
                replace_token = (DEFAULT_TARGET_TOKEN + " ") * target_num
                if mm_use_im_start_end:
                    replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                                     + DEFAULT_IM_END_TOKEN)
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_TARGET_TOKEN, replace_token)
    return sources


def _tok(prompt: str, tokenizer, has_image: bool) -> List[int]:
    if has_image:
        return tokenizer_image_token(prompt, tokenizer)
    return tokenizer.encode(prompt)


def preprocess_plain(sources: Sequence[Source], tokenizer) -> Dict:
    """Stage-2 'plain' dialect: `<image>` + caption. Parity:
    base_dataset.py:388-407 (mask everything up to the caption)."""
    input_ids, labels = [], []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        conversation = (DEFAULT_IMAGE_TOKEN + source[1]["value"]
                        + conversation_lib.conv_llava_plain.sep)
        ids = tokenizer_image_token(conversation, tokenizer)
        lbl = list(ids)
        n_prefix = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))
        lbl[:n_prefix] = [IGNORE_INDEX] * n_prefix
        input_ids.append(ids)
        labels.append(lbl)
    return dict(input_ids=input_ids, labels=labels)


def _apply_template(sources: Sequence[Source], conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles.get(source[0]["from"]) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "conversation roles mismatch"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _mask_assistant_spans(conversations: Sequence[str], tokenizer,
                          has_image: bool, round_sep: str,
                          instr_sep: str) -> Dict:
    """Supervise only assistant answers: rounds split on `round_sep`,
    instruction part ends at `instr_sep`. Shared skeleton of the v1 /
    llama_2 maskers (base_dataset.py:214-297 / 132-211), with exact span
    arithmetic on accumulated prefixes."""
    input_ids, labels = [], []
    for conversation in conversations:
        ids = _tok(conversation, tokenizer, has_image)
        lbl = [IGNORE_INDEX] * len(ids)
        rounds = conversation.split(round_sep)
        prefix = ""
        ok = True
        for rou in rounds:
            if rou == "":
                continue
            parts = rou.split(instr_sep)
            if len(parts) != 2:
                ok = len(parts) == 1
                break
            instr = prefix + parts[0] + instr_sep
            full = prefix + rou + round_sep
            start = len(_tok(instr, tokenizer, has_image))
            end = len(_tok(full, tokenizer, has_image))
            if not (0 <= start <= end <= len(ids)):
                ok = False
                break
            lbl[start:end] = ids[start:end]
            prefix = full
        if not ok:
            logger.warning("tokenization mismatch while masking; sample "
                           "fully ignored (parity: base_dataset.py:286-292)")
            lbl = [IGNORE_INDEX] * len(ids)
        input_ids.append(ids)
        labels.append(lbl)
    return dict(input_ids=input_ids, labels=labels)


def preprocess_llama_2(sources: Sequence[Source], tokenizer,
                       has_image: bool = False) -> Dict:
    """LLaMA-2 [INST] dialect. Parity: base_dataset.py:132-211."""
    conv = conversation_lib.conv_llama_2.copy()
    conversations = _apply_template(sources, conv)
    return _mask_assistant_spans(conversations, tokenizer, has_image,
                                 round_sep=conv.sep2, instr_sep="[/INST] ")


def preprocess_mpt(sources: Sequence[Source], tokenizer,
                   has_image: bool = False) -> Dict:
    """MPT chatml dialect. Parity: base_dataset.py:300-385 (rounds
    re-grouped as [system+user+gpt], then [user+gpt]...)."""
    conv = conversation_lib.conv_mpt.copy()
    conversations = _apply_template(sources, conv)
    instr_sep = conv.sep + conv.roles[1]       # '<|im_end|><|im_start|>assistant\n'
    input_ids, labels = [], []
    for conversation in conversations:
        ids = _tok(conversation, tokenizer, has_image)
        lbl = [IGNORE_INDEX] * len(ids)
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for i in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[i:i + 2]))
        prefix = ""
        ok = True
        for rou in re_rounds:
            if rou == "":
                continue
            parts = rou.split(conv.roles[1])
            if len(parts) != 2:
                ok = len(parts) == 1
                break
            instr = prefix + parts[0] + conv.roles[1]
            full = prefix + rou + conv.sep
            start = len(_tok(instr, tokenizer, has_image))
            end = len(_tok(full, tokenizer, has_image))
            if not (0 <= start <= end <= len(ids)):
                ok = False
                break
            lbl[start:end] = ids[start:end]
            prefix = full
        if not ok:
            lbl = [IGNORE_INDEX] * len(ids)
        input_ids.append(ids)
        labels.append(lbl)
    return dict(input_ids=input_ids, labels=labels)


def preprocess_v1(sources: Sequence[Source], tokenizer,
                  has_image: bool = False) -> Dict:
    """Vicuna v1 (TWO separator) with human-turn masking.

    Parity: base_dataset.py:214-297 — same round decomposition
    (`split(sep2)`, instruction = up to 'sep + ASSISTANT: '), with spans
    measured by exact tokenization of the accumulated prefix instead of the
    reference's per-round count arithmetic (which needs HF-version-specific
    ±1/±2 corrections).
    """
    conv = conversation_lib.conv_vicuna_v1.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles.get(source[0]["from"]) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "conversation roles mismatch"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    sep = conv.sep + conv.roles[1] + ": "
    input_ids, labels = [], []
    for conversation in conversations:
        ids = _tok(conversation, tokenizer, has_image)
        lbl = [IGNORE_INDEX] * len(ids)

        # supervise each assistant answer (+ its trailing sep2)
        rounds = conversation.split(conv.sep2)
        prefix = ""
        ok = True
        for rou in rounds:
            if rou == "":
                continue
            parts = rou.split(sep)
            if len(parts) != 2:
                ok = len(parts) == 1   # trailing fragment
                break
            instr = prefix + parts[0] + sep
            full = prefix + rou + conv.sep2
            start = len(_tok(instr, tokenizer, has_image))
            end = len(_tok(full, tokenizer, has_image))
            if not (0 <= start <= end <= len(ids)):
                ok = False
                break
            lbl[start:end] = ids[start:end]
            prefix = full
        if not ok:
            logger.warning("tokenization mismatch while masking; sample "
                           "fully ignored (parity: base_dataset.py:286-292)")
            lbl = [IGNORE_INDEX] * len(ids)
        input_ids.append(ids)
        labels.append(lbl)
    return dict(input_ids=input_ids, labels=labels)


def preprocess(sources: Sequence[Source], tokenizer,
               has_image: bool = False,
               version: Optional[str] = None) -> Dict:
    """Dialect dispatcher. Parity: base_dataset.py:410-455."""
    version = version or conversation_lib.default_conversation.version
    style = conversation_lib.conv_templates.get(
        version, conversation_lib.default_conversation).sep_style
    if style == conversation_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if style == conversation_lib.SeparatorStyle.TWO:
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if style == conversation_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if style == conversation_lib.SeparatorStyle.MPT:
        return preprocess_mpt(sources, tokenizer, has_image=has_image)
    raise NotImplementedError(f"preprocessor for style {style}")
