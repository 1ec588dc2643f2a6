"""Text tokenizer loading and a dependency-free fallback.

A copy of `setok_tpu/data/tokenizer.py`: `load_text_tokenizer` builds an HF
tokenizer from a local checkpoint directory (`transformers` is imported only
then); without one, `WordTokenizer` gives a deterministic word-hash
vocabulary, so the serving CLI runs without any tokenizer files.
"""

from __future__ import annotations

from typing import List, Optional


class WordTokenizer:
    """Deterministic word-level tokenizer (stable across processes)."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    model_max_length = 2048

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size
        self._added = {}

    def _hash(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 10 + h % (self.vocab_size - 10)

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_token_id]
        for w in text.split():
            ids.append(self._added.get(w, self._hash(w)))
        return ids

    def decode(self, ids) -> str:
        return " ".join(str(i) for i in ids
                        if i not in (self.bos_token_id, self.pad_token_id))

    def add_tokens(self, tokens, special_tokens: bool = True) -> int:
        new = [t for t in tokens if t not in self._added]
        for t in new:
            self._added[t] = self.vocab_size + len(self._added)
        return len(new)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._added.get(token, self._hash(token))

    def __call__(self, text, **kw):
        class _Out:
            pass

        out = _Out()
        out.input_ids = self.encode(text)
        return out


class HFTokenizerAdapter:
    """An HF tokenizer behind the `.encode(str) -> List[int]` and attribute
    surface of `WordTokenizer`."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.bos_token_id = hf_tokenizer.bos_token_id or 1
        self.eos_token_id = hf_tokenizer.eos_token_id or 2
        self.pad_token_id = hf_tokenizer.pad_token_id or 0
        self.model_max_length = getattr(hf_tokenizer, "model_max_length",
                                        2048)

    def encode(self, text: str) -> List[int]:
        return self.hf.encode(text)

    def decode(self, ids) -> str:
        return self.hf.decode(ids, skip_special_tokens=True)

    def add_tokens(self, tokens, special_tokens: bool = True) -> int:
        return self.hf.add_tokens(tokens, special_tokens=special_tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.hf.convert_tokens_to_ids(token)


def load_text_tokenizer(path: Optional[str] = None,
                        vocab_size: int = 32000):
    """HF tokenizer from a local path, else the word-hash fallback."""
    if path:
        from transformers import AutoTokenizer
        return HFTokenizerAdapter(
            AutoTokenizer.from_pretrained(path, use_fast=True))
    return WordTokenizer(vocab_size=vocab_size)
