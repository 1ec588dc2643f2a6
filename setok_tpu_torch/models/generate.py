"""Generation: text with the KV cache (prefill, then a loop of decode
steps), and images from the hidden states of a generated span.

The counterpart of `setok_tpu/models/generate.py`. Where the JAX package
runs the decode loop as one compiled scan, the port runs a Python loop of
`Setokim.decode_step`, with the same semantics: rows that emitted EOS are
frozen to the pad token from the next step on, and the hidden states align
with the tokens as the JAX scan's do. `generate_image` runs the MaskGIT/MAR
loop over a span's hidden states and renders the concept tokens;
`generate` renders every non-empty `<im_start> .. <im_end>` span it finds.
Every draw comes from an explicit `torch.Generator` (the JAX package's
`jax.random` bits are not reproduced; the tests replay them through
`ImageDraws`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from setok_tpu_torch.models.setokim import ImageDraws, Setokim


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor    # (B, max_new_tokens) ids (pad after EOS)
    hidden: torch.Tensor    # (B, max_new_tokens, H) last-layer hidden states
    done: torch.Tensor      # (B,) finished flags


def _top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering: logits outside the smallest set of cumulative
    probability ≥ top_p become -inf. top_p: a float or a (B, 1) tensor."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, float("-inf")))


def sample(logits: torch.Tensor, temperature: float, top_p: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy at temperature 0, else a temperature/nucleus categorical."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        logits = _top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate_text(model: Setokim, input_ids, images, max_new_tokens: int,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_p: float = 1.0,
                  eos_id: int = 2, pad_id: int = 0) -> GenerateOutput:
    """Greedy or sampled decode with a KV cache. input_ids: (B, L) in the
    collator layout (image slots pre-expanded); images: (B, H, W, 3)."""
    b, l = input_ids.shape
    logits, _, cache, cache_valid, _ = model.prefill(
        input_ids, images, l + max_new_tokens)
    next_pos = cache_valid.to(torch.int32).sum(dim=1)
    tok = sample(logits, temperature, top_p, generator)
    toks, hiddens = [tok], []
    # as the JAX scan: the frozen set starts empty, EOS at the first token
    # counts only in the returned `done`
    done = torch.zeros(b, dtype=torch.bool, device=tok.device)
    for _ in range(max_new_tokens - 1):
        logits, hidden, cache, cache_valid = model.decode_step(
            tok[:, None], cache, cache_valid, next_pos)
        nxt = sample(logits, temperature, top_p, generator)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
        next_pos = next_pos + 1
        tok = nxt
        toks.append(nxt)
        hiddens.append(hidden)
    done = done | (toks[0] == eos_id)
    if hiddens:
        # hiddens[j] is the hidden of toks[j]; the last token is never fed
        # back, so it repeats its predecessor's
        hiddens.append(hiddens[-1])
        hidden = torch.stack(hiddens, dim=1)
    else:
        hidden = torch.zeros((b, 1, model.cfg.llama.hidden_size),
                             device=tok.device)
    return GenerateOutput(tokens=torch.stack(toks, dim=1), hidden=hidden,
                          done=done)


def find_image_spans(ids: np.ndarray, im_start_id: int, im_end_id: int
                     ) -> List[Tuple[int, int]]:
    """[(start, end)) index pairs strictly between the markers."""
    spans = []
    starts = np.nonzero(ids == im_start_id)[0]
    ends = np.nonzero(ids == im_end_id)[0]
    for s in starts:
        after = ends[ends > s]
        if after.size:
            spans.append((int(s) + 1, int(after[0])))
    return spans


def pad_to(ids: np.ndarray, width: int, pad_id: int = 0) -> np.ndarray:
    out = np.full((width,), pad_id, dtype=ids.dtype)
    out[:len(ids)] = ids
    return out


def truncate_at_stop(ids: np.ndarray, stopping) -> np.ndarray:
    """Cut a 1-D id sequence at the earliest keyword stop, the keyword
    kept."""
    for t in range(1, len(ids) + 1):
        if stopping.should_stop(ids[:t].tolist()):
            return ids[:t]
    return ids


def generate_image(model: Setokim, hidden_span: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   num_iter: int = 16, cfg_scale: float = 1.0,
                   temperature: float = 1.0, *,
                   draws: Optional[ImageDraws] = None) -> torch.Tensor:
    """Hidden states of a generation span (B, T, H) → the rendered image
    (B, H_img, W_img, 3): `sample_image_tokens`, then `render_image`. The
    draws come from `generator`, or replayed from `draws`."""
    tokens = model.sample_image_tokens(hidden_span, generator, num_iter,
                                       cfg_scale, temperature, draws=draws)
    return model.render_image(tokens).image


def generate(model: Setokim, input_ids, images, max_new_tokens: int = 64,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, eos_id: int = 2,
             im_start_id: Optional[int] = None,
             im_end_id: Optional[int] = None, num_iter: int = 16,
             cfg_scale: float = 1.0, stopping=None):
    """Text and the images the model chose to emit → (tokens (B, T) numpy,
    per-row lists of (H, W, 3) numpy images). A keyword stop truncates
    each row on the host afterwards. Each non-empty span between
    `im_start_id` and `im_end_id` renders through `generate_image`, the
    spans in order, each drawing from `generator` (a generator seeded 0 on
    the model's device when none is given)."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    out = generate_text(model, input_ids, images, max_new_tokens, generator,
                        temperature=temperature, eos_id=eos_id)
    ids = out.tokens.cpu().numpy()
    if stopping is not None:
        ids = np.stack([pad_to(truncate_at_stop(row, stopping), ids.shape[1])
                        for row in ids])
    images_out: List[List[np.ndarray]] = [[] for _ in range(ids.shape[0])]
    if im_start_id is not None and im_end_id is not None:
        for bi, row in enumerate(ids):
            for s, e in find_image_spans(row, im_start_id, im_end_id):
                if e <= s:
                    continue
                img = generate_image(model, out.hidden[bi:bi + 1, s:e],
                                     generator, num_iter, cfg_scale)
                images_out[bi].append(img[0].cpu().numpy())
    return ids, images_out
