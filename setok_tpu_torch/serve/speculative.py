"""Prompt-lookup drafting and speculative sampling.

The counterpart of `setok_tpu/serve/speculative.py`. Draft tokens come from
the request's own context: the longest recent n-gram that occurred earlier
continues the way it did then. There is no draft model and no extra
weight; each draft the verify forward (`Setokim.verify_step`) accepts saves
a whole decode step.

`speculative_sample` takes its draws as an argument (`SpecDraws`: the
uniforms of the acceptance test and the Gumbel noise of the residual's
categorical, which is `argmax(log p + gumbel)`), so that the same draws
can be replayed; `draw_spec` makes them from a `torch.Generator`.

A context may hold negative sentinels (`IMAGE_TOKEN_INDEX` at the image
slots of a prompt), and the drafter can propose one. `clean_drafts` maps
every draft outside [0, vocab) to `pad_id` before the verify: a gather at a
negative id would raise on the CPU and assert on the card. Greedy streams
do not depend on the drafts (each emitted token is the argmax of a real
forward), so this changes none of them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["SpecDraws", "clean_drafts", "draft_prompt_lookup", "draw_spec",
           "speculative_sample"]


def draft_prompt_lookup(context: Sequence[int], num_draft: int,
                        max_ngram: int = 3, pad_id: int = 0) -> np.ndarray:
    """Propose `num_draft` tokens continuing `context`.

    Matches the trailing n-gram (n = max_ngram down to 1) against every
    earlier position, the most recent occurrence first, and returns the
    tokens that followed it. Unfilled positions hold `pad_id`."""
    out = np.full((num_draft,), pad_id, np.int64)
    ctx = np.asarray(context, np.int64)
    n_ctx = ctx.shape[0]
    if n_ctx < 2:
        return out
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        tail = ctx[n_ctx - n:]
        # windows over ctx[:-1], so that a match has a continuation
        wins = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.flatnonzero((wins == tail).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1])
        cont = ctx[start + n: start + n + num_draft]
        out[: cont.shape[0]] = cont
        return out
    return out


def clean_drafts(drafts: np.ndarray, vocab: int, pad_id: int) -> np.ndarray:
    """Drafts with every id outside [0, vocab) replaced by `pad_id`."""
    drafts = np.asarray(drafts)
    return np.where((drafts >= 0) & (drafts < vocab), drafts, pad_id)


class SpecDraws(NamedTuple):
    """The draws of one `speculative_sample` over (B, T, V) probabilities:
    `u` (B, T - 1) uniforms in [0, 1) and `gumbel` (B, V) standard Gumbel
    noise, float32."""
    u: torch.Tensor
    gumbel: torch.Tensor


def draw_spec(b: int, d: int, vocab: int, generator, device) -> SpecDraws:
    """The draws of one verify dispatch of B rows of D drafts."""
    u = torch.rand((b, d), generator=generator, device=device)
    e = torch.rand((b, vocab), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return SpecDraws(u, -torch.log(-torch.log(e.clamp_min(tiny))))


def speculative_sample(probs: torch.Tensor, drafts: torch.Tensor,
                       draws: SpecDraws):
    """Rejection-sample a drafted chunk so that the emitted tokens follow
    the ancestral sampling distribution exactly.

    probs: (B, T, V), position i the next-token distribution after chunk
    input i; drafts: (B, T - 1) ids in [0, V). With a deterministic drafter
    the rule is: accept draft d_i with probability p_i(d_i); at the first
    rejection sample from p_i with d_i taken out (renormalised); if every
    draft is accepted sample the bonus token from p_T (Leviathan et al.,
    Chen et al.).

    → (out_tok (B, T) int64, acc (B,) int64): out_tok[b, :acc[b]] are the
    accepted drafts, out_tok[b, acc[b]] the rejection or bonus sample; the
    entries after it are not meaningful."""
    b, t, v = probs.shape
    d = t - 1
    p_draft = torch.gather(probs[:, :d], 2, drafts[..., None])[..., 0]
    accept = draws.u < p_draft
    acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    rows = torch.arange(b, device=probs.device)
    p_sel = probs[rows, acc]                                      # (B, V)
    draft_at = torch.gather(drafts, 1, acc.clamp(max=d - 1)[:, None])[:, 0]
    # the residual (p - q)+ of a point mass q at the rejected draft: p with
    # that token zeroed; a rejection implies p(draft) < 1, so it has mass
    exclude = torch.nn.functional.one_hot(draft_at, v).to(probs.dtype)
    resid = torch.where((acc < d)[:, None], p_sel * (1.0 - exclude), p_sel)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-30)
    sampled = torch.argmax(torch.log(resid + 1e-30) + draws.gumbel, dim=-1)
    out = torch.cat([drafts, drafts.new_zeros((b, 1))], dim=1)
    out[rows, acc] = sampled.to(out.dtype)
    return out, acc
