"""Continuous-batching serving engine over the static KV cache.

The counterpart of the core of `setok_tpu/serve/engine.py`:

  * a fixed `max_batch` slot array; each slot owns one row of the
    (layers, B, max_len, kv_heads, head_dim) KV cache and its own write
    offset (`KVCache.length` is a (B,) tensor), so the decode step is one
    batched `Setokim.decode_step` whatever the slots hold;
  * continuous batching: between decode dispatches finished slots retire
    and queued requests are admitted by prefilling them (prompts padded to
    `prompt_len`; requests of one kind queued together prefill as one
    batch, image and text-only requests apart) and copying each prefilled
    row into its slot;
  * greedy or temperature/top-p sampling, presence/frequency penalties,
    EOS, budget, cache-capacity and keyword stops, cancellation, and the
    per-request timing (`Request.ttft`, `Request.latency`);
  * `per_request_sampling`: each `submit` may override the temperature,
    top-p and penalties; the decode step then samples with per-row (B,)
    vectors, greedy rows taking the argmax of their penalised logits;
  * `decode_block = K`: K decode steps per host round trip. Sampling, the
    counts, the pinning of retired rows and the active flag's flip on EOS
    and at the cache's end stay on the card; the host then gets the (K, B)
    tokens, hidden states and active-at-entry trace in one copy and applies
    the budget and keyword stops token by token, dropping what a row
    decoded after its stop (its slot state is overwritten at its next
    admission). Greedy streams are those of K = 1;
  * rendering at retirement (`im_start_id`, `im_end_id`): each non-empty
    span of a retired request's tokens renders through
    `models/generate.generate_image` from the hidden states of its tokens;
  * `prefill_chunk = C`: text-only prompts admit in chunks of C tokens
    through `Setokim.prefill_text_chunk`, up to the cache's width (the
    last `_chunk_cap()` tokens) rather than the `prompt_len` bucket; each
    row's first token comes from the chunk that holds its last prompt
    token. Image admissions stay single-shot;
  * the prefix cache (`register_prefix`, `max_prefixes`): the K/V slab of
    a shared prefix (a system prompt) is computed once; an admission whose
    prompt extends a registered prefix starts from a fresh copy of the
    slab (the cache is written in place, so the slab itself is never
    handed out) and chunk-prefills only its suffix, appended at the slab's
    padded width with positions continuing from the prefix's length. When
    that length is a multiple of C the cache is the one chunk-prefilling
    the whole prompt gives; otherwise the pad holes are masked;
  * `spec_len = D`: speculative decoding. Each row drafts D tokens by
    prompt lookup (`serve/speculative.py`); one `Setokim.verify_step`
    scores the (B, 1 + D) chunk; greedy rows accept the drafts that match
    the argmax chain, and at temperature > 0 `speculative_sample` decides
    on the nucleus-filtered softmax. A row's length and position advance
    by the tokens it emits (accepted + 1), the validity of the rest is
    cleared, and the host applies the stops over each row's accepted
    prefix. Drafts outside [0, vocab) (a prompt's image sentinels) become
    `pad_id` before the verify.

The JAX engine prefills, and renders, on a worker thread and splices the
results in at a later step. Here `step()` prefills its admissions
synchronously, before the decode: a request's rows are computed by the
same functions on the same inputs either way, and no row of the batch
depends on another, so every request's tokens are the same; only when a
request joins the batch can differ. Renders run at the start of the next
`step()` (or in `run()` when the queue drains), in retirement order, each
drawing from the engine's generator; as in the JAX engine the slot frees at
`_retire`, and the request's `done` flips only when its images are
harvested (`stats()["renders_in_flight"]` counts those waiting).

Multi-card serving (`mesh`, a (data, model) mesh from
parallel/mesh.make_mesh, one process per card): the trunk is TP-sharded
over `model` (models/llama.tensor_parallel_, Megatron column/row split, one
all-reduce per attention and MLP block), and the KV cache with the int8
cache's scales holds this rank's kv heads: a shard where `num_kv_heads %
tp == 0`, else the one kv head its query heads read. Every rank runs the
same engine on the same requests: the logits are gathered alike on every
rank, and each sampled token is broadcast from the group's first rank, so
the scheduler and the streams are the same on every rank (a stream that
differed would leave the ranks waiting on different collectives). The
`data` axis holds replicas.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from setok_tpu_torch.models.generate import (_top_p_filter, find_image_spans,
                                             generate_image, sample)
from setok_tpu_torch.models.llama import KVCache, init_cache
from setok_tpu_torch.models.setokim import Setokim, mark_columns
from setok_tpu_torch.parallel.mesh import (MODEL_AXIS, axis_group,
                                           check_backend)
from setok_tpu_torch.serve.speculative import (clean_drafts,
                                               draft_prompt_lookup,
                                               draw_spec, speculative_sample)

@dataclasses.dataclass
class Request:
    """One generation request. `tokens` fills as it runs."""

    prompt_ids: np.ndarray                 # (L,) int, collator layout
    image: Optional[np.ndarray] = None     # (H, W, 3) float or None
    max_new_tokens: int = 64
    # a keyword stopping criterion (`should_stop(tokens)`), checked after
    # every token
    stopping: Optional[Any] = None
    # streaming: on_token(request, token_id) after every token (the first
    # included), on the thread that calls step()
    on_token: Optional[Any] = None
    # per-request sampling (an engine with per_request_sampling=True);
    # None = the engine's own
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # (H, W, 3) images rendered from the request's generated spans
    images_out: List[np.ndarray] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    # monotonic seconds, None until reached: submit → first token → done
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # the last-layer hidden state of each fed token (the token before each
    # decoded one), (H,) each: what a generated span renders from
    _hiddens: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        """Submit → first-token latency (s), or None if no token yet."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency(self) -> Optional[float]:
        """Submit → done wall time (s), or None while running."""
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def cancel(self) -> None:
        """Stop this request at the engine's next scheduling pass. A queued
        request retires without tokens; a running one keeps those emitted."""
        self.cancelled = True


@dataclasses.dataclass(eq=False)
class ServeEngine:
    model: Setokim
    max_batch: int = 4
    prompt_len: int = 64
    max_len: int = 256                     # KV-cache width per slot
    eos_id: int = 2
    pad_id: int = 0
    temperature: float = 0.0               # 0 = greedy
    top_p: float = 1.0                     # nucleus at temperature > 0
    # OpenAI semantics: logits[t] -= presence·1[n_t > 0] + frequency·n_t,
    # n_t the count of t in the slot's prompt and generated text
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # per-row (B,) sampling vectors; each submit() may override them
    per_request_sampling: bool = False
    im_start_id: Optional[int] = None      # render generated image spans
    im_end_id: Optional[int] = None
    num_iter: int = 16                     # MaskGIT iterations per image
    cfg_scale: float = 1.0
    decode_block: int = 1                  # decode steps per host trip
    # speculative decoding: drafts per row and dispatch (prompt lookup of
    # n-grams up to spec_ngram); exclusive with decode_block > 1, the
    # penalties and per_request_sampling
    spec_len: int = 0
    spec_ngram: int = 3
    # chunked text-only prefill: admit prompts in chunks of C tokens (0 =
    # single-shot); the prefix cache needs it
    prefill_chunk: int = 0
    max_prefixes: int = 8                  # registered prefixes (LRU)
    cache_dtype: Any = torch.bfloat16
    mesh: Any = None

    def __post_init__(self):
        self._tp_group = None
        if self.mesh is not None:
            check_backend(self.model.device)
            self._tp_group = axis_group(self.mesh, MODEL_AXIS)
            if self._tp_group is not None \
                    and self.model.llama.tp_group is None:
                self.model.llama.tensor_parallel_(self._tp_group)
        if self.prompt_len >= self.max_len:
            raise ValueError("prompt_len must leave decode room in max_len")
        if self.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.spec_len < 0:
            raise ValueError("spec_len must be >= 0")
        if self.spec_len > 0:
            if self.decode_block > 1:
                raise ValueError("spec_len and decode_block>1 are exclusive "
                                 "amortizations — pick one")
            if self.presence_penalty or self.frequency_penalty:
                raise ValueError("presence/frequency penalties are not "
                                 "supported with speculative decoding "
                                 "(verification would need within-chunk "
                                 "count updates)")
            if self.per_request_sampling:
                raise ValueError("per_request_sampling is not supported "
                                 "with speculative decoding (mixed rows "
                                 "cannot share one rejection chunk)")
        b, s = self.max_batch, self.max_len
        cfg = self.model.cfg.llama
        dev = self.model.device
        kv_shape = (cfg.num_layers, b, s, self.model.llama.kv_heads,
                    cfg.head_dim)
        quant = self.cache_dtype == torch.int8

        def scales():
            return (torch.zeros(kv_shape[:-1], dtype=torch.float32,
                                device=dev) if quant else None)

        self._cache = KVCache(
            k=torch.zeros(kv_shape, dtype=self.cache_dtype, device=dev),
            v=torch.zeros(kv_shape, dtype=self.cache_dtype, device=dev),
            length=torch.zeros((b,), dtype=torch.int32, device=dev),
            k_scale=scales(), v_scale=scales())
        self._cache_valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
        self._pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._cur_tok = torch.full((b,), self.pad_id, dtype=torch.long,
                                   device=dev)
        # per-slot token counts over the vocabulary (repetition penalties)
        self._counts = torch.zeros((b, cfg.vocab_size), dtype=torch.int32,
                                   device=dev)
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._slots: List[Optional[Request]] = [None] * b
        self._active = np.zeros((b,), bool)
        # host mirror of each row's write offset (cache.length): capacity
        # stops use it, since a write past max_len clamps backward over
        # valid entries
        self._len_host = np.zeros((b,), np.int64)
        # per-slot sampling values (per_request_sampling): host mirrors set
        # at admission, the (4, B) device copy made again after a change
        self._samp_np = np.tile(np.asarray(
            [[self.temperature], [self.top_p], [self.presence_penalty],
             [self.frequency_penalty]], np.float32), (1, b))
        self._samp_dev: Optional[torch.Tensor] = None
        self._gen = torch.Generator(device=dev).manual_seed(0)
        # retired requests whose spans wait to render: (request, (T, H)
        # hidden states, spans)
        self._renders: List[Any] = []
        # registered prefixes: tuple(ids) → (slab cache (layers, 1, S),
        # validity (1, S), prefix length, padded width); order = recency
        self._prefixes: "OrderedDict[Tuple[int, ...], Tuple]" = OrderedDict()
        self._n_done = 0
        self._n_tokens = 0
        # speculative decoding: verify dispatches, the rows active in them
        # and the drafts they accepted
        self._n_verify = self._n_verify_rows = self._n_accepted = 0

    # ------------------------------------------------------------------
    def _agree(self, *toks):
        """Under tensor parallelism, the group's first rank's tokens on
        every rank (the same values: each rank samples the same gathered
        logits with the same generator; the broadcast makes it so)."""
        g = self._tp_group
        if g is not None:
            src = torch.distributed.get_global_rank(g, 0)
            for t in toks:
                torch.distributed.broadcast(t, src, group=g)
        return toks[0] if len(toks) == 1 else toks

    def _sample(self, logits, counts, samp=None):
        """Penalties, then greedy or temperature/nucleus sampling; with the
        (4, n) per-row vectors `samp`, `sample_rows`."""
        return self._agree(self._sample_local(logits, counts, samp))

    def _sample_local(self, logits, counts, samp=None):
        if samp is not None:
            return sample_rows(logits, counts, samp, self._gen)
        if self.presence_penalty or self.frequency_penalty:
            c = counts.to(logits.dtype)
            logits = (logits - self.presence_penalty * (c > 0).to(logits.dtype)
                      - self.frequency_penalty * c)
        return sample(logits, self.temperature, self.top_p, self._gen)

    def _samp_of(self, reqs) -> Optional[torch.Tensor]:
        """The (4, n) sampling vectors of a batch of admitted requests
        (None without per_request_sampling)."""
        if not self.per_request_sampling:
            return None
        return torch.from_numpy(np.stack(
            [_samp_values(self, r) for r in reqs], axis=1)).to(
            self.model.device)

    def _prompt_counts(self, ids, vocab):
        # the real prompt tokens (pads and negative sentinels excluded)
        valid = (ids >= 0) & (ids != self.pad_id)
        return torch.zeros((ids.shape[0], vocab), dtype=torch.int32,
                           device=ids.device).scatter_add_(
            1, ids.clamp(min=0), valid.to(torch.int32))

    def _prefill_impl(self, ids, images, samp=None):
        logits, _, cache, cache_valid, _ = self.model.prefill(
            ids, images, self.max_len, cache_dtype=self.cache_dtype)
        return self._first(ids, logits, cache, cache_valid, samp)

    def _prefill_text_impl(self, ids, samp=None):
        # text-only: never touches the vision tower
        logits, _, cache, cache_valid, _ = self.model.prefill_text(
            ids, self.max_len, cache_dtype=self.cache_dtype)
        return self._first(ids, logits, cache, cache_valid, samp)

    def _first(self, ids, logits, cache, cache_valid, samp, next_pos=None,
               prefix=()):
        """The first token of each admitted row, and the admission's
        results. `next_pos` defaults to the count of valid columns;
        `prefix`, the ids of a cached prefix, adds to the prompt counts."""
        if next_pos is None:
            next_pos = cache_valid.to(torch.int32).sum(dim=1)
        counts = self._prompt_counts(ids, logits.shape[-1])
        pref = [t for t in prefix if t >= 0 and t != self.pad_id]
        if pref:
            counts += torch.from_numpy(np.bincount(
                pref, minlength=counts.shape[1]).astype(np.int32)).to(
                counts.device)
        first = self._sample(logits, counts, samp)
        counts[torch.arange(ids.shape[0], device=ids.device), first] += 1
        return cache, cache_valid, next_pos, first, counts

    # ------------------------------------------------------------------
    # chunked prefill and the prefix cache
    def _chunk_cap(self) -> int:
        """Whole-chunk prompt capacity of a chunked admission: the cache
        width less one decode column, rounded down to whole chunks."""
        c = self.prefill_chunk
        return ((self.max_len - 2) // c) * c

    def _run_chunks(self, ids, lens, cache, cache_valid, pos_base: int = 0):
        """The (n, W) left-aligned ids (W a multiple of C; `lens` their
        true lengths on the host) through `prefill_text_chunk`, chunk by
        chunk, appended to `cache` → (each row's logits at its last token,
        cache, cache_valid)."""
        c = self.prefill_chunk
        dev = ids.device
        lens = np.asarray(lens)
        rows = torch.arange(ids.shape[0], device=dev)
        at = torch.from_numpy((lens - 1) % c).to(dev)
        first_logits = None
        for ci in range(ids.shape[1] // c):
            # valid tokens are contiguous from 0: min(len, ci·C) precede
            pos_off = torch.from_numpy((pos_base + np.minimum(
                lens, ci * c)).astype(np.int32)).to(dev)
            logits, _, cache, cache_valid = self.model.prefill_text_chunk(
                ids[:, ci * c:(ci + 1) * c], cache, cache_valid, pos_off)
            sel = logits[rows, at]
            last = torch.from_numpy((lens - 1) // c == ci).to(dev)
            first_logits = sel if first_logits is None else torch.where(
                last[:, None], sel, first_logits)
        return first_logits, cache, cache_valid

    def _prefill_text_chunked(self, ids, lens, samp=None):
        """A chunked text-only admission into a new cache; the contract of
        `_prefill_text_impl`."""
        n = ids.shape[0]
        cache = init_cache(self.model.cfg.llama, n, self.max_len,
                           dtype=self.cache_dtype, device=ids.device,
                           kv_heads=self.model.llama.kv_heads)
        cache_valid = torch.zeros((n, self.max_len), dtype=torch.bool,
                                  device=ids.device)
        logits, cache, cache_valid = self._run_chunks(ids, lens, cache,
                                                      cache_valid)
        next_pos = torch.as_tensor(lens, dtype=torch.int32, device=ids.device)
        return self._first(ids, logits, cache, cache_valid, samp, next_pos)

    @torch.inference_mode()
    def register_prefix(self, prefix_ids) -> None:
        """Compute and keep the K/V slab of a shared prompt prefix. Later
        text-only admissions whose prompt extends it (and whose suffix fits
        the chunk capacity left) start from a copy of the slab and prefill
        only their suffix. Needs `prefill_chunk > 0`; past `max_prefixes`
        the least recently used prefix goes (an admission refreshes it)."""
        if self.prefill_chunk <= 0:
            raise ValueError("register_prefix requires prefill_chunk > 0")
        ids = np.asarray(prefix_ids, np.int64)
        c = self.prefill_chunk
        pw = max(c, ((len(ids) + c - 1) // c) * c)
        if pw > self._chunk_cap() - c:
            raise ValueError("prefix leaves no room for a suffix chunk "
                             f"({pw} padded vs cap {self._chunk_cap()})")
        dev = self.model.device
        padded = np.full((1, pw), self.pad_id, np.int64)
        padded[0, :len(ids)] = ids
        cache = init_cache(self.model.cfg.llama, 1, self.max_len,
                           dtype=self.cache_dtype, device=dev,
                           kv_heads=self.model.llama.kv_heads)
        cache_valid = torch.zeros((1, self.max_len), dtype=torch.bool,
                                  device=dev)
        _, cache, cache_valid = self._run_chunks(
            torch.from_numpy(padded).to(dev), [len(ids)], cache, cache_valid)
        key = tuple(int(x) for x in ids)
        self._prefixes[key] = (cache, cache_valid, len(ids), pw)
        self._prefixes.move_to_end(key)
        while len(self._prefixes) > self.max_prefixes:
            self._prefixes.popitem(last=False)

    def _match_prefix(self, prompt_ids) -> Optional[Tuple[int, ...]]:
        """The longest registered prefix this prompt strictly extends (a
        suffix token gives the first token's logits) whose suffix fits the
        capacity left after its slab; else None (the plain chunked
        admission, which keeps the prompt's last tokens)."""
        if self.prefill_chunk <= 0 or not self._prefixes:
            return None
        prompt = tuple(int(x) for x in prompt_ids)
        best = None
        for key, (_, _, _, pw) in self._prefixes.items():
            if (len(key) < len(prompt) and prompt[:len(key)] == key
                    and len(prompt) - len(key) <= self._chunk_cap() - pw
                    and (best is None or len(key) > len(best))):
                best = key
        return best

    def _prefill_text_prefixed(self, suffix_ids, lens, pkey, samp=None):
        """A prefix-cached admission: n fresh copies of the slab, then the
        suffix's chunks, appended at the slab's padded width with positions
        continuing from the prefix's length."""
        pcache, pvalid, plen, pw = self._prefixes[pkey]
        n = suffix_ids.shape[0]

        def rep(t):                        # a copy, at n == 1 too
            return None if t is None else t.repeat(1, n, *[1] * (t.dim() - 2))

        cache = KVCache(k=rep(pcache.k), v=rep(pcache.v), length=pw,
                        k_scale=rep(pcache.k_scale),
                        v_scale=rep(pcache.v_scale))
        logits, cache, cache_valid = self._run_chunks(
            suffix_ids, lens, cache, pvalid.repeat(n, 1), pos_base=plen)
        next_pos = torch.as_tensor(plen + np.asarray(lens), dtype=torch.int32,
                                   device=suffix_ids.device)
        return self._first(suffix_ids, logits, cache, cache_valid, samp,
                           next_pos, prefix=pkey)

    def _insert_impl(self, slot: int, row: int, row_cache: KVCache,
                     row_valid, row_pos, row_tok, row_counts) -> None:
        """Copy row `row` of a prefill's results into slot `slot`."""
        c = self._cache
        c.k[:, slot] = row_cache.k[:, row]
        c.v[:, slot] = row_cache.v[:, row]
        if c.k_scale is not None:
            c.k_scale[:, slot] = row_cache.k_scale[:, row]
            c.v_scale[:, slot] = row_cache.v_scale[:, row]
        # the prefill's write offset is its prompt width, shared by its rows
        c.length[slot] = row_cache.length
        self._cache_valid[slot] = row_valid[row]
        self._pos[slot] = row_pos[row]
        self._cur_tok[slot] = row_tok[row]
        self._counts[slot] = row_counts[row]

    def _step_impl(self, active: torch.Tensor) -> torch.Tensor:
        """`decode_block` decode steps on the card from the (B,) active
        flags. Each step as one decode step of the JAX engine: rows
        inactive at its entry emit pad and keep their position and write
        offset; a row's flag turns off after it emits EOS or reaches the
        cache's last position. → the (K, B, 3 + H) float32 record of the
        block: each step's token, active-at-entry flag, position after the
        step and the hidden state of the token it fed."""
        samp = None
        if self.per_request_sampling:
            if self._samp_dev is None:
                self._samp_dev = torch.from_numpy(self._samp_np).to(
                    active.device)
            samp = self._samp_dev
        rows = torch.arange(active.shape[0], device=active.device)
        record = []
        for _ in range(self.decode_block):
            cache = self._cache
            logits, hidden, cache, self._cache_valid = self.model.decode_step(
                self._cur_tok[:, None], cache, self._cache_valid, self._pos)
            nxt = torch.where(active, self._sample(logits, self._counts, samp),
                              self.pad_id)
            self._counts.index_put_((rows, nxt), active.to(torch.int32),
                                    accumulate=True)
            self._pos = torch.where(active, self._pos + 1, self._pos)
            # decode_step advanced every row's length; inactive rows must
            # not advance, so their clamped writes stay pinned and droppable
            self._cache = cache._replace(length=torch.where(
                active, cache.length, cache.length - 1))
            self._cur_tok = nxt
            # exact in float32: token ids and positions < 2^24
            record.append(torch.cat([nxt[:, None].float(),
                                     active[:, None].float(),
                                     self._pos[:, None].float(),
                                     hidden.float()], dim=1))
            active = (active & (nxt != self.eos_id)
                      & (self._pos < self.max_len - 1))
        return torch.stack(record)

    def _spec_step_impl(self, drafts: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
        """One speculative dispatch: verify the (B, 1 + D) chunks of the
        current tokens and their drafts, accept the longest valid prefix of
        each row's drafts, rewind the rest. A row emits acc + 1 tokens (0
        when inactive): its length and position advance by that, the
        validity of its other new columns is cleared (their K/V is
        overwritten by later appends), and its next token is out_tok[acc].
        → the (B, 1 + D, 2 + H) float32 record: each position's token, the
        row's emitted count, and the hidden state of the token it fed."""
        b, d = drafts.shape
        t = d + 1
        dev = drafts.device
        old_len = self._cache.length
        logits, hidden, cache, cache_valid = self.model.verify_step(
            torch.cat([self._cur_tok[:, None], drafts], dim=1), self._cache,
            self._cache_valid, self._pos)
        if self.temperature == 0.0:
            out_tok = logits.argmax(-1)
            match = drafts == out_tok[:, :-1]
            acc = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
        else:
            scaled = logits.float() / self.temperature
            if self.top_p < 1.0:
                scaled = _top_p_filter(scaled, self.top_p)
            out_tok, acc = speculative_sample(
                torch.softmax(scaled, dim=-1), drafts,
                draw_spec(b, d, logits.shape[-1], self._gen, dev))
        out_tok, acc = self._agree(out_tok.contiguous(), acc.contiguous())
        emit = torch.where(active, acc + 1, 0).to(torch.int32)
        keep = torch.arange(t, device=dev)[None, :] < emit[:, None]
        self._cache_valid = mark_columns(cache_valid, old_len, keep)
        nxt = torch.gather(out_tok, 1, acc[:, None])[:, 0]
        self._cur_tok = torch.where(active, nxt, self.pad_id)
        self._cache = cache._replace(length=old_len + emit)
        self._pos = self._pos + emit
        # exact in float32: token ids and counts < 2^24
        return torch.cat([out_tok.float()[..., None],
                          emit.float()[:, None, None].expand(b, t, 1),
                          hidden.float()], dim=2)

    # ------------------------------------------------------------------
    def submit(self, prompt_ids, image=None, max_new_tokens: int = 64,
               stopping=None, on_token=None, temperature=None, top_p=None,
               presence_penalty=None, frequency_penalty=None) -> Request:
        overrides = (temperature, top_p, presence_penalty, frequency_penalty)
        if (any(o is not None for o in overrides)
                and not self.per_request_sampling):
            raise ValueError("per-request sampling overrides require "
                             "ServeEngine(per_request_sampling=True)")
        req = Request(prompt_ids=np.asarray(prompt_ids, np.int64),
                      image=image, max_new_tokens=max_new_tokens,
                      stopping=stopping, on_token=on_token,
                      temperature=temperature, top_p=top_p,
                      presence_penalty=presence_penalty,
                      frequency_penalty=frequency_penalty,
                      t_submit=time.monotonic())
        self._queue.put(req)
        return req

    def _emit(self, req: Request, tok: int) -> None:
        req.tokens.append(tok)
        self._n_tokens += 1
        if req.t_first is None:
            req.t_first = time.monotonic()
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish(self, req: Request) -> None:
        req.done = True
        req.t_done = time.monotonic()
        self._n_done += 1

    def _admit(self) -> None:
        """Prefill queued requests into free slots. Consecutive queued
        requests of one kind (image / text-only, and for text the same
        registered prefix or none) prefill as one batch: single-shot at
        `prompt_len`, in chunks, or after a copy of a prefix's slab."""
        free = [s for s in range(self.max_batch)
                if not self._active[s] and self._slots[s] is None]
        dev = self.model.device
        while free and not self._queue.empty():
            try:
                reqs = [self._queue.get_nowait()]
            except queue.Empty:            # racing submitter threads
                break
            if reqs[0].cancelled:          # cancelled while queued
                self._finish(reqs[0])
                continue
            has_image = reqs[0].image is not None
            pkey = (None if has_image
                    else self._match_prefix(reqs[0].prompt_ids))
            while len(reqs) < len(free) and not self._queue.empty():
                nxt = self._queue.queue[0]   # peek: the same kind only
                if nxt.cancelled:
                    try:
                        self._finish(self._queue.get_nowait())
                    except queue.Empty:
                        break
                    continue
                if (nxt.image is not None) != has_image:
                    break
                if (not has_image
                        and self._match_prefix(nxt.prompt_ids) != pkey):
                    break
                try:
                    reqs.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            slots = [free.pop(0) for _ in reqs]
            samp = self._samp_of(reqs)
            if pkey is not None or (self.prefill_chunk > 0 and not has_image):
                if pkey is not None:
                    self._prefixes.move_to_end(pkey)        # LRU refresh
                    prompts = [r.prompt_ids[len(pkey):] for r in reqs]
                else:
                    # the last cap tokens: the cache's width less one
                    # decode column, in whole chunks
                    prompts = [r.prompt_ids[-self._chunk_cap():]
                               for r in reqs]
                c = self.prefill_chunk
                lens = [len(p) for p in prompts]
                width = max(c, ((max(lens) + c - 1) // c) * c)
                ids = np.full((len(reqs), width), self.pad_id, np.int64)
                for i, p in enumerate(prompts):
                    ids[i, :len(p)] = p
                ids_t = torch.from_numpy(ids).to(dev)
                result = (self._prefill_text_chunked(ids_t, lens, samp)
                          if pkey is None else self._prefill_text_prefixed(
                              ids_t, lens, pkey, samp))
                self._harvest(reqs, slots, result)
                continue
            ids = np.full((len(reqs), self.prompt_len), self.pad_id, np.int64)
            for i, r in enumerate(reqs):
                p = r.prompt_ids[-self.prompt_len:]
                ids[i, :len(p)] = p
            ids_t = torch.from_numpy(ids).to(dev)
            if has_image:
                images = torch.from_numpy(np.stack(
                    [np.asarray(r.image, np.float32) for r in reqs])).to(dev)
                result = self._prefill_impl(ids_t, images, samp)
            else:
                result = self._prefill_text_impl(ids_t, samp)
            self._harvest(reqs, slots, result)

    def _harvest(self, reqs, slots, result) -> None:
        """Splice prefilled rows into their slots; emit the first tokens."""
        row_cache, row_valid, row_pos, first, row_counts = result
        firsts = first.cpu().numpy()
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._slots[slot] = req
            self._insert_impl(slot, i, row_cache, row_valid, row_pos, first,
                              row_counts)
            self._active[slot] = True
            self._len_host[slot] = int(row_cache.length)
            if self.per_request_sampling:
                self._samp_np[:, slot] = _samp_values(self, req)
                self._samp_dev = None
            tok = int(firsts[i])
            self._emit(req, tok)
            # the first token counts against the same stops as the others
            if (tok == self.eos_id or req.cancelled
                    or len(req.tokens) >= req.max_new_tokens
                    or (req.stopping is not None
                        and req.stopping.should_stop(req.tokens))):
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        """Free the slot. EOS and what follows leave the text; a request
        with a non-empty generated span waits for its render (its `done`
        flips at `_harvest_renders`)."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._active[slot] = False
        if req is None:
            return
        if self.eos_id in req.tokens:      # EOS itself stays out of the text
            req.tokens = req.tokens[:req.tokens.index(self.eos_id)]
        hiddens, req._hiddens = req._hiddens, []
        if (self.im_start_id is not None and self.im_end_id is not None
                and hiddens and not req.cancelled):
            # hiddens[j] is the hidden of tokens[j]; the last token was
            # never fed, so it repeats its predecessor's
            hid = np.stack(hiddens, axis=0)
            if len(hiddens) < len(req.tokens) + 1:
                hid = np.concatenate([hid, hid[-1:]], axis=0)
            spans = [(s, e) for s, e in find_image_spans(
                np.asarray(req.tokens), self.im_start_id, self.im_end_id)
                if e > s and e <= hid.shape[0]]
            if spans:
                self._renders.append((req, hid, spans))
                return
        self._finish(req)

    def _harvest_renders(self) -> None:
        """Render every waiting request's spans, in retirement order, and
        finish it. The renders run here, on the calling thread: none is
        left in flight when this returns."""
        dev = self.model.device
        renders, self._renders = self._renders, []
        for req, hid, spans in renders:
            for s, e in spans:
                span = torch.from_numpy(hid[None, s:e]).to(dev)
                img = generate_image(self.model, span, self._gen,
                                     self.num_iter, self.cfg_scale)
                req.images_out.append(img[0].cpu().numpy())
            self._finish(req)

    def stats(self) -> Dict[str, Any]:
        """Slot occupancy, queue depth, renders waiting and cumulative
        counters."""
        return {"active_slots": int(self._active.sum()),
                "max_batch": self.max_batch,
                "queued": self._queue.qsize(),
                "renders_in_flight": len(self._renders),
                "requests_done": self._n_done,
                "tokens_emitted": self._n_tokens,
                "prefixes": len(self._prefixes),
                "verify_dispatches": self._n_verify,
                "verify_rows": self._n_verify_rows,
                "drafts_accepted": self._n_accepted}

    @torch.inference_mode()
    def step(self) -> int:
        """Render what waits, admit, then run one dispatch: `decode_block`
        decode steps, or one speculative verify; returns the active
        count."""
        self._harvest_renders()
        self._admit()
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if self._active[slot] and req is not None and req.cancelled:
                self._retire(slot)
        # capacity: a dispatch writes up to `need` cache entries per row at
        # its offset; a row without room retires before it (a write past
        # max_len would clamp back over valid entries)
        need = 1 + self.spec_len if self.spec_len else self.decode_block
        for slot in range(self.max_batch):
            if (self._active[slot]
                    and self._len_host[slot] + need > self.max_len):
                self._retire(slot)
        if not self._active.any():
            return 0
        if self.spec_len > 0:
            return self._step_spec()
        record = self._step_impl(
            torch.from_numpy(self._active).to(self.model.device))
        record = record.cpu().numpy()          # the block's one copy
        toks = record[:, :, 0].astype(np.int64)
        act_in = record[:, :, 1] > 0
        pos = record[:, :, 2]
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            for t in range(self.decode_block):
                if not act_in[t, slot]:
                    break
                req._hiddens.append(record[t, slot, 3:])
                tok = int(toks[t, slot])
                self._emit(req, tok)
                self._len_host[slot] += 1
                if (tok == self.eos_id
                        or len(req.tokens) >= req.max_new_tokens
                        or pos[t, slot] >= self.max_len - 1
                        or (req.stopping is not None
                            and req.stopping.should_stop(req.tokens))):
                    self._retire(slot)
                    break
        return int(self._active.sum())

    def _step_spec(self) -> int:
        """Draft by prompt lookup, verify in one dispatch, and apply the
        EOS, budget and keyword stops over each row's accepted prefix (the
        cache's capacity is `step()`'s guard)."""
        d = self.spec_len
        drafts = np.full((self.max_batch, d), self.pad_id, np.int64)
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            ctx = ([int(x) for x in req.prompt_ids[-self.prompt_len:]]
                   + req.tokens)
            drafts[slot] = draft_prompt_lookup(ctx, d, self.spec_ngram,
                                               self.pad_id)
        drafts = clean_drafts(drafts, self.model.cfg.llama.vocab_size,
                              self.pad_id)
        dev = self.model.device
        record = self._spec_step_impl(
            torch.from_numpy(drafts).to(dev),
            torch.from_numpy(self._active).to(dev)).cpu().numpy()
        self._n_verify += 1
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            emit = int(record[slot, 0, 1])
            self._n_verify_rows += 1
            self._n_accepted += emit - 1
            for i in range(emit):
                req._hiddens.append(record[slot, i, 2:])
                tok = int(record[slot, i, 0])
                self._emit(req, tok)
                self._len_host[slot] += 1
                if (tok == self.eos_id
                        or len(req.tokens) >= req.max_new_tokens
                        or (req.stopping is not None
                            and req.stopping.should_stop(req.tokens))):
                    self._retire(slot)
                    break
        return int(self._active.sum())

    @torch.inference_mode()
    def run(self, max_steps: int = 100000) -> None:
        """Decode until every submitted request is done (its images
        rendered)."""
        for _ in range(max_steps):
            if self.step() == 0 and self._queue.empty():
                self._harvest_renders()
                return


def _samp_values(engine: ServeEngine, req: Request) -> np.ndarray:
    """A request's (4,) temperature, top-p, presence and frequency
    penalties, the engine's where the request gives none."""
    return np.asarray(
        [engine.temperature if req.temperature is None else req.temperature,
         engine.top_p if req.top_p is None else req.top_p,
         engine.presence_penalty if req.presence_penalty is None
         else req.presence_penalty,
         engine.frequency_penalty if req.frequency_penalty is None
         else req.frequency_penalty], np.float32)


def sample_rows(logits: torch.Tensor, counts: torch.Tensor,
                samp: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-row sampling: samp (4, B) the temperature, top-p, presence and
    frequency penalties of each row. Every row is penalised; greedy rows
    (temperature 0) take the argmax, the others the categorical of their
    tempered, nucleus-filtered logits."""
    t, tp, pres, freq = samp
    c = counts.to(logits.dtype)
    logits = (logits - pres[:, None] * (c > 0).to(logits.dtype)
              - freq[:, None] * c)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / t.clamp(min=1e-6)[:, None]
    probs = torch.softmax(_top_p_filter(scaled, tp[:, None]), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(t > 0.0, sampled, greedy)
