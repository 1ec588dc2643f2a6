"""Continuous-batching serving engine over the static KV cache.

The counterpart of the core of `setok_tpu/serve/engine.py`:

  * a fixed `max_batch` slot array; each slot owns one row of the
    (layers, B, max_len, kv_heads, head_dim) KV cache and its own write
    offset (`KVCache.length` is a (B,) tensor), so the decode step is one
    batched `Setokim.decode_step` whatever the slots hold;
  * continuous batching: between decode steps finished slots retire and
    queued requests are admitted by prefilling them (prompts padded to
    `prompt_len`; requests of one kind queued together prefill as one
    batch, image and text-only requests apart) and copying each prefilled
    row into its slot;
  * greedy or temperature/top-p sampling, presence/frequency penalties,
    EOS, budget, cache-capacity and keyword stops, cancellation, and the
    per-request timing (`Request.ttft`, `Request.latency`).

The JAX engine prefills on a worker thread and splices the result in at a
later step. Here `step()` prefills its admissions synchronously, before
the decode: a request's rows are computed by the same functions on the
same inputs either way, and no row of the batch depends on another, so
every request's tokens are the same; only when a request joins the batch
can differ.

Not ported here, each raising `NotImplementedError` with its ROADMAP.md
entry: chunked prefill and prefix caching (`prefill_chunk`,
`register_prefix`), `decode_block > 1`, speculative decoding
(`spec_len`), `per_request_sampling`, multi-card serving (`mesh`) and
rendering generated image spans (`im_start_id`).
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from setok_tpu_torch.models.generate import sample
from setok_tpu_torch.models.llama import KVCache
from setok_tpu_torch.models.setokim import Setokim

SERVING_FEATURES = "ROADMAP.md, Queue A (serving features)"


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
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    # monotonic seconds, None until reached: submit → first token → done
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

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
    per_request_sampling: bool = False
    im_start_id: Optional[int] = None
    im_end_id: Optional[int] = None
    decode_block: int = 1
    spec_len: int = 0
    prefill_chunk: int = 0
    cache_dtype: Any = torch.bfloat16
    mesh: Any = None

    def __post_init__(self):
        for name, bad in (("per_request_sampling", self.per_request_sampling),
                          ("im_start_id (image rendering)",
                           self.im_start_id is not None),
                          ("decode_block > 1", self.decode_block != 1),
                          ("spec_len > 0", self.spec_len != 0),
                          ("prefill_chunk > 0", self.prefill_chunk != 0),
                          ("mesh", self.mesh is not None)):
            if bad:
                raise NotImplementedError(f"{name} is not ported: "
                                          f"{SERVING_FEATURES}")
        if self.prompt_len >= self.max_len:
            raise ValueError("prompt_len must leave decode room in max_len")
        b, s = self.max_batch, self.max_len
        cfg = self.model.cfg.llama
        dev = self.model.device
        kv_shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)
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
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self._n_done = 0
        self._n_tokens = 0

    # ------------------------------------------------------------------
    def _sample(self, logits, counts):
        """Penalties, then greedy or temperature/nucleus sampling."""
        if self.presence_penalty or self.frequency_penalty:
            c = counts.to(logits.dtype)
            logits = (logits - self.presence_penalty * (c > 0).to(logits.dtype)
                      - self.frequency_penalty * c)
        return sample(logits, self.temperature, self.top_p, self._gen)

    def _prompt_counts(self, ids, vocab):
        # the real prompt tokens (pads and negative sentinels excluded)
        valid = (ids >= 0) & (ids != self.pad_id)
        return torch.zeros((ids.shape[0], vocab), dtype=torch.int32,
                           device=ids.device).scatter_add_(
            1, ids.clamp(min=0), valid.to(torch.int32))

    def _prefill_impl(self, ids, images):
        logits, _, cache, cache_valid, _ = self.model.prefill(
            ids, images, self.max_len, cache_dtype=self.cache_dtype)
        return self._first(ids, logits, cache, cache_valid)

    def _prefill_text_impl(self, ids):
        # text-only: never touches the vision tower
        logits, _, cache, cache_valid, _ = self.model.prefill_text(
            ids, self.max_len, cache_dtype=self.cache_dtype)
        return self._first(ids, logits, cache, cache_valid)

    def _first(self, ids, logits, cache, cache_valid):
        next_pos = cache_valid.to(torch.int32).sum(dim=1)
        counts = self._prompt_counts(ids, logits.shape[-1])
        first = self._sample(logits, counts)
        counts[torch.arange(ids.shape[0], device=ids.device), first] += 1
        return cache, cache_valid, next_pos, first, counts

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

    def _step_impl(self, active):
        cache = self._cache
        logits, _, cache, self._cache_valid = self.model.decode_step(
            self._cur_tok[:, None], cache, self._cache_valid, self._pos)
        nxt = torch.where(active, self._sample(logits, self._counts),
                          self.pad_id)
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        self._counts.index_put_((rows, nxt), active.to(torch.int32),
                                accumulate=True)
        self._pos = torch.where(active, self._pos + 1, self._pos)
        # decode_step advanced every row's length; retired rows must not
        # advance, so their clamped writes stay pinned and droppable
        self._cache = cache._replace(length=torch.where(
            active, cache.length, cache.length - 1))
        self._cur_tok = nxt

    # ------------------------------------------------------------------
    def submit(self, prompt_ids, image=None, max_new_tokens: int = 64,
               stopping=None, on_token=None) -> Request:
        req = Request(prompt_ids=np.asarray(prompt_ids, np.int64),
                      image=image, max_new_tokens=max_new_tokens,
                      stopping=stopping, on_token=on_token,
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
        requests of one kind (image / text-only) prefill as one batch."""
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
                try:
                    reqs.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            slots = [free.pop(0) for _ in reqs]
            ids = np.full((len(reqs), self.prompt_len), self.pad_id, np.int64)
            for i, r in enumerate(reqs):
                p = r.prompt_ids[-self.prompt_len:]
                ids[i, :len(p)] = p
            ids_t = torch.from_numpy(ids).to(dev)
            if has_image:
                images = torch.from_numpy(np.stack(
                    [np.asarray(r.image, np.float32) for r in reqs])).to(dev)
                result = self._prefill_impl(ids_t, images)
            else:
                result = self._prefill_text_impl(ids_t)
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
            tok = int(firsts[i])
            self._emit(req, tok)
            # the first token counts against the same stops as the others
            if (tok == self.eos_id or req.cancelled
                    or len(req.tokens) >= req.max_new_tokens
                    or (req.stopping is not None
                        and req.stopping.should_stop(req.tokens))):
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._active[slot] = False
        if req is None:
            return
        if self.eos_id in req.tokens:      # EOS itself stays out of the text
            req.tokens = req.tokens[:req.tokens.index(self.eos_id)]
        self._finish(req)

    def stats(self) -> Dict[str, Any]:
        """Slot occupancy, queue depth and cumulative counters."""
        return {"active_slots": int(self._active.sum()),
                "max_batch": self.max_batch,
                "queued": self._queue.qsize(),
                "requests_done": self._n_done,
                "tokens_emitted": self._n_tokens}

    @torch.inference_mode()
    def step(self) -> int:
        """Admit, then run one decode step; returns the active count."""
        self._admit()
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if self._active[slot] and req is not None and req.cancelled:
                self._retire(slot)
        # capacity: a decode step writes one cache entry per row at its
        # offset; a row without room retires before it
        for slot in range(self.max_batch):
            if self._active[slot] and self._len_host[slot] + 1 > self.max_len:
                self._retire(slot)
        if not self._active.any():
            return 0
        self._step_impl(torch.from_numpy(self._active).to(self.model.device))
        toks = self._cur_tok.cpu().numpy()
        pos = self._pos.cpu().numpy()
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            tok = int(toks[slot])
            self._emit(req, tok)
            self._len_host[slot] += 1
            if (tok == self.eos_id or len(req.tokens) >= req.max_new_tokens
                    or int(pos[slot]) >= self.max_len - 1
                    or (req.stopping is not None
                        and req.stopping.should_stop(req.tokens))):
                self._retire(slot)
        return int(self._active.sum())

    def run(self, max_steps: int = 100000) -> None:
        """Decode until every submitted request is done."""
        for _ in range(max_steps):
            if self.step() == 0 and self._queue.empty():
                return
