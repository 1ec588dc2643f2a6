"""The port's ServeEngine against the JAX package's, on `tiny_setokim()`.

Six greedy requests, two with an image, through `max_batch=4` slots: the
first admissions fill the slots in three prefills (text, image, two texts),
the last two wait for retirements, so admissions interleave with decode
steps. Both engines hold the same flax weights and run their default bf16
cache. The token streams must be identical; where one first differs, the
test passes only if the JAX logits' top-2 gap at that step is below 1e-4
of their largest magnitude (a near-tie a last-bit difference may flip),
and it prints that gap. The same holds with presence and frequency
penalties, which act on the greedy choice.
"""

import numpy as np
import jax.numpy as jnp

from setok_tpu import config as jcfg
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.serve import ServeEngine as JServeEngine
from setok_tpu_torch.serve import ServeEngine
from test_torch_setokim import (IMAGE_TOKEN_INDEX, K_MAX, L, MAX_LEN,
                                flax_params, port_model)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_NEW = 10
EOS, PAD = 2, 0
TIE_GAP = 1e-4
IMAGE_REQUESTS = (1, 4)

__all__ = ["flax_params"]          # the shared module-scoped fixture


def requests():
    rs = np.random.RandomState(17)
    out = []
    for i in range(6):
        n_text = 5 + (3 * i) % 7
        text = rs.randint(10, 400, n_text)
        if i in IMAGE_REQUESTS:
            ids = np.concatenate([[1], np.full(K_MAX, IMAGE_TOKEN_INDEX),
                                  text])
            image = rs.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
        else:
            ids, image = np.concatenate([[1], text]), None
        out.append((ids.astype(np.int64), image))
    return out


def jax_top2_gap(params, ids, image, tokens, at):
    """The JAX model's top-2 logit gap, relative to max|logits|, where it
    chose tokens[at] (a batch of one, the engines' bf16 cache)."""
    model = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    row = np.full((1, L), PAD, np.int64)
    row[0, :len(ids)] = ids
    if image is None:
        logits, _, cache, valid, _ = model.apply(
            params, jnp.asarray(row), MAX_LEN, cache_dtype=jnp.bfloat16,
            method=model.prefill_text)
    else:
        logits, _, cache, valid, _ = model.apply(
            params, jnp.asarray(row), jnp.asarray(image)[None], MAX_LEN,
            cache_dtype=jnp.bfloat16, method=model.prefill)
    pos = jnp.sum(valid.astype(jnp.int32), axis=1)
    length = jnp.full((1,), cache.length, jnp.int32)
    cache = cache._replace(length=length)
    for tok in tokens[:at]:
        logits, _, cache, valid = model.apply(
            params, jnp.asarray([[tok]], jnp.int32), cache, valid, pos,
            method=model.decode_step)
        pos = pos + 1
    top = np.sort(np.asarray(logits[0], np.float64))[::-1]
    return (top[0] - top[1]) / np.abs(top).max()


def compare_streams(params, reqs, jreqs, preqs):
    for i, (jr, pr) in enumerate(zip(jreqs, preqs)):
        assert pr.ttft is not None and pr.latency >= pr.ttft
        if pr.tokens == jr.tokens:
            continue
        at = next(j for j, (a, b) in enumerate(zip(pr.tokens, jr.tokens))
                  if a != b)
        gap = jax_top2_gap(params, *reqs[i], jr.tokens, at)
        print(f"request {i}: streams first differ at token {at}, JAX top-2 "
              f"gap {gap:.3e} of max|logits|")
        assert gap < TIE_GAP, (i, pr.tokens, jr.tokens, gap)
        assert pr.tokens[:at] == jr.tokens[:at]


def test_engine_streams_match_jax_engine(flax_params):
    reqs = requests()
    jmodel = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    jeng = JServeEngine(jmodel, flax_params, max_batch=4, prompt_len=L,
                        max_len=MAX_LEN, eos_id=EOS, pad_id=PAD)
    jreqs = [jeng.submit(ids, image=img, max_new_tokens=MAX_NEW)
             for ids, img in reqs]
    jeng.run()

    eng = ServeEngine(port_model(flax_params), max_batch=4, prompt_len=L,
                      max_len=MAX_LEN, eos_id=EOS, pad_id=PAD)
    preqs = [eng.submit(ids, image=img, max_new_tokens=MAX_NEW)
             for ids, img in reqs]
    steps = 0
    while eng.step() or not eng._queue.empty():
        steps += 1
    assert all(r.done for r in jreqs + preqs)
    assert steps > MAX_NEW, "the admissions did not interleave"
    stats = eng.stats()
    assert stats["requests_done"] == 6 and stats["active_slots"] == 0
    compare_streams(flax_params, reqs, jreqs, preqs)


def test_penalised_streams_match_jax_engine(flax_params):
    """Text-only requests, two slots, presence and frequency penalties
    (the near-tie rule reads the unpenalised logits: it only excuses)."""
    reqs = [r for r in requests() if r[1] is None][:3]
    kw = dict(max_batch=2, prompt_len=L, max_len=MAX_LEN, eos_id=EOS,
              pad_id=PAD, presence_penalty=0.5, frequency_penalty=0.3)
    jeng = JServeEngine(JSetokim(jcfg.tiny_setokim(), target_token_id=3),
                        flax_params, **kw)
    jreqs = [jeng.submit(ids, max_new_tokens=MAX_NEW) for ids, _ in reqs]
    jeng.run()
    eng = ServeEngine(port_model(flax_params), **kw)
    preqs = [eng.submit(ids, max_new_tokens=MAX_NEW) for ids, _ in reqs]
    eng.run()
    assert all(r.done for r in preqs)
    compare_streams(flax_params, reqs, jreqs, preqs)
