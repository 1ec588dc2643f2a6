"""The port's chunked prefill and prefix cache against the JAX package's
engine, on `tiny_setokim()` (2 trunk layers) with the same flax weights:

  * chunked prefill (after JAX tests/test_chunked_prefill.py): the chunked
    cache (K, V and scales at every valid column, validity, length)
    identical to a single-shot prefill of the same padded width (C = 8 and
    16 over a 16-wide batch, float32 and int8 caches); greedy streams equal to the JAX engine's
    (the near-tie rule of tests/test_torch_serve.py); a 24-token prompt
    past a 16 bucket admits whole;
  * the prefix cache (after tests/test_prefix_cache.py): a prefixed
    admission byte-identical to a plain chunked one when the prefix's
    length is a multiple of C, streams equal when it is not (and equal to
    the JAX engine's), LRU eviction and the fallback on a mismatch, the
    registered slab unchanged after admissions of one and of two rows,
    and the `ValueError`s.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.serve import ServeEngine as JServeEngine
from setok_tpu_torch.serve import ServeEngine
from test_torch_serve import EOS, PAD, compare_streams, requests
from test_torch_setokim import L, MAX_LEN, port_model, prompts

MAX_NEW = 6
CACHES = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


@functools.lru_cache(maxsize=1)
def tiny_flax_params():
    """The flax weights of tests/test_torch_setokim.py's fixture, made once
    per process for the serving-feature test files."""
    model = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    ids, images = prompts(0, 1)
    ids, images = jnp.asarray(ids), jnp.asarray(images)
    params = jax.jit(lambda r: model.init(
        r, ids, images, ids, images, jax.random.PRNGKey(1),
        method=model.init_all))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_params():
    return tiny_flax_params()


def text_prompts():
    rs = np.random.RandomState(0)
    return [np.concatenate([[1], rs.randint(4, 500, size=10)]),   # 11
            np.asarray([1, 17, 23, 99, 5])]                       # 5


def serve(engine, prompts, max_new=MAX_NEW):
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    assert all(r.done and len(r.tokens) == max_new for r in handles)
    return handles


def slot_state(eng, slot):
    """Everything a slot's admission wrote: its cache row, validity,
    write offset, position and first token."""
    c = eng._cache
    out = {"k": c.k[:, slot], "v": c.v[:, slot],
           "valid": eng._cache_valid[slot], "length": c.length[slot],
           "pos": eng._pos[slot], "tok": eng._cur_tok[slot]}
    if c.k_scale is not None:
        out.update(k_scale=c.k_scale[:, slot], v_scale=c.v_scale[:, slot])
    return {k: v.clone() for k, v in out.items()}


def assert_same_state(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ----------------------------------------------------------------------------
# chunked prefill


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("cache", list(CACHES))
def test_chunked_cache_equals_single_shot(flax_params, chunk, cache):
    eng = ServeEngine(port_model(flax_params), max_batch=2, prompt_len=16,
                      max_len=MAX_LEN, eos_id=-1, pad_id=PAD,
                      prefill_chunk=chunk, cache_dtype=CACHES[cache][0])
    prompts = text_prompts()
    ids = np.zeros((2, 16), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    ids = torch.from_numpy(ids)
    with torch.inference_mode():
        want = eng._prefill_text_impl(ids)
        got = eng._prefill_text_chunked(ids, [len(p) for p in prompts])
    (wc, wv, wpos, wfirst, wcounts), (gc, gv, gpos, gfirst, gcounts) = \
        want, got
    assert gc.length == wc.length == 16
    assert (gc.k_scale is None) == (wc.k_scale is None) == (cache == "f32")
    # a pad's query is wholly masked and attends evenly over the cache's
    # columns, which hold what has been written so far: its K/V in the
    # next layer depends on the chunking (as in the JAX package), and no
    # query reads it. Every valid column is identical, and with one chunk
    # every column is.
    cols = wv if chunk < 16 else torch.ones_like(wv)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(gc, name), getattr(wc, name)
        if a is not None:
            assert torch.equal(a[:, cols], b[:, cols]), name
    for a, b in ((gv, wv), (gpos, wpos), (gfirst, wfirst),
                 (gcounts, wcounts)):
        assert torch.equal(a, b)


def test_chunked_streams_match_jax(flax_params):
    """Six requests (two with an image, which stay single-shot) through
    two slots, C = 8: the port's streams against its single-shot ones and
    the JAX engine's."""
    reqs = requests()
    kw = dict(max_batch=2, prompt_len=L, max_len=MAX_LEN, eos_id=EOS,
              pad_id=PAD)

    def run(engine):
        handles = [engine.submit(ids, image=img, max_new_tokens=MAX_NEW)
                   for ids, img in reqs]
        engine.run()
        return handles

    got = run(ServeEngine(port_model(flax_params), prefill_chunk=8, **kw))
    single = run(ServeEngine(port_model(flax_params), **kw))
    assert [r.tokens for r in got] == [r.tokens for r in single]
    want = run(JServeEngine(JSetokim(jcfg.tiny_setokim(), target_token_id=3),
                            flax_params, prefill_chunk=8, **kw))
    compare_streams(flax_params, reqs, want, got)


def test_long_prompt_admits_whole(flax_params):
    """A 24-token prompt overflows a 16 bucket (the single-shot engine
    keeps its last 16 tokens) but admits whole with C = 8: its stream is
    that of a single-shot engine whose bucket holds the whole prompt."""
    model = port_model(flax_params)
    rs = np.random.RandomState(1)
    prompt = np.concatenate([[1], rs.randint(4, 500, size=23)])
    kw = dict(max_batch=1, max_len=48, eos_id=-1, pad_id=PAD)
    whole = serve(ServeEngine(model, prompt_len=24, **kw), [prompt])[0]
    chunked = serve(ServeEngine(model, prompt_len=16, prefill_chunk=8, **kw),
                    [prompt])[0]
    cut = serve(ServeEngine(model, prompt_len=16, **kw), [prompt])[0]
    assert chunked.tokens == whole.tokens
    assert cut.tokens != whole.tokens


# ----------------------------------------------------------------------------
# the prefix cache

PREFIX = np.asarray([1, 40, 41, 42, 43, 44, 45, 46], np.int64)    # 8 = C


def prefix_engine(model, **kw):
    args = dict(max_batch=2, prompt_len=16, max_len=48, eos_id=-1,
                pad_id=PAD, prefill_chunk=8)
    args.update(kw)
    return ServeEngine(model, **args)


@pytest.mark.parametrize("cache", list(CACHES))
def test_prefixed_admission_is_byte_identical_when_aligned(flax_params,
                                                          cache):
    """plen = C: the slot a prefixed admission fills equals the one a plain
    chunked admission of the whole prompt fills, bit for bit."""
    model = port_model(flax_params)
    prompt = np.concatenate([PREFIX, [60, 61, 62, 63, 64]])
    dt = CACHES[cache][0]
    plain = prefix_engine(model, max_batch=1, cache_dtype=dt)
    cached = prefix_engine(model, max_batch=1, cache_dtype=dt)
    cached.register_prefix(PREFIX)
    with torch.inference_mode():
        for eng in (plain, cached):
            eng.submit(prompt, max_new_tokens=4)
            eng._admit()
    assert_same_state(slot_state(cached, 0), slot_state(plain, 0))
    assert cached._len_host[0] == plain._len_host[0] == 16


def test_prefixed_streams_match_when_unaligned(flax_params):
    """plen = 5 (the slab padded to 8, holes masked): the streams equal a
    plain chunked engine's and the JAX prefixed engine's."""
    prefix = PREFIX[:5]
    prompts = [np.concatenate([prefix, [70 + i, 80, 90 + i][:2 + i]])
               for i in range(2)]
    model = port_model(flax_params)
    plain = serve(prefix_engine(model), prompts)
    eng = prefix_engine(model)
    eng.register_prefix(prefix)
    got = serve(eng, prompts)
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    jeng = JServeEngine(JSetokim(jcfg.tiny_setokim(), target_token_id=3),
                        flax_params, max_batch=2, prompt_len=16, max_len=48,
                        eos_id=-1, pad_id=PAD, prefill_chunk=8)
    jeng.register_prefix(prefix)
    want = serve(jeng, prompts)
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_lru_eviction_and_mismatch_fallback(flax_params):
    model = port_model(flax_params)
    other = np.asarray([1, 50, 51, 52, 53, 54, 55, 56], np.int64)
    eng = prefix_engine(model, max_prefixes=1)
    eng.register_prefix(PREFIX)
    eng.register_prefix(other)                  # evicts PREFIX (cap 1)
    assert list(eng._prefixes) == [tuple(other)]
    prompt = np.concatenate([PREFIX, [60, 61]])
    assert eng._match_prefix(prompt) is None
    # the fallback is the plain chunked admission: the same stream
    plain = serve(prefix_engine(model), [prompt])[0]
    assert serve(eng, [prompt])[0].tokens == plain.tokens
    # a hit refreshes recency: with two, the older one hit survives
    eng2 = prefix_engine(model, max_prefixes=2)
    eng2.register_prefix(PREFIX)
    eng2.register_prefix(other)
    serve(eng2, [prompt])
    eng2.register_prefix(PREFIX[:5])
    assert set(eng2._prefixes) == {tuple(PREFIX), tuple(PREFIX[:5])}
    # the longest usable prefix wins; a prompt equal to a prefix has no
    # suffix token, and a suffix past the capacity falls back
    assert eng2._match_prefix(prompt) == tuple(PREFIX)
    assert eng2._match_prefix(PREFIX) == tuple(PREFIX[:5])
    long_suffix = np.concatenate([PREFIX, np.arange(100, 140)])
    assert eng2._match_prefix(long_suffix) is None


@pytest.mark.parametrize("n", [1, 2])
def test_slab_survives_admissions(flax_params, n):
    """The cache is written in place: each admission starts from a copy of
    the slab, so the registered slab is unchanged after it."""
    eng = prefix_engine(port_model(flax_params), cache_dtype=torch.int8)
    eng.register_prefix(PREFIX[:6])
    slab = eng._prefixes[tuple(PREFIX[:6])]
    before = [t.clone() for t in (slab[0].k, slab[0].v, slab[0].k_scale,
                                  slab[0].v_scale, slab[1])]
    prompts = [np.concatenate([PREFIX[:6], [60 + i, 61, 62]])
               for i in range(n)]
    serve(eng, prompts)
    serve(eng, prompts)
    after = (slab[0].k, slab[0].v, slab[0].k_scale, slab[0].v_scale, slab[1])
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_prefix_value_errors(flax_params):
    model = port_model(flax_params)
    with pytest.raises(ValueError, match="prefill_chunk > 0"):
        prefix_engine(model, prefill_chunk=0).register_prefix(PREFIX)
    with pytest.raises(ValueError, match="no room"):
        # 40 tokens pad to 40 > cap (46 // 8)·8 - 8 = 32
        prefix_engine(model).register_prefix(np.arange(1, 41))
    with pytest.raises(ValueError, match="prefill_chunk must be >= 0"):
        prefix_engine(model, prefill_chunk=-1)
    eng = prefix_engine(model)
    eng.register_prefix(PREFIX)
    assert eng.stats()["prefixes"] == 1
