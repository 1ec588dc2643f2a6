"""The port's speculative decoding against the JAX package, on
`tiny_setokim()` (2 trunk layers) with the same flax weights:

  * `draft_prompt_lookup` equal to the JAX function on random contexts
    (hypothesis);
  * `speculative_sample` equal to JAX's (`out_tok` and `acc`, exactly) on
    JAX's own draws: the uniforms of its first key and the Gumbel noise of
    its second, since `jax.random.categorical` is argmax(logits + gumbel);
  * the int8 cache's dequantised route (every forward of T > 1 queries)
    giving each position the decode kernel's plain result to the bit;
  * `Setokim.verify_step` and `prefill_text_chunk` against the JAX methods:
    logits, hidden and cache within the 1e-4 max-rel of the decode step
    (tests/test_torch_setokim.py), validity exact, a row whose columns run
    past the cache dropping them (the K/V write clamps);
  * greedy streams at spec_len 4 equal to the port's single steps and to
    the JAX engine's (the near-tie rule of tests/test_torch_serve.py),
    image and text requests, float32 and int8 caches;
  * an oracle drafter (the known greedy continuation) finishes in
    ⌈(max_new − 1)/(d + 1)⌉ verify dispatches;
  * at temperature 0.8 / top-p 0.9 the engine is reproducible from its
    seed and emits no id outside [0, vocab), a forced sentinel draft
    (IMAGE_TOKEN_INDEX, which the JAX engine would gather at) included;
  * the configuration errors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from setok_tpu import config as jcfg
from setok_tpu.models.llama import init_cache as j_init_cache
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.serve import ServeEngine as JServeEngine
from setok_tpu.serve import speculative as jspec
from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.models.llama import init_cache
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.serve import engine as engine_mod
from setok_tpu_torch.serve.speculative import (SpecDraws, clean_drafts,
                                               draft_prompt_lookup,
                                               speculative_sample)
from test_torch_serve import EOS, PAD, compare_streams, requests
from test_torch_serve_chunked import tiny_flax_params
from test_torch_setokim import L, MAX_LEN, max_rel, port_model
from test_torch_setokim import prompts as image_prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D = 4
MAX_NEW = 9
VOCAB = jcfg.tiny_setokim().llama.vocab_size


@pytest.fixture(scope="module")
def flax_params():
    return tiny_flax_params()


def serve(engine, reqs, max_new=MAX_NEW):
    handles = [engine.submit(ids, image=img, max_new_tokens=max_new)
               for ids, img in reqs]
    engine.run()
    assert all(r.done for r in handles)
    return handles


# ----------------------------------------------------------------------------
# the drafter and the sampler


@settings(max_examples=60, deadline=None)
@given(ctx=st.lists(st.integers(-1, 6), max_size=24),
       num_draft=st.integers(1, 5), ngram=st.integers(1, 4))
def test_draft_prompt_lookup_matches_jax(ctx, num_draft, ngram):
    ctx = [IMAGE_TOKEN_INDEX if t < 0 else t for t in ctx]
    np.testing.assert_array_equal(
        draft_prompt_lookup(ctx, num_draft, ngram, PAD),
        jspec.draft_prompt_lookup(ctx, num_draft, ngram, PAD))


def test_clean_drafts_maps_outside_ids_to_pad():
    got = clean_drafts(np.asarray([[5, IMAGE_TOKEN_INDEX, VOCAB, 0]]), VOCAB,
                       PAD)
    np.testing.assert_array_equal(got, [[5, PAD, PAD, 0]])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculative_sample_matches_jax_on_its_draws(seed):
    """Random chunks where drafts are often likely, some rows nucleus-cut
    (zero probabilities), on the draws JAX takes from its key."""
    rs = np.random.RandomState(seed)
    b, t, v = 6, D + 1, 40
    logits = rs.randn(b, t, v).astype(np.float32) * 2
    drafts = rs.randint(0, v, (b, t - 1))
    boost = rs.rand(b, t - 1) < 0.7
    for i, j in zip(*np.nonzero(boost)):
        logits[i, j, drafts[i, j]] += 4.0
    logits[: b // 2, :, : v // 2] = -np.inf          # cut by the nucleus
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    key = jax.random.PRNGKey(seed)
    want_tok, want_acc = jax.jit(jspec.speculative_sample)(
        jnp.asarray(probs), jnp.asarray(drafts, jnp.int32), key)
    u_key, s_key = jax.random.split(key)
    draws = SpecDraws(
        torch.tensor(np.asarray(jax.random.uniform(u_key, (b, t - 1)))),
        torch.tensor(np.asarray(jax.random.gumbel(s_key, (b, v)))))
    got_tok, got_acc = speculative_sample(torch.tensor(probs),
                                          torch.from_numpy(drafts), draws)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    assert len(set(got_acc.tolist())) > 1
    for row in range(b):
        n = int(want_acc[row]) + 1         # the meaningful entries
        np.testing.assert_array_equal(got_tok[row, :n].numpy(),
                                      np.asarray(want_tok)[row, :n])


def test_exact_cache_attention_is_the_decode_plain_per_position():
    """The dequantised route of a T-query forward (a verify, a chunk)
    gives each position the decode kernel's plain result, to the bit:
    positions do not depend on how many share the call."""
    from setok_tpu_torch.kernels import cache_attention as ca
    rs = np.random.RandomState(7)
    b, t, h, kvh, s, d = 2, 5, 4, 2, 24, 16
    q = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
    k8 = torch.from_numpy(rs.randint(-127, 128, (b, s, kvh, d)).astype(
        np.int8))
    v8 = torch.from_numpy(rs.randint(-127, 128, (b, s, kvh, d)).astype(
        np.int8))
    ks = torch.from_numpy(rs.rand(b, s, kvh).astype(np.float32) / 50)
    vs = torch.from_numpy(rs.rand(b, s, kvh).astype(np.float32) / 50)
    mask = torch.from_numpy(rs.rand(b, t, s) > 0.3)
    mask[1, 2] = False                          # a wholly masked query
    got = ca.int8_cache_attention_exact(q, k8, ks, v8, vs, mask, d ** -0.5)
    for i in range(t):
        want = ca.int8_cache_decode_attention_plain(
            q[:, i], k8, ks, v8, vs, mask[:, i], d ** -0.5)
        assert torch.equal(got[:, i], want)


# ----------------------------------------------------------------------------
# the model's verify and chunk forwards


def test_verify_step_matches_jax(flax_params):
    """After an image prefill, one verify of 1 + D tokens with per-row
    lengths: row 0 at the prompt's width, row 1 two columns before the
    cache's end (its last D - 1 columns drop, its K/V write clamps)."""
    ids, images = image_prompts(5)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    _, _, jcache, jvalid, _ = jax.jit(lambda p, i, im: jm.apply(
        p, i, im, MAX_LEN, cache_dtype=jnp.float32, method=jm.prefill))(
        flax_params, jnp.asarray(ids), jnp.asarray(images))
    pos = np.asarray(jnp.sum(jvalid, axis=1), np.int32)
    lengths = np.array([L, MAX_LEN - 2], np.int32)
    toks = np.random.RandomState(5).randint(10, 400, (2, D + 1))
    w_logits, w_hidden, w_cache, w_valid = jax.jit(
        lambda p, *a: jm.apply(p, *a, method=jm.verify_step))(
        flax_params, jnp.asarray(toks), jcache._replace(
            length=jnp.asarray(lengths)), jvalid, jnp.asarray(pos))
    model = port_model(flax_params)
    _, _, cache, valid, _ = model.prefill(
        torch.from_numpy(ids), torch.from_numpy(images), MAX_LEN,
        cache_dtype=torch.float32)
    g_logits, g_hidden, g_cache, g_valid = model.verify_step(
        torch.from_numpy(toks), cache._replace(
            length=torch.from_numpy(lengths)), valid, torch.from_numpy(pos))
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))
    assert g_valid[1, -2:].all() and g_valid[0, L:L + D + 1].all()
    np.testing.assert_array_equal(g_cache.length.numpy(), lengths + D + 1)
    assert max_rel(g_logits, w_logits) <= 1e-4
    assert max_rel(g_hidden, w_hidden) <= 1e-4
    for name in ("k", "v"):
        assert max_rel(getattr(g_cache, name).numpy(),
                       np.asarray(getattr(w_cache, name))) <= 1e-4


def test_prefill_text_chunk_matches_jax(flax_params):
    """Two 8-token chunks of two left-aligned prompts (11 and 5 tokens)
    into an empty float32 cache, each against the JAX method."""
    ids = np.zeros((2, 16), np.int64)
    ids[0, :11] = np.concatenate([[1], np.arange(20, 30)])
    ids[1, :5] = [1, 17, 23, 99, 5]
    lens = np.array([11, 5])
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    jcache = j_init_cache(jm.cfg.llama, 2, MAX_LEN, dtype=jnp.float32)
    jvalid = jnp.zeros((2, MAX_LEN), bool)
    model = port_model(flax_params)
    cache = init_cache(model.cfg.llama, 2, MAX_LEN, dtype=torch.float32)
    valid = torch.zeros((2, MAX_LEN), dtype=torch.bool)
    chunk_fn = jax.jit(lambda p, *a: jm.apply(
        p, *a, method=jm.prefill_text_chunk))
    for ci in range(2):
        chunk = ids[:, ci * 8:(ci + 1) * 8]
        off = np.minimum(lens, ci * 8).astype(np.int32)
        w_logits, _, jcache, jvalid = chunk_fn(
            flax_params, jnp.asarray(chunk), jcache, jvalid,
            jnp.asarray(off))
        g_logits, _, cache, valid = model.prefill_text_chunk(
            torch.from_numpy(chunk), cache, valid, torch.from_numpy(off))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert max_rel(g_logits, w_logits) <= 1e-4
    assert cache.length == int(jcache.length) == 16
    for name in ("k", "v"):
        assert max_rel(getattr(cache, name).numpy(),
                       np.asarray(getattr(jcache, name))) <= 1e-4


# ----------------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_spec_greedy_streams_match_single_steps_and_jax(flax_params, cache):
    """Six requests (two with an image) through two slots at spec_len 4."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "int8": (torch.int8, jnp.int8)}[cache]
    reqs = requests()
    kw = dict(max_batch=2, prompt_len=L, max_len=MAX_LEN, eos_id=EOS,
              pad_id=PAD)
    single = serve(ServeEngine(port_model(flax_params), cache_dtype=tdt,
                               **kw), reqs)
    eng = ServeEngine(port_model(flax_params), cache_dtype=tdt, spec_len=D,
                      **kw)
    got = serve(eng, reqs)
    assert [r.tokens for r in got] == [r.tokens for r in single]
    stats = eng.stats()
    assert stats["verify_dispatches"] > 0
    assert stats["drafts_accepted"] >= 0
    want = serve(JServeEngine(JSetokim(jcfg.tiny_setokim(),
                                       target_token_id=3), flax_params,
                              cache_dtype=jdt, spec_len=D, **kw), reqs)
    compare_streams(flax_params, reqs, want, got)


def test_oracle_drafter_finishes_in_the_fewest_dispatches(flax_params,
                                                         monkeypatch):
    """Drafts that are always right: the first token at admission, then
    D + 1 tokens a dispatch, the same stream as single steps."""
    reqs = requests()[1:2]                      # an image request
    model = port_model(flax_params)
    kw = dict(max_batch=1, prompt_len=L, max_len=MAX_LEN, eos_id=-1,
              pad_id=PAD)
    full = serve(ServeEngine(model, **kw), reqs)[0].tokens

    def oracle(context, num_draft, max_ngram=3, pad_id=0):
        done = next(n for n in range(len(full), -1, -1)
                    if list(context[len(context) - n:]) == full[:n])
        out = np.full((num_draft,), pad_id, np.int64)
        nxt = full[done:done + num_draft]
        out[:len(nxt)] = nxt
        return out

    monkeypatch.setattr(engine_mod, "draft_prompt_lookup", oracle)
    eng = ServeEngine(model, spec_len=D, **kw)
    r = eng.submit(*reqs[0][:1], image=reqs[0][1], max_new_tokens=MAX_NEW)
    steps = 0
    while not r.done:
        eng.step()
        steps += 1
    assert r.tokens == full
    want = -(-(MAX_NEW - 1) // (D + 1))
    assert eng.stats()["verify_dispatches"] == steps == want
    # every dispatch but the last emits D + 1 (the last may accept past
    # the budget)
    assert eng.stats()["drafts_accepted"] >= MAX_NEW - 1 - want


def test_sampled_spec_is_seeded_and_stays_in_vocab(flax_params, monkeypatch):
    reqs = requests()[:4]
    model = port_model(flax_params)
    kw = dict(max_batch=2, prompt_len=L, max_len=MAX_LEN, eos_id=-1,
              pad_id=PAD, spec_len=D, temperature=0.8, top_p=0.9)

    def run():
        got = serve(ServeEngine(model, **kw), reqs)
        assert all(len(r.tokens) == MAX_NEW for r in got)
        return [r.tokens for r in got]

    first = run()
    assert run() == first
    assert all(0 <= t < VOCAB for toks in first for t in toks)

    def sentinel(context, num_draft, max_ngram=3, pad_id=0):
        out = draft_prompt_lookup(context, num_draft, max_ngram, pad_id)
        out[0] = IMAGE_TOKEN_INDEX
        out[-1] = VOCAB + 7
        return out

    monkeypatch.setattr(engine_mod, "draft_prompt_lookup", sentinel)
    forced = run()
    assert all(0 <= t < VOCAB for toks in forced for t in toks)


def test_spec_config_errors(flax_params, tmp_path):
    model = port_model(flax_params)
    kw = dict(max_batch=1, prompt_len=8, max_len=16)
    for bad, match in (({"spec_len": -1}, "spec_len must be >= 0"),
                       ({"spec_len": 2, "decode_block": 4}, "exclusive"),
                       ({"spec_len": 2, "presence_penalty": 0.5},
                        "penalties"),
                       ({"spec_len": 2, "frequency_penalty": 0.5},
                        "penalties"),
                       ({"spec_len": 2, "per_request_sampling": True},
                        "per_request_sampling")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(model, **kw, **bad)
    # a mesh runs, speculative decoding included: over a (1, 1) mesh the
    # tensor-parallel forms over one rank stream the same tokens
    import copy
    from setok_tpu_torch.config import MeshConfig
    from setok_tpu_torch.parallel.mesh import make_mesh
    from tests.torch_parallel_workers import one_rank_group

    def run(m, mesh=None):
        eng = ServeEngine(m, max_batch=1, prompt_len=8, max_len=24,
                          spec_len=2, eos_id=-1, mesh=mesh)
        req = eng.submit(np.arange(1, 7), max_new_tokens=6)
        eng.run()
        return req.tokens

    want = run(model)
    with one_rank_group(tmp_path):
        got = run(copy.deepcopy(model),
                  make_mesh(MeshConfig(data=1, model=1)))
    assert got == want and len(got) == 6
