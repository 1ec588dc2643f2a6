"""The port's ServeEngine features of the decode loop against the JAX
package's engine, on `tiny_setokim()` with the same flax weights:

  * rendering at retirement (after JAX tests/test_serve.py:220): the slot
    frees at once, `done` flips when the images are harvested, EOS leaves
    the text before the spans are found, and the image equals
    `generate_image` on the same span and draws;
  * `decode_block = K > 1` (after tests/test_serve.py:332): greedy streams
    identical to the port's K = 1 and to the JAX engine's K = 4 (the
    near-tie rule of tests/test_torch_serve.py: a first difference passes
    only where the JAX top-2 logit gap is below 1e-4 of max|logits|);
    a keyword stop exact mid-block (:359) and a cancel during a block
    (tests/test_serve_streaming.py:100);
  * `per_request_sampling` (after :669): greedy rows equal to JAX's beside
    a hot sibling and with per-request penalties, `sample_rows`' greedy
    rows equal to JAX's `_sample_rows` on the same penalised logits, and
    overrides without the flag raise;
  * the port's `scripts/demo.py --tiny --cpu` and `scripts/serve.py --tiny
    --cpu --decode-block 4` run, and the flags still not ported refuse.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.serve import ServeEngine as JServeEngine
from setok_tpu_torch.models.generate import find_image_spans, generate_image
from setok_tpu_torch.scripts import demo, serve as cli
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.serve.engine import sample_rows
from test_torch_serve import EOS, PAD, compare_streams, requests
from test_torch_setokim import L, MAX_LEN, flax_params, port_model

__all__ = ["flax_params"]          # the shared module-scoped fixture

MAX_NEW = 9


def jax_engine(params, **kw):
    return JServeEngine(JSetokim(jcfg.tiny_setokim(), target_token_id=3),
                        params, prompt_len=L, max_len=MAX_LEN, eos_id=EOS,
                        pad_id=PAD, **kw)


def port_engine(params, **kw):
    return ServeEngine(port_model(params), prompt_len=L, max_len=MAX_LEN,
                       eos_id=EOS, pad_id=PAD, **kw)


def serve(engine, reqs, **kw):
    handles = [engine.submit(ids, image=img, max_new_tokens=MAX_NEW, **kw)
               for ids, img in reqs]
    engine.run()
    assert all(r.done for r in handles)
    return handles


def span_markers(tokens):
    """The first pair of ids (start, end) of a stream between which it
    holds a non-empty span."""
    for i, start in enumerate(tokens):
        for end in tokens[i + 2:]:
            if end != start and any(
                    e > s for s, e in find_image_spans(np.asarray(tokens),
                                                       start, end)):
                return start, end
    raise AssertionError(f"no span in {tokens}")


# ----------------------------------------------------------------------------
# rendering at retirement


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_render_at_retirement_is_generate_image(flax_params, cfg_scale):
    """A retired request with a 3-token span and an EOS after it (the
    tokens after EOS, a second span among them, leave the text)."""
    im_start, im_end = 500, 501
    model = port_model(flax_params)
    hidden = model.cfg.llama.hidden_size
    eng = ServeEngine(model, max_batch=1, prompt_len=L, max_len=MAX_LEN,
                      eos_id=EOS, pad_id=PAD, im_start_id=im_start,
                      im_end_id=im_end, num_iter=2, cfg_scale=cfg_scale)
    req = eng.submit(np.zeros((L,), np.int64), max_new_tokens=12)
    req.tokens = [7, im_start, 11, 12, 13, im_end, 9, EOS, im_start, 5,
                  im_end]
    rs = np.random.RandomState(0)
    req._hiddens = [rs.randn(hidden).astype(np.float32)
                    for _ in range(len(req.tokens) - 1)]
    want_hid = np.stack(req._hiddens)
    eng._slots[0], eng._active[0] = req, True
    eng._retire(0)
    assert eng._slots[0] is None and not eng._active[0]
    assert not req.done and eng.stats()["renders_in_flight"] == 1
    assert req.tokens == [7, im_start, 11, 12, 13, im_end, 9]
    eng._harvest_renders()
    assert req.done and eng.stats()["renders_in_flight"] == 0
    assert len(req.images_out) == 1
    want = generate_image(model, torch.from_numpy(want_hid[None, 2:5]),
                          torch.Generator().manual_seed(0), 2, cfg_scale)
    assert req.images_out[0].shape == (32, 32, 3)
    np.testing.assert_array_equal(req.images_out[0], want[0].numpy())


def test_render_through_the_decode_loop(flax_params):
    """Markers taken from a first greedy run: the second run's request
    decodes the same tokens, retires with a span and renders it (one
    finite image) before `run` returns."""
    reqs = requests()[:1]
    first = serve(port_engine(flax_params, max_batch=1), reqs)[0].tokens
    start, end = span_markers(first)
    eng = port_engine(flax_params, max_batch=1, im_start_id=start,
                      im_end_id=end, num_iter=2)
    got = serve(eng, reqs)[0]
    assert got.tokens == first and len(got.images_out) == 1
    assert np.isfinite(got.images_out[0]).all()


# ----------------------------------------------------------------------------
# decode_block


def test_decode_block_streams_match_single_steps_and_jax(flax_params):
    """Six requests (two with an image) through 2 slots: admissions into
    recycled slots between blocks, budget stops mid-block."""
    reqs = requests()
    single = serve(port_engine(flax_params, max_batch=2), reqs)
    block = serve(port_engine(flax_params, max_batch=2, decode_block=4),
                  reqs)
    assert [r.tokens for r in block] == [r.tokens for r in single]
    jreqs = serve(jax_engine(flax_params, max_batch=2, decode_block=4), reqs)
    compare_streams(flax_params, reqs, jreqs, block)


def test_decode_block_stops_at_the_capacity_edge(flax_params):
    """A cache of L + 6 columns: K = 4 reserves 4 writes a dispatch, so
    the row retires where the JAX engine's does."""
    reqs = requests()[:1]
    kw = dict(max_batch=1, decode_block=4)
    got = ServeEngine(port_model(flax_params), prompt_len=L,
                      max_len=L + 6, eos_id=-1, pad_id=PAD, **kw)
    want = JServeEngine(JSetokim(jcfg.tiny_setokim(), target_token_id=3),
                        flax_params, prompt_len=L, max_len=L + 6, eos_id=-1,
                        pad_id=PAD, **kw)
    g, w = serve(got, reqs)[0], serve(want, reqs)[0]
    assert len(g.tokens) == len(w.tokens) < MAX_NEW


def test_decode_block_keyword_stop_exact(flax_params):
    class StopAfterThree:
        def should_stop(self, tokens):
            return len(tokens) >= 3

    reqs = requests()[1:2]                      # an image request
    base = serve(port_engine(flax_params, max_batch=1), reqs)[0]
    eng = port_engine(flax_params, max_batch=1, decode_block=5)
    r = serve(eng, reqs, stopping=StopAfterThree())[0]
    assert r.tokens == base.tokens[:3]
    assert eng.stats()["tokens_emitted"] == 3


def test_cancel_during_a_block(flax_params):
    """What a row decoded on the card after its cancel never surfaces."""
    eng = ServeEngine(port_model(flax_params), max_batch=1, prompt_len=L,
                      max_len=MAX_LEN, eos_id=-1, pad_id=PAD, decode_block=4)
    r = eng.submit(requests()[0][0], max_new_tokens=12)
    eng.step()
    n = len(r.tokens)
    assert n == 5                               # the first + one block
    r.cancel()
    eng.run()
    assert r.done and len(r.tokens) == n


# ----------------------------------------------------------------------------
# per-request sampling


def test_per_request_defaults_reproduce_the_static_engine(flax_params):
    reqs = requests()[:4]
    base = serve(port_engine(flax_params, max_batch=2), reqs)
    vec = serve(port_engine(flax_params, max_batch=2,
                            per_request_sampling=True, decode_block=3), reqs)
    assert [r.tokens for r in vec] == [r.tokens for r in base]


@pytest.mark.parametrize("sibling", [
    {"temperature": 0.8, "top_p": 0.9}, {"presence_penalty": 1e9}])
def test_greedy_rows_beside_per_request_siblings_match_jax(flax_params,
                                                           sibling):
    """Rows 0 and 2 greedy, rows 1 and 3 with the sibling's overrides: the
    greedy rows equal the JAX engine's in the same run; a row under an
    infinite presence penalty repeats no token."""
    reqs = requests()[:4]

    def run(engine):
        handles = [engine.submit(ids, image=img, max_new_tokens=MAX_NEW,
                                 **(sibling if i % 2 else {}))
                   for i, (ids, img) in enumerate(reqs)]
        engine.run()
        return handles

    got = run(port_engine(flax_params, max_batch=4,
                          per_request_sampling=True))
    want = run(jax_engine(flax_params, max_batch=4,
                          per_request_sampling=True))
    greedy = [0, 2]
    compare_streams(flax_params, [reqs[i] for i in greedy],
                    [want[i] for i in greedy], [got[i] for i in greedy])
    if "presence_penalty" in sibling:
        for r in (got[1], got[3]):
            assert len(set(r.tokens)) == len(r.tokens)


def test_sample_rows_greedy_rows_match_jax():
    """On the same logits, counts and vectors (greedy rows with penalties
    among sampled rows), the greedy rows take JAX's argmax."""
    rs = np.random.RandomState(3)
    b, v = 6, 50
    logits = (rs.randn(b, v) * 2).astype(np.float32)
    counts = rs.randint(0, 3, (b, v)).astype(np.int32)
    samp = np.stack([[0.0, 0.7, 0.0, 1.2, 0.0, 0.5],
                     [1.0, 0.9, 1.0, 0.8, 1.0, 1.0],
                     [0.0, 0.2, 1.5, 0.0, 0.3, 0.0],
                     [0.0, 0.1, 0.4, 0.0, 2.0, 0.0]]).astype(np.float32)
    want = np.asarray(JServeEngine._sample_rows(
        jnp.asarray(logits), jnp.asarray(counts),
        tuple(jnp.asarray(a) for a in samp), jax.random.PRNGKey(0)))
    got = sample_rows(torch.from_numpy(logits), torch.from_numpy(counts),
                      torch.from_numpy(samp), torch.Generator().manual_seed(0)
                      ).numpy()
    greedy = samp[0] == 0.0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    assert ((got >= 0) & (got < v)).all()


def test_overrides_need_per_request_sampling(flax_params):
    eng = port_engine(flax_params, max_batch=1)
    for kw in ({"temperature": 0.5}, {"top_p": 0.9},
               {"presence_penalty": 0.1}, {"frequency_penalty": 0.1}):
        with pytest.raises(ValueError, match="per_request_sampling"):
            eng.submit(requests()[0][0], **kw)


# ----------------------------------------------------------------------------
# the scripts


def test_demo_runs_on_the_cpu(capsys):
    demo.main(["--tiny", "--cpu"])
    out = capsys.readouterr().out
    for step in ("[tokenize]", "[reconstruct] psnr=", "[generate]",
                 "[image-gen] rendered (1, 32, 32, 3) image, finite=True"):
        assert step in out


def test_serve_cli_takes_decode_block(capsys):
    cli.main(["--cpu", "--tiny", "--bits", "8", "--kv-bits", "8",
              "--decode-block", "4", "--max-new-tokens", "6",
              "--prompt-len", "16", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "4 requests, 24 tokens" in out and "TTFT mean" in out


@pytest.mark.parametrize("script,flag", [
    (cli, ["--spec-len", "2"]), (cli, ["--spec-ngram", "3"]),
    (cli, ["--prefill-chunk", "8"]), (cli, ["--system-prompt", "x"]),
    (cli, ["--tensor-parallel", "2"]), (cli, ["--checkpoint", "x"]),
    (demo, ["--checkpoint", "x"]), (demo, ["--image", "x.png"])])
def test_flags_not_ported_refuse(script, flag, capsys):
    with pytest.raises(SystemExit):
        script.parse_args(flag)
    assert "ROADMAP.md" in capsys.readouterr().err
