"""Pieces of the port's serving path that need no model parity run: the
text tokenizer copy, nucleus filtering against the JAX filter, sampling
and stops in the engine, the serve CLI, and the random initialisation of a
quantised Setokim."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.data.tokenizer import WordTokenizer as JWordTokenizer
from setok_tpu.models.generate import _top_p_filter as j_top_p
from setok_tpu_torch import config as cfgs
from setok_tpu_torch.data.tokenizer import WordTokenizer, load_text_tokenizer
from setok_tpu_torch.models.generate import _top_p_filter
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.scripts import serve as cli
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.utils.init import init_setokim_random_


@pytest.fixture(scope="module")
def model8():
    model = Setokim(cfgs.tiny_setokim(), weight_bits=8, cache_kernel=True,
                    device="cpu")
    return init_setokim_random_(model, 0)


def test_word_tokenizer_is_the_jax_copy():
    text = "Describe the image in one line <target> please"
    for vocab in (512, 32000):
        assert WordTokenizer(vocab).encode(text) == \
            JWordTokenizer(vocab).encode(text)
    assert isinstance(load_text_tokenizer(None, 512), WordTokenizer)


@pytest.mark.parametrize("top_p", [0.1, 0.6, 0.95])
def test_top_p_filter_matches_jax(top_p):
    logits = np.random.RandomState(5).randn(3, 40).astype(np.float32) * 3
    want = np.asarray(j_top_p(jnp.asarray(logits), top_p))
    got = _top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_quantised_init_fills_the_buffers(model8):
    lin = model8.llama.model.layer_0.mlp.down_proj
    assert lin.q.dtype == torch.int8 and int(lin.q.abs().max()) == 127
    assert bool((lin.s > 0).all())
    again = init_setokim_random_(Setokim(
        cfgs.tiny_setokim(), weight_bits=8, device="cpu"), 0)
    torch.testing.assert_close(again.llama.model.layer_0.mlp.down_proj.q,
                               lin.q, rtol=0, atol=0)


def _prompt(n):
    return np.concatenate([[1], np.arange(10, 10 + n)])


def test_sampling_is_seeded_and_stops_hold(model8):
    def run():
        eng = ServeEngine(model8, max_batch=2, prompt_len=16, max_len=24,
                          temperature=0.8, top_p=0.9, eos_id=-1,
                          cache_dtype=torch.int8)
        reqs = [eng.submit(_prompt(5), max_new_tokens=5),
                eng.submit(_prompt(7), max_new_tokens=3)]
        eng.run()
        return [r.tokens for r in reqs]

    first = run()
    assert [len(t) for t in first] == [5, 3]
    assert run() == first


def test_stops_cancel_and_capacity(model8):
    class StopAfter:
        def should_stop(self, tokens):
            return len(tokens) >= 2

    streamed = []
    eng = ServeEngine(model8, max_batch=1, prompt_len=16, max_len=20,
                      eos_id=-1)
    kw_req = eng.submit(_prompt(4), max_new_tokens=10, stopping=StopAfter(),
                        on_token=lambda r, t: streamed.append(t))
    cap_req = eng.submit(_prompt(4), max_new_tokens=50)
    gone = eng.submit(_prompt(4))
    gone.cancel()
    eng.run()
    assert kw_req.tokens == streamed and len(kw_req.tokens) == 2
    # the cache holds 20 columns: a 16-wide prompt leaves 4 decode writes
    assert cap_req.done and len(cap_req.tokens) == 5
    assert gone.done and gone.tokens == []
    assert eng.stats()["requests_done"] == 3


def test_engine_refuses_what_is_not_ported(model8):
    for kw in ({"spec_len": 2}, {"prefill_chunk": 8}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ServeEngine(model8, max_batch=1, prompt_len=8, max_len=16, **kw)


def test_cli_serves_on_the_cpu(capsys):
    cli.main(["--cpu", "--tiny", "--bits", "4", "--kv-bits", "8",
              "--max-new-tokens", "3", "--prompt-len", "16", "--max-len",
              "24"])
    out = capsys.readouterr().out
    assert "4 requests, 12 tokens" in out and "TTFT mean" in out


def test_cli_refuses_flags_it_does_not_run():
    with pytest.raises(SystemExit):
        cli.parse_args(["--spec-len", "2"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--checkpoint", "x"])
