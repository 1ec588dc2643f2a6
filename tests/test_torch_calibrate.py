"""The port's int4 calibration against the JAX package's, on
`tiny_setokim()` (2 trunk layers) with the same flax weights:

  * `collect_row_weights` (forward pre-hooks) against the JAX interceptor
    over the same text prefill: the same module paths, one per trunk
    linear, E[x²] within 1e-5 relative;
  * `quantize_trunk_weights(..., row_weights=)` against the JAX transform
    on the same row weights: the packed nibbles exact, the scales within
    1e-6 relative, per channel and at group 16;
  * the weighted error of each calibrated linear no worse than that of the
    uncalibrated clip search;
  * `lookup_row_weight`'s exact and suffix matches, and a calibrated int4
    model that serves.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.models.llama import quantize_trunk_weights as j_quantize
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.serve.calibrate import collect_row_weights as j_collect
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.kernels.quant import unpack_nibbles
from setok_tpu_torch.models.llama import TRUNK_LINEARS, quantize_trunk_weights
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.serve import ServeEngine, collect_row_weights
from setok_tpu_torch.serve.calibrate import lookup_row_weight
from test_torch_serve_chunked import text_prompts, tiny_flax_params
from test_torch_setokim import MAX_LEN, port_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def flax_params():
    return tiny_flax_params()


@pytest.fixture(scope="module")
def calibration(flax_params):
    """(port model, port row weights, JAX row weights) over one prefill of
    the two text prompts."""
    ids = np.zeros((2, 16), np.int64)
    for i, p in enumerate(text_prompts()):
        ids[i, :len(p)] = p
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    jrw = j_collect(lambda: jm.apply(flax_params, jnp.asarray(ids), MAX_LEN,
                                     method=jm.prefill_text))
    model = port_model(flax_params)
    rw = collect_row_weights(model, lambda: model.prefill_text(
        torch.from_numpy(ids), MAX_LEN))
    return model, rw, jrw


def dequant(p, s):
    """(out, in) float64 weight of packed nibbles p and (groups, out) s."""
    q = torch.cat(unpack_nibbles(p), dim=1).double()
    g = q.shape[1] // s.shape[0]
    return q * s.double().t().repeat_interleave(g, dim=1)


def test_row_weights_match_jax(calibration):
    model, rw, jrw = calibration
    cfg = model.cfg.llama
    assert set(rw) == set(jrw)
    assert len(rw) == len(TRUNK_LINEARS) * cfg.num_layers
    for key, want in jrw.items():
        got = rw[key]
        assert got.dtype == np.float32 and got.shape == want.shape
        k = cfg.intermediate_size if key[-1] == "down_proj" \
            else cfg.hidden_size
        assert got.shape == (k,) and (got >= 0).all()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key


@pytest.mark.parametrize("group", [0, 16])
def test_calibrated_int4_buffers_match_jax(flax_params, calibration, group):
    model, _, jrw = calibration
    want = j_quantize(flax_params, bits=4, group_size=group, clip_search=8,
                      row_weights=jrw)
    got = quantize_trunk_weights(model.state_dict(), bits=4,
                                 group_size=group, clip_search=8,
                                 row_weights=jrw)
    n = 0
    for path in jrw:
        node = want["params"]
        for part in path:
            node = node[part]
        key = ".".join(path)
        np.testing.assert_array_equal(got[key + ".p"].numpy(),
                                      np.asarray(node["p"]).T)
        s, ws = got[key + ".s"].numpy(), np.asarray(node["s"])
        assert s.shape == ws.shape
        assert np.abs(s - ws).max() <= 1e-6 * np.abs(ws).max(), key
        n += 1
    assert n == len(TRUNK_LINEARS) * model.cfg.llama.num_layers


@pytest.mark.parametrize("group", [0, 16])
def test_weighted_error_no_worse_than_uncalibrated(calibration, group):
    model, rw, _ = calibration
    state = model.state_dict()
    cal = quantize_trunk_weights(state, bits=4, group_size=group,
                                 clip_search=8, row_weights=rw)
    plain = quantize_trunk_weights(state, bits=4, group_size=group,
                                   clip_search=8)
    moved = 0
    for path, d in rw.items():
        key = ".".join(path)
        w = state[key + ".weight"].double()
        dw = torch.from_numpy(d).double()
        errs = [float((((w - dequant(q[key + ".p"], q[key + ".s"])) ** 2)
                       * dw).sum()) for q in (cal, plain)]
        assert errs[0] <= errs[1] * (1 + 1e-6), (key, errs)
        moved += errs[0] < errs[1]
    assert moved > 0            # the weighting changed some choices


def test_lookup_row_weight_paths(calibration):
    _, rw, _ = calibration
    key = ("llama", "model", "layer_0", "mlp", "gate_proj")
    assert lookup_row_weight(rw, key) is rw[key]
    # a state dict rooted at the trunk, or under another root
    assert lookup_row_weight(rw, key[2:]) is rw[key]
    assert lookup_row_weight(rw, ("outer",) + key) is rw[key]
    assert lookup_row_weight(rw, ("gate_proj",)) is None        # ambiguous
    assert lookup_row_weight(rw, ("nope", "gate_proj")) is None


def test_calibrated_int4_model_serves(calibration):
    model, rw, _ = calibration
    q4 = Setokim(tcfg.tiny_setokim(), target_token_id=3, weight_bits=4,
                 quant_group=16, device="cpu")
    q4.load_state_dict(quantize_trunk_weights(
        model.state_dict(), bits=4, group_size=16, clip_search=8,
        row_weights=rw))
    eng = ServeEngine(q4, max_batch=2, prompt_len=16, max_len=MAX_LEN,
                      eos_id=-1, pad_id=0, cache_dtype=torch.int8)
    reqs = [eng.submit(p, max_new_tokens=4) for p in text_prompts()]
    eng.run()
    assert all(len(r.tokens) == 4 for r in reqs)
