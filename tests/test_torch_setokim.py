"""The port's Setokim serving forward against the JAX package on the CPU.

`tiny_setokim()` with the same flax weights (float, or quantised by the
JAX package's `quantize_trunk_weights`) and the same numpy inputs: a
prefill with an image (the splice leaves holes where the image has fewer
clusters than k_max), then 8 decode steps fed the JAX side's greedy
tokens. JAX kernels run in interpret mode, as tests/test_int8_cache.py
runs them. Bars, max-rel = max|got - want| / max|want|:

  * float trunk (bits 16), float32 cache: logits and hidden 1e-4, cache
    1e-4;
  * float trunk, bf16 cache: logits and hidden 2e-3; at least 97 % of the
    cache entries equal and all within 1e-2: a last-bit difference
    upstream flips the bf16 rounding of a few K or V entries, which every
    later layer and step then reads;
  * int8 / int4 trunk, int8 cache, `cache_kernel` off and on: logits and
    hidden 2e-3; at least 99 % of the int8 cache entries equal, the rest
    one step apart (a last-bit difference upstream flips a rounding).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu import config as jcfg
from setok_tpu.constants import IMAGE_TOKEN_INDEX
from setok_tpu.models.llama import quantize_trunk_weights
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_setokim_random_
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L = 24
MAX_LEN = 40
STEPS = 8
K_MAX = 8


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def prompts(seed, b=2):
    """Collator layout: BOS, k_max image slots, text, pads."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((b, L), np.int64)
    for i in range(b):
        n_text = 4 + (seed + 3 * i) % 6
        ids[i, 0] = 1
        ids[i, 1:1 + K_MAX] = IMAGE_TOKEN_INDEX
        ids[i, 1 + K_MAX:1 + K_MAX + n_text] = rs.randint(10, 400, n_text)
    images = rs.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    return ids, images


@functools.lru_cache(maxsize=1)
def seeded_flax_params():
    """The tiny Setokim's weights in the flax layout, drawn by the port
    from seed 0 (`to_flax_tree`): the tree a flax init returns, without
    compiling one (some 13 s a process). Made once per process."""
    model = init_setokim_random_(Setokim(tcfg.tiny_setokim(),
                                         target_token_id=3, device="cpu"), 0)
    return to_flax_tree(model)


@pytest.fixture(scope="module")
def flax_params():
    return seeded_flax_params()


def port_model(params, bits=16, group=0, cache_kernel=False):
    model = Setokim(tcfg.tiny_setokim(), target_token_id=3, weight_bits=bits,
                    quant_group=group, cache_kernel=cache_kernel,
                    device="cpu")
    return load_flax_params(model, params)


def run_jax(params, bits, group, cache_kernel, cache_dtype, ids, images):
    model = JSetokim(jcfg.tiny_setokim(), target_token_id=3,
                     weight_bits=bits, quant_group=group,
                     cache_kernel=cache_kernel)
    prefill = jax.jit(lambda p, i, im: model.apply(
        p, i, im, MAX_LEN, cache_dtype=cache_dtype, method=model.prefill))
    step = jax.jit(lambda p, t, c, v, pos: model.apply(
        p, t, c, v, pos, method=model.decode_step))
    logits, hidden, cache, valid, _ = prefill(params, jnp.asarray(ids),
                                              jnp.asarray(images))
    outs = [(logits, hidden)]
    pos = jnp.sum(valid.astype(jnp.int32), axis=1)
    toks = [jnp.argmax(logits, -1)]
    for _ in range(STEPS):
        logits, hidden, cache, valid = step(params, toks[-1][:, None], cache,
                                            valid, pos)
        outs.append((logits, hidden))
        toks.append(jnp.argmax(logits, -1))
        pos = pos + 1
    return ([tuple(np.asarray(a, np.float32) for a in o) for o in outs],
            [np.asarray(t) for t in toks], jax.tree.map(np.asarray, cache),
            np.asarray(valid))


def run_port(model, cache_dtype, ids, images, toks):
    logits, hidden, cache, valid, _ = model.prefill(
        torch.from_numpy(ids), torch.from_numpy(images), MAX_LEN,
        cache_dtype=cache_dtype)
    outs = [(logits, hidden)]
    pos = valid.to(torch.int32).sum(dim=1)
    for t in toks[:STEPS]:
        logits, hidden, cache, valid = model.decode_step(
            torch.from_numpy(t.copy())[:, None], cache, valid, pos)
        outs.append((logits, hidden))
        pos = pos + 1
    return [tuple(a.numpy() for a in o) for o in outs], cache, valid.numpy()


CASES = {
    # bits, int4 group, cache_kernel, JAX cache dtype, port cache dtype, bar
    "f32-f32cache": (16, 0, False, jnp.float32, torch.float32, 1e-4),
    "f32-bf16cache": (16, 0, False, jnp.bfloat16, torch.bfloat16, 2e-3),
    "int8-int8cache-kernel": (8, 0, True, jnp.int8, torch.int8, 2e-3),
    "int4g16-int8cache": (4, 16, False, jnp.int8, torch.int8, 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(flax_params, case):
    bits, group, kernel, jdt, tdt, bar = CASES[case]
    params = flax_params
    if bits != 16:
        params = jax.tree.map(np.asarray, quantize_trunk_weights(
            params, bits=bits, group_size=group,
            clip_search=8 if bits == 4 else 0))
    ids, images = prompts(5)
    want, toks, jcache, jvalid = run_jax(params, bits, group, kernel, jdt,
                                         ids, images)
    got, cache, valid = run_port(port_model(params, bits, group, kernel),
                                 tdt, ids, images, toks)
    assert not jvalid[:, :L].all(), "the splice left no holes"
    np.testing.assert_array_equal(valid, jvalid)
    assert cache.length == L + STEPS
    for step, ((gl, gh), (wl, wh)) in enumerate(zip(got, want)):
        assert max_rel(gl, wl) <= bar, (step, max_rel(gl, wl))
        assert max_rel(gh, wh) <= bar, (step, max_rel(gh, wh))
    for name in ("k", "v"):
        g = getattr(cache, name).float().numpy()
        w = np.asarray(getattr(jcache, name), np.float32)
        if tdt == torch.int8:
            assert np.abs(g - w).max() <= 1
            assert (g == w).mean() >= 0.99
            gs = getattr(cache, f"{name}_scale").numpy()
            ws = getattr(jcache, f"{name}_scale")
            assert max_rel(gs, ws) <= bar
        elif tdt == torch.bfloat16:
            assert (g == w).mean() >= 0.97
            assert max_rel(g, w) <= 1e-2
        else:
            assert max_rel(g, w) <= bar


def test_multi_image_splice_matches_jax(flax_params):
    """Two images per row: the slots take them in order; holes and
    positions as the JAX splice gives them."""
    rs = np.random.RandomState(9)
    ids = np.zeros((2, 2 * K_MAX + 8), np.int64)
    ids[:, 0] = 1
    ids[:, 1:1 + K_MAX] = IMAGE_TOKEN_INDEX
    ids[:, 1 + K_MAX:4 + K_MAX] = rs.randint(10, 400, (2, 3))
    ids[:, 4 + K_MAX:4 + 2 * K_MAX] = IMAGE_TOKEN_INDEX
    ids[0, 4 + 2 * K_MAX:] = rs.randint(10, 400, 4)
    images = rs.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    w_emb, w_valid, w_pos = jm.apply(flax_params, jnp.asarray(ids),
                                     jnp.asarray(images),
                                     method=jm.prepare_multimodal)
    with torch.no_grad():      # the splice is differentiable (training)
        emb, valid, pos = port_model(flax_params).prepare_multimodal(
            torch.from_numpy(ids), torch.from_numpy(images))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(w_valid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(w_pos))
    assert max_rel(emb, w_emb) <= 1e-4


def test_generate_text_matches_jax(flax_params):
    """Greedy generate_text: prefill, then the decode loop with EOS
    freezing and the hidden-state alignment of the JAX scan."""
    from setok_tpu.models.generate import generate_text as j_generate
    from setok_tpu_torch.models.generate import generate_text

    ids, images = prompts(11)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    # an EOS id the greedy stream reaches, so that the freeze shows
    want = j_generate(jm, flax_params, jnp.asarray(ids), jnp.asarray(images),
                      6, eos_id=2, pad_id=0)
    eos = int(np.asarray(want.tokens)[0, 2])
    want = j_generate(jm, flax_params, jnp.asarray(ids), jnp.asarray(images),
                      6, eos_id=eos, pad_id=0)
    got = generate_text(port_model(flax_params), torch.from_numpy(ids),
                        torch.from_numpy(images), 6, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    assert got.hidden.shape == tuple(want.hidden.shape)
    assert max_rel(got.hidden, want.hidden) <= 1e-4


def test_per_row_decode_drops_and_clamps_like_jax(flax_params):
    """Per-slot (B,) cache lengths, one row past the cache: its validity
    column is dropped while its K/V write clamps to the last column, as
    the JAX scatter does."""
    ids, images = prompts(3)
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    logits, _, jcache, jvalid, _ = jm.apply(
        flax_params, jnp.asarray(ids), jnp.asarray(images), MAX_LEN,
        method=jm.prefill)
    tok = np.asarray(jnp.argmax(logits, -1))[:, None]
    pos = np.asarray(jnp.sum(jvalid, axis=1), np.int32)
    lengths = np.array([L, MAX_LEN], np.int32)
    w_logits, _, w_cache, w_valid = jm.apply(
        flax_params, jnp.asarray(tok), jcache._replace(
            length=jnp.asarray(lengths)), jvalid, jnp.asarray(pos),
        method=jm.decode_step)
    model = port_model(flax_params)
    _, _, cache, valid, _ = model.prefill(torch.from_numpy(ids),
                                          torch.from_numpy(images), MAX_LEN)
    g_logits, _, g_cache, g_valid = model.decode_step(
        torch.from_numpy(tok), cache._replace(
            length=torch.from_numpy(lengths)), valid, torch.from_numpy(pos))
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))
    assert not g_valid[1, -1] and g_valid[0, L]
    np.testing.assert_array_equal(g_cache.length.numpy(), lengths + 1)
    assert max_rel(g_logits, w_logits) <= 1e-4
    assert max_rel(g_cache.k.numpy(), np.asarray(w_cache.k)) <= 1e-4
