"""The serving path's kernels: their plain versions against the JAX kernels.

On numpy inputs from a seed, each plain version of the port against the
JAX package's Pallas kernel run with `interpret=True` (as
tests/test_quant_matmul.py, tests/test_quant_dense.py and
tests/test_int8_cache.py run them). Bars, max-rel = max|got - want| /
max|want|:

  * quant_matmul / quant4_matmul: 1e-5. Both sides take the int products
    exactly and apply the scales in the same order; what remains is a
    last-bit difference of an activation scale that flips one rounding.
  * int8_cache_decode_attention: 1e-5 (float32; the sums run in another
    order).
  * quantize_weight_int4 with the clip search: the packed bytes and the
    scales are equal.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (Quant4Weight, QuantizedWeight,
                                           quantize_weight,
                                           quantize_weight_int4,
                                           unpack_nibbles)

# the modules themselves (setok_tpu.kernels re-exports functions of
# these names)
jca = importlib.import_module("setok_tpu.kernels.cache_attention")
jqm = importlib.import_module("setok_tpu.kernels.quant_matmul")

TOL = 1e-5


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x_w(seed, m, k, n):
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, k) * rs.uniform(0.5, 2.0, (m, 1))).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)     # flax (K, N)
    return x, w


@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (4, 256, 128),
                                   (300, 128, 64)])
def test_quant_matmul_plain_matches_jax(m, k, n):
    x, w = _x_w(m + k + n, m, k, n)
    jw = jqm.quantize_weight(jnp.asarray(w))
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    pw = quantize_weight(t(w.T))
    np.testing.assert_array_equal(pw.values.numpy(), np.asarray(jw.values).T)
    np.testing.assert_array_equal(pw.scales.numpy(),
                                  np.asarray(jw.scales)[0])
    got = qm.quant_matmul(t(x), pw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert max_rel(got, want) <= TOL


@pytest.mark.parametrize("m,k,n,group", [(1, 64, 96, None),
                                         (4, 256, 128, None),
                                         (300, 128, 64, None),
                                         (4, 256, 128, 32),
                                         (300, 128, 64, 16)])
def test_quant4_matmul_plain_matches_jax(m, k, n, group):
    x, w = _x_w(7 * m + k + n, m, k, n)
    jw = jqm.quantize_weight_int4(jnp.asarray(w), group_size=group)
    want = np.asarray(jqm.quant4_matmul(jnp.asarray(x), jw, interpret=True))
    pw = Quant4Weight(t(np.asarray(jw.packed).T), t(np.asarray(jw.scales)))
    got = qm.quant4_matmul(t(x), pw)
    assert got.shape == (m, n)
    assert max_rel(got, want) <= TOL


@pytest.mark.parametrize("group,clip", [(None, 0), (None, 8), (32, 8)])
def test_quantize_weight_int4_equals_jax(group, clip):
    _, w = _x_w(11, 1, 256, 96)
    w[5, 3] = 4.0                                 # an outlier row to clip
    jw = jqm.quantize_weight_int4(jnp.asarray(w), group_size=group,
                                  clip_search=clip)
    pw = quantize_weight_int4(t(w.T), group_size=group, clip_search=clip)
    np.testing.assert_array_equal(pw.packed.numpy(), np.asarray(jw.packed).T)
    np.testing.assert_array_equal(pw.scales.numpy(), np.asarray(jw.scales))
    lo, hi = unpack_nibbles(pw.packed)
    jlo, jhi = jqm.unpack_nibbles(jw.packed)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).T)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).T)


def test_wrappers_check_their_inputs():
    x, w = _x_w(3, 2, 64, 32)
    pw = quantize_weight(t(w.T))
    with pytest.raises(ValueError, match="input width"):
        qm.quant_matmul(t(x[:, :32]), QuantizedWeight(
            pw.values[:, :48].contiguous(), pw.scales))
    with pytest.raises(ValueError, match="scale rows"):
        qm.quant4_matmul(t(x), Quant4Weight(pw.values[:, :32].contiguous(),
                                            torch.ones(3, 32)))


def _int8_cache(rs, b, s, kvh, d):
    f = rs.randn(b, s, kvh, d).astype(np.float32)
    sc = (np.abs(f).max(-1) / 127.0 + 1e-8).astype(np.float32)
    q8 = np.clip(np.round(f / sc[..., None]), -127, 127).astype(np.int8)
    return q8, sc


@pytest.mark.parametrize("b,s,kvh,g,d", [(2, 64, 2, 3, 32),
                                         (3, 40, 4, 1, 16)],
                         ids=["gqa", "mha"])
def test_cache_attention_plain_matches_jax(b, s, kvh, g, d):
    rs = np.random.RandomState(b * s + g)
    q = rs.randn(b, kvh * g, d).astype(np.float32)
    k8, ks = _int8_cache(rs, b, s, kvh, d)
    v8, vs = _int8_cache(rs, b, s, kvh, d)
    valid = rs.rand(b, s) > 0.3
    valid[0, 0] = True
    valid[-1] = False                             # a fully masked row
    want = np.asarray(jca.int8_cache_decode_attention(
        *map(jnp.asarray, (q, k8, ks, v8, vs, valid)), interpret=True))
    got = ca.int8_cache_decode_attention(*map(t, (q, k8, ks, v8, vs, valid)))
    assert got.shape == (b, kvh * g, d)
    assert max_rel(got, want) <= TOL
    # the fully masked row is the uniform average over all S keys
    vd = v8[-1].astype(np.float32) * vs[-1][..., None]       # (S, KVH, D)
    uniform = np.repeat(vd.mean(0), g, axis=0)
    np.testing.assert_allclose(got[-1].numpy(), uniform, rtol=1e-5,
                               atol=1e-6)


def test_cache_gate_is_the_jax_gate():
    for args in ((8192, 128, 32, False), (8193, 128, 32, True),
                 (512, 16, 4, False), (512, 16, 4, True)):
        assert ca.fits_vmem(*args) == jca.fits_vmem(*args)
