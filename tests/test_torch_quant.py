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
  * bfloat16 input, as the int8 SeTok's Dense under bf16 glue calls it:
    the plain version on bf16 x equals, bit for bit, the route that stages
    x in float32 and casts the float32 output (what the card's wrapper did
    before its kernel read x and wrote the output type itself); and it
    matches the JAX kernel on the same bf16 x at so400m fc2's ragged K
    (4304 = 16 mod 32) and at 384 px qkv's width, with out_dtype bfloat16
    and float32, at 1e-5. A bf16 output can differ from JAX's by one bf16
    step only where the float32 values differ, so the bar is the same.
  * `chip_smoke.quant_bound` counts x and the output in the types the call
    moves.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu_torch.kernels import cache_attention as ca
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import (Quant4Weight, QuantizedWeight,
                                           int_dot, quant_rows,
                                           quantize_weight,
                                           quantize_weight_int4,
                                           unpack_nibbles)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _bf16_x_w(seed, m, k, n):
    x, w = _x_w(seed, m, k, n)
    return torch.from_numpy(x).to(torch.bfloat16), w


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_quant_matmul_plain_reads_bf16_as_the_f32_staged_route(out_dtype):
    x, w = _bf16_x_w(5, 37, 4304, 96)
    pw = quantize_weight(t(w.T))
    got = qm.quant_matmul(x, pw, out_dtype=out_dtype)
    staged = qm.quant_matmul(x.float(), pw, out_dtype=torch.float32)
    assert got.dtype == out_dtype
    assert torch.equal(got, staged.to(out_dtype))


def _jax_row_scales(x: np.ndarray) -> torch.Tensor:
    """The row scales as the compiled JAX kernel computes them: XLA turns
    `max(absmax, 1e-8) / 127.0` into a product with the reciprocal, which
    differs from the true division in the last bit for some rows."""
    f = jax.jit(lambda a: jnp.maximum(jnp.max(jnp.abs(a), axis=-1,
                                              keepdims=True), 1e-8) / 127.0)
    return t(np.asarray(f(jnp.asarray(x))))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(37, 4304, 96), (300, 768, 2304)])
def test_quant_matmul_plain_matches_jax_on_bf16_input(m, k, n, out_dtype):
    """Rows whose scale the compiled JAX kernel rounds as the true division
    does match at 1e-5. On the others (some rows at 768 -> 2304) XLA's
    reciprocal product moves the scale by one float32 step, which
    flips int8 steps of x; there, the port's arithmetic on JAX's scales
    gives JAX's output at 1e-5: the only difference is that rounding. The
    port and its CUDA kernel divide, as the JAX source reads."""
    x, w = _bf16_x_w(m + n, m, k, n)
    jw = jqm.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    dtype = getattr(torch, out_dtype)
    want = np.asarray(jqm.quant_matmul(
        jx, jw, out_dtype=getattr(jnp, out_dtype), interpret=True),
        np.float32)
    pw = quantize_weight(t(w.T))
    got = qm.quant_matmul(x, pw, out_dtype=dtype)
    assert got.shape == (m, n) and got.dtype == dtype
    js = _jax_row_scales(x.float().numpy())
    same = (js == quant_rows(x.float())[1])[:, 0]
    assert int(same.sum()) >= 0.9 * m
    assert max_rel(got.float()[same], want[same.numpy()]) <= TOL
    steps = (js[~same].view(torch.int32)
             - quant_rows(x.float())[1][~same].view(torch.int32)).abs()
    assert bool((steps == 1).all())
    x8 = torch.round(x.float() / js).clamp(-127, 127).to(torch.int8)
    on_jax_scales = (int_dot(x8, pw.values) * js * pw.scales).to(dtype)
    assert max_rel(on_jax_scales.float(), want) <= TOL


def test_quant_bound_counts_the_types_the_call_moves():
    """At 384 px qkv (M = 36,864, 768 -> 2304) under bf16 glue: bf16 x and
    output, int8 weight, f32 scales; the int8 products at 1979 TOP/s."""
    import chip_smoke

    m, k, n = 36864, 768, 2304
    t_bytes, t_ops = chip_smoke.quant_bound(m, k, n, 8, 1, x_size=2,
                                            out_size=2)
    assert t_bytes == pytest.approx((2 * m * k + n * k + 4 * n + 2 * m * n)
                                    / 3.35e12, rel=1e-12)
    assert t_ops == pytest.approx(2 * m * n * k / 1979e12, rel=1e-12)
    # float32 x and output, as the serving trunk calls it
    f32_bytes, _ = chip_smoke.quant_bound(m, k, n, 8, 1, x_size=4,
                                          out_size=4)
    assert f32_bytes * 3.35e12 - t_bytes * 3.35e12 == pytest.approx(
        2 * m * k + 2 * m * n)
    assert 1e3 * t_bytes == pytest.approx(0.0681, abs=1e-4)


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
