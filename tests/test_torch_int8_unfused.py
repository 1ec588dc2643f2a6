"""The unfused int8 route against the JAX package on the CPU.

Where the gates of the whole-sublayer int8 kernels fail, the JAX package's
blocks keep their float structure and their `Attention`, `Mlp` and `Dense`
take `fused_attention_int8`, `fused_mlp_int8` and `quant_matmul`. The
port's modules do the same; here they are held to the JAX modules on the
same flax weights and the same numpy inputs from a seed, with the JAX
kernels run with `interpret=True`, as the JAX tests run them.

Bars, max-rel = max|got - want| / max|want|:

  * `fused_mlp_int8` and `Dense`-int8: 1e-5. The int products are exact
    and the float epilogues follow the kernels operation by operation.
  * `fused_attention_int8`: 2e-3, with at least 99 % of the elements
    within 1e-5 of max|want|. The f32 scores and PV sum in another order,
    which can flip one int8 step of the attention output.
  * modules in each route: 2e-3 in float32. In bf16 glue the modules round
    to bf16 between the int8 products (the JAX route's casts), so a bf16
    rounding of a value on either side of an int8 step moves a row by one
    step: 2e-2, and the output type must be JAX's: the float32 outputs
    of `fused_mlp_int8` and `fused_attention_int8` promote a bf16
    residual, the `Dense`-int8 ones are bf16 (test_wrong_cast_is_caught).

The configurations of the route (base @384, base with a 4096-wide tokenizer
MLP, so400m) and a tiny forward end to end are in
tests/test_torch_int8_unfused_setok.py.
"""

import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.kernels.fused_attention_int8 import (
    fused_attention_int8 as j_attn)
from setok_tpu.kernels.fused_mlp import fused_mlp_int8 as j_mlp
from setok_tpu.models.vit import ViTEncoderBlock as JViTEncoderBlock
from setok_tpu.ops import blocks as jblocks
from setok_tpu_torch.kernels import fused_attention_int8 as fai
from setok_tpu_torch.kernels import fused_mlp as fm
from setok_tpu_torch.kernels import fused_sublayer as fs
from setok_tpu_torch.kernels import quant_matmul as qm
from setok_tpu_torch.kernels.quant import quantize_weight
from setok_tpu_torch.models.vit import ViTEncoderBlock
from setok_tpu_torch.ops import blocks
from setok_tpu_torch.utils.from_flax import load_flax_params

jfs = importlib.import_module("setok_tpu.kernels.fused_sublayer")

KERNEL_TOL = 1e-5
ATTN_TOL = 2e-3
ATTN_CLOSE_SHARE = 0.99
MODULE_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close_share(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) <= rel * np.abs(want).max()).mean())


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def qw(w_in_out):
    """A flax-layout (in, out) kernel → the port's int8 weight."""
    return quantize_weight(t(w_in_out.T))


def _dense(rs, fan_in, fan_out):
    return ((rs.randn(fan_in, fan_out) / np.sqrt(fan_in)).astype(np.float32),
            (rs.randn(fan_out) * 0.1).astype(np.float32))


def _block_mask(b, n, rs, n_groups=3):
    labels = rs.randint(0, n_groups, size=(b, n))
    return labels[:, :, None] == labels[:, None, :]


def _valid_mask(b, n, n_valid):
    valid = np.zeros((b, n), bool)
    for i, k in enumerate(n_valid):
        valid[i, :k] = True
    return valid[:, None, :] & valid[:, :, None]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------------
# the kernels' plain versions


@pytest.mark.parametrize("seed,lead,c,hidden,c_out", [
    (0, (3, 16), 32, 64, 32),        # leading dims
    (1, (37,), 32, 96, 32),          # ragged M: 37 rows in blocks of 16
    (2, (2, 5, 7), 64, 128, 48),     # C_out != C
])
def test_fused_mlp_matches_jax(seed, lead, c, hidden, c_out):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, c).astype(np.float32)
    w1, b1 = _dense(rs, c, hidden)
    w2, b2 = _dense(rs, hidden, c_out)
    want = np.asarray(j_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                            block_m=16, interpret=True))
    got = fm.fused_mlp_int8(t(x), qw(w1), t(b1), qw(w2), t(b2))
    assert got.shape == (*lead, c_out) and got.dtype == torch.float32
    assert max_rel(got.numpy(), want) <= KERNEL_TOL


@pytest.mark.parametrize("b,n,c,heads,mask_kind,sm_scale", [
    (2, 16, 64, 4, None, None),
    (2, 24, 128, 2, "block", None),      # the inner Block: clusters
    (2, 12, 256, 2, "valid", None),      # the inter Block: masked rows
    (1, 8, 768, 2, "block", None),       # head dim 384, as on the path
    (2, 16, 64, 4, "block", 0.3),        # an explicit qk scale
], ids=["plain", "inner", "inter", "hd384", "qk_scale"])
def test_fused_attention_matches_jax(b, n, c, heads, mask_kind, sm_scale):
    rs = np.random.RandomState(300 + c + n)
    x = rs.randn(b, n, c).astype(np.float32)
    wqkv, bqkv = _dense(rs, c, 3 * c)
    wp, bp = _dense(rs, c, c)
    mask = None
    if mask_kind == "block":
        mask = _block_mask(b, n, rs)
    elif mask_kind == "valid":
        mask = _valid_mask(b, n, [n - 3, 5])
    want = np.asarray(j_attn(
        *map(jnp.asarray, (x, wqkv, bqkv, wp, bp)), heads,
        None if mask is None else jnp.asarray(mask), sm_scale,
        interpret=True))
    got = fai.fused_attention_int8(
        t(x), qw(wqkv), t(bqkv), qw(wp), t(bp), heads,
        None if mask is None else t(mask), sm_scale).numpy()
    assert max_rel(got, want) <= ATTN_TOL
    assert close_share(got, want) >= ATTN_CLOSE_SHARE
    if mask_kind == "valid":
        # a fully masked query row attends to nothing: o = 0, out = b_proj
        rows = ~mask.any(-1)
        assert rows.any()
        np.testing.assert_array_equal(got[rows],
                                      np.broadcast_to(bp, got[rows].shape))


# ----------------------------------------------------------------------------
# Dense


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dense_int8_matches_jax(dtype):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 10, 48).astype(np.float32)
    jm = jblocks.Dense(80, quant8=True, dtype=JNP[dtype])
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)          # a live bias
    want = jm.apply(params, jnp.asarray(x))
    tm = load_flax_params(blocks.Dense(48, 80, quant8=True, dtype=dtype),
                          to_np(params))
    with torch.inference_mode():
        got = tm(t(x))
    assert got.dtype == dtype and want.dtype == JNP[dtype]
    assert max_rel(got.float().numpy(), np.asarray(want, np.float32)) \
        <= KERNEL_TOL


def test_dense_above_the_int8_gate_stays_float(monkeypatch):
    """in·out > 8 Mi: the float product, and no weight is quantised."""
    k, n = 4096, 2049
    assert k * n > blocks.DENSE_INT8_MAX
    monkeypatch.setattr(qm, "quant_matmul", None)         # must not be called
    rs = np.random.RandomState(6)
    x = rs.randn(2, k).astype(np.float32)
    jm = jblocks.Dense(n, quant8=True)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_flax_params(blocks.Dense(k, n, quant8=True), to_np(params))
    with torch.inference_mode():
        got = tm(t(x))
    assert "_int8" not in tm.__dict__
    assert max_rel(got.numpy(), want) <= 1e-5


# ----------------------------------------------------------------------------
# modules in each route, the gates of both packages forced alike


ROUTES = {"both": (True, True), "attn_only": (True, False),
          "mlp_only": (False, True), "neither": (False, False)}


@pytest.fixture
def route(request, monkeypatch):
    """Force `attn_fits_vmem` and `mlp_fits_vmem` of both packages to the
    route's answers."""
    attn_fits, mlp_fits = ROUTES[request.param]
    for mod in (jfs, fs):
        monkeypatch.setattr(mod, "attn_fits_vmem", lambda n, c: attn_fits)
        monkeypatch.setattr(mod, "mlp_fits_vmem",
                            lambda c, h, block_m=256: mlp_fits)
    return request.param


def _jax_module(name, quant8, dtype=torch.float32):
    jd = JNP[dtype]
    if name == "mlp":
        return jblocks.Mlp(hidden_features=64, quant8=quant8, dtype=jd)
    if name == "attention":
        return jblocks.Attention(num_heads=2, quant8=quant8, dtype=jd)
    if name == "block":
        return jblocks.Block(num_heads=2, mlp_hidden_dim=64, depth=2,
                             quant8=quant8, dtype=jd)
    if name == "vitblock":
        return jblocks.ViTBlock(num_heads=2, quant8=quant8, dtype=jd)
    return JViTEncoderBlock(num_heads=2, mlp_ratio=4.0, quant8=quant8,
                            dtype=jd)


def _port_module(name, dtype):
    if name == "mlp":
        return blocks.Mlp(32, 64, quant8=True, dtype=dtype)
    if name == "attention":
        return blocks.Attention(32, 2, quant8=True, dtype=dtype)
    if name == "block":
        return blocks.Block(32, 2, 64, depth=2, norm_eps=1e-5, quant8=True,
                            dtype=dtype)
    if name == "vitblock":
        return blocks.ViTBlock(32, 2, norm_eps=1e-5, quant8=True, dtype=dtype)
    return ViTEncoderBlock(32, 2, 4.0, quant8=True, dtype=dtype)


MASKED = ("attention", "block", "vitblock")


@functools.cache
def _inputs(name, seed=21):
    """x, the mask kwargs and the flax parameters (with live biases) of one
    module. The float module declares the same tree as the int8 one, and its
    init runs no interpret-mode kernel."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 16, 32).astype(np.float32)
    kw = {"mask": _block_mask(2, 16, rs)} if name in MASKED else {}
    params = _jax_module(name, False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    return x, kw, to_np(jax.tree.map(lambda a: a + 0.05, params))


def _run_module(name, dtype):
    x, kw, params = _inputs(name)
    want = _jax_module(name, True, dtype).apply(
        params, jnp.asarray(x, JNP[dtype]),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tm = load_flax_params(_port_module(name, dtype), params)
    with torch.inference_mode():
        got = tm(t(x).to(dtype), **{k: t(v) for k, v in kw.items()})
    return got, want


# the JAX package's kernel per module and route
def _kernels_taken(name, route):
    attn_fits, mlp_fits = ROUTES[route]
    if name == "mlp":
        return {"fused_mlp_int8"} if mlp_fits else {"quant_matmul"}
    if name == "attention":
        return {"fused_attention_int8"} if attn_fits else {"quant_matmul"}
    if attn_fits and mlp_fits:
        return {"attn_sublayer_int8", "mlp_sublayer_int8"}
    return ({"fused_attention_int8"} if attn_fits else set()) | (
        {"fused_mlp_int8"} if mlp_fits else set()) | (
        set() if attn_fits and mlp_fits else {"quant_matmul"})


def _spy_port(monkeypatch):
    seen = set()
    for mod, name in ((fs, "attn_sublayer_int8"), (fs, "mlp_sublayer_int8"),
                      (fm, "fused_mlp_int8"), (fai, "fused_attention_int8"),
                      (qm, "quant_matmul")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.add(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


# Mlp and Attention read one gate each; the blocks read both
MODULE_ROUTES = ([(m, r) for m in ("mlp", "attention")
                  for r in ("both", "neither")]
                 + [(m, r) for m in ("block", "vitblock", "vit_encoder_block")
                    for r in ROUTES])


def _torch_dtype(want):
    return {jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16}[want.dtype.type]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,route", MODULE_ROUTES, indirect=["route"],
                         ids=[f"{m}-{r}" for m, r in MODULE_ROUTES])
def test_int8_route_matches_jax(name, route, dtype, monkeypatch):
    seen = _spy_port(monkeypatch)
    got, want = _run_module(name, dtype)
    assert seen == _kernels_taken(name, route)
    assert got.dtype == _torch_dtype(want)
    assert max_rel(got.float().numpy(), np.asarray(want, np.float32)) \
        <= MODULE_TOL[dtype]


@pytest.mark.parametrize("route", ["mlp_only"], indirect=True)
def test_wrong_cast_is_caught(route, monkeypatch):
    """`fused_mlp_int8` returns float32, which promotes the bf16 residual
    of the unfused Block. A port that cast it to the glue type would stay
    within the bf16 bar; the type check of the route test catches it."""
    real = fm.fused_mlp_int8
    monkeypatch.setattr(fm, "fused_mlp_int8",
                        lambda *a: real(*a).to(torch.bfloat16))
    got, want = _run_module("block", torch.bfloat16)
    assert want.dtype == jnp.float32
    assert got.dtype != _torch_dtype(want)
