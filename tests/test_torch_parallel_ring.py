"""The port's `ring_attention` over 2 and 4 gloo processes against the
JAX package's under `shard_map` on the virtual CPU mesh of
tests/conftest.py: the same numpy q, k, v, causal and not, with and
without hole-aware positions and validity. Bars of
tests/test_ring_attention.py: forward rtol 2e-4 / atol 2e-5, gradients
(of sum(out · ct), with respect to q, k and v) rtol 2e-3 / atol 2e-4."""

import numpy as np
import pytest

from tests import torch_parallel_workers as W
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, L, D = 2, 2, 32, 16


def cases():
    rs = np.random.RandomState(0)
    out = []
    for causal, holes in ((True, False), (False, False), (True, True)):
        q, k, v, ct = (rs.randn(B, H, L, D).astype(np.float32)
                       for _ in range(4))
        positions = valid = None
        if holes:
            # the Setokim splice's layout: masked holes mid-sequence and a
            # pad tail; positions count the valid tokens before
            valid = np.ones((B, L), bool)
            valid[0, 5:9] = False
            valid[1, 20:] = False
            valid[1, 2:4] = False
            positions = (np.cumsum(valid, axis=1) - 1).astype(np.int32)
        out.append((q, k, v, ct, causal, positions, valid))
    return out


def jax_ring(world, q, k, v, ct, causal, positions, valid):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from setok_tpu.parallel.ring_attention import ring_attention
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    spec, row = P(None, None, "seq", None), P(None, "seq")

    def f(q, k, v, *pv):
        kw = {}
        if pv:
            kw = dict(positions=pv[0], valid=pv[1])
        return ring_attention(q, k, v, "seq", causal=causal, **kw)

    args = [jnp.asarray(x) for x in (q, k, v)]
    specs = [spec] * 3
    if positions is not None:
        args += [jnp.asarray(positions), jnp.asarray(valid)]
        specs += [row, row]
    ring = shard_map(f, mesh=mesh, in_specs=tuple(specs), out_specs=spec)

    def loss(q, k, v):
        out = ring(q, k, v, *args[3:])
        return jnp.sum(out * ct), out

    # the forward and the gradients in one compile
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args[:3])
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax_shard_map(world, tmp_path):
    cs = cases()
    got = W.spawn(W.ring_cases, world, tmp_path, cs)
    for i, c in enumerate(cs):
        want = jax_ring(world, *c)
        full = [np.concatenate([got[r][i][j] for r in range(world)], axis=2)
                for j in range(4)]
        np.testing.assert_allclose(full[0], want[0], rtol=2e-4, atol=2e-5)
        for g, w in zip(full[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
