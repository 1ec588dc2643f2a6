"""The port's sharding rules against the JAX package's, as pure functions
(no process group, no compile): `fsdp_spec` on shapes, and
`setokim_shardings` (TP on the trunk through `llama_tp_spec`, the FSDP
rule elsewhere) over every parameter of `tiny_setokim()` and
`base_setokim()` (the port model on the meta device; the JAX tree its flax
layout as ShapeDtypeStructs), each port spec taken to the flax layout
(a Dense weight is the flax kernel transposed). And `initialize_multihost`
without a device at WORLD_SIZE 2: it wants this process's card, so without
CUDA it raises and starts no group (never a gloo one)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.parallel import sharding as ps
from setok_tpu_torch.parallel.mesh import initialize_multihost
from setok_tpu_torch.train.opt8 import flax_perm
from setok_tpu_torch.utils.from_flax import flax_entries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _norm(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_fsdp_spec_matches_jax():
    from setok_tpu.parallel.sharding import fsdp_spec as j_fsdp_spec
    rs = np.random.RandomState(0)
    shapes = [(4096, 11008), (11008, 4096), (4096, 4096), (32000, 4096),
              (768,), (3, 3, 64, 128), (7, 9), (2 ** 15,), (2 ** 15 - 1,),
              (6, 6000), (5, 7000)]
    shapes += [tuple(int(x) for x in rs.randint(1, 300, rs.randint(1, 4)))
               for _ in range(40)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            assert _norm(ps.fsdp_spec(shape, n)) == _norm(
                tuple(j_fsdp_spec(shape, n))), (shape, n)


def _flax_spec(model, name, spec):
    """A port parameter's spec over its flax layout (the patch embedding's
    (C, p·p·3) weight is the (p, p, 3, C) kernel: its C is the kernel's
    last dimension, its p·p·3 the leading three)."""
    mod_name, _, leaf = name.rpartition(".")
    mod = dict(model.named_modules())[mod_name]
    p = dict(model.named_parameters())[name]
    perm = flax_perm(mod, leaf, p)
    if not spec:
        return ()
    flax = tuple(spec[perm[fd]] for fd in range(len(perm)))
    if mod_name.endswith("patch_embed"):
        flax = (flax[0], None, None, flax[1])
    return _norm(flax)


@pytest.mark.parametrize("preset,data,model", [
    ("tiny", 2, 2), ("tiny", 4, 1), ("tiny", 1, 4), ("tiny", 2, 4),
    ("base", 2, 2), ("base", 2, 4)])
def test_setokim_shardings_match_jax(preset, data, model):
    import jax
    from jax.sharding import Mesh
    from setok_tpu.parallel.sharding import (
        setokim_shardings as j_setokim_shardings)
    cfg = tcfg.tiny_setokim() if preset == "tiny" else tcfg.base_setokim()
    port = Setokim(cfg, device="meta")
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    tree, names = {}, {}
    for path, (key, v) in flax_entries(port).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
        names[path] = key
    want = j_setokim_shardings(tree, mesh)
    got = ps.setokim_shardings(port, {"data": data, "model": model})
    params = dict(port.named_parameters())
    n_tp = 0
    for path, key in names.items():
        if key not in params:
            continue                       # a buffer: not a parameter
        node = want
        for k in path:
            node = node[k]
        jspec = _norm(tuple(node.spec))
        assert _flax_spec(port, key, got[key]) == jspec, (key, got[key],
                                                          jspec)
        n_tp += "model" in jspec
    if model > 1:
        assert n_tp > 0


def test_initialize_multihost_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: started.append((a, k)))
    address = f"file://{tmp_path / 'rendezvous'}"
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        initialize_multihost(address)
    assert started == [] and not dist.is_initialized()
    # an explicit CPU device is what asks for gloo
    initialize_multihost(address, device="cpu")
    assert [a[0] for a, _ in started] == ["gloo"]
