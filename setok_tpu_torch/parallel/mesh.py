"""Device meshes over `torch.distributed`: one process per card.

The counterpart of `setok_tpu/parallel/mesh.py`. Where the JAX package
runs one program over a `jax.sharding.Mesh` and lets XLA insert the
collectives, the port runs one process per card (launched by `torchrun`)
and issues its collectives itself (parallel/comm.py). A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the JAX axis names and the
same row-major layout of ranks as `np.array(devices).reshape(data, model)`:
rank r sits at (r // model, r % model).

Axis conventions:
  data  — batch / FSDP shards (parallel/sharding.Fsdp)
  model — tensor-parallel shards of the LLaMA trunk
  seq   — the ring of sequence-parallel attention (parallel/ring_attention)

`initialize_multihost` reads torchrun's environment and starts the process
group: NCCL for a CUDA device (the default: this process's card), gloo for
an explicit CPU device, never a CPU group for a CUDA model. At one process
it does nothing, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from setok_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed: call "
                           "initialize_multihost(...) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(shape: Tuple[int, int], names: Tuple[str, str]) -> DeviceMesh:
    n = shape[0] * shape[1]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh wants {n} devices, have {world}")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(names))


def make_mesh(cfg: Optional[MeshConfig] = None) -> DeviceMesh:
    """A (data, model) mesh. With cfg=None, every rank goes to `data`."""
    if cfg is None:
        cfg = MeshConfig(data=dist.get_world_size(), model=1)
    return _build((cfg.data, cfg.model), cfg.axis_names)


def make_sp_mesh(data: int, seq: int) -> DeviceMesh:
    """(data, seq) mesh for sequence-parallel (ring-attention) training:
    the sequence axis carries the K/V ring; the batch stays on `data`."""
    return _build((data, seq), (DATA_AXIS, SEQ_AXIS))


def data_sharding(mesh: DeviceMesh):
    """The batch's placements: dim 0 sharded over `data`, replicated over
    every other axis."""
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` (1 without a mesh or without that axis). `mesh`
    may also be a mapping of axis sizes (`jax.sharding.Mesh.shape`'s
    form), for the sharding rules alone."""
    if isinstance(mesh, dict):
        return int(mesh.get(axis, 1))
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This process's coordinate on `axis` (0 without it)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group along `axis`, or None without a mesh or without
    that axis (every collective over it is then the identity). An axis of
    size 1 has its group: the mesh code runs, over one rank."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def local_device(cpu: bool = False) -> torch.device:
    """The card of this process (`cuda:LOCAL_RANK`), or the CPU."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> None:
    """Start the process group (a no-op at one process).

    The count and the rank come from the arguments or from torchrun's
    `WORLD_SIZE` / `RANK`; the address from `coordinator_address`
    ("tcp://host:port" or "file://path") or torchrun's
    `MASTER_ADDR` / `MASTER_PORT`. `device` picks the backend: NCCL for a
    CUDA device (which becomes this process's current card), gloo for the
    CPU. None means this process's card (`local_device()`): without CUDA
    that raises, and only `device="cpu"` starts a gloo group."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    device = local_device() if device is None else torch.device(device)
    kw = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass device='cpu' "
                               "for a gloo group")
        torch.cuda.set_device(device)
        backend = "nccl"
        kw["device_id"] = device
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=coordinator_address or
                            "env://", world_size=num_processes,
                            rank=process_id, **kw)


def check_backend(device) -> None:
    """Raise unless the process group's backend serves `device`: NCCL for
    a CUDA device, gloo for the CPU (no fallback either way)."""
    if not dist.is_initialized():
        return
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a {torch.device(device).type} model needs a "
                           f"{want} process group, not "
                           f"{dist.get_backend()}")
