"""Parameter sharding rules: FSDP over `data`, tensor parallelism over
`model`, and optimizer state parked in host memory.

The counterpart of `setok_tpu/parallel/sharding.py`. The rules are the JAX
package's, answered in the port's names and layouts:

  * `fsdp_spec`: shard a leaf's largest dimension that divides the axis
    size; replicate a leaf under 2^15 elements. The port applies it to
    each parameter in its flax layout (a Dense weight is the flax kernel
    transposed) and maps the chosen dimension back, so that a leaf is
    split on the same logical dimension as under the JAX mesh.
  * `llama_tp_spec`: Megatron's column split of q/k/v/gate/up/lm_head (the
    output features) and row split of o/down (the input features), with
    the JAX divisibility checks. The port's Dense weights are (out, in)
    against flax's (in, out), so the split dimensions swap.
  * `setokim_shardings`: TP on the trunk, the FSDP rule for the rest.

Where XLA partitions a program from these specs, the port applies them
itself. `Fsdp` is ZeRO-3 by gather-on-use: each rank keeps its slice of a
sharded parameter (the Parameter object stays, its data becomes the
slice); a unit module (a trunk block) all-gathers its parameters in a
forward pre-hook and drops them after the forward, and `gathered()` does
the same for the parameters outside the units over a whole step. The
gather is differentiable: its backward reduce-scatters (sums) the
gradient into the slice, so `torch.autograd.grad` of a loss returns
slice-shaped gradients. Under `remat` (non-reentrant checkpointing) the
recomputation gathers again, so a rank never holds more than one block's
full parameters at a time outside `gathered()`.

Block-quantised 8-bit moments (train/opt8.py) block each parameter in its
flax element order. A slice of the flax array's leading dimension whose
size is a whole number of blocks is a contiguous run of whole blocks, the
same blocks as one process: such parameters take that dimension, or stay
whole where it does not divide.

`offload_to_host` / `fetch_to_device` park optimizer state in pinned host
memory and bring it to the card on a side stream for the step
(`HostOffload`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.parallel import comm
from setok_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                           axis_group, axis_size)

MIN_SHARD_ELEMS = 2 ** 15


def fsdp_spec(shape, axis_size: int, axis: str = DATA_AXIS,
              min_shard_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """Partition spec of one array (a tuple of axis names or None per
    dimension, () = replicated): the largest dimension that divides."""
    if int(np.prod(shape)) < min_shard_elems:
        return ()
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in dims:
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def _perm(module: nn.Module, leaf: str, p: torch.Tensor):
    from setok_tpu_torch.train.opt8 import flax_perm
    return flax_perm(module, leaf, p)


def _named_leaves(model: nn.Module):
    """(state-dict name, module, leaf, parameter) of each parameter."""
    for mod_name, mod in model.named_modules():
        for leaf, p in mod._parameters.items():
            if p is not None:
                yield (f"{mod_name}.{leaf}" if mod_name else leaf), mod, \
                    leaf, p


def _port_spec(flax_spec: tuple, perm) -> tuple:
    """A spec over the flax layout → the same split over the port's."""
    if not flax_spec:
        return ()
    out = [None] * len(perm)
    for fd, ax in enumerate(flax_spec):
        out[perm[fd]] = ax
    return tuple(out)


def fsdp_port_spec(module: nn.Module, leaf: str, p: torch.Tensor,
                   axis_size: int, axis: str = DATA_AXIS,
                   min_shard_elems: int = MIN_SHARD_ELEMS,
                   name: str = "") -> tuple:
    """`fsdp_spec` of a port parameter, taken over its flax layout. The
    patch embedding's flax kernel (p, p, 3, C) is its (C, p·p·3) weight
    transposed and reshaped: a split of C, or of the leading p (a
    contiguous run of p·p·3), maps back; an inner dimension's does not,
    and the weight stays whole."""
    from setok_tpu_torch.utils.from_flax import _flax_leaf
    perm = _perm(module, leaf, p)
    shape = [p.shape[i] for i in perm]
    flax = tuple(_flax_leaf(module, leaf, torch.empty(
        tuple(p.shape), device="meta"), name.rpartition(".")[0])[1].shape)
    if len(flax) == len(shape):
        return _port_spec(fsdp_spec(shape, axis_size, axis,
                                    min_shard_elems), perm)
    spec = fsdp_spec(flax, axis_size, axis, min_shard_elems)
    if not spec:
        return ()
    fd = spec.index(axis)
    if fd not in (0, len(flax) - 1):
        return ()
    return _port_spec((axis, None) if fd == 0 else (None, axis), perm)


def fsdp_dim(module: nn.Module, leaf: str, p: torch.Tensor, n: int,
             axis: str = DATA_AXIS, min_shard_elems: int = MIN_SHARD_ELEMS,
             name: str = "", blocked: bool = False,
             block: int = 256) -> Optional[int]:
    """The port dimension `Fsdp` splits a parameter on over n ranks, or
    None (whole): the FSDP rule's; for a parameter with block-quantised
    moments (`blocked`), its flax leading dimension where the rule shards
    at all and each slice is a whole number of blocks."""
    if not p.dim():
        return None
    spec = fsdp_port_spec(module, leaf, p, n, axis, min_shard_elems, name)
    if not spec:
        return None
    if not blocked:
        return spec.index(axis)
    lead = _perm(module, leaf, p)[0]
    ok = p.shape[lead] % n == 0 and (p.numel() // n) % block == 0
    return lead if ok else None


def fsdp_shardings(model: nn.Module, mesh, axis: str = DATA_AXIS,
                   min_shard_elems: int = MIN_SHARD_ELEMS) -> Dict[str, tuple]:
    """{parameter name: spec} of the FSDP rule over `axis` of `mesh`."""
    n = axis_size(mesh, axis)
    return {name: (fsdp_port_spec(mod, leaf, p, n, axis, min_shard_elems,
                                  name) if p.dim() else ())
            for name, mod, leaf, p in _named_leaves(model)}


def shard_tree(model: nn.Module, mesh, axis: str = DATA_AXIS,
               **kw) -> "Fsdp":
    """Shard `model`'s parameters by the FSDP rule over `axis` (in place);
    the returned `Fsdp` gathers them on use."""
    return Fsdp(model, mesh, axis=axis, **kw)


# ---------------------------------------------------------------------------
# Tensor parallelism for the LLaMA trunk (Megatron-style column/row split)

_TP_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
_TP_ROW = ("o_proj", "down_proj")


def llama_tp_spec(name: str, shape, model_axis: str = MODEL_AXIS,
                  model_size: int = 1):
    """Spec of one trunk parameter by its port name, or None if it is not
    TP-split (the caller then takes the FSDP rule). The JAX rule on the
    flax layout: column-parallel kernels split their output features,
    row-parallel ones their input features, the embedding its hidden
    width, each only where the size divides."""
    if model_size <= 1 or len(shape) != 2:
        return None
    parts = name.split(".")
    if any(k in parts for k in _TP_COL):
        # (out, in): flax's (in, out) split on out
        if shape[0] % model_size == 0:
            return (model_axis, None)
    if any(k in parts for k in _TP_ROW):
        if shape[1] % model_size == 0:
            return (None, model_axis)
    if "embed_tokens" in parts and shape[1] % model_size == 0:
        return (None, model_axis)
    return None


def setokim_shardings(model: nn.Module, mesh, data_axis: str = DATA_AXIS,
                      model_axis: str = MODEL_AXIS,
                      min_shard_elems: int = MIN_SHARD_ELEMS
                      ) -> Dict[str, tuple]:
    """{parameter name: spec}: TP on the LLaMA trunk, FSDP for the rest."""
    model_size = axis_size(mesh, model_axis)
    data_size = axis_size(mesh, data_axis)
    out = {}
    for name, mod, leaf, p in _named_leaves(model):
        spec = llama_tp_spec(name, tuple(p.shape), model_axis, model_size)
        if spec is None:
            spec = (fsdp_port_spec(mod, leaf, p, data_size, data_axis,
                                   min_shard_elems, name)
                    if p.dim() else ())
        out[name] = spec
    return out


# ---------------------------------------------------------------------------
# FSDP: ZeRO-3 by gather-on-use


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.all_gather_cat(local.detach(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter_cat(g, ctx.dim, ctx.group), None, None


class Piece:
    """Where a local tensor lies in its full one: `dim` (None: whole) and
    this rank's [start, start + length) along it."""

    __slots__ = ("dim", "start", "length", "full")

    def __init__(self, dim: Optional[int], start: int, length: int,
                 full: Tuple[int, ...]):
        self.dim, self.start, self.length, self.full = dim, start, length, \
            tuple(full)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full tensor (a copy)."""
        if self.dim is None:
            return full.clone()
        return full.narrow(self.dim, self.start, self.length).clone()



class Fsdp:
    """Shard `root`'s parameters over `axis` of `mesh` by the FSDP rule and
    gather them on use (see the module docstring).

    `units`: modules that gather their own parameters around each forward
    (the trunk blocks); `skip`: parameters left whole (tensor-parallel
    slices, which the JAX rule does not shard on `data`); `block_params`:
    parameters with block-quantised moments (train/opt8.BLOCK elements),
    which take the flax leading dimension or stay whole."""

    def __init__(self, root: nn.Module, mesh, axis: str = DATA_AXIS,
                 units: Sequence[nn.Module] = (),
                 skip: Iterable[torch.Tensor] = (),
                 block_params: Iterable[torch.Tensor] = (),
                 block: int = 256,
                 min_shard_elems: int = MIN_SHARD_ELEMS):
        self.group = axis_group(mesh, axis)
        self.size = comm.group_size(self.group)
        self.rank = comm.group_rank(self.group)
        skip = {id(p) for p in skip}
        blocked = {id(p) for p in block_params}
        # (module, leaf, parameter, dim)
        self.entries: List[tuple] = []
        self.pieces: Dict[int, Piece] = {}
        seen = set()
        for name, mod, leaf, p in _named_leaves(root):
            if id(p) in seen:
                continue
            seen.add(id(p))
            dim = None
            if id(p) not in skip and self.group is not None:
                dim = fsdp_dim(mod, leaf, p, self.size, axis,
                               min_shard_elems, name, id(p) in blocked,
                               block)
            full = tuple(p.shape)
            if dim is None:
                self.pieces[id(p)] = Piece(None, 0, 0, full)
                continue
            length = full[dim] // self.size
            piece = Piece(dim, self.rank * length, length, full)
            with torch.no_grad():
                p.data = piece.take(p.data)
            self.pieces[id(p)] = piece
            self.entries.append((mod, leaf, p, dim))
        self._unit_entries = set()
        for u in units:
            mine = [e for e in self.entries
                    if any(e[0] is m for m in u.modules())]
            if not mine:
                continue
            self._unit_entries.update(id(e[2]) for e in mine)
            u.register_forward_pre_hook(
                lambda mod, args, mine=mine: self._gather(mine))
            u.register_forward_hook(
                lambda mod, args, out, mine=mine: self._release(mine))
        self._root = [e for e in self.entries
                      if id(e[2]) not in self._unit_entries]

    def _gather(self, entries) -> None:
        for mod, leaf, p, dim in entries:
            if torch.is_grad_enabled() and p.requires_grad:
                full = _GatherParam.apply(p, dim, self.group)
            else:
                full = comm.all_gather_cat(p.detach(), dim, self.group)
            mod.__dict__[leaf] = full

    @staticmethod
    def _release(entries) -> None:
        for mod, leaf, _, _ in entries:
            mod.__dict__.pop(leaf, None)

    @contextlib.contextmanager
    def gathered(self):
        """The parameters outside the units gathered for the duration (a
        training step's forward and backward)."""
        self._gather(self._root)
        try:
            yield
        finally:
            self._release(self._root)

    def is_sharded(self, p: torch.Tensor) -> bool:
        piece = self.pieces.get(id(p))
        return piece is not None and piece.dim is not None

    def reduce_grads(self, params: Sequence[torch.Tensor],
                     grads: List[torch.Tensor]) -> None:
        """Sum over the data ranks the gradients of the parameters left
        whole (a sharded one's gradient came out of the gather's
        reduce-scatter already summed)."""
        for i, p in enumerate(params):
            if not self.is_sharded(p):
                comm.all_reduce_(grads[i], self.group)

    def full(self, p: torch.Tensor, t: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """The full tensor of parameter `p` (or of `t`, a tensor laid out
        like p's slice) on every rank."""
        t = p.detach() if t is None else t
        piece = self.pieces.get(id(p))
        if piece is None or piece.dim is None:
            return t
        return comm.all_gather_cat(t.contiguous(), piece.dim, self.group)


def gather_layout(state, layout: Dict[str, tuple]):
    """A copy of a trainer's `state_dict()` with each leaf of `layout`
    ({checkpoint path: (Piece, group)}) gathered to its full tensor (a
    collective: every rank of the groups calls it)."""
    from setok_tpu_torch.utils.checkpoint import map_leaves

    def full(path, t):
        got = layout.get(path)
        if got is None or not isinstance(t, torch.Tensor):
            return t
        return comm.all_gather_cat(t.detach().contiguous(), got[0].dim,
                                   got[1])

    return map_leaves(state, full)


def sharded_sq_norm(groups: Dict[Tuple[Any, ...], List[torch.Tensor]]
                    ) -> torch.Tensor:
    """sqrt of the sum of squares of gradients that lie in slices: each
    key is a tuple of the process groups over which its tensors are split
    (their squares are summed over those groups), () for whole ones."""
    total = None
    for key in sorted(groups, key=len):
        ts = groups[key]
        if not ts:
            continue
        s = sum((t.float() * t.float()).sum() for t in ts)
        for g in key:
            comm.all_reduce_(s, g)
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Host offload: optimizer state in pinned host memory, on the card only
# inside the step (the JAX package's `offload_to_host` / `fetch_to_device`)


def offload_to_host(tree: Any, into: Any = None) -> Any:
    """Every tensor of `tree` copied to pinned host memory (into the
    matching tensors of `into` where given, without blocking: the caller
    synchronises before reading them). Non-tensors pass through."""
    if isinstance(tree, dict):
        return {k: offload_to_host(v, None if into is None else into.get(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(offload_to_host(v, None if into is None
                                          else into[i])
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if into is not None and into.shape == tree.shape \
            and into.dtype == tree.dtype:
        into.copy_(tree, non_blocking=True)
        return into
    pin = tree.device.type == "cuda"
    out = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=pin)
    out.copy_(tree)
    return out


def fetch_to_device(tree: Any, device, stream=None) -> Any:
    """Every tensor of `tree` copied to `device`, `non_blocking` on
    `stream` when given (the caller's stream waits for it)."""
    if isinstance(tree, dict):
        return {k: fetch_to_device(v, device, stream) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_to_device(v, device, stream) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if stream is None:
        return tree.to(device)
    with torch.cuda.stream(stream):
        return tree.to(device, non_blocking=True)


class HostOffload:
    """An optimizer whose state lives in pinned host memory between steps:
    `step()` fetches it to the card on a side stream, runs the
    optimizer's step there and writes the new state back into the pinned
    buffers (the copy-back is waited for before `step()` returns). On the
    CPU the state is already on the host, and the step is the
    optimizer's."""

    def __init__(self, opt: torch.optim.Optimizer):
        self.opt = opt
        self.host: Dict[torch.Tensor, dict] = {}

    def __getattr__(self, name):
        if name == "opt":               # not yet set (a copy, an unpickle)
            raise AttributeError(name)
        return getattr(self.opt, name)

    def _device(self):
        for g in self.opt.param_groups:
            for p in g["params"]:
                return p.device
        return torch.device("cpu")

    @staticmethod
    def _moments(st: dict) -> dict:
        """The state's tensors that move (a 0-dim step count stays where
        the optimizer keeps it)."""
        return {k: v for k, v in st.items()
                if isinstance(v, torch.Tensor) and v.dim()}

    def step(self, closure=None):
        dev = self._device()
        if dev.type != "cuda":
            return self.opt.step(closure)
        side = torch.cuda.Stream(device=dev)
        for p, host in self.host.items():
            self.opt.state[p].update(fetch_to_device(host, dev, side))
        torch.cuda.current_stream(dev).wait_stream(side)
        out = self.opt.step(closure)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for p, st in self.opt.state.items():
                self.host[p] = offload_to_host(self._moments(st),
                                               self.host.get(p))
        side.synchronize()
        for p, st in self.opt.state.items():
            st.update(self.host[p])
        return out

    def zero_grad(self, set_to_none: bool = True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state):
        self.opt.load_state_dict(state)
        if self._device().type == "cuda":
            for p, st in self.opt.state.items():
                self.host[p] = offload_to_host(self._moments(st))
                st.update(self.host[p])

    def device_bytes(self) -> int:
        """Bytes of optimizer state on the card between steps (a step
        count the optimizer keeps there stays)."""
        return sum(t.numel() * t.element_size()
                   for st in self.opt.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda")
