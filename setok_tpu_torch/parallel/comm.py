"""Collectives that autograd differentiates, for the mesh code.

Each takes a process group, or None for an axis of size 1, where it is the
identity. The Megatron pair `copy_to` (forward: identity, backward:
all-reduce) and `reduce_from` (forward: all-reduce, backward: identity)
bracket a tensor-parallel block. `gather_replicated` concatenates the
ranks' pieces where what follows is computed alike on every rank (its
backward keeps this rank's slice of the gradient); `gather_summed`
concatenates pieces whose consumers differ by rank (its backward sums the
gradients of every rank before taking the slice: the transpose of an
all-gather, as `jax.lax.all_gather` has it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the single-tensor collectives under their newer names where the
# installed PyTorch has them (same arguments)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (no autograd); the identity without a group. A
    non-contiguous tensor (NCCL takes none) goes through a contiguous
    copy."""
    if group is None:
        return t
    if t.is_contiguous():
        dist.all_reduce(t, op=op, group=group)
        return t
    flat = t.contiguous()
    dist.all_reduce(flat, op=op, group=group)
    return t.copy_(flat)


def all_reduce_many(tensors, group, op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce of many tensors, one collective per dtype (the
    tensors flattened into one buffer)."""
    if group is None or not tensors:
        return
    by_type: dict = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for ts in by_type.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=op, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `t` concatenated along `dim` (no autograd)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather_single(out, moved, group=group)
    return out.movedim(0, dim)


def reduce_scatter_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ranks of `t`, this rank's slice along `dim` (the
    transpose of `all_gather_cat`; no autograd)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _reduce_scatter_single(out, moved, group=group)
    return out.movedim(0, dim)


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    return t.chunk(n, dim)[r]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of a row-parallel layer's partial outputs."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, group)
    return all_reduce_(x.contiguous(), group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherReplicated.apply(x, dim, group)
    return all_gather_cat(x, dim, group)


def gather_summed(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSummed.apply(x, dim, group)
    return all_gather_cat(x, dim, group)


def shift_ring(tensors, group, reverse: bool = False):
    """Each rank's tensors sent to the next rank of `group` (the previous
    one with `reverse`), the previous rank's received: JAX's `ppermute`
    over the ring i → i + 1, through `batch_isend_irecv` (no autograd)."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    r = group_rank(group)
    nxt, prv = (r + 1) % n, (r - 1) % n
    if reverse:
        nxt, prv = prv, nxt
    to = dist.get_global_rank(group, nxt)
    frm = dist.get_global_rank(group, prv)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, to, group))
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """The ring shift of float tensors; its transpose is the reverse
    shift."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(shift_ring(xs, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *shift_ring([g.contiguous() for g in gs], ctx.group,
                                  reverse=True))


def rotate(tensors, group):
    """`shift_ring`, differentiable for the tensors that require grad."""
    if group_size(group) == 1:
        return list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_Rotate.apply(group, *tensors))
    return shift_ring(tensors, group)
