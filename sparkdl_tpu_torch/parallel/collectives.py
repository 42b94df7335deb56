"""Differentiable collectives over a mesh axis.

The JAX package's parallel wrappers take and return global arrays, and
``jax.grad`` of one loss over the global output gives the dense gradient.
In the port every process of a ``torch.distributed`` group holds the full
inputs, computes the same loss over the same replicated output and calls
``backward()``. Each function here is a ``torch.autograd.Function`` whose
backward is the adjoint under that convention (the Megatron-LM f/g
pattern, Shoeybi et al., 1909.08053), so that every process ends with
exactly the JAX package's gradient, not ``n`` times it and not only its
own rows:

- :func:`take_rows`: this process's slice of a replicated tensor. Backward:
  all-gather the slices' gradients, so every process holds the whole
  input gradient.
- :func:`gather_rows`: the shards gathered into a replicated tensor.
  Backward: this process's slice of the cotangent, which every process
  already holds whole (not the sum over processes).
- :func:`shift`: to the axis's next process (``jax.lax.ppermute``), around
  the ring or along a line. Backward: to the previous process.
- :func:`all_to_all`: chunk ``i`` of dim 0 to process ``i``. Backward: the
  same exchange, which is its own inverse.
- :func:`all_reduce_sum`: ``psum``. Backward: the identity.
- :func:`copy_to_axis`: a replicated input entering a computation that is
  split over the axis. Forward: the identity; backward: the all-reduce of
  every process's partial gradient.

On an axis of one process each is the identity, both ways, and records
nothing. ``torch.distributed.nn.functional``'s ``all_gather`` and
``all_reduce`` sum the cotangents of all processes in backward, which under
this convention counts the loss ``n`` times, so none of them is used.

A backward here communicates, so the processes of a group must run their
backward nodes in one order. Autograd orders them by the graph, so the
callers compute as SPMD code does: every process runs the same operations
in the same order, with the same tensors requiring grad, and selects by
its index on the axis only through tensors (``torch.where``), never
through a Python branch that records other operations.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _axis(mesh, axis: str):
    """(group, size, index) of this process on ``axis``."""
    return mesh.axis_group(axis), mesh.axis_size(axis), mesh.axis_index(axis)


def _all_gather_cat(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _exchange(tensors: Sequence[torch.Tensor], group, dst, src) -> List[torch.Tensor]:
    """Send each tensor to the group's process ``dst`` and receive one like
    it from ``src`` (None: no send, or zeros received)."""
    ops, received = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t) if src is not None else torch.zeros_like(t)
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src), group))
        received.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received


def _exchange_chunks(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, r, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        c = x.shape[dim] // n
        return x.narrow(dim, r * c, c).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_cat(grad, ctx.group, ctx.n, ctx.dim), None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, r, dim):
        ctx.r, ctx.dim, ctx.rows = r, dim, x.shape[dim]
        return _all_gather_cat(x, group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        rows = grad.narrow(ctx.dim, ctx.r * ctx.rows, ctx.rows).contiguous()
        return rows, None, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, n, r, wrap, *tensors):
        ctx.group, ctx.n, ctx.r, ctx.wrap = group, n, r, wrap
        nxt = (r + 1) % n if wrap or r < n - 1 else None
        prev = (r - 1) % n if wrap or r > 0 else None
        return tuple(_exchange(tensors, group, nxt, prev))

    @staticmethod
    def backward(ctx, *grads):
        n, r, wrap = ctx.n, ctx.r, ctx.wrap
        prev = (r - 1) % n if wrap or r > 0 else None
        nxt = (r + 1) % n if wrap or r < n - 1 else None
        needs = ctx.needs_input_grad[4:]
        moved = iter(_exchange([g for g, need in zip(grads, needs) if need], ctx.group, prev, nxt))
        return (None, None, None, None) + tuple(next(moved) if need else None for need in needs)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange_chunks(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange_chunks(grad, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, need in zip(grads, ctx.needs_input_grad[1:]):
            if need:
                g = g.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(g, group=ctx.group)
            out.append(g if need else None)
        return (None,) + tuple(out)


def take_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This process's ``1/n`` slice of ``x`` along ``dim`` (the size must
    divide by the axis size)."""
    group, n, r = _axis(mesh, axis)
    if n == 1:
        return x
    return _TakeRows.apply(x, group, n, r, dim)


def gather_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The axis's shards of ``x`` concatenated along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``), the same on every process."""
    group, n, r = _axis(mesh, axis)
    if n == 1:
        return x
    return _GatherRows.apply(x, group, n, r, dim)


def shift(tensors: Sequence[torch.Tensor], mesh, axis: str, wrap: bool = True) -> List[torch.Tensor]:
    """Send each tensor to the axis's next process and receive the previous
    one's: ``ppermute`` over ``[(i, (i + 1) % n)]`` (``wrap``) or over
    ``[(i, i + 1) for i < n - 1]``, where the first process receives zeros."""
    group, n, r = _axis(mesh, axis)
    if n == 1:
        return list(tensors) if wrap else [torch.zeros_like(t) for t in tensors]
    return list(_Shift.apply(group, n, r, wrap, *tensors))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk ``i`` of dim 0 goes to the axis's process ``i``; chunk ``i`` of
    the result came from process ``i`` (dim 0 must divide by the axis)."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the axis (``psum``), the same on every process."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return x
    return _AllReduceSum.apply(x, group)


def copy_to_axis(tensors: Sequence[torch.Tensor], mesh, axis: str) -> List[torch.Tensor]:
    """The tensors unchanged, as inputs of a computation split over the
    axis: each process's gradient of them is a part, and backward sums the
    parts, so every process holds the whole."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return list(tensors)
    return list(_CopyToAxis.apply(group, *tensors))
