"""Megatron-style tensor parallelism over a ``tp`` mesh axis.

The port of the JAX package's ``parallel/tensor_parallel.py``: the
weights of a two-dense block are split over the axis, the first dense
column-wise and the second row-wise, so the block needs exactly one
all-reduce at its output (Shoeybi et al., "Megatron-LM", 1909.08053), and
the activations between the two products stay split, so each process
holds ``1/n`` of the block's weights and of its hidden activations.

The JAX package's helpers run inside ``shard_map`` on local shards; here
each process of the axis calls them on its own shards.
:func:`tp_block_sharded` takes the full weights (or this process's shards
from :func:`shard_dense_params`) and a replicated input on every process
and returns the block's output on every process, differentiable: backward
leaves every process with the whole gradient of the input and of every
weight (``parallel/collectives.py``). The products are plain torch
matmuls, as they are XLA's in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.nn.functional as F

from sparkdl_tpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis, gather_rows, take_rows

#: the attribute :func:`shard_dense_params` sets on each shard it returns:
#: (the tp axis, the dimension it splits)
SHARD_ATTR = "_tp_shard"


def column_parallel(x, w, b=None):
    """First dense of a TP block: ``w`` is the LOCAL column shard [d_in,
    d_ff/n]; the output stays split on its last dim (no communication).
    Bias, if any, is the matching column shard."""
    y = x @ w
    return y if b is None else y + b


def row_parallel(x, w, mesh, axis_name: str = "tp", b=None):
    """Second dense of a TP block: ``w`` is the LOCAL row shard [d_ff/n,
    d_out]; the partial products are summed with ONE all-reduce over
    ``axis_name`` (the identity in backward). Bias, if any, is full-size and
    added AFTER the sum (added per shard it would count n times)."""
    y = all_reduce_sum(x @ w, mesh, axis_name)
    return y if b is None else y + b


def tp_mlp(x, w1, w2, mesh, axis_name: str = "tp", activation: Callable = F.relu, b1=None, b2=None):
    """The canonical two-dense TP block on this process's shards:
    column-parallel ``w1``, ``activation``, row-parallel ``w2``, one
    all-reduce. ``x`` enters the split computation through
    :func:`~sparkdl_tpu_torch.parallel.collectives.copy_to_axis`, so its
    gradient is whole on every process."""
    (x,) = copy_to_axis([x], mesh, axis_name)
    h = activation(column_parallel(x, w1, b1))
    return row_parallel(h, w2, mesh, axis_name, b2)


def shard_dense_params(w1, w2, mesh, axis: str = "tp", b1=None, b2=None):
    """This process's shards of full ``[d_in, d_ff]`` / ``[d_ff, d_out]``
    weights, as :func:`tp_block_sharded` takes them: ``w1`` column-split,
    ``w2`` row-split, ``b1`` column-split, ``b2`` whole (None stays None).
    The split shards carry :data:`SHARD_ATTR`, so the wrapper passes them
    through unchanged; their gradients are those of the shards."""
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)

    def split(t, dim):
        if t is None:
            return None
        c = t.shape[dim] // n
        shard = t.narrow(dim, r * c, c).detach().clone().requires_grad_(t.requires_grad)
        setattr(shard, SHARD_ATTR, (axis, dim))
        return shard

    return split(w1, 1), split(w2, 0), split(b1, 0), b2


def _is_shard(t, axis: str) -> bool:
    return getattr(t, SHARD_ATTR, (None,))[0] == axis


def tp_block_sharded(
    x, w1, w2, mesh, axis: str = "tp",
    activation: Callable = F.relu,
    b1=None, b2=None,
    dp_axis: Optional[str] = None,
):
    """Full (or pre-sharded, :func:`shard_dense_params`) weights in, the TP
    block's output out, the same on every process of ``axis``.
    ``dp_axis`` also splits the batch over a second mesh axis (2-D dp×tp):
    each dp shard runs its rows and the rows are gathered back, so the
    output is the whole ``[B, d_out]`` on every process."""
    n = mesh.axis_size(axis)
    w1_shard, w2_shard, b1_shard = (_is_shard(t, axis) for t in (w1, w2, b1))
    d_ff1 = w1.shape[1] * (n if w1_shard else 1)
    d_ff2 = w2.shape[0] * (n if w2_shard else 1)
    if d_ff1 != d_ff2:
        raise ValueError(f"w1 [.., {d_ff1}] and w2 [{d_ff2}, ..] disagree on d_ff")
    if d_ff1 % n:
        raise ValueError(f"d_ff {d_ff1} must divide over tp axis {axis!r} ({n})")
    if dp_axis is not None and x.shape[0] % mesh.axis_size(dp_axis):
        raise ValueError(
            f"Batch {x.shape[0]} must divide over dp_axis {dp_axis!r} "
            f"({mesh.axis_size(dp_axis)} shards)"
        )
    weights = [w1, w2, b1, b2]
    if dp_axis is not None:
        # each dp shard's weight gradient covers its rows only: sum them
        present = [w for w in weights if w is not None]
        copies = iter(copy_to_axis(present, mesh, dp_axis))
        weights = [None if w is None else next(copies) for w in weights]
        x = take_rows(x, mesh, dp_axis)
    w1, w2, b1, b2 = weights
    if not w1_shard:
        w1 = take_rows(w1, mesh, axis, dim=1)
    if not w2_shard:
        w2 = take_rows(w2, mesh, axis, dim=0)
    if b1 is not None and not b1_shard:
        b1 = take_rows(b1, mesh, axis, dim=0)
    y = tp_mlp(x, w1, w2, mesh, axis, activation, b1, b2)
    return gather_rows(y, mesh, dp_axis) if dp_axis is not None else y
