"""GPipe-style pipeline parallelism over a ``pp`` mesh axis.

The port of the JAX package's ``parallel/pipeline_parallel.py`` (Huang et
al., "GPipe", 1811.06965): a stack of layers split into ``n`` stages, one
per process along the axis, and a batch fed through as microbatches on
the JAX package's tick schedule. Each of ``n_micro + n - 1`` ticks every
stage runs its stage once; stage 0 takes microbatch ``t`` (zeros once
the batch is drained), the others what the previous stage sent at the
tick before, and the last stage emits microbatch ``t - (n - 1)``.
Activations hop stage ``i`` -> ``i + 1`` through
``parallel/collectives.shift`` (the JAX ``ppermute``; its backward sends
the gradient back ``i + 1`` -> ``i``), and a masked all-reduce
replicates the last stage's outputs on every process.

Every stage must keep the activation's shape and dtype. Stage parameters
are stacked on a leading axis (:func:`stack_stage_params`); each process
takes its own stage's slice. Like the JAX function the schedule is
differentiable: ``backward()`` through :func:`pipeline_apply` leaves on
every process the gradient of the sequential stack, the whole stacked
parameters' and the input's. So the schedule runs as SPMD code does
(``parallel/collectives.py``): every stage runs every tick, bubbles on
zeros included, and a stage's index selects its input and its output
only through ``torch.where``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from sparkdl_tpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis, gather_rows, shift, take_rows


def stack_stage_params(param_trees) -> Any:
    """Stack per-stage parameter trees (dicts of tensors, one per stage) on
    a new leading axis: the layout :func:`pipeline_apply` takes."""
    leaves = [pytree.tree_flatten(tree) for tree in param_trees]
    spec = leaves[0][1]
    return pytree.tree_unflatten(
        [torch.stack(group, dim=0) for group in zip(*(flat for flat, _ in leaves))], spec
    )


def _copy_tree(tree, mesh, axis: str):
    flat, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(copy_to_axis(flat, mesh, axis), spec)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh,
    axis: str = "pp",
    n_microbatches: Optional[int] = None,
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run ``x`` [B, ...] through the ``n`` stages of ``stage_fn`` over
    ``axis``, every process holding the same ``x`` and ``stacked_params``.

    ``stage_fn(params_i, h) -> h`` keeps the activation's signature.
    ``stacked_params``: per-stage parameters stacked on dim 0 (see
    :func:`stack_stage_params`), as many as the axis has processes. ``x``
    is split into ``n_microbatches`` (default: the stage count) along dim
    0. Returns the ``[B, ...]`` outputs on every process.

    ``dp_axis``: a second mesh axis to split each microbatch's rows over;
    stage parameters stay replicated across it."""
    n = mesh.axis_size(axis)
    n_micro = n if n_microbatches is None else n_microbatches
    B = x.shape[0]
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"Batch {B} must divide into n_microbatches={n_micro}")
    if dp_axis is not None and (B // n_micro) % mesh.axis_size(dp_axis):
        raise ValueError(
            f"Microbatch size {B // n_micro} must divide over "
            f"dp_axis {dp_axis!r} ({mesh.axis_size(dp_axis)} shards)"
        )
    leaves = pytree.tree_leaves(stacked_params)
    stages = leaves[0].shape[0]
    if stages != n:
        raise ValueError(f"stacked_params has {stages} stages but mesh axis {axis!r} has {n} devices")
    xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    if dp_axis is not None:
        stacked_params = _copy_tree(stacked_params, mesh, dp_axis)
        xm = take_rows(xm, mesh, dp_axis, dim=1)
    # every stage reads x (stage 0 alone for real): sum the stages' parts
    (xm,) = copy_to_axis([xm], mesh, axis)
    params = pytree.tree_map(lambda t: take_rows(t, mesh, axis, dim=0)[0], stacked_params)

    idx = mesh.axis_index(axis)
    # (filled on the device: a host tensor copied there would wait for the stream)
    first = torch.full((), idx == 0, device=x.device)
    last = torch.full((), idx == n - 1, device=x.device)
    # zeros that require grad when the schedule does, so that every stage
    # records every shift, whatever reaches it first
    needs_grad = torch.is_grad_enabled() and (xm.requires_grad or any(t.requires_grad for t in leaves))
    zeros_mb = torch.zeros_like(xm[0]).requires_grad_(needs_grad)
    incoming = zeros_mb
    outs = []
    ticks = n_micro + n - 1
    for t in range(ticks):
        feed = xm[t] if t < n_micro else zeros_mb
        y = stage_fn(params, torch.where(first, feed, incoming))
        if t >= n - 1:  # the last stage emits microbatch t - (n - 1)
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if n > 1 and t < ticks - 1:  # the last tick's send reaches no stage that runs again
            (incoming,) = shift([y], mesh, axis, wrap=False)
    # only the last stage holds the outputs: replicate them
    out = all_reduce_sum(torch.stack(outs), mesh, axis)
    if dp_axis is not None:
        out = gather_rows(out, mesh, dp_axis, dim=1)
    return out.reshape(B, *out.shape[2:])
