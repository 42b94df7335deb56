"""GShard-style expert parallelism (a mixture of experts) over an ``ep``
mesh axis.

The port of the JAX package's ``parallel/expert_parallel.py`` (Lepikhin
et al., "GShard", 2006.16668; Fedus et al., "Switch Transformer",
2101.03961): top-1 routing as dense one-hot dispatch and combine einsums
over a static capacity axis, and the experts split over the axis, with
two all-to-alls moving token slots to their expert's process and back.

Shapes on each process (n = axis size, E = experts, C = capacity):

    x        [T/n, D]       this process's tokens
    dispatch [T/n, E, C]    one-hot: token t -> expert e, slot c
    staged   [E, C, D]      einsum(dispatch, x), f32
    --all_to_all-->         [E/n, n*C, D]  local experts, every process's slots
    experts                 each local expert on its slots
    --all_to_all-->         [E, C, D]  back to the tokens' owners
    out      [T/n, D]       einsum(combine, staged), f32, cast to x's dtype

Tokens past an expert's capacity come out as zeros. Every process holds
the same ``x`` and weights and gets the whole ``[T, D]`` output; the
router is differentiable through the combine weights, and ``backward()``
leaves every process with the whole gradient
(``parallel/collectives.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from sparkdl_tpu_torch.parallel.collectives import all_to_all, copy_to_axis, gather_rows, take_rows


def switch_route(router_logits, num_experts: int, capacity: int):
    """Top-1 routing -> (dispatch [T, E, C] one-hot, combine [T, E, C]).

    Slots are given in arrival order within each expert (a cumsum over the
    tokens); a token past ``capacity`` is dropped (an all-zero dispatch
    row, so a zero output). The argmax takes the first of tied experts, as
    the JAX package's does."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # [T]
    onehot = F.one_hot(expert, num_experts).float()
    # position of each token in its expert's arrival order
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot  # [T, E]
    slot = pos.sum(dim=-1).to(torch.int32)  # [T]
    keep = (slot < capacity).float()
    # one-hot of the slot, all zeros past the capacity (jax.nn.one_hot)
    slots = (slot[:, None] == torch.arange(capacity, device=slot.device)).float()
    dispatch = onehot[:, :, None] * slots[:, None, :] * keep[:, None, None]  # [T, E, C]
    # dispatch carries the keep mask, so the gate needn't
    gate = (probs * onehot).sum(dim=-1)  # [T]
    return dispatch, dispatch * gate[:, None, None]


def _local_moe(expert_fn, mesh, axis, num_experts, capacity, router_w, expert_params, x):
    """This process's part: its tokens ``x`` [T/n, D] and its experts'
    stacked parameters [E/n, ...]."""
    n = mesh.axis_size(axis)
    dispatch, combine = switch_route(x @ router_w, num_experts, capacity)
    staged = torch.einsum("tec,td->ecd", dispatch, x.float())  # [E, C, D]
    # chunk j of the experts goes to process j; the slots come back in
    # process order: [E/n, n*C, D]
    e_local, d = num_experts // n, staged.shape[-1]
    got = all_to_all(staged, mesh, axis).reshape(n, e_local, capacity, d)
    staged = got.permute(1, 0, 2, 3).reshape(e_local, n * capacity, d)
    out = torch.stack([
        expert_fn(pytree.tree_map(lambda t: t[e], expert_params), staged[e]) for e in range(e_local)
    ])
    sent = out.reshape(e_local, n, capacity, d).permute(1, 0, 2, 3).reshape(num_experts, capacity, d)
    out = all_to_all(sent, mesh, axis)  # [E, C, D], in expert order
    return torch.einsum("tec,ecd->td", combine, out.float()).to(x.dtype)


def moe_apply(
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    router_w: torch.Tensor,
    expert_params: Any,
    x: torch.Tensor,
    mesh,
    axis: str = "ep",
    capacity_factor: float = 2.0,
    capacity: Optional[int] = None,
) -> torch.Tensor:
    """A top-1 MoE layer with the experts split over ``axis``.

    ``expert_fn(params_e, h) -> h`` is one expert ([C', D] -> [C', D]);
    ``expert_params``: a tree of tensors stacked [E, ...]; ``router_w``
    [D, E]; ``x`` [T, D] tokens, split over ``axis`` (each process routes
    its own ``T/n``, the tokens-by-experts square layout of MoE). The
    capacity defaults to ``max(1, ceil((T // n) / E * capacity_factor))``.

    Returns [T, D] on every process. Dropped tokens (capacity overflow)
    come out as zeros."""
    E = router_w.shape[-1]
    n = mesh.axis_size(axis)
    if E % n:
        raise ValueError(f"num_experts {E} must divide over ep axis {axis!r} ({n})")
    leaves = pytree.tree_leaves(expert_params)
    if not leaves:
        raise ValueError("expert_params is an empty pytree")
    bad = [tuple(leaf.shape[:1]) for leaf in leaves if tuple(leaf.shape[:1]) != (E,)]
    if bad:
        raise ValueError(
            f"every expert_params leaf must be stacked [num_experts={E}, "
            f"...]; got leading dims {bad[:3]}"
        )
    T = x.shape[0]
    if T % n:
        raise ValueError(f"Tokens {T} must divide over ep axis {axis!r} ({n})")
    if capacity is None:
        capacity = max(1, math.ceil((T // n) / E * capacity_factor))
    # every process's tokens give a part of the router's gradient: sum them
    (router_w,) = copy_to_axis([router_w], mesh, axis)
    local_params = pytree.tree_map(lambda t: take_rows(t, mesh, axis), expert_params)
    y = _local_moe(expert_fn, mesh, axis, E, capacity, router_w, local_params, take_rows(x, mesh, axis))
    return gather_rows(y, mesh, axis)
