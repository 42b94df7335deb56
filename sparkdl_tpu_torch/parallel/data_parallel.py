"""Synchronous data-parallel training over the process group.

The port of the JAX package's ``parallel/data_parallel.py``. Each process
drives one GPU and holds one shard of every global batch: it computes the
loss and float32 gradients of its shard, the gradients (and the loss) are
averaged over the ``dp`` axis by one ``all_reduce`` (the Horovod ring;
the JAX package's ``pmean``), and every process applies the same
optimizer update to its replicated parameters. The loss is a mean per
shard, so the average of shard means equals the global mean only when
every shard holds the same number of valid rows.

Parameters are a ``{name: float32 tensor}`` dict
(``ModelFunction.named_params``: parameters AND BatchNorm statistics, the
whole variable tree the JAX package differentiates). ``loss_fn(params,
batch) -> scalar`` runs the model through ``ModelFunction.apply``. The
optimizer is a ``torch.optim`` factory, ``optimizer(list_of_tensors)``
(``functools.partial(torch.optim.Adam, lr=1e-3)``). The port updates the
state in place (PyTorch's optimizers do) and returns it.

- :func:`make_data_parallel_step`: gradient accumulation over
  ``grad_accum_steps`` microbatches, weighted by
  ``microbatch_weight_fn`` (the valid rows of a padded microbatch), and
  ``compute_dtype`` (the forward and backward see bf16-ROUNDED master
  weights, as the JAX package's ``_cast_for_compute`` casts every
  floating leaf: on a float32 module flax then promotes back to float32;
  a module built in bf16 computes in bf16 itself);
- :func:`make_zero1_data_parallel_step`: ZeRO-1, the optimizer state for
  this process's shard of the flattened parameters only: gradients are
  reduce-scattered, the shard updated, the parameters all-gathered. The
  optimizer must work elementwise, which a build-time probe checks;
- :func:`make_eval_step`: metrics averaged over the axis.

A float32 step holds :func:`~sparkdl_tpu_torch.runtime.device.exact_float32`
across forward, backward and update: autograd runs the backward
convolutions after the model's own forward has returned, where cuDNN
would otherwise round them to TF32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sparkdl_tpu_torch.parallel.mesh import Mesh
from sparkdl_tpu_torch.runtime.device import exact_float32

Params = Dict[str, torch.Tensor]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """The step count, the float32 master parameters (leaves that require
    grad) and the optimizer that updates them; ``shard`` is this process's
    slice of the flattened parameters under ZeRO-1 (the tensor its
    optimizer holds), else None."""

    step: int
    params: Params
    optimizer: torch.optim.Optimizer
    shard: Optional[torch.Tensor] = None

    def state_dict(self) -> dict:
        out = {
            "step": self.step,
            "params": {n: p.detach().cpu() for n, p in self.params.items()},
            "optimizer": self.optimizer.state_dict(),
        }
        if self.shard is not None:
            out["shard"] = self.shard.detach().cpu()
        return out

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(sd["params"][n])
            if self.shard is not None:
                self.shard.copy_(sd["shard"])
        self.optimizer.load_state_dict(sd["optimizer"])


def _as_leaves(params: Params) -> Params:
    return {n: t.detach().clone().float().requires_grad_(True) for n, t in params.items()}


def create_train_state(params: Params, optimizer: OptimizerFactory) -> TrainState:
    leaves = _as_leaves(params)
    return TrainState(0, leaves, optimizer(list(leaves.values())))


def _cast_for_compute(params: Params, compute_dtype) -> Params:
    """The master parameters as the forward sees them: rounded to
    ``compute_dtype`` (differentiably) where one is set."""
    if compute_dtype is None:
        return params
    return {n: p.to(compute_dtype).to(p.dtype) for n, p in params.items()}


def _accumulated_loss_and_grads(
    loss_fn, params: Params, batch, grad_accum_steps: int,
    microbatch_weight_fn, compute_dtype,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """This shard's loss and float32 gradients, accumulated over
    ``grad_accum_steps`` microbatches (rows ``[k*m, (k+1)*m)``) with
    weights from ``microbatch_weight_fn``, as the JAX package's
    ``lax.scan``. Shared by both step builders."""
    leaves = list(params.values())

    def one(mb):
        loss = loss_fn(_cast_for_compute(params, compute_dtype), mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach().float(), [
            torch.zeros_like(p) if g is None else g.float() for p, g in zip(leaves, grads)
        ]

    if grad_accum_steps <= 1:
        return one(batch)
    rows = batch[0].shape[0] // grad_accum_steps
    loss_sum = torch.zeros((), device=leaves[0].device)
    w_sum = torch.zeros((), device=leaves[0].device)
    grad_sum = [torch.zeros_like(p) for p in leaves]
    for k in range(grad_accum_steps):
        mb = tuple(t[k * rows : (k + 1) * rows] for t in batch)
        loss, grads = one(mb)
        w = (
            torch.as_tensor(microbatch_weight_fn(mb), dtype=torch.float32, device=loss.device)
            if microbatch_weight_fn is not None
            else torch.ones((), device=loss.device)
        )
        loss_sum = loss_sum + loss * w
        for a, g in zip(grad_sum, grads):
            a.add_(g * w)
        w_sum = w_sum + w
    inv = 1.0 / torch.clamp(w_sum, min=1e-30)
    return loss_sum * inv, [g * inv for g in grad_sum]


def _grad_buffer(leaves: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One float32 buffer for every gradient and the loss (one collective
    per step), and a view of it per parameter laid out as the parameter
    is (a ``channels_last`` conv weight gets ``channels_last`` strides):
    the optimizer's multi-tensor kernels take only gradients whose strides
    match their parameters', and fall back to a few kernels per tensor
    otherwise."""
    flat = torch.empty(sum(p.numel() for p in leaves) + 1, device=leaves[0].device)
    views, off = [], 0
    for p in leaves:
        dense = p.is_contiguous() or (p.dim() == 4 and p.is_contiguous(memory_format=torch.channels_last))
        views.append(
            flat.as_strided(p.shape, p.stride(), off) if dense else flat[off : off + p.numel()].view(p.shape)
        )
        off += p.numel()
    return flat, views


def make_data_parallel_step(
    loss_fn: Callable[[Params, Any], torch.Tensor],
    mesh: Mesh,
    grad_accum_steps: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    microbatch_weight_fn: Optional[Callable[[Any], torch.Tensor]] = None,
):
    """The data-parallel train step: ``step_fn(state, batch) -> (state,
    {"loss", "grad_norm"})``, where ``batch`` is THIS process's shard (a
    tuple of tensors on the device). The metrics are device tensors,
    the same on every process."""

    def step_fn(state: TrainState, batch):
        leaves = list(state.params.values())
        with exact_float32():
            loss, grads = _accumulated_loss_and_grads(
                loss_fn, state.params, batch, grad_accum_steps,
                microbatch_weight_fn, compute_dtype,
            )
            flat, views = _grad_buffer(leaves)
            for v, g in zip(views, grads):
                v.copy_(g)
            flat[-1] = loss
            if mesh.group is not None:
                dist.all_reduce(flat, group=mesh.group)
                flat /= mesh.size
            loss = flat[-1]
            grad_norm = torch.linalg.vector_norm(flat[:-1])
            for p, v in zip(leaves, views):
                p.grad = v
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step_fn


def _assert_elementwise_optimizer(optimizer: OptimizerFactory) -> None:
    """Build-time probe for ZeRO-1's silent divergence: three updates of a
    small vector, once whole and once split into two shards (what the
    sharded step does), at magnitudes from 1 to 1e6 with shard norms that
    differ by about 1e5, must agree. A norm-dependent optimizer (global
    clipping, trust ratios) computes other factors per shard and is
    refused; one that cannot update a bare tensor is refused too."""
    probe_p = torch.tensor([0.5, -1.2, 2.0, -0.3, 0.01, 1.5, -2.2, 0.8])
    base_g = np.asarray([4e2, -7e2, 9e2, -2e2, 3e-3, -1e-3, 5e-3, 2e-3], np.float32)
    grad_seq = [base_g, base_g[::-1].copy() * 1e6, base_g * 0.5]

    def run_steps(p0: torch.Tensor, grads) -> np.ndarray:
        p = p0.clone().requires_grad_(True)
        opt = optimizer([p])
        update = None
        for g in grads:
            before = p.detach().clone()
            p.grad = torch.tensor(g)  # a copy: an optimizer may scale it in place
            opt.step()
            update = p.detach() - before
        return update.numpy()

    try:
        full = run_steps(probe_p, grad_seq)
        halves = [
            run_steps(probe_p[s], [g[s] for g in grad_seq])
            for s in (slice(0, 4), slice(4, 8))
        ]
    except Exception as e:  # noqa: BLE001 — reported as the constraint it breaks
        raise ValueError(
            "shardOptimizerState=True (ZeRO-1) flattens params to one "
            "vector, so the optimizer must work elementwise on a bare "
            f"tensor; probing this one failed ({type(e).__name__}: {e})."
            " Use shardOptimizerState=False, or validateOptimizer=False if "
            "the optimizer is verified shard-consistent."
        ) from e
    if not np.allclose(full, np.concatenate(halves), rtol=1e-4, atol=1e-6):
        raise ValueError(
            "shardOptimizerState=True (ZeRO-1) requires an ELEMENTWISE "
            "optimizer: this one produces different updates when params "
            "are split into shards (global-norm clipping / trust-ratio / "
            "per-layer rules do), so the sharded update would silently "
            "diverge from unsharded training. Drop the non-elementwise "
            "rule, or use the replicated-state step "
            "(shardOptimizerState=False / make_data_parallel_step)."
        )


def make_zero1_data_parallel_step(
    loss_fn: Callable[[Params, Any], torch.Tensor],
    optimizer: OptimizerFactory,
    mesh: Mesh,
    params_template: Params,
    compute_dtype: Optional[torch.dtype] = None,
    grad_accum_steps: int = 1,
    microbatch_weight_fn: Optional[Callable[[Any], torch.Tensor]] = None,
    validate_elementwise: bool = True,
):
    """ZeRO-1 (Xu et al., arXiv:2004.13336): the parameters flattened to
    one float32 vector padded to a multiple of the axis size; this process
    keeps the optimizer state of its ``1/N`` slice only. Per step the
    gradients are reduce-scattered (each process gets the mean of its
    slice), the slice is updated, and the slices are all-gathered back
    into the parameters. Returns ``(step_fn, init_fn)``; ``init_fn(params)``
    builds the :class:`TrainState`."""
    if validate_elementwise:
        _assert_elementwise_optimizer(optimizer)
    n_shards = mesh.size
    sizes = [int(t.numel()) for t in params_template.values()]
    total = sum(sizes)
    padded = -(-total // n_shards) * n_shards
    shard_len = padded // n_shards
    lo = mesh.rank * shard_len

    def flatten(tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return F.pad(flat, (0, padded - total))

    def init_fn(params: Params) -> TrainState:
        leaves = _as_leaves(params)
        with torch.no_grad():
            shard = flatten(leaves.values())[lo : lo + shard_len].clone()
        shard.requires_grad_(True)
        return TrainState(0, leaves, optimizer([shard]), shard=shard)

    def step_fn(state: TrainState, batch):
        with exact_float32():
            loss, grads = _accumulated_loss_and_grads(
                loss_fn, state.params, batch, grad_accum_steps,
                microbatch_weight_fn, compute_dtype,
            )
            gflat = flatten(grads)
            if mesh.group is not None:
                gshard = torch.empty(shard_len, device=gflat.device)
                dist.reduce_scatter_tensor(gshard, gflat, group=mesh.group)
                gshard /= n_shards
                dist.all_reduce(loss, group=mesh.group)
                loss = loss / n_shards
            else:
                gshard = gflat
            norm_sq = (gshard * gshard).sum()
            state.shard.grad = gshard
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            new_shard = state.shard.detach()
            if mesh.group is not None:
                new_flat = torch.empty(padded, device=new_shard.device)
                dist.all_gather_into_tensor(new_flat, new_shard.contiguous(), group=mesh.group)
                dist.all_reduce(norm_sq, group=mesh.group)
            else:
                new_flat = new_shard
            with torch.no_grad():
                for p, v in zip(state.params.values(), torch.split(new_flat[:total], sizes)):
                    p.copy_(v.view(p.shape))
        state.step += 1
        return state, {"loss": loss, "grad_norm": torch.sqrt(norm_sq)}

    return step_fn, init_fn


def make_eval_step(metric_fn: Callable[[Params, Any], Dict[str, torch.Tensor]], mesh: Mesh):
    """``eval_fn(params, batch) -> {name: tensor}``: this shard's metrics
    averaged over the axis, without autograd."""

    def eval_fn(params: Params, batch):
        with torch.no_grad(), exact_float32():
            out = metric_fn(params, batch)
            if mesh.group is None:
                return out
            names = list(out)
            flat = torch.stack([torch.as_tensor(out[k], dtype=torch.float32) for k in names])
            dist.all_reduce(flat, group=mesh.group)
            flat /= mesh.size
            return {k: flat[i] for i, k in enumerate(names)}

    return eval_fn
