"""Ring attention: sequence-parallel exact attention over a mesh axis.

The port of the JAX package's ``ops/ring_attention.py``. A sequence too
long for one device is sharded over the mesh's ``sp`` axis
(``parallel/mesh.py``): each process holds its Q/K/V chunk and walks the
ring, handing its K/V block (and its key mask) to the next process
(``parallel/collectives.shift``) where the JAX package ``ppermute``s it,
and accumulates the softmax online (a running max, sum and output), so no
process holds the whole ``[L, L]`` score matrix or the whole K/V.

Scores and the accumulator are f32 whatever the compute dtype; the result
is cast back to ``dtype``. The block update is plain torch under autograd,
as it is jnp under ``jax.grad`` in the JAX package, and each collective
carries its adjoint (the shift sends the K/V gradients back around the
ring), so ``backward()`` leaves every process with the dense gradient. The
flash kernel (``ops/flash_attention.py``) returns neither the row max nor
the row sum that merging its blocks would need.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from sparkdl_tpu_torch.parallel.collectives import gather_rows, shift, take_rows


def _online_block_update(q, k_blk, v_blk, mask_blk, m, l, o, scale):
    """One online-softmax step against a K/V block.

    q: [B, H, Lq, Dh] f32; k_blk, v_blk: [B, H, Lk, Dh]; mask_blk:
    additive f32 [B, 1, 1, Lk] or None; m, l: [B, H, Lq]; o: [B, H, Lq,
    Dh] (all f32)."""
    s = torch.matmul(q, k_blk.float().transpose(-1, -2)) * scale
    if mask_blk is not None:
        s = s + mask_blk
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully masked blocks or queries (m or m_new still -inf): exp(-inf -
    # -inf) = nan must become exp(-inf) = 0 in both places
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_new, neg_inf))
    p = torch.exp(torch.where(torch.isfinite(m_new)[..., None], s - m_new[..., None], neg_inf))
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(p, v_blk.float())
    return m_new, l_new, o_new


def _default_mesh(mesh, axis: str):
    if mesh is not None:
        return mesh
    from sparkdl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({axis: -1})


def make_ring_attention(axis_name: str = "sp", mesh=None) -> Callable:
    """An attention fn with the ``dense_attention(q, k, v, mask, dtype)``
    signature over this process's sequence shard: q, k, v are ``[B, H,
    L/n, Dh]`` and mask the additive ``[B, 1, 1, L/n]`` (or None). ``mesh``
    (default: every process on ``axis_name``) names the group the ring
    runs over."""

    def ring_attention(q, k, v, mask, dtype):
        msh = _default_mesh(mesh, axis_name)
        n = msh.axis_size(axis_name)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float()
        m = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        mask_blk = (
            mask.float()
            if mask is not None
            else torch.zeros((q.shape[0], 1, 1, k.shape[2]), dtype=torch.float32, device=q.device)
        )
        k_blk, v_blk = k, v
        for step in range(n):
            m, l, o = _online_block_update(qf, k_blk, v_blk, mask_blk, m, l, o, scale)
            if step < n - 1:  # the JAX loop's last rotation returns the blocks home unread
                k_blk, v_blk, mask_blk = shift([k_blk, v_blk, mask_blk], msh, axis_name)
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)

    return ring_attention


def sharded_attention(attn, q, k, v, mask, mesh, axis: str, dtype=torch.float32):
    """The sequence-parallel wrapper shared by the long-context strategies:
    full ``[B, H, L, Dh]`` q/k/v (and an additive ``[B, 1, 1, L]`` mask, or
    None) on every process of the axis in, exact attention out. Each
    process runs ``attn`` (``make_ring_attention`` or
    ``make_ulysses_attention``) on its ``L/n`` shard and the shards are
    gathered along L, so every process returns what the JAX package's
    ``shard_map`` wrapper returns; ``backward()`` gives every process the
    whole ``dq``, ``dk`` and ``dv``."""
    n = mesh.axis_size(axis)
    r = mesh.axis_index(axis)
    B, _, L, _ = q.shape
    if L % n:
        raise ValueError(f"sequence length {L} must be divisible by the {axis!r} axis size ({n})")
    if mask is None:
        mask = torch.zeros((B, 1, 1, L), dtype=torch.float32, device=q.device)
    mask = mask.reshape(B, 1, 1, L)
    lc = L // n
    q, k, v = (take_rows(t, mesh, axis, dim=2) for t in (q, k, v))
    out = attn(q, k, v, mask[..., r * lc : (r + 1) * lc].contiguous(), dtype)
    return gather_rows(out, mesh, axis, dim=2)


def ring_attention_sharded(q, k, v, mask, mesh, axis: str = "sp", dtype=torch.float32):
    """Exact ring-parallel attention over ``axis``: full tensors in, full
    output out (:func:`sharded_attention` over :func:`make_ring_attention`)."""
    return sharded_attention(make_ring_attention(axis, mesh), q, k, v, mask, mesh, axis, dtype)
