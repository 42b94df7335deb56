"""Ring attention: sequence-parallel exact attention over a mesh axis.

The port of the JAX package's ``ops/ring_attention.py``. A sequence too
long for one device is sharded over the mesh's ``sp`` axis
(``parallel/mesh.py``): each process holds its Q/K/V chunk and walks the
ring, handing its K/V block (and its key mask) to the next process with
``dist.batch_isend_irecv`` where the JAX package ``ppermute``s it, and
accumulates the softmax online (a running max, sum and output), so no
process holds the whole ``[L, L]`` score matrix or the whole K/V.

Scores and the accumulator are f32 whatever the compute dtype; the result
is cast back to ``dtype``. The block update is plain torch, as in the JAX
package: the flash kernel (``ops/flash_attention.py``) returns neither the
row max nor the row sum that merging its blocks would need.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.distributed as dist


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


def _rotate(tensors: List[torch.Tensor], group, n: int, r: int) -> List[torch.Tensor]:
    """Send each tensor to the axis's next process and receive the
    previous one's: one step of the ring (the JAX package's ``ppermute``
    over ``[(i, (i + 1) % n)]``)."""
    dst = dist.get_global_rank(group, (r + 1) % n)
    src = dist.get_global_rank(group, (r - 1) % n)
    ops, received = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        received.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def make_ring_attention(axis_name: str = "sp", mesh=None) -> Callable:
    """An attention fn with the ``dense_attention(q, k, v, mask, dtype)``
    signature over this process's sequence shard: q, k, v are ``[B, H,
    L/n, Dh]`` and mask the additive ``[B, 1, 1, L/n]`` (or None). ``mesh``
    (default: every process on ``axis_name``) names the group the ring
    runs over."""

    def ring_attention(q, k, v, mask, dtype):
        msh = _default_mesh(mesh, axis_name)
        n = msh.axis_size(axis_name)
        group = msh.axis_group(axis_name)
        r = msh.axis_index(axis_name)
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
                k_blk, v_blk, mask_blk = _rotate([k_blk, v_blk, mask_blk], group, n, r)
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)

    return ring_attention


def _all_gather_cat(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The axis's shards of ``t`` concatenated along ``dim``, in axis
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def sharded_attention(attn, q, k, v, mask, mesh, axis: str, dtype=torch.float32):
    """The sequence-parallel wrapper shared by the long-context strategies:
    full ``[B, H, L, Dh]`` q/k/v (and an additive ``[B, 1, 1, L]`` mask, or
    None) on every process of the axis in, exact attention out. Each
    process runs ``attn`` (``make_ring_attention`` or
    ``make_ulysses_attention``) on its ``L/n`` shard and the shards are
    gathered along L, so every process returns what the JAX package's
    ``shard_map`` wrapper returns."""
    n = mesh.axis_size(axis)
    r = mesh.axis_index(axis)
    B, _, L, _ = q.shape
    if L % n:
        raise ValueError(f"sequence length {L} must be divisible by the {axis!r} axis size ({n})")
    if mask is None:
        mask = torch.zeros((B, 1, 1, L), dtype=torch.float32, device=q.device)
    mask = mask.reshape(B, 1, 1, L)
    lc = L // n
    rows = slice(r * lc, (r + 1) * lc)
    out = attn(
        q[:, :, rows].contiguous(), k[:, :, rows].contiguous(), v[:, :, rows].contiguous(),
        mask[..., rows].contiguous(), dtype,
    )
    return _all_gather_cat(out, mesh.axis_group(axis), n, dim=2)


def ring_attention_sharded(q, k, v, mask, mesh, axis: str = "sp", dtype=torch.float32):
    """Exact ring-parallel attention over ``axis``: full tensors in, full
    output out (:func:`sharded_attention` over :func:`make_ring_attention`)."""
    return sharded_attention(make_ring_attention(axis, mesh), q, k, v, mask, mesh, axis, dtype)
