"""Ulysses-style all-to-all sequence parallelism.

The port of the JAX package's ``ops/ulysses.py``, the second
long-context strategy beside ``ops/ring_attention.py``: two all-to-alls
re-shard the activations between the sequence-sharded and the
head-sharded layouts (Jacobs et al., "DeepSpeed Ulysses", 2309.14509):

    [B, H, L/n, Dh] --all_to_all--> [B, H/n, L, Dh]
        (attention over the whole sequence on 1/n of the heads)
    [B, H/n, L, Dh] --all_to_all--> [B, H, L/n, Dh]

Inside attention each process sees the whole sequence for its heads, so
any inner attention runs unchanged, the flash kernel
(``ops/flash_attention.make_flash_attention_fn``) included. The JAX
package's ``all_to_all(tiled=True)`` becomes
``parallel/collectives.all_to_all`` (``all_to_all_single``, which splits
and concatenates dim 0, and is its own adjoint): a permute before and
after puts the chunks in the JAX package's order. The price is that the
head count must divide by the axis size. With the default dense inner,
``backward()`` gives every process the dense gradient; the flash kernel
has no backward (the JAX kernel has no ``custom_vjp``), so a backward
through it on CUDA raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sparkdl_tpu_torch.ops.ring_attention import _default_mesh, sharded_attention
from sparkdl_tpu_torch.parallel.collectives import all_to_all, gather_rows


def _seq_to_heads(x: torch.Tensor, mesh, axis: str, n: int) -> torch.Tensor:
    """[B, H, L/n, Dh] -> [B, H/n, L, Dh]: head chunk ``j`` goes to process
    ``j``, and the sequence chunks come back in process order."""
    if n == 1:
        return x
    B, H, lc, dh = x.shape
    sent = x.reshape(B, n, H // n, lc, dh).permute(1, 0, 2, 3, 4)
    got = all_to_all(sent, mesh, axis)  # [n (source), B, H/n, L/n, Dh]
    return got.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * lc, dh)


def _heads_to_seq(x: torch.Tensor, mesh, axis: str, n: int) -> torch.Tensor:
    """[B, H/n, L, Dh] -> [B, H, L/n, Dh]: sequence chunk ``j`` goes to
    process ``j``, and the head chunks come back in process order."""
    if n == 1:
        return x
    B, hn, L, dh = x.shape
    sent = x.reshape(B, hn, n, L // n, dh).permute(2, 0, 1, 3, 4)
    got = all_to_all(sent, mesh, axis)  # [n (source), B, H/n, L/n, Dh]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * hn, L // n, dh)


def make_ulysses_attention(axis_name: str = "sp", inner: Optional[Callable] = None, mesh=None) -> Callable:
    """An attention fn with the ``dense_attention(q, k, v, mask, dtype)``
    signature over this process's sequence shard: q, k, v are ``[B, H,
    L/n, Dh]`` and mask the additive ``[B, 1, 1, L/n]`` (or None).
    ``inner`` runs on the head-sharded layout (default: dense softmax
    attention; ``make_flash_attention_fn()`` for the flash kernel).
    ``mesh`` (default: every process on ``axis_name``) names the group."""

    def ulysses_attention(q, k, v, mask, dtype):
        msh = _default_mesh(mesh, axis_name)
        n = msh.axis_size(axis_name)
        nheads = q.shape[1]
        if nheads % n != 0:
            raise ValueError(
                f"Ulysses attention needs heads % axis_size == 0; got "
                f"{nheads} heads over {n} devices (use ring attention for "
                "head counts that don't divide)"
            )
        inner_fn = inner
        if inner_fn is None:
            from sparkdl_tpu_torch.models.bert import dense_attention

            inner_fn = dense_attention
        qh, kh, vh = (_seq_to_heads(t, msh, axis_name, n) for t in (q, k, v))
        full_mask = gather_rows(mask, msh, axis_name, dim=3) if mask is not None else None
        out = inner_fn(qh, kh, vh, full_mask, dtype)
        return _heads_to_seq(out, msh, axis_name, n)

    return ulysses_attention


def ulysses_attention_sharded(
    q, k, v, mask, mesh, axis: str = "sp", dtype=torch.float32, inner: Optional[Callable] = None,
):
    """Exact attention with L sharded over ``axis`` and the heads swapped by
    all-to-all inside: full tensors in, full output out, as
    ``ring_attention_sharded``."""
    return sharded_attention(
        make_ulysses_attention(axis, inner=inner, mesh=mesh), q, k, v, mask, mesh, axis, dtype,
    )
