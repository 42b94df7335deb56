"""Asynchronous D2H readback: overlap result copy-back with dispatch.

The port of the JAX package's ``runtime/readback.py``. The shared feeder
gets its readback overlap from here:

- :func:`start_copy`: right after dispatch, copy a CUDA result into a
  pinned host buffer with ``non_blocking=True`` on the stream that
  computed it and record a ``torch.cuda.Event`` behind the copy, so the
  D2H transfer rides under the device's compute of the next batches.
  Returns a :class:`PendingCopy`. Pinned buffers come from PyTorch's
  caching host allocator, which reuses a freed pinned block once the
  copies that used it are done, so no batch pays for pinning after the
  first few. Anything that is not a CUDA tensor passes through unchanged.
- :func:`is_ready`: ``event.query()``, or None where there is no event
  to ask (a CPU result); used only for the hit/miss counters.
- :func:`to_host`: ``event.synchronize()`` on this batch's event only,
  never ``torch.cuda.synchronize()``, so one model's drain never waits
  on another's work queued behind it. A CUDA tensor whose copy was not
  started (the synchronous arm) is copied here, then waited on.
- :func:`scatter_rows`: vectorized scatter of result rows into a
  partition's output list, as in the JAX module.

On a CPU device a result is already on the host and is read as it is.
``SPARKDL_ASYNC_READBACK=0`` keeps the JAX module's synchronous arm: no
copy at dispatch, no drainer thread.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sparkdl_tpu_torch.runtime import knobs

__all__ = [
    "PendingCopy",
    "async_readback_enabled",
    "is_ready",
    "scatter_rows",
    "start_copy",
    "to_host",
]


def async_readback_enabled() -> bool:
    """SPARKDL_ASYNC_READBACK gates the dispatch-time copy and the
    feeder's drainer thread (default on; 0/off = the synchronous drain)."""
    return knobs.get_flag("SPARKDL_ASYNC_READBACK")


class PendingCopy:
    """A D2H copy in flight: the pinned host tensor and the event
    recorded behind the copy on the computing stream."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event: "torch.cuda.Event"):
        self.host = host
        self.event = event

    @property
    def nbytes(self) -> int:
        return self.host.nbytes


def start_copy(y, stream: Optional["torch.cuda.Stream"] = None):
    """Start the device-to-host copy of a dispatched result now, without
    blocking: a :class:`PendingCopy` for a CUDA tensor, ``y`` itself for
    anything else. ``stream`` is the stream that computed ``y`` (default:
    the current stream of ``y``'s device); the copy is ordered after the
    computation on it."""
    if not (isinstance(y, torch.Tensor) and y.is_cuda):
        return y
    stream = stream if stream is not None else torch.cuda.current_stream(y.device)
    with torch.cuda.stream(stream):
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return PendingCopy(host, event)


def is_ready(r) -> Optional[bool]:
    """Whether the result's copy has completed; None where there is no
    event to ask."""
    if isinstance(r, PendingCopy):
        return bool(r.event.query())
    return None


def to_host(r, stream: Optional["torch.cuda.Stream"] = None) -> np.ndarray:
    """The result on the host as numpy. Blocks only for this batch: the
    event behind its own copy."""
    if isinstance(r, torch.Tensor) and r.is_cuda:
        r = start_copy(r, stream)
    if isinstance(r, PendingCopy):
        r.event.synchronize()
        return r.host.numpy()
    if isinstance(r, torch.Tensor):
        return r.detach().numpy()
    return np.asarray(r)


def scatter_rows(
    out: List[Optional[np.ndarray]],
    dest_idx: Sequence,
    rows: np.ndarray,
) -> None:
    """Scatter ``rows[k]`` into ``out[dest_idx[k]]``: one list-slice
    assignment when the destinations are one contiguous run (increasing
    submission order makes the span check sufficient), a zip over native
    ints otherwise."""
    n = len(dest_idx)
    if n == 0:
        return
    views = list(rows[:n])
    first = int(dest_idx[0])
    last = int(dest_idx[-1])
    if last - first + 1 == n:
        out[first : last + 1] = views
    else:
        idx = (
            dest_idx.tolist()
            if isinstance(dest_idx, np.ndarray)
            else list(dest_idx)
        )
        for d, v in zip(idx, views):
            out[d] = v
