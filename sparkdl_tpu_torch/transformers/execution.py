"""Batched, pipelined execution of a device function over a partition.

The single-device counterpart of the JAX package's ``run_batched``:

- a host producer thread assembles fixed-size batches (``to_batch``),
  zero-pads the tail batch to ``batch_size``, and for a CUDA device stages
  each batch in pinned memory;
- the dispatch loop copies each batch to the device with
  ``non_blocking=True``, runs ``device_fn`` on it, starts the result's
  copy back into pinned memory and records a CUDA event, keeping at most
  ``prefetch`` batches in flight;
- the oldest batch is drained (its event waited on) only when the window
  is full, and its valid rows are scattered back to their cell positions.
  Rows whose mask is False come back as ``None``.

``run_batched_shared`` is an alias for now: the cross-partition shared
feeder of the JAX package is not ported yet. ``arrays_to_batch`` is the
host stage of tensor columns.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics

_SENTINEL = object()


def default_prefetch() -> int:
    """In-flight window of one device (``SPARKDL_PREFETCH_PER_DEVICE``)."""
    return max(1, knobs.get_int("SPARKDL_PREFETCH_PER_DEVICE"))


def _put_or_stop(out_q: "queue.Queue", item, stop: threading.Event) -> bool:
    """put() that gives up once the consumer has stopped, so the producer
    never blocks forever on a full queue."""
    while not stop.is_set():
        try:
            out_q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _batch_producer(
    cells: Sequence,
    to_batch: Callable[[Sequence], Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    pin: bool,
    out_q: "queue.Queue",
    stop: threading.Event,
) -> None:
    """Host stage, on a background thread: padded fixed-size batches, as
    (pinned, for a CUDA device) tensors, handed over through a bounded
    queue."""
    try:
        for start in range(0, len(cells), batch_size):
            if stop.is_set():
                return
            t0 = time.perf_counter()
            chunk = list(cells[start : start + batch_size])
            batch, mask = to_batch(chunk)
            pad = batch_size - len(chunk)
            if pad and mask.any():
                batch = np.concatenate(
                    [batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)]
                )
            host = torch.from_numpy(np.ascontiguousarray(batch))
            if pin and mask.any():
                host = host.pin_memory()
            metrics.record_time(
                "transform.host_batch", time.perf_counter() - t0
            )
            if not _put_or_stop(out_q, (start, host, mask), stop):
                return
        _put_or_stop(out_q, _SENTINEL, stop)
    except BaseException as e:  # noqa: BLE001 — relayed to the consumer
        _put_or_stop(out_q, e, stop)


def run_batched(
    cells: Sequence,
    to_batch: Callable[[Sequence], Tuple[np.ndarray, np.ndarray]],
    device_fn: Callable[[torch.Tensor], torch.Tensor],
    batch_size: int,
    prefetch: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """Map ``device_fn`` over ``cells`` in fixed-size batches, pipelined.

    Args:
        cells: partition column values (may contain None).
        to_batch: host stage: list of cells -> (batch array, bool mask of
            rows that hold data).
        device_fn: callable over one batch tensor on ``device_fn.device``.
        batch_size: device batch size; the tail batch is zero-padded to it.
        prefetch: batches in flight ahead of readback (default
            ``SPARKDL_PREFETCH_PER_DEVICE``).

    Returns one output per cell: an np.ndarray row, or None where masked.
    """
    device = torch.device(device_fn.device)
    prefetch = max(1, prefetch if prefetch is not None else default_prefetch())
    n = len(cells)
    out: List[Optional[np.ndarray]] = [None] * n
    if n == 0:
        return out
    on_cuda = device.type == "cuda"

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    producer = threading.Thread(
        target=_batch_producer,
        name="sparkdl-torch-batch-producer",
        args=(cells, to_batch, batch_size, on_cuda, q, stop),
        daemon=True,
    )
    producer.start()
    inflight: deque = deque()

    def dispatch(start: int, host: torch.Tensor, mask: np.ndarray) -> None:
        y = device_fn(host.to(device, non_blocking=True))
        metrics.inc("transform.batches")
        done = None
        if on_cuda:
            y_host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            y_host.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            y = y_host
        inflight.append((start, mask, y, done))

    def drain() -> None:
        start, mask, y, done = inflight.popleft()
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()  # this batch only; later ones keep running
        metrics.record_time("transform.device_wait", time.perf_counter() - t0)
        rows = y.numpy()
        valid = np.flatnonzero(mask)
        metrics.inc("transform.rows", int(len(valid)))
        for i in valid:
            out[start + int(i)] = rows[i]

    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            start, host, mask = item
            if not mask.any():
                continue  # every row null or failed to tokenize
            while len(inflight) >= prefetch:
                drain()
            dispatch(start, host, mask)
        while inflight:
            drain()
    finally:
        stop.set()
        producer.join(timeout=5.0)
    return out


#: The cross-partition shared feeder is not ported yet; every partition
#: runs its own pipeline.
run_batched_shared = run_batched


def arrays_to_batch(
    chunk: Sequence, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Host stage for tensor columns: 1-D (or k-D) array cells -> batch.
    All valid cells must share a shape; Nones become zero rows."""
    shapes = {np.asarray(c).shape for c in chunk if c is not None}
    if len(shapes) > 1:
        raise ValueError(
            f"Tensor column has inconsistent shapes within a batch: {shapes}"
        )
    if not shapes:
        return np.zeros((len(chunk), 1), dtype=dtype), np.zeros(
            len(chunk), dtype=bool
        )
    batch = np.zeros((len(chunk), *shapes.pop()), dtype=dtype)
    mask = np.zeros((len(chunk),), dtype=bool)
    for i, c in enumerate(chunk):
        if c is None:
            continue
        batch[i] = np.asarray(c, dtype=dtype)
        mask[i] = True
    return batch, mask
