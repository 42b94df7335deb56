"""Batched, pipelined execution of a device function over a partition.

The single-device counterpart of the JAX package's ``run_batched``:

- a host producer thread assembles fixed-size batches (``to_batch``),
  zero-pads the tail batch to ``batch_size``, and for a CUDA device stages
  each batch in pinned memory;
- the dispatch loop hands each batch to the device fn, which copies it to
  the device with ``non_blocking=True`` and runs the model; the result's
  copy back into pinned memory starts at once behind an event
  (``runtime/readback``), and at most ``prefetch`` batches are in flight.
  On CUDA every call is issued on the device's launch thread
  (``runtime/device.Launcher``), as the shared feeder issues its own, so
  the partition threads never issue forwards at once;
- the oldest batch is drained (its event waited on) only when the window
  is full, and its valid rows are scattered back to their cell positions.
  Rows whose mask is False come back as ``None``.

:func:`run_batched_shared` is the router the transformers call: when the
executor runs more than one partition at once it streams their rows into
one shared feeder (``runtime/feeder.run_shared``), so full batches pack
across partition boundaries; otherwise it is :func:`run_batched`.
:func:`model_device_fn` builds the device fn that the feeder, the router
and the transformers dispatch through. ``arrays_to_batch`` is the host
stage of tensor columns; :func:`prefetch_iter` runs any generator a few
items ahead on a thread (the streamed trainer's feed).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.runtime import knobs, readback
from sparkdl_tpu_torch.runtime.device import compute_stream, copy_stream, launcher
from sparkdl_tpu_torch.runtime.transfer import Staged, copy_to_device
from sparkdl_tpu_torch.utils.metrics import metrics

_SENTINEL = object()


def default_prefetch(device_fn=None) -> int:
    """In-flight window: ``SPARKDL_PREFETCH_PER_DEVICE`` per device the
    device fn engages (one here: the port has no multi-device fn yet)."""
    per_device = max(1, knobs.get_int("SPARKDL_PREFETCH_PER_DEVICE"))
    return per_device * max(1, getattr(device_fn, "n_devices", 1))


def model_device_fn(model_function):
    """The device fn that the shared feeder and the serving router
    dispatch a ModelFunction's batches through: the single-device
    counterpart of the JAX package's ``model_device_fn``.

    ``fn(batch)`` takes a host batch (a tensor, pinned for a CUDA device,
    or a numpy array) or a :class:`~sparkdl_tpu_torch.runtime.transfer.Staged`
    input from ``fn.stage_put``, and returns the output tensor on the
    device. On CUDA every call runs on the device's compute stream
    (``runtime/device.compute_stream``): a staged input makes the stream
    ``wait_event`` on its copy and is ``record_stream``'d to it, a host
    batch is copied with ``non_blocking=True`` on the stream itself. The
    caller reads the result back with ``runtime/readback`` on
    ``fn.stream``. Image models take their rows as NHWC (the wire and JAX
    layout) and the fn permutes them to the NCHW the port's modules take:
    on a ``channels_last`` module that is a free view.

    A function that takes NHWC rows itself (``mf.takes_nhwc``, the
    trainable image functions) gets them as they are.

    Attributes the feeder and router read: ``device``, ``stream`` (None on
    the CPU), ``stage_put`` (the transfer half, ``runtime/transfer.py``),
    ``launcher`` (the device's :class:`~sparkdl_tpu_torch.runtime.device.Launcher`,
    on whose thread the feeder issues every call; None on the CPU),
    ``n_devices = batch_multiplier = 1`` and ``single_stream``, carried
    from the ModelFunction (a sequence-parallel model runs each batch on
    its whole mesh axis: no length bucketing, no shared feeder).
    """
    mf = model_function
    device = torch.device(mf.device if mf.device is not None else "cpu")
    on_cuda = device.type == "cuda"
    nhwc = (
        mf.input_shape is not None and len(mf.input_shape) == 3 and not mf.takes_nhwc
    )
    stream = None
    if on_cuda:
        stream = compute_stream(device)
        # the module was built on another stream: order the compute
        # stream after that work once, here, not on every call
        built = torch.cuda.Event()
        built.record(torch.cuda.current_stream(device))
        stream.wait_event(built)
        copies = copy_stream(device)

    def run(x: torch.Tensor) -> torch.Tensor:
        if nhwc and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        return mf(x)

    def fn(batch):
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if not on_cuda:
            return run(batch.tensor if isinstance(batch, Staged) else batch)
        with torch.cuda.stream(stream):
            if isinstance(batch, Staged):
                stream.wait_event(batch.event)
                x = batch.tensor
                x.record_stream(stream)
            else:
                x = batch.to(device, non_blocking=True)
            return run(x)

    def stage_put(host: torch.Tensor) -> Staged:
        if not on_cuda:
            return Staged(host, None)
        return copy_to_device(host, device, copies)

    fn.device = device
    fn.stream = stream
    fn.stage_put = stage_put
    fn.launcher = launcher(device) if on_cuda else None
    fn.n_devices = 1
    fn.batch_multiplier = 1
    fn.single_stream = bool(getattr(mf, "single_stream", False))
    return fn


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


def prefetch_iter(gen, depth: int = 2):
    """Run ``gen`` on a producer thread, ``depth`` items ahead through a
    bounded queue, so host work (decode, shuffle) overlaps the device.
    Exceptions reach the consumer; abandoning the returned iterator
    (break, raise, ``close``) stops the producer at its next put."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def produce():
        try:
            for item in gen:
                if not _put_or_stop(q, item, stop):
                    return
            _put_or_stop(q, _SENTINEL, stop)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _put_or_stop(q, e, stop)

    t = threading.Thread(target=produce, name="sparkdl-torch-stream-producer", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


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
        device_fn: a :func:`model_device_fn` fn, which takes the host
            batch and copies it on its own stream; or any callable over
            one batch tensor on ``device_fn.device``, which gets the batch
            copied there on the launch thread's stream.
        batch_size: device batch size; the tail batch is zero-padded to it.
        prefetch: batches in flight ahead of readback (default
            ``SPARKDL_PREFETCH_PER_DEVICE``).

    Returns one output per cell: an np.ndarray row, or None where masked.
    """
    device = torch.device(device_fn.device)
    prefetch = max(1, prefetch if prefetch is not None else default_prefetch(device_fn))
    n = len(cells)
    out: List[Optional[np.ndarray]] = [None] * n
    if n == 0:
        return out
    on_cuda = device.type == "cuda"
    takes_host = hasattr(device_fn, "stage_put")
    stream = getattr(device_fn, "stream", None)
    la = (getattr(device_fn, "launcher", None) or launcher(device)) if on_cuda else None

    def issue(host: torch.Tensor):
        y = device_fn(host if takes_host else host.to(device, non_blocking=True))
        return readback.start_copy(y, stream)

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
        y = issue(host) if la is None else la.run(issue, host)
        metrics.inc("transform.batches")
        inflight.append((start, mask, y))

    def drain() -> None:
        start, mask, y = inflight.popleft()
        t0 = time.perf_counter()
        rows = readback.to_host(y)  # this batch only; later ones keep running
        metrics.record_time("transform.device_wait", time.perf_counter() - t0)
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


def shared_feeder_enabled() -> bool:
    """SPARKDL_SHARED_FEEDER gates coalescing across concurrent partitions
    (default on; 0/off gives every partition its own pipeline: the A/B
    arm)."""
    return knobs.get_flag("SPARKDL_SHARED_FEEDER")


def device_preproc_enabled() -> bool:
    """SPARKDL_DEVICE_PREPROC gates the on-device image preprocessing
    arm: the host ships uint8 rows at each partition's source geometry
    and the resize (then the normalization it feeds) runs on the device,
    so H2D bytes scale with the source, not the model input. Default off
    (opt-in A/B arm): a real resize is not bit-identical to the host
    resizers, and rows of another size than the partition's first pay a
    host resize to its geometry first (``ImageModelTransformer``)."""
    return knobs.get_flag("SPARKDL_DEVICE_PREPROC")


def run_batched_shared(
    cells: Sequence,
    to_batch: Callable[[Sequence], Tuple[np.ndarray, np.ndarray]],
    device_fn: Callable,
    batch_size: int,
    prefetch: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """:func:`run_batched` that coalesces across concurrent partitions
    (:func:`start_batched_shared`, waited on at once)."""
    return start_batched_shared(cells, to_batch, device_fn, batch_size, prefetch)()


def start_batched_shared(
    cells: Sequence,
    to_batch: Callable[[Sequence], Tuple[np.ndarray, np.ndarray]],
    device_fn: Callable,
    batch_size: int,
    prefetch: Optional[int] = None,
) -> Callable[[], List[Optional[np.ndarray]]]:
    """The router behind :func:`run_batched_shared`, returning a function
    that gives the rows.

    When the executor runs this call as one of more than one partition at
    once (its :class:`~sparkdl_tpu_torch.runtime.executor.TaskContext`)
    and the shared feeder is on, the rows stream into the feeder of
    ``(device_fn, batch geometry)``: the partitions feed ONE dispatch loop
    with full batches packed across partition boundaries, and only the
    last flush is padded. A single partition, a ``single_stream`` fn and
    ``SPARKDL_SHARED_FEEDER=0`` keep :func:`run_batched`, which runs
    before this returns. On the feeder the rows are submitted before this
    returns and the function waits for them (``feeder.submit_shared``).
    The output contract is :func:`run_batched`'s."""
    from sparkdl_tpu_torch.runtime.executor import current_task_context

    ctx = current_task_context()
    if (
        not shared_feeder_enabled()
        or ctx is None
        or ctx.concurrency <= 1
        or getattr(device_fn, "single_stream", False)
    ):
        out = run_batched(cells, to_batch, device_fn, batch_size, prefetch)
        return lambda: out
    from sparkdl_tpu_torch.runtime.feeder import submit_shared

    return submit_shared(
        device_fn, cells, to_batch, batch_size, prefetch=prefetch,
        partition=ctx.partition_index,
    )


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
