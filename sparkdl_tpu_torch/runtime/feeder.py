"""Continuous batching over one device stream: the shared device feeder.

The port of the JAX package's ``runtime/feeder.py``. A
:class:`DeviceFeeder` is shared per ``(device_fn, dispatch size, row
shape, dtype)``. Producers (serving groups, later the partition threads)
submit only VALID rows through :meth:`~DeviceFeeder.open_handle` /
:meth:`~DeviceFeeder.submit_rows` / :meth:`~DeviceFeeder.finish`; one owner
thread per feeder packs them into full ``dispatch_rows``-row batches in a
small ring of host buffers, dispatches them with a bounded in-flight
window, and scatters results back to each producer's output list. Only a
tail flushed after a quiet period (``SPARKDL_FEEDER_LINGER_MS``) is padded.

Host buffer ring: slots are allocated lazily up to ``prefetch +
stage_depth + 2`` and, for a CUDA device fn, pinned once when allocated
and reused for the life of the feeder (pinning per batch would cost
milliseconds). A buffer returns to the ring only after its batch's result
has been read back: the H2D copy reads it asynchronously, and the copy is
ordered before the compute that produced the result.

Device staging (the H2D half, ``runtime/transfer.py``): with
``SPARKDL_DEVICE_STAGE`` on and a device fn that has ``stage_put``, each
packed batch's copy starts on a copy stream the moment it is full, and
dispatch claims the oldest staged slot once ``SPARKDL_DEVICE_STAGE_DEPTH``
batches ride ahead (or at once when no more rows are queued). The time the
owner spends claiming a slot is the handle's ``stage_wait`` segment.

Launching: a device fn with a ``launcher`` (every CUDA fn of
``model_device_fn``) is called on that launcher's thread, one per device,
never on the owner thread: eager PyTorch issues a forward's kernels from
the calling thread, and owner threads of many streams issuing forwards at
once contend for the interpreter lock and each hold a cuBLAS workspace.
The owner waits for its call to be issued, not for the device, so the
``dispatch`` segment is the wait for the launcher's turn plus the host
time of issuing the forward.

Readback (the D2H half, ``runtime/readback.py``): with
``SPARKDL_ASYNC_READBACK`` on, dispatch starts each result's copy into a
pinned buffer behind an event, and a drainer thread waits on that event
alone (the ``drain_wait`` segment), scatters rows back and returns the
buffer to the ring while the owner keeps packing and dispatching.
``feeder.readback_async_hits`` / ``.misses`` count whether the copy had
already landed when the drain started. ``0``/``off`` drains synchronously
on the owner thread.

When a device call raises, every open handle receives the exception and
the feeder resets for later work. Every thread that dispatches waits on
events of its own batches only, never on ``torch.cuda.synchronize()``, so
one model's drain never waits on another model's work.

Env knobs (read per event, so tests can flip them live):
``SPARKDL_FEEDER_LINGER_MS`` (default 20), ``SPARKDL_FEEDER_IDLE_S``
(default 30; ``0`` = owner threads never exit, the serving keepalive),
``SPARKDL_MAX_FEEDERS`` (default 8), ``SPARKDL_ASYNC_READBACK``,
``SPARKDL_DEVICE_STAGE`` and ``SPARKDL_DEVICE_STAGE_DEPTH`` (read at
feeder construction: it sizes the ring).

The control plane's notes: each dispatch's wall and each drain's
residual are device busy time in the utilization ledger
(``obs/utilization.py``), the staged-copy claim's residual its H2D wait;
staged batches and outputs in the drain are device bytes in the memory
ledger (``obs/memory.py``) until dispatch or delivery.

Fault injection: ``maybe_fault("feeder.dispatch")`` before each dispatch
(``resilience/faults.py``); a raised fault takes the fail-all path.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sparkdl_tpu_torch.obs import memory, span, utilization
from sparkdl_tpu_torch.resilience.faults import maybe_fault
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.runtime import knobs, locksmith, readback, transfer
from sparkdl_tpu_torch.utils.metrics import metrics


def _max_feeders() -> int:
    """Feeders kept alive in the registry; least-recently-used *idle*
    feeders beyond this are closed (busy feeders are never evicted).
    The default suits the batch engine (one geometry per model); the
    serving layer multiplies the population by its batch-size rungs
    (model x rung x shape), so serving deployments raise
    SPARKDL_MAX_FEEDERS to avoid LRU churn re-spawning owner threads —
    the latency the SPARKDL_FEEDER_IDLE_S=0 keepalive exists to avoid."""
    return max(1, knobs.get_int("SPARKDL_MAX_FEEDERS"))


#: The handle-open race (LRU eviction closing a feeder between registry
#: lookup and first use) is local and fast-resolving: many cheap
#: attempts, near-zero backoff, only RuntimeError (the "closed" signal)
#: retries. Public: the serving router opens streams through the same
#: registry and shares the same race (and must stay tuned with it).
open_handle_policy = RetryPolicy(
    max_attempts=8,
    base_delay_s=0.001,
    max_delay_s=0.02,
    retryable=(RuntimeError,),
)


#: how long the owner thread waits on an empty queue before it looks at
#: its timers (linger, idle exit) again
_POLL_S = 0.05


def _linger_s() -> float:
    return max(0.0, knobs.get_float("SPARKDL_FEEDER_LINGER_MS")) / 1e3


def _idle_s() -> float:
    """Idle-exit window for owner threads. ``0`` (or negative) means
    NEVER exit — the serving keepalive: an online request stream pays
    owner-thread respawn latency on every burst otherwise. Values in
    (0, 0.1) clamp up to 0.1s so a typo can't busy-spin the lifecycle."""
    raw = knobs.get_float("SPARKDL_FEEDER_IDLE_S")
    if raw <= 0.0:
        return float("inf")
    return max(0.1, raw)


class _Handle:
    """One partition run's submission stream into a feeder.

    Completion is row-count driven: ``_pending`` rises as valid rows are
    submitted and falls as their results scatter back; the event fires
    when the producer has ended its stream and every submitted row is
    accounted for. ``fail`` is sticky — the first error wins and wakes
    the waiting partition immediately."""

    __slots__ = (
        "feeder", "out", "partition", "_lock", "_event", "_pending",
        "_ended", "error", "segments",
    )

    def __init__(self, feeder: "DeviceFeeder", out: list, partition=None):
        self.feeder = feeder
        self.out = out
        self.partition = partition
        self._lock = locksmith.lock("sparkdl_tpu_torch/runtime/feeder.py::_Handle._lock")
        self._event = threading.Event()
        self._pending = 0
        self._ended = False
        self.error: Optional[BaseException] = None
        #: per-stream stage attribution: the owner / drainer accumulate
        #: the stage_wait (claiming the staged H2D copy), dispatch
        #: (device call) and drain_wait (residual D2H) seconds of each
        #: batch this stream contributed to. The serving router reads
        #: them after wait(): one handle per dispatch group, so the
        #: totals ARE the group's.
        self.segments: dict = {}

    def _note_seg(self, name: str, dt: float) -> None:
        with self._lock:
            self.segments[name] = self.segments.get(name, 0.0) + dt

    def segments_snapshot(self) -> dict:
        with self._lock:
            return dict(self.segments)

    @property
    def failed(self) -> bool:
        return self.error is not None

    def _add_pending(self, n: int) -> None:
        with self._lock:
            self._pending += n

    def _rows_drained(self, n: int) -> None:
        with self._lock:
            self._pending -= n
            if self._ended and self._pending <= 0:
                self._event.set()

    def _mark_ended(self) -> None:
        with self._lock:
            self._ended = True
            if self._pending <= 0:
                self._event.set()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            # A stream whose every row already landed is complete — a
            # later foreign failure (another partition's device error,
            # feeder close) must not poison its successful result.
            complete = self._ended and self._pending <= 0
            if self.error is None and not complete:
                self.error = exc
            self._event.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted row's result has landed (or the
        stream failed). Re-raises producer/device errors. Guards against
        a dead owner thread so a bug there surfaces as an exception in
        the partition task, never as a hang."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._event.wait(timeout=0.2):
            if not self.feeder._owner_alive():
                self.fail(
                    RuntimeError(
                        "DeviceFeeder owner thread exited with rows still "
                        "pending (feeder closed or crashed)"
                    )
                )
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"DeviceFeeder result wait exceeded {timeout}s "
                    f"({self._pending} rows pending)"
                )
        if self.error is not None:
            raise self.error


class DeviceFeeder:
    """Shared continuous-batching service for one (device_fn, batch
    geometry). Producers submit valid-row chunks via :meth:`open_handle`
    / :meth:`submit_rows` / :meth:`finish`; the single owner thread packs
    them into full ``dispatch_rows``-row batches and dispatches with a
    bounded in-flight window."""

    def __init__(self, device_fn, dispatch_rows, row_shape, dtype, prefetch):
        self.device_fn = device_fn
        device = getattr(device_fn, "device", None)
        #: CUDA device fns get pinned ring buffers and readback on the
        #: fn's compute stream
        self._pin = device is not None and torch.device(device).type == "cuda"
        self._stream = getattr(device_fn, "stream", None)
        #: the device's launch thread, which issues every call of the fn
        #: (None: the owner thread calls it itself)
        self._launcher = getattr(device_fn, "launcher", None)
        self.dispatch_rows = int(dispatch_rows)
        self.row_shape = tuple(int(d) for d in row_shape)
        self.dtype = np.dtype(dtype)
        self.prefetch = max(1, int(prefetch))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(4, 2 * self.prefetch))
        self._lock = locksmith.lock("sparkdl_tpu_torch/runtime/feeder.py::DeviceFeeder._lock")
        self._open = 0  # producers registered whose "end" is unprocessed
        self._handles: set = set()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Batch-assembly state (owner thread only): the buffer being
        # filled and its segment map. Ring slots allocate LAZILY in
        # _take_buffer up to _ring_cap — a stream that never has a
        # second batch in flight never pays for the whole ring.
        self._free: List[torch.Tensor] = []
        self._allocated = 0
        # 1 filling + stage_depth staged + prefetch in flight + 1 spare.
        self._stage_lag = transfer.stage_depth()
        self._ring_cap = self.prefetch + self._stage_lag + 2
        self._cur: Optional[torch.Tensor] = None
        self._fill = 0
        self._segs: list = []  # (handle, dest_idx, buffer offset)
        # Device-side staging slots awaiting dispatch (owner thread
        # only): (segs, fill, pad, StagedBatch, buffer).
        self._staged: deque = deque()
        # Drain-side state, shared between the owner and the (async-arm)
        # drainer thread, all guarded by _drain_cv: dispatched batches
        # waiting for readback, the free-buffer ring they return to, a
        # count of entries popped-but-not-finished, and the drainer's
        # first error (the owner resets its assembly state on seeing it).
        self._drain_cv = locksmith.condition("sparkdl_tpu_torch/runtime/feeder.py::DeviceFeeder._drain_cv")
        self._inflight: deque = deque()
        self._draining = 0
        self._drainer: Optional[threading.Thread] = None
        self._drainer_stop = False
        self._drain_exc: Optional[BaseException] = None

    # -- producer side ------------------------------------------------------

    def open_handle(self, out: list, partition=None) -> _Handle:
        h = _Handle(self, out, partition)
        with self._lock:
            if self._closed:
                raise RuntimeError("DeviceFeeder is closed")
            self._open += 1
            self._handles.add(h)
            self._ensure_owner_locked()
            metrics.gauge("feeder.open_producers", self._open)
        return h

    def submit_rows(self, handle: _Handle, dest_idx: np.ndarray, rows: np.ndarray) -> None:
        """Hand a chunk of VALID rows to the owner. ``dest_idx[k]`` is the
        index in ``handle.out`` that ``rows[k]``'s result lands in."""
        handle._add_pending(len(dest_idx))
        self._put(("rows", handle, dest_idx, rows))

    def finish(self, handle: _Handle) -> None:
        """End a producer's stream (normal completion, producer error, or
        an abandoning consumer). Idempotent enough for the error path:
        the owner decrements its producer count exactly once per queued
        end marker."""
        handle._mark_ended()
        self._put(("end", handle))

    def _put(self, item) -> None:
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError("DeviceFeeder is closed")
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                if not self._owner_alive():
                    raise RuntimeError(
                        "DeviceFeeder owner thread is not running and the "
                        "submission queue is full"
                    )

    # -- owner thread -------------------------------------------------------

    def _ensure_owner_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._owner_loop,
                name=f"sparkdl-feeder-{id(self) & 0xFFFFFF:x}",
                daemon=True,
            )
            self._thread.start()

    def _owner_alive(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    @staticmethod
    def _clear_gauges() -> None:
        """Rewrite the depth gauges from the TRUE aggregate state of all
        registered feeders on owner exit, so a post-run snapshot never
        shows a stale nonzero depth from the last burst (the burst stays
        visible via the gauges' max envelope and the time-series
        sampler's history). The gauges are process-global and shared by
        every feeder, so an exiting feeder must not write a blind zero —
        a sibling mid-burst keeps its open-producer count. A handle
        opened between this read and the write can still be overwritten
        for one event (gauge writes aren't globally serialized); the
        next submit/end rewrites the truth. Must be called without the
        feeder's own lock held (idle() takes it)."""
        with _feeders_lock:
            open_total, busy = 0, False
            for f in _feeders.values():
                if f._closed:
                    continue
                with f._lock:
                    open_total += f._open
                if not f.idle():
                    busy = True
            metrics.gauge("feeder.open_producers", open_total)
            if not busy:
                metrics.gauge("feeder.queue_depth", 0)

    def _owner_loop(self) -> None:
        idle_s = _idle_s()
        flush_at: Optional[float] = None
        last_work = time.monotonic()
        while True:
            self._check_drain_exc()
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                now = time.monotonic()
                with self._lock:
                    open_producers = self._open
                    closed = self._closed
                if closed:
                    self._abort(RuntimeError("DeviceFeeder closed"))
                    self._clear_gauges()
                    return
                if open_producers == 0 and (
                    self._fill or self._staged or self._pending_results()
                ):
                    # Staged batches are COMPLETE — nothing more can
                    # coalesce into them; dispatch before any linger so
                    # a quiet stream never holds a packed batch back.
                    if self._staged:
                        try:
                            while self._staged:
                                self._dispatch_staged()
                        except BaseException as e:  # noqa: BLE001
                            self._fail_all(e)
                    # Quiet period with a partial batch: linger briefly so
                    # a late-starting partition can still coalesce into the
                    # tail, then pad and flush the ONE tail batch.
                    if flush_at is None:
                        flush_at = now + _linger_s()
                    if now >= flush_at:
                        try:
                            if self._fill:
                                # Tail-flush accounting lives HERE, at the
                                # call site, so a tail that happens to be
                                # exactly full (pad == 0) still counts —
                                # _flush's pad branch only owns pad_rows.
                                metrics.inc("feeder.flushes")
                                self._flush()
                            self._settle_inflight()
                        except BaseException as e:  # noqa: BLE001
                            self._fail_all(e)
                        flush_at = None
                        last_work = time.monotonic()
                elif open_producers == 0:
                    exiting = False
                    with self._lock:
                        if (
                            time.monotonic() - last_work > idle_s
                            and self._open == 0
                            and self._q.empty()
                        ):
                            self._thread = None  # restarted lazily
                            exiting = True
                    if exiting:  # clear OUTSIDE our lock (idle() takes it)
                        self._stop_drainer()  # restarts with the owner
                        self._clear_gauges()
                        return
                else:
                    flush_at = None
                    # Producers are mid-assembly but the queue is empty:
                    # nothing new is arriving, so a held staging slot
                    # gains no overlap — keep the device fed instead.
                    if self._staged:
                        try:
                            while self._staged:
                                self._dispatch_staged()
                        except BaseException as e:  # noqa: BLE001
                            self._fail_all(e)
                    # Reclaim a finished batch so results (and ring
                    # buffers) keep flowing. With the async arm a live
                    # drainer already does this off-thread.
                    if self._pending_results() and not self._drainer_alive():
                        try:
                            self._drain_one()
                        except BaseException as e:  # noqa: BLE001
                            self._fail_all(e)
                continue
            flush_at = None
            last_work = time.monotonic()
            kind = item[0]
            if kind == "stop":
                self._abort(RuntimeError("DeviceFeeder closed"))
                self._clear_gauges()
                return
            if kind == "end":
                with self._lock:
                    self._open -= 1
                    self._handles = {
                        h for h in self._handles if not h._event.is_set()
                    }
                    metrics.gauge("feeder.open_producers", self._open)
                if self._q.empty():
                    try:
                        self._settle_quiet()
                    except BaseException as e:  # noqa: BLE001
                        self._fail_all(e)
                continue
            _, handle, dest_idx, rows = item
            if handle.failed:
                continue  # stream already dead; drop its rows
            try:
                self._append_rows(handle, dest_idx, rows)
            except BaseException as e:  # noqa: BLE001
                self._fail_all(e)

    def _settle_quiet(self) -> None:
        """A stream ended and nothing else is queued: its last rows must
        not wait out the queue poll. ``_flush`` holds a staged slot back
        while the queue is non-empty, and the end marker right behind a
        group's rows is such an item; so dispatch the held slots now and,
        with no drainer thread (the synchronous arm), drain what is in
        flight. The JAX package's feeder leaves both to the next
        ``_POLL_S`` timeout, up to 50 ms on every serving group."""
        while self._staged:
            self._dispatch_staged()
        if not self._drainer_alive():
            while self._drain_one():
                pass

    def _append_rows(self, handle: _Handle, dest_idx: np.ndarray, rows: np.ndarray) -> None:
        if self._cur is None:  # a failed flush left no current buffer
            self._cur = self._take_buffer()
        if tuple(rows.shape[1:]) != self.row_shape or rows.dtype != self.dtype:
            handle.fail(
                ValueError(
                    f"DeviceFeeder expects rows of shape {self.row_shape} "
                    f"dtype {self.dtype}, got {tuple(rows.shape[1:])} "
                    f"{rows.dtype}"
                )
            )
            return
        off, n = 0, len(dest_idx)
        while off < n:
            take = min(n - off, self.dispatch_rows - self._fill)
            view = self._cur.numpy()  # the ring buffer, written in place
            view[self._fill : self._fill + take] = rows[off : off + take]
            self._segs.append((handle, dest_idx[off : off + take], self._fill))
            self._fill += take
            off += take
            if self._fill == self.dispatch_rows:
                self._flush()

    def _flush(self) -> None:
        fill, buf, segs = self._fill, self._cur, self._segs
        pad = self.dispatch_rows - fill
        if pad:
            buf[fill:] = 0  # the ring reuses buffers; stale rows pad as zeros
            metrics.inc("feeder.pad_rows", pad)
        batch = buf
        stage_fn = getattr(self.device_fn, "stage_put", None)
        if transfer.device_stage_enabled() and stage_fn is not None:
            # Double-buffered device staging: this batch's H2D copy
            # starts NOW on a copy stream; dispatch claims the oldest
            # slot once the ring is `stage_lag` batches ahead — while
            # batch N computes, batch N+1's copy is already in flight.
            slot = transfer.stage_batch(stage_fn, batch, rows=fill)
            staged_bytes = int(getattr(batch, "nbytes", 0) or 0)
            # memory ledger: the staged copy holds device bytes until
            # dispatch claims it (or a failure reset reclaims it)
            memory.note_staged(staged_bytes)
            # buf is now owned by the staged entry: drop it from _cur
            # BEFORE anything below can raise, or _fail_all would hand
            # the same buffer out twice (once from _cur, once from the
            # entry) and corrupt a dispatched batch.
            self._staged.append((segs, fill, pad, slot, buf, staged_bytes))
            self._cur = None
            self._fill = 0
            self._segs = []
            # Hold a staged slot back only while MORE rows are arriving
            # (that's when the lag buys overlap: batch N+1's copy rides
            # under batch N's compute). An empty queue means a shallow
            # stream — serving's exact-rung groups — where holding the
            # slot would just add dispatch latency.
            while len(self._staged) >= self._stage_lag or (
                self._staged and self._q.empty()
            ):
                self._dispatch_staged()
        else:
            if self._staged:  # arm flipped off mid-stream: keep order
                while self._staged:
                    self._dispatch_staged()
            self._dispatch(segs, fill, pad, batch, buf)
            # buf now rides the in-flight entry (same aliasing hazard as
            # the staged branch above).
            self._cur = None
            self._fill = 0
            self._segs = []
        self._cur = self._take_buffer()

    def _dispatch_staged(self) -> None:
        """Dispatch the OLDEST staged slot: its H2D copy has been in
        flight under the later packs/stages, so claiming it pays at most
        the residual (hit/miss counted in StagedBatch.take). A failed
        claim or dispatch returns the buffer to the ring before the
        error reaches the owner's fail-all."""
        segs, fill, pad, slot, buf, staged_bytes = self._staged.popleft()
        try:
            t0 = time.perf_counter()
            batch = slot.take()
            dt = time.perf_counter() - t0
            for h in {s[0] for s in segs}:
                h._note_seg("stage_wait", dt)
            if dt > 0:
                # utilization ledger: the residual H2D wait is device idle
                # time attributed to the transfer
                utilization.note_transfer(h2d_s=dt)
            self._dispatch(segs, fill, pad, batch, buf, staged=True)
        except BaseException:
            # the copy may still be reading buf: wait it out first
            slot.settle()
            with self._drain_cv:
                self._free.append(buf)
                self._drain_cv.notify_all()
            raise
        finally:
            # dispatched or reclaimed: no longer a staged holding
            memory.release_staged(staged_bytes)

    def _dispatch(self, segs, fill, pad, batch, buf, staged=False) -> None:
        arm = readback.async_readback_enabled()
        if arm:
            self._ensure_drainer()
        self._throttle_inflight(arm)  # cap device residency at `prefetch`
        depth = self._q.qsize()
        metrics.gauge("feeder.queue_depth", depth)
        # chaos hook (a no-op without a fault plan): a raise= here takes
        # the owner's fail-all path, every open handle re-raises
        maybe_fault("feeder.dispatch", rows=fill, depth=depth)

        def launch():
            y = self.device_fn(batch)
            # Start the D2H copy NOW, right behind the forward on its
            # stream, while the next batches pack and dispatch: the
            # drainer's later wait only pays the residual (a CPU result
            # passes through unchanged).
            return readback.start_copy(y, self._stream) if arm else y

        t0 = time.perf_counter()
        with span(
            "dispatch",
            rows=fill,
            pad=pad,
            bytes=int(getattr(batch, "nbytes", 0)),
            feeder=True,
            queue_depth=depth,
            staged=staged,
        ):
            y_dev = launch() if self._launcher is None else self._launcher.run(launch)
        dt = time.perf_counter() - t0
        for h in {s[0] for s in segs}:
            h._note_seg("dispatch", dt)
        # utilization ledger: the dispatch's wall is device busy time (on
        # CUDA the eager forward issues its kernels as the card runs them)
        utilization.note_busy(dt)
        metrics.inc("feeder.coalesced_batches")
        with self._drain_cv:
            self._inflight.append((segs, fill, y_dev, buf, arm))
            self._drain_cv.notify_all()

    # -- drain side (owner thread, or the drainer thread on the async arm) --

    def _pending_results(self) -> bool:
        with self._drain_cv:
            return bool(self._inflight or self._draining)

    def _check_drain_exc(self) -> None:
        """Owner-side: after a drainer-thread failure (which already
        failed every open handle and reclaimed the in-flight buffers),
        discard the partial batch under assembly — its segments belong
        to failed handles and must not dispatch as garbage."""
        with self._drain_cv:
            exc = self._drain_exc
            self._drain_exc = None
        if exc is not None:
            self._fill = 0
            self._segs = []
            self._reclaim_staged()

    def _throttle_inflight(self, arm: bool) -> None:
        """Block until fewer than ``prefetch`` batches are dispatched but
        undrained. Sync arm (or a dead drainer): drain the oldest batch
        ourselves, exactly the legacy behavior."""
        while True:
            with self._drain_cv:
                if len(self._inflight) + self._draining < self.prefetch:
                    return
                if self._closed:
                    raise RuntimeError("DeviceFeeder closed")
                wait_only = arm and self._drainer_alive()
                if wait_only:
                    self._drain_cv.wait(timeout=0.1)
                    continue
            if not self._drain_one():
                with self._drain_cv:
                    if (
                        len(self._inflight) + self._draining
                        >= self.prefetch
                    ):
                        self._drain_cv.wait(timeout=0.05)

    def _take_buffer(self) -> torch.Tensor:
        """Pop a free ring buffer — allocating a fresh one while the ring
        is under its cap (lazy: a stream that never goes deep never pays
        for the full ring) — draining (or waiting for the drainer) when
        the ring is momentarily empty. Buffer conservation: every
        dispatched buffer returns via _drain_entry's finally or the
        failure paths, so free+inflight+draining can only all be empty
        on a leak — raise rather than hang."""
        while True:
            with self._drain_cv:
                if self._free:
                    return self._free.pop()
                if self._closed:
                    raise RuntimeError("DeviceFeeder closed")
                if self._allocated < self._ring_cap:
                    self._allocated += 1
                    buf = torch.from_numpy(
                        np.zeros((self.dispatch_rows, *self.row_shape), self.dtype)
                    )
                    # pinned once, here, and reused for the feeder's life
                    return buf.pin_memory() if self._pin else buf
            if not self._drain_one():
                with self._drain_cv:
                    if self._free:
                        continue
                    if self._inflight or self._draining:
                        self._drain_cv.wait(timeout=0.1)
                    else:
                        raise RuntimeError(
                            "DeviceFeeder buffer ring exhausted with "
                            "nothing in flight (buffer leak)"
                        )

    def _settle_inflight(self) -> None:
        """Quiet-period tail: every dispatched batch's result has landed
        (drained by us or the drainer) before the stream is settled.
        Staged copies still awaiting dispatch go out first, in order."""
        while self._staged:
            self._dispatch_staged()
        while True:
            if self._drain_one():
                continue
            with self._drain_cv:
                if self._inflight:
                    continue
                if self._draining:
                    self._drain_cv.wait(timeout=0.1)
                    continue
                return

    def _drain_one(self) -> bool:
        """Pop and drain the oldest in-flight batch; False when there was
        nothing to pop. Safe from either thread — entries are claimed
        under the drain lock, so each drains exactly once."""
        with self._drain_cv:
            if not self._inflight:
                return False
            entry = self._inflight.popleft()
            self._draining += 1
        try:
            self._drain_entry(*entry)
        finally:
            with self._drain_cv:
                self._draining -= 1
                self._drain_cv.notify_all()
        return True

    def _drain_entry(self, segs, fill, y_dev, buf, arm) -> None:
        # memory ledger: the output holds device bytes for the drain
        # window; released in the finally, before the drain lock
        readback_bytes = int(getattr(y_dev, "nbytes", 0) or 0)
        memory.note_readback(readback_bytes)
        try:
            if arm:
                ready = readback.is_ready(y_dev)
                if ready is not None:
                    metrics.inc(
                        "feeder.readback_async_hits"
                        if ready
                        else "feeder.readback_async_misses"
                    )
            t0 = time.perf_counter()
            # drain_wait (async arm) is the RESIDUAL wait after the
            # dispatch-time copy; device_wait (sync arm) is the legacy
            # full block on program + D2H.
            with span(
                "drain_wait" if arm else "device_wait", rows=fill, feeder=True
            ):
                y = readback.to_host(y_dev, self._stream)
            dt = time.perf_counter() - t0
            metrics.record_time("transform.device_wait", dt)
            if dt > 0:
                # the drain residual is the tail of the program and its
                # D2H copy still running: busy, attributed to readback
                utilization.note_busy(dt)
                utilization.note_transfer(d2h_s=dt)
            # the readback residual is the handle's drain_wait segment on
            # either arm (the span names differ so each arm stays
            # readable on its own)
            for handle in {s[0] for s in segs}:
                if not handle.failed:
                    handle._note_seg("drain_wait", dt)
            delivered = 0
            for handle, dest_idx, off in segs:
                if handle.failed:
                    continue  # failed streams deliver nothing — don't count
                readback.scatter_rows(
                    handle.out, dest_idx, y[off : off + len(dest_idx)]
                )
                delivered += len(dest_idx)
                handle._rows_drained(len(dest_idx))
            if delivered:
                metrics.inc("transform.rows", delivered)
                metrics.inc("feeder.rows", delivered)
        finally:
            memory.release_readback(readback_bytes)
            with self._drain_cv:
                # a readback error must not shrink the ring
                self._free.append(buf)
                self._drain_cv.notify_all()

    # -- drainer thread lifecycle -------------------------------------------

    def _ensure_drainer(self) -> None:
        """Owner-thread only: (re)start the drainer lazily, mirroring the
        owner's own lazy lifecycle."""
        t = self._drainer
        if t is not None and t.is_alive():
            return
        with self._drain_cv:
            self._drainer_stop = False
        t = threading.Thread(
            target=self._drainer_loop,
            name=f"sparkdl-feeder-drain-{id(self) & 0xFFFFFF:x}",
            daemon=True,
        )
        self._drainer = t
        t.start()

    def _drainer_alive(self) -> bool:
        t = self._drainer
        return t is not None and t.is_alive()

    def _stop_drainer(self, timeout: float = 5.0) -> None:
        t = self._drainer
        with self._drain_cv:
            self._drainer_stop = True
            self._drain_cv.notify_all()
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def _drainer_loop(self) -> None:
        """Async-arm drain stage: wait out each batch's residual D2H and
        scatter results while the owner keeps packing and dispatching.
        Errors fail every open handle (same contract as the owner's
        drain) and flag the owner to reset its assembly state."""
        while True:
            with self._drain_cv:
                while not self._inflight:
                    if self._closed or self._drainer_stop:
                        return
                    self._drain_cv.wait(timeout=0.25)
                entry = self._inflight.popleft()
                self._draining += 1
            try:
                self._drain_entry(*entry)
            except BaseException as e:  # noqa: BLE001
                self._drain_failure(e)
            finally:
                with self._drain_cv:
                    self._draining -= 1
                    self._drain_cv.notify_all()

    def _drain_failure(
        self, exc: BaseException, from_drainer: bool = True
    ) -> None:
        """Thread-safe half of the failure reset: fail every open stream,
        reclaim in-flight buffers, and (from the drainer) leave the error
        for the owner to discard its partial batch."""
        with self._lock:
            handles = list(self._handles)
            self._handles.clear()
        for h in handles:
            h.fail(exc)
        with self._drain_cv:
            while self._inflight:
                entry = self._inflight.popleft()
                self._free.append(entry[3])
            if from_drainer:
                self._drain_exc = exc
            self._drain_cv.notify_all()

    def _reclaim_staged(self) -> None:
        """Owner-side: return staged slots' buffers to the ring after a
        failure reset, waiting out any copy still reading them (a
        device_put may alias the host buffer zero-copy)."""
        while self._staged:
            _, _, _, slot, buf, staged_bytes = self._staged.popleft()
            slot.settle()
            memory.release_staged(staged_bytes)
            with self._drain_cv:
                self._free.append(buf)
                self._drain_cv.notify_all()

    def _fail_all(self, exc: BaseException) -> None:
        """Device-path error: every open stream receives the exception
        (their partitions re-raise and the executor's retry applies) and
        the owner resets to a clean state for subsequent work."""
        self._drain_failure(exc, from_drainer=False)
        self._fill = 0
        self._segs = []
        self._reclaim_staged()
        if self._cur is None:
            with self._drain_cv:
                if self._free:
                    self._cur = self._free.pop()

    def _abort(self, exc: BaseException) -> None:
        self._fail_all(exc)
        self._stop_drainer()  # in-flight is clear, so it exits promptly
        while True:  # unblock any producer stuck on a full queue
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item[0] == "end":
                with self._lock:
                    self._open -= 1
            elif item[0] == "rows":
                item[1].fail(exc)

    # -- lifecycle ----------------------------------------------------------

    def idle(self) -> bool:
        with self._lock:
            if self._open or self._fill or not self._q.empty():
                return False
        return not (self._staged or self._pending_results())

    def retire_if_idle(self) -> bool:
        """Close admission if the feeder is idle, in the same critical
        section as the check, so a producer either opened its handle first
        (not idle) or finds the feeder closed and opens another: a stream
        is never failed by a cap eviction under it."""
        with self._lock:
            if self._open or self._fill or not self._q.empty():
                return False
            if self._staged or self._pending_results():
                return False
            self._closed = True
        return True

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            t = self._thread
        with self._drain_cv:
            self._drain_cv.notify_all()  # wake buffer/slot/drainer waits
        try:
            self._q.put_nowait(("stop",))
        except queue.Full:
            pass  # owner sees _closed on its next queue timeout
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        # The owner's exit paths stop the drainer themselves; this covers
        # an owner that never started (or died) — close() must never
        # leak the drain thread.
        self._stop_drainer(timeout=timeout)
        self._fail_all(RuntimeError("DeviceFeeder closed"))
        self._clear_gauges()  # owner may never have started; don't rely on it


# -- registry ----------------------------------------------------------------

_feeders: "OrderedDict[tuple, DeviceFeeder]" = OrderedDict()
_feeders_lock = locksmith.lock("sparkdl_tpu_torch/runtime/feeder.py::_feeders_lock")


def get_feeder(device_fn, dispatch_rows, row_shape, dtype, prefetch) -> DeviceFeeder:
    """The process-wide feeder for this (device_fn, batch geometry).
    Entries hold the device_fn itself so the id() in the key can never be
    recycled by a GC'd-and-reallocated callable; least-recently-used IDLE
    feeders beyond the cap are closed (busy ones never are)."""
    key = (
        id(device_fn),
        int(dispatch_rows),
        tuple(int(d) for d in row_shape),
        str(np.dtype(dtype)),
    )
    evicted: List[DeviceFeeder] = []
    with _feeders_lock:
        f = _feeders.get(key)
        if f is not None and f.device_fn is device_fn and not f._closed:
            _feeders.move_to_end(key)
            return f
        f = DeviceFeeder(device_fn, dispatch_rows, row_shape, dtype, prefetch)
        metrics.inc("feeder.opened")
        _feeders[key] = f
        cap = _max_feeders()
        if len(_feeders) > cap:
            for k in list(_feeders):
                if len(_feeders) <= cap:
                    break
                cand = _feeders[k]
                if cand is not f and cand.retire_if_idle():
                    evicted.append(_feeders.pop(k))
    if evicted:
        metrics.inc("feeder.evicted", len(evicted))
    for ev in evicted:
        ev.close(timeout=1.0)
    return f


def shutdown_feeders() -> None:
    """Close every registered feeder (tests / process teardown): a
    shut-down engine leaves no owner or drainer thread behind."""
    with _feeders_lock:
        feeders = list(_feeders.values())
        _feeders.clear()
    for f in feeders:
        f.close()


def close_feeders_for(device_fn) -> int:
    """Close and deregister every feeder stream of ONE device fn — the
    residency manager's eviction hook: a model leaving device memory must
    not keep compiled streams (and, via the registry's strong device_fn
    reference, its params) alive. Returns how many feeders closed."""
    with _feeders_lock:
        doomed = [
            k for k, f in _feeders.items() if f.device_fn is device_fn
        ]
        feeders = [_feeders.pop(k) for k in doomed]
    for f in feeders:
        f.close(timeout=1.0)
    return len(feeders)


# -- the partition-side entry point ------------------------------------------


def run_shared(
    device_fn: Callable,
    cells: Sequence,
    to_batch: Callable,
    batch_size: int,
    prefetch: Optional[int] = None,
    partition=None,
) -> List[Optional[np.ndarray]]:
    """Shared-feeder equivalent of ``run_batched``: same signature shape,
    same per-cell output contract (ndarray rows, None where masked out).

    The calling partition thread stays the host stage: it runs
    ``to_batch`` chunk by chunk, compresses each chunk
    to its valid rows with vectorized masked indexing, and streams them
    into the feeder keyed by the observed row shape — so workloads whose
    row shape varies between chunks (legal on the legacy path, which
    recompiles per shape) transparently use one feeder per shape."""
    return submit_shared(device_fn, cells, to_batch, batch_size, prefetch, partition)()


def submit_shared(
    device_fn: Callable,
    cells: Sequence,
    to_batch: Callable,
    batch_size: int,
    prefetch: Optional[int] = None,
    partition=None,
) -> Callable[[], List[Optional[np.ndarray]]]:
    """The first half of :func:`run_shared`: stream every row into the
    feeders and end this producer's streams, then return a function that
    waits for the rows and returns them. A caller with several groups of
    rows (the text path's length buckets) submits them all before it
    waits on any, so no feeder holds a partial batch for a producer that
    is still busy elsewhere."""
    from sparkdl_tpu_torch.transformers.execution import default_prefetch

    dispatch_rows = batch_size * getattr(device_fn, "batch_multiplier", 1)
    if prefetch is None:
        prefetch = default_prefetch(device_fn)
    n = len(cells)
    out: List[Optional[np.ndarray]] = [None] * n
    if n == 0:
        return lambda: out
    handles: dict = {}
    try:
        for start in range(0, n, dispatch_rows):
            chunk = list(cells[start : start + dispatch_rows])
            t0 = time.perf_counter()
            with span(
                "ingest", batch_start=start, partition=partition, feeder=True
            ) as sp:
                batch, mask = to_batch(chunk)
                valid = np.flatnonzero(mask)
                sp.add(
                    rows=int(len(valid)),
                    bytes=int(getattr(batch, "nbytes", 0)),
                )
            metrics.record_time(
                "transform.host_batch", time.perf_counter() - t0
            )
            if not len(valid):
                continue  # every cell null/undecodable: no device rows
            rows = batch if len(valid) == len(chunk) else batch[valid]
            key = (tuple(rows.shape[1:]), str(rows.dtype))
            handle = handles.get(key)
            if handle is None:
                # LRU eviction can close the feeder between registry
                # lookup and first use; the registry re-creates it, so
                # the race is retryable — under the shared policy (tiny
                # backoff: the closer is another thread mid-close, not a
                # remote system) instead of the old hard-coded 8-loop.
                def _open():
                    feeder = get_feeder(
                        device_fn, dispatch_rows, rows.shape[1:],
                        rows.dtype, prefetch,
                    )
                    return feeder.open_handle(out, partition=partition)

                try:
                    handle = open_handle_policy.call(_open)
                except RuntimeError as e:
                    raise RuntimeError(
                        "could not open a DeviceFeeder handle (feeder "
                        "repeatedly closed under us)"
                    ) from e
                handles[key] = handle
            handle.feeder.submit_rows(handle, start + valid, rows)
    except BaseException as e:
        for h in handles.values():
            h.fail(e)  # wake anything; owner drops our queued rows
        raise
    finally:
        for h in handles.values():
            try:
                h.feeder.finish(h)
            except RuntimeError:
                pass  # feeder closed underneath us; handles already failed

    def wait() -> List[Optional[np.ndarray]]:
        for h in handles.values():
            h.wait()
        return out

    return wait
