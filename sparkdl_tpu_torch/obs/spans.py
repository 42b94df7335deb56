"""Nestable, thread-safe spans with attributes, feeding a bounded ring.

The port of the JAX package's ``obs/spans.py``. A span is one timed
region of a path (``executor.partition``, ``worker.partition``, the
feeder's ``feeder.dispatch``, the router's ``serve.dispatch``,
``serve.model_load``, ...) with free-form attributes. Spans nest per
thread: each thread keeps its own stack, so a child's ``parent_id``
names the innermost open span of its own thread.

Closing a span records it in three places:

- the metrics registry's ``span.<name>`` timer (and ``span.<name>.rows``
  / ``.bytes`` counters when the span carries ``rows`` / ``bytes``), the
  aggregate view the chip script and ``/metrics`` read;
- the ring of closed spans (``SPARKDL_OBS_RING`` deep, oldest dropped),
  which the flight recorder dumps on a failure (``obs/export.py``) and the
  Chrome trace renders;
- while it is open, the open-span table (:func:`active_spans`), which a
  heartbeat's :func:`compact_status` carries.

``SPARKDL_OBS=0`` makes :func:`span` a shared no-op: nothing is
recorded, the timers included. Start times are anchored once per process
to ``time.time``, so the spans of a gang's processes line up on one
timeline to within clock skew.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics

# Process-wide anchor: wall time of the perf_counter epoch, fixed at
# import so every span's start_unix is consistent within the process.
_ANCHOR_UNIX = time.time() - time.perf_counter()


def obs_enabled() -> bool:
    return knobs.get_flag("SPARKDL_OBS")


def ring_capacity() -> int:
    return max(1, knobs.get_int("SPARKDL_OBS_RING"))


@dataclass
class SpanRecord:
    """One closed span, as it sits in the ring buffer."""

    name: str
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    thread_name: str
    start_pc: float  # perf_counter at __enter__
    dur_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def start_unix(self) -> float:
        return _ANCHOR_UNIX + self.start_pc

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread_id": self.thread_id,
            "thread_name": self.thread_name,
            "start_unix": self.start_unix,
            "dur_s": self.dur_s,
            "attrs": self.attrs,
        }


class SpanRecorder:
    """Bounded ring buffer of closed spans + registry of open ones.

    Thread-safe throughout: partition threads, the batch producer, the
    heartbeat thread, and the H2D thread pool all record concurrently.
    The open-span registry exists so liveness tooling (heartbeat beats)
    can report *what a thread is doing right now*, not just what it
    finished."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity or ring_capacity())
        self._open: Dict[int, SpanRecord] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- span lifecycle (called by the ``span`` context manager) ------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, attrs: Dict[str, Any]) -> SpanRecord:
        t = threading.current_thread()
        stack = self._stack()
        rec = SpanRecord(
            name=name,
            span_id=next(self._ids),
            parent_id=stack[-1].span_id if stack else None,
            thread_id=t.ident or 0,
            thread_name=t.name,
            start_pc=time.perf_counter(),
            attrs=attrs,
        )
        stack.append(rec)
        with self._lock:
            self._open[rec.span_id] = rec
        return rec

    def close(self, rec: SpanRecord) -> None:
        rec.dur_s = time.perf_counter() - rec.start_pc
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        else:  # out-of-order exit (generator misuse): drop from wherever
            try:
                stack.remove(rec)
            except ValueError:
                pass
        with self._lock:
            self._open.pop(rec.span_id, None)
            self._ring.append(rec)
        # Aggregate view: spans double as registry timers so the cheap
        # always-on counters and the ring buffer can never disagree.
        metrics.record_time(f"span.{rec.name}", rec.dur_s)
        rows = rec.attrs.get("rows")
        if rows:
            metrics.inc(f"span.{rec.name}.rows", float(rows))
        nbytes = rec.attrs.get("bytes")
        if nbytes:
            metrics.inc(f"span.{rec.name}.bytes", float(nbytes))

    # -- reading ------------------------------------------------------------

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def open_spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._open.values())

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()


_recorder: Optional[SpanRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    """The process-global recorder (capacity read from the env on first
    use; tests swap it with :func:`set_recorder`)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = SpanRecorder()
        return _recorder


def set_recorder(recorder: Optional[SpanRecorder]) -> None:
    global _recorder
    with _recorder_lock:
        _recorder = recorder


class _Span:
    """Context manager for one recorded span. ``attrs`` may be extended
    mid-span via :meth:`add` (e.g. row counts known only after batching)."""

    __slots__ = ("_name", "_attrs", "_rec", "_recorder")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self._name = name
        self._attrs = attrs
        self._rec: Optional[SpanRecord] = None
        self._recorder: Optional[SpanRecorder] = None

    def add(self, **attrs) -> "_Span":
        if self._rec is not None:
            # Atomic dict swap, never in-place mutation: concurrent
            # readers (active_spans / dump_on_failure snapshotting open
            # spans) see either the old or the new attrs, and can never
            # hit "dictionary changed size during iteration".
            self._rec.attrs = {**self._rec.attrs, **attrs}
        else:
            self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._recorder = get_recorder()
        self._rec = self._recorder.open(self._name, self._attrs)
        return self

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            if exc and exc[0] is not None and "error" not in self._rec.attrs:
                # same atomic-swap discipline as add()
                self._rec.attrs = {
                    **self._rec.attrs,
                    "error": exc[0].__name__,
                }
            self._recorder.close(self._rec)


class _NoopSpan:
    """Shared do-nothing span for SPARKDL_OBS=0 paths."""

    __slots__ = ()

    def add(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span named ``name`` with initial attributes.

    Usage::

        with span("ingest", partition=i) as sp:
            batch, mask = to_batch(chunk)
            sp.add(rows=int(mask.sum()), bytes=batch.nbytes)
    """
    if not obs_enabled():
        return _NOOP
    return _Span(name, attrs)


def active_spans(recorder: Optional[SpanRecorder] = None) -> List[dict]:
    """The currently-open spans across all threads, oldest first —
    "what is this process doing right now"."""
    now = time.perf_counter()
    recorder = recorder or get_recorder()
    out = [
        {
            "name": rec.name,
            "age_s": round(now - rec.start_pc, 4),
            "thread": rec.thread_name,
            "attrs": dict(rec.attrs),
        }
        for rec in recorder.open_spans()
    ]
    out.sort(key=lambda d: -d["age_s"])
    return out


def compact_status(max_spans: int = 8, max_counters: int = 16) -> dict:
    """Small (<~1 KB) liveness payload for heartbeat beats: the open
    spans plus the top counters BY VALUE (row/byte totals dominate, and
    those are the "what was this rank chewing on" signal). Bounded so a
    beat file never balloons; the full picture lives in the ring-buffer
    snapshot."""
    snap = metrics.snapshot()
    counters = dict(
        sorted(snap["counters"].items(), key=lambda kv: -kv[1])[
            :max_counters
        ]
    )
    return {
        "active": active_spans()[:max_spans],
        "counters": counters,
    }


__all__ = [
    "SpanRecord",
    "SpanRecorder",
    "active_spans",
    "compact_status",
    "get_recorder",
    "obs_enabled",
    "ring_capacity",
    "set_recorder",
    "span",
]
