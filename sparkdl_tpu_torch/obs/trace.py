"""Request trace identity, timing spans, and the gateway's trace records.

A trimmed copy of the JAX package's ``obs/trace.py``:

- the trace id that every serving request carries (minted here or taken
  from the inbound ``X-Sparkdl-Trace`` header);
- :func:`span`, which times a block into the metrics registry as
  ``span.<name>`` and lists itself in the open-span table while it runs
  (:func:`active_spans`; a heartbeat's :func:`compact_status` carries it,
  as the JAX package's ``obs/spans.compact_status`` does);
- the gateway's half of the trace store: :class:`TraceStore`
  (:func:`get_store`), the deterministic head-sampling coin
  (:func:`trace_sampled`, ``SPARKDL_TRACE_SAMPLE``) and
  :func:`record_gateway_trace`, the gateway's record of one forwarded
  request with its attempt ledger.

Not ported yet (ROADMAP Queue A item 4.11): the tail exemplars, the
worker-side request records and the per-request waterfall.
"""

from __future__ import annotations

import hashlib
import itertools
import re
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics

#: HTTP header that carries a trace id between hops
TRACE_HEADER = "X-Sparkdl-Trace"

#: a served request's stages, in order, seconds each (``Request.trace_segments``);
#: ``decode`` is the wall of the decode steps a generate request rode, 0
#: for every other request
SEGMENTS = (
    "queue_wait",
    "group_wait",
    "stage_wait",
    "dispatch",
    "decode",
    "drain_wait",
    "scatter",
)

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{4,64}$")

#: a random 8-hex process prefix + a 32-bit sequence: unique for the
#: life of the process at a fraction of uuid4's cost per request
_MINT_PREFIX = uuid.uuid4().hex[:8]
_mint_counter = itertools.count()


def mint_trace_id() -> str:
    """A fresh 16-hex trace id."""
    return f"{_MINT_PREFIX}{next(_mint_counter) & 0xFFFFFFFF:08x}"


def coerce_trace_id(raw: Optional[str]) -> str:
    """The header value when it parses as hex (lowercased, dashes
    stripped), else a freshly minted id."""
    if raw:
        candidate = raw.strip().lower().replace("-", "")
        if _TRACE_ID_RE.match(candidate):
            return candidate
    return mint_trace_id()


class Span:
    """An open span: ``add`` attaches attributes learned inside it."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def add(self, **attrs) -> None:
        self.attrs.update(attrs)


#: the spans open right now: id -> (span, start on the perf clock, thread
#: name); one dict insert and one pop per span (atomic under the GIL)
_open_spans: Dict[int, tuple] = {}
_span_ids = itertools.count()


@contextmanager
def span(name: str, **attrs) -> Iterator[Span]:
    """Time the block on the host clock into ``span.<name>`` (recorded
    whether the block returns or raises)."""
    sp = Span(name, attrs)
    key = next(_span_ids)
    t0 = time.perf_counter()
    _open_spans[key] = (sp, t0, threading.current_thread().name)
    try:
        yield sp
    finally:
        _open_spans.pop(key, None)
        metrics.record_time(f"span.{name}", time.perf_counter() - t0)


def active_spans() -> List[dict]:
    """The spans open across all threads, oldest first: what this
    process is doing right now."""
    now = time.perf_counter()
    out = [
        {
            "name": sp.name,
            "age_s": round(now - t0, 4),
            "thread": thread,
            "attrs": dict(sp.attrs),
        }
        for sp, t0, thread in list(_open_spans.values())
    ]
    out.sort(key=lambda d: -d["age_s"])
    return out


def compact_status(max_spans: int = 8, max_counters: int = 16) -> dict:
    """Small liveness payload for heartbeat beats: the open spans and the
    top counters by value (JAX ``obs/spans.compact_status``)."""
    snap = metrics.snapshot()
    counters = dict(
        sorted(snap["counters"].items(), key=lambda kv: -kv[1])[:max_counters]
    )
    return {"active": active_spans()[:max_spans], "counters": counters}


# -- the gateway's trace records -------------------------------------------------


def trace_sample_rate() -> float:
    """Head-sampling probability (``SPARKDL_TRACE_SAMPLE``, clamped to
    [0, 1])."""
    return min(1.0, max(0.0, knobs.get_float("SPARKDL_TRACE_SAMPLE")))


def trace_sampled(trace_id: str) -> bool:
    """Deterministic head-sampling coin: a pure hash of the trace id
    against the sample rate, so every process of a gang agrees about one
    request without coordination."""
    rate = trace_sample_rate()
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = int.from_bytes(hashlib.sha256(trace_id.encode()).digest()[:8], "big")
    return (h / float(1 << 64)) < rate


def trace_ring_capacity() -> int:
    return max(1, knobs.get_int("SPARKDL_TRACE_RING"))


class TraceStore:
    """Bounded per-process retention of finished trace records.

    Keyed by trace id; one id may hold several records. The oldest
    unpinned ids fall off beyond capacity (``SPARKDL_TRACE_RING``)."""

    def __init__(self, capacity: Optional[int] = None):
        # a leaf lock: nothing is called while it is held
        self._lock = threading.Lock()
        self._capacity = capacity
        self._records: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._pinned: Set[str] = set()

    def _cap(self) -> int:
        return self._capacity if self._capacity is not None else trace_ring_capacity()

    def add(self, record: dict, pin: bool = False) -> None:
        tid = record.get("trace_id")
        if not tid:
            return
        with self._lock:
            self._records.setdefault(tid, []).append(record)
            self._records.move_to_end(tid)
            if pin:
                self._pinned.add(tid)
            cap = self._cap()
            if len(self._records) > cap:
                for key in list(self._records):
                    if len(self._records) <= cap:
                        break
                    if key in self._pinned:
                        continue
                    del self._records[key]

    def pin(self, trace_id: str) -> None:
        with self._lock:
            self._pinned.add(trace_id)

    def unpin(self, trace_id: str) -> None:
        with self._lock:
            self._pinned.discard(trace_id)

    def get(self, trace_id: str) -> List[dict]:
        """Records for ``trace_id``: an exact match, or a unique prefix."""
        with self._lock:
            if trace_id in self._records:
                return list(self._records[trace_id])
            hits = [k for k in self._records if k.startswith(trace_id)]
            if len(hits) == 1:
                return list(self._records[hits[0]])
            return []

    def records(self) -> List[dict]:
        """Every retained record, oldest id first."""
        with self._lock:
            return [r for recs in self._records.values() for r in recs]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._pinned.clear()


_store: Optional[TraceStore] = None
_trace_lock = threading.Lock()


def get_store() -> TraceStore:
    global _store
    with _trace_lock:
        if _store is None:
            _store = TraceStore()
        return _store


def reset() -> None:
    """Drop the retained traces (tests)."""
    get_store().clear()


def record_gateway_trace(
    trace_id: str,
    path: str,
    attempts: List[dict],
    e2e_s: float,
    status: int,
    start_unix: Optional[float] = None,
) -> Optional[dict]:
    """The gateway-side record of one forwarded request. Stored when
    head-sampled, when the request needed more than one attempt (the
    re-dispatch is the record), or when it failed."""
    keep = trace_sampled(trace_id) or len(attempts) > 1 or int(status) >= 400
    if not keep:
        return None
    from sparkdl_tpu_torch.obs.export import obs_rank

    record = {
        "kind": "gateway",
        "trace_id": trace_id,
        "path": path,
        "rank": obs_rank(),
        "start_unix": round(float(start_unix if start_unix is not None else time.time()), 6),
        "e2e_s": round(float(e2e_s), 6),
        "attempts": list(attempts),
        "status": int(status),
    }
    get_store().add(record)
    metrics.inc("trace.records")
    if len(attempts) > 1:
        metrics.inc("trace.stitched_attempts", len(attempts) - 1)
    return record


__all__ = [
    "SEGMENTS",
    "TRACE_HEADER",
    "Span",
    "TraceStore",
    "active_spans",
    "coerce_trace_id",
    "compact_status",
    "get_store",
    "mint_trace_id",
    "record_gateway_trace",
    "reset",
    "span",
    "trace_ring_capacity",
    "trace_sample_rate",
    "trace_sampled",
]
