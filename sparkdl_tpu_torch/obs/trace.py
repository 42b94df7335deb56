"""Per-request tracing: trace ids, the trace store, tail exemplars and
the waterfall.

The port of the JAX package's ``obs/trace.py``:

- the trace id that every serving request carries: minted here, or taken
  from the inbound ``X-Sparkdl-Trace`` header; every hop forwards it and
  every reply (errors included) returns it;
- a request's seven waterfall segments (:data:`SEGMENTS`), which the
  router writes on the :class:`~sparkdl_tpu_torch.serving.request.Request`
  and which sum to its end-to-end latency;
- head sampling (``SPARKDL_TRACE_SAMPLE``, a deterministic coin on the
  trace id, so every process of a gang agrees) and, independently, tail
  exemplars: each successful completion is offered to its class's top-K
  slowest (``SPARKDL_TRACE_EXEMPLARS``), and a promoted one's record is
  pinned in the store, so every tail number in ``/metrics``, ``GET
  /v1/slo`` and an SLO alert resolves to a trace. Failed and expired
  requests always store their record;
- the store (:class:`TraceStore`, ``SPARKDL_TRACE_RING`` ids, pinned ids
  never evicted) holding the worker's records
  (:func:`record_serve_trace`) and the gateway's
  (:func:`record_gateway_trace`, with its attempt ledger); records ride
  the obs snapshot's ``"traces"`` key, so ``obs merge`` and ``obs trace``
  stitch one request across processes (:func:`collect_trace`,
  :func:`render_waterfall`).

The span layer lives in ``obs/spans.py``; :func:`span`,
:func:`active_spans` and :func:`compact_status` are re-exported here for
the call sites that import them from this module. The store's and the
reservoir's locks are leaf locks: nothing is called while one is held.
"""

from __future__ import annotations

import hashlib
import itertools
import re
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from sparkdl_tpu_torch.obs.spans import active_spans, compact_status, span
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


def exemplar_k() -> int:
    return max(1, knobs.get_int("SPARKDL_TRACE_EXEMPLARS"))


class TraceStore:
    """Bounded per-process retention of finished trace records.

    Keyed by trace_id; one id may hold several records (a gateway retry
    that re-lands on the same worker, an error then a re-dispatch).
    Oldest UNPINNED ids fall off beyond capacity; exemplar-pinned ids
    survive eviction (their count is bounded by classes x K), so the
    slow trace a ``/metrics`` exemplar names is still resolvable long
    after the flood that produced it."""

    def __init__(self, capacity: Optional[int] = None):
        # leaf lock by design (metrics-registry discipline): nothing is
        # called while held, so it can never participate in an order cycle
        self._lock = threading.Lock()
        self._capacity = capacity
        self._records: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._pinned: Set[str] = set()

    def _cap(self) -> int:
        return (
            self._capacity
            if self._capacity is not None
            else trace_ring_capacity()
        )

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
        """Release an eviction pin (the trace fell out of its exemplar
        reservoir): the records stay retained but age out of the ring
        like any other id — pins stay bounded by classes x K."""
        with self._lock:
            self._pinned.discard(trace_id)

    def get(self, trace_id: str) -> List[dict]:
        """Records for ``trace_id`` — exact match, or unique-prefix
        (operators paste truncated ids from report lines)."""
        with self._lock:
            if trace_id in self._records:
                return list(self._records[trace_id])
            hits = [
                k for k in self._records if k.startswith(trace_id)
            ]
            if len(hits) == 1:
                return list(self._records[hits[0]])
            return []

    def records(self) -> List[dict]:
        """Every retained record, oldest id first — what rides the obs
        snapshot's ``"traces"`` key."""
        with self._lock:
            return [r for recs in self._records.values() for r in recs]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._pinned.clear()


class ExemplarStore:
    """Top-K slowest (value, trace_id) per metric name — the tail-based
    half of sampling. ``note`` returns True when the observation entered
    the top-K (the caller pins its trace), so "every p99 links to a
    trace" holds by construction: the K slowest completions ever seen
    bound the reservoir's p99 from above."""

    def __init__(self, k: Optional[int] = None):
        self._lock = threading.Lock()  # leaf lock, same discipline
        self._k = k
        self._top: Dict[str, List[Tuple[float, str]]] = {}

    def note(
        self, name: str, value_s: float, trace_id: str
    ) -> Tuple[bool, List[str]]:
        """Offer one observation. Returns ``(promoted, displaced)`` —
        ``displaced`` lists trace ids that just fell OUT of the top-K,
        so the caller can release their store pins (without that, a
        long-lived server with drifting tails would pin every
        record-breaking completion forever and the trace ring would
        grow past its cap)."""
        k = self._k if self._k is not None else exemplar_k()
        with self._lock:
            entries = self._top.setdefault(name, [])
            if len(entries) >= k and value_s <= entries[-1][0]:
                return False, []
            entries.append((float(value_s), trace_id))
            entries.sort(key=lambda e: -e[0])
            dropped = entries[k:]
            del entries[k:]
            kept = {tid for _, tid in entries}
            return True, [
                tid for _, tid in dropped if tid not in kept
            ]

    def exemplar(self, name: str) -> Optional[dict]:
        """The slowest entry for ``name`` (the one a p99 line links),
        or None."""
        with self._lock:
            entries = self._top.get(name)
            if not entries:
                return None
            value_s, tid = entries[0]
            return {"value_s": value_s, "trace_id": tid}

    def snapshot(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {
                name: [
                    {"value_s": v, "trace_id": tid} for v, tid in entries
                ]
                for name, entries in self._top.items()
                if entries
            }

    def clear(self) -> None:
        with self._lock:
            self._top.clear()


_store: Optional[TraceStore] = None
_exemplars: Optional[ExemplarStore] = None
_trace_lock = threading.Lock()


def get_store() -> TraceStore:
    global _store
    with _trace_lock:
        if _store is None:
            _store = TraceStore()
        return _store


def get_exemplars() -> ExemplarStore:
    global _exemplars
    with _trace_lock:
        if _exemplars is None:
            _exemplars = ExemplarStore()
        return _exemplars


def reset() -> None:
    """Drop retained traces + exemplars (tests, bench warmup resets)."""
    get_store().clear()
    get_exemplars().clear()


def _obs_rank() -> Optional[int]:
    # imported at call time: obs/export imports this module
    from sparkdl_tpu_torch.obs.export import obs_rank

    return obs_rank()


def record_serve_trace(
    request, e2e_s: float, status: str = "ok", error: Optional[str] = None
) -> Optional[dict]:
    """Offer one completed serving request to the trace layer (called
    from ``Request`` completion, success and failure paths alike).

    Always: successful completions feed the per-class exemplar
    reservoir. Stored (and counted) only when head-sampled, promoted to
    an exemplar (then PINNED), or failed/expired — the storage policy,
    not the measurement, is what the sample rate dials."""
    tid = getattr(request, "trace_id", None)
    if not tid:
        return None
    promoted = False
    if status == "ok":
        promoted, displaced = get_exemplars().note(
            f"serve.latency.{request.priority}", e2e_s, tid
        )
        if promoted:
            metrics.inc("trace.exemplars")
            for old in displaced:
                get_store().unpin(old)
    sampled = trace_sampled(tid)
    if sampled:
        metrics.inc("trace.sampled")
    if not (sampled or promoted or status != "ok"):
        return None
    segments = {
        name: round(float(getattr(request, "trace_segments", {}).get(name, 0.0)), 6)
        for name in SEGMENTS
    }
    record = {
        "kind": "serve",
        "trace_id": tid,
        "model": request.model,
        "cls": request.priority,
        "rows": int(request.rows),
        "rank": _obs_rank(),
        "start_unix": round(
            float(getattr(request, "enqueue_unix", time.time())), 6
        ),
        "e2e_s": round(float(e2e_s), 6),
        "segments": segments,
        "status": status,
    }
    if error:
        record["error"] = error
    get_store().add(record, pin=promoted)
    metrics.inc("trace.records")
    return record


def record_gateway_trace(
    trace_id: str,
    path: str,
    attempts: List[dict],
    e2e_s: float,
    status: int,
    start_unix: Optional[float] = None,
) -> Optional[dict]:
    """The gateway-side record for one forwarded request. Stored when
    head-sampled, when the request needed more than one attempt (the
    stitched-re-dispatch story IS the record), or when it failed — a
    single clean 200 at a 1% sample rate stays storage-free."""
    keep = (
        trace_sampled(trace_id)
        or len(attempts) > 1
        or int(status) >= 400
    )
    if not keep:
        return None
    record = {
        "kind": "gateway",
        "trace_id": trace_id,
        "path": path,
        "rank": _obs_rank(),
        "start_unix": round(
            float(start_unix if start_unix is not None else time.time()), 6
        ),
        "e2e_s": round(float(e2e_s), 6),
        "attempts": list(attempts),
        "status": int(status),
    }
    get_store().add(record)
    metrics.inc("trace.records")
    if len(attempts) > 1:
        metrics.inc("trace.stitched_attempts", len(attempts) - 1)
    return record


# -- rendering ----------------------------------------------------------------


def collect_trace(
    trace_id: str, snaps: Dict[int, dict]
) -> List[dict]:
    """All records matching ``trace_id`` (exact or unique prefix) across
    per-rank snapshots, each tagged with the lane it came from."""
    matches: List[dict] = []
    candidates: Set[str] = set()
    exact = False
    for rank, snap in snaps.items():
        for rec in snap.get("traces") or []:
            tid = rec.get("trace_id", "")
            if tid == trace_id or tid.startswith(trace_id):
                candidates.add(tid)
                exact = exact or tid == trace_id
                lane = rec.get("rank")
                matches.append(
                    {
                        **rec,
                        "lane": lane if lane is not None else rank,
                        "role": snap.get("role"),
                    }
                )
    if exact:
        # an exact id wins outright: a short honored inbound id must
        # stay queryable even when a longer id shares its prefix
        matches = [m for m in matches if m.get("trace_id") == trace_id]
    elif len(candidates) > 1:
        # ambiguous prefix: refuse to silently merge two requests
        return []
    matches.sort(key=lambda r: r.get("start_unix", 0.0))
    return matches


def _fmt_ms(v: float) -> str:
    return f"{v * 1e3:.2f}ms"


def render_waterfall(trace_id: str, records: List[dict]) -> str:
    """Human-readable per-request waterfall across every process that
    recorded this trace: the gateway's attempt ledger, then each
    worker-side record's seven-segment breakdown with cumulative offsets
    and a proportional bar."""
    if not records:
        return f"trace {trace_id}: no records found"
    full_id = records[0].get("trace_id", trace_id)
    lines = [
        f"trace {full_id} — {len(records)} record(s) across "
        f"{len({r['lane'] for r in records})} process lane(s)"
    ]
    for rec in records:
        lane = rec.get("lane")
        role = rec.get("role") or rec.get("kind")
        if rec.get("kind") == "gateway":
            lines.append(
                f"[gateway lane={lane}] {rec.get('path')} "
                f"status={rec.get('status')} e2e={_fmt_ms(rec['e2e_s'])}"
            )
            for i, att in enumerate(rec.get("attempts") or [], 1):
                lines.append(
                    f"  attempt {i} -> rank {att.get('rank')}: "
                    f"{att.get('dur_ms', 0.0):.2f}ms "
                    f"({att.get('outcome')})"
                )
            continue
        lines.append(
            f"[{role} lane={lane}] model={rec.get('model')} "
            f"cls={rec.get('cls')} rows={rec.get('rows')} "
            f"status={rec.get('status')} e2e={_fmt_ms(rec['e2e_s'])}"
            + (
                f" error={rec['error']}" if rec.get("error") else ""
            )
        )
        segments = rec.get("segments") or {}
        total = max(rec.get("e2e_s", 0.0), 1e-9)
        offset = 0.0
        width = 32
        for name in SEGMENTS:
            dur = float(segments.get(name, 0.0))
            pad = int(round(offset / total * width))
            bar = max(1, int(round(dur / total * width))) if dur > 0 else 0
            lines.append(
                f"  {name:<11} {_fmt_ms(offset):>10} +{_fmt_ms(dur):>10}  "
                f"{' ' * pad}{'#' * bar}"
            )
            offset += dur
        lines.append(
            f"  segments sum {_fmt_ms(offset)} vs e2e "
            f"{_fmt_ms(rec['e2e_s'])}"
        )
    return "\n".join(lines)


__all__ = [
    "ExemplarStore",
    "active_spans",
    "compact_status",
    "span",
    "SEGMENTS",
    "TRACE_HEADER",
    "TraceStore",
    "coerce_trace_id",
    "collect_trace",
    "exemplar_k",
    "get_exemplars",
    "get_store",
    "mint_trace_id",
    "record_gateway_trace",
    "record_serve_trace",
    "render_waterfall",
    "reset",
    "trace_sample_rate",
    "trace_sampled",
    "trace_ring_capacity",
]
