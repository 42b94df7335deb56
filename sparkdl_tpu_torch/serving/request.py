"""Online request objects and the class-aware admission queue.

The port of the JAX package's ``serving/request.py``. The serving layer's
unit of work is a :class:`Request`: a few rows for one model, tagged with
an SLA class and an optional deadline. Three classes, strictest first:

- ``interactive``: a user is waiting; latency is the product;
- ``batch``: programmatic callers that still want an answer soon;
- ``background``: backfills and rescores that care about throughput.

Admission is strict priority with aging: the queue serves the lowest
effective class first, where a request's class improves by one level per
``SPARKDL_SERVE_AGING_S`` seconds queued, so ``background`` waits at most
about ``classes * aging_s`` under sustained ``interactive`` load.

Flow control is part of admission: the queue holds at most
``SPARKDL_SERVE_QUEUE_CAP`` queued rows, and a submit beyond that is
rejected at once (:class:`AdmissionRejected`, ``serve.rejected``). A
request whose deadline passes while queued is failed at pop time with
:class:`DeadlineExceeded` (``serve.expired``), so the device never spends a
batch on an answer nobody waits for.

Completion is future-shaped: the router calls ``req.set_result`` /
``req.set_error`` and callers block in ``req.result(timeout)``. Every
completion records ``serve.latency.<class>`` (submit to result, queue wait
included: the number an SLA is written against).

A generate request (``mode="generate"``) also carries its sampling
parameters, its prompt length and its KV-cache reservation, released once
by whichever path completes it, and a token mailbox: the generation
engine pushes each token as it lands (:meth:`Request.push_token`) and a
streaming caller reads them (:meth:`Request.iter_tokens`).

Completions feed the SLO engine (``obs/slo.py``): a result is a good
event (and a slow one past the class's p95 objective), a failure or an
expiry a bad one; a shutdown spends nothing. A request that a canary
split routed (``canary_arm``) records its latency and failures per arm
(``serve.canary.*``, ``serve.primary.*``). Every completion, success
and failure alike, is offered to the trace layer
(``obs/trace.record_serve_trace``): the class's tail exemplars, and the
request's record when it is head-sampled, promoted or failed.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.obs import slo
from sparkdl_tpu_torch.obs.trace import SEGMENTS, mint_trace_id, record_serve_trace
from sparkdl_tpu_torch.runtime import knobs, locksmith
from sparkdl_tpu_torch.utils.metrics import metrics, percentile_of_sorted

#: SLA classes, strictest first; index = base priority (lower serves first).
PRIORITY_CLASSES = ("interactive", "batch", "background")

_req_ids = itertools.count()

#: Last-N completion latencies per class: the router's batch-window
#: feedback. A bounded recent window, not the lifetime timer, so cold-start
#: model loads age out of the signal.
_RECENT_WINDOW = 128
_recent_latency: Dict[str, "deque"] = {
    cls: deque(maxlen=_RECENT_WINDOW) for cls in PRIORITY_CLASSES
}


def recent_p95_s(priority: str) -> Optional[float]:
    """p95 over the last ``_RECENT_WINDOW`` completions of this class
    (None before any)."""
    vals = sorted(_recent_latency[priority])
    if not vals:
        return None
    return percentile_of_sorted(vals, 95)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before a result could be produced."""


class AdmissionRejected(RuntimeError):
    """The admission queue is at capacity; the request was never queued."""


class Draining(RuntimeError):
    """The worker is draining: admission is closed while queued and
    in-flight work completes (HTTP 503 with ``Retry-After``, where
    :class:`AdmissionRejected` is 429)."""


class Closed(Draining):
    """The router is closed or closing: the request was refused, or
    failed before it ran. Answered as a draining worker answers (503 with
    ``Retry-After``), so a gateway re-dispatches it to another worker; the
    JAX package answers 500 here."""


def aging_s() -> float:
    """Seconds of queue age that promote a request one class level
    (``SPARKDL_SERVE_AGING_S``, default 5; <=0 disables aging)."""
    return knobs.get_float("SPARKDL_SERVE_AGING_S")


def queue_cap_rows() -> int:
    """Admission bound in ROWS (``SPARKDL_SERVE_QUEUE_CAP``, default
    4096): rows, not requests, so one giant background submit cannot
    squeeze out a thousand single-row interactive ones."""
    return max(1, knobs.get_int("SPARKDL_SERVE_QUEUE_CAP"))


class Request:
    """One admitted unit of serving work.

    ``payload`` is a (rows, *row_shape) array; multi-row submits are one
    admission and completion unit. ``deadline_s`` is a RELATIVE budget at
    construction, converted to an absolute monotonic deadline."""

    __slots__ = (
        "id", "model", "payload", "priority", "deadline_at", "mode",
        "enqueue_t", "enqueue_unix", "dequeue_t", "ordinal", "canary_arm", "precision", "precision_armed",
        "trace_id", "trace_segments", "gen_params", "prompt_len", "kv_bytes",
        "_event", "_outputs", "_error", "_kv_release", "_token_q",
    )

    def __init__(
        self,
        model: str,
        payload: np.ndarray,
        priority: str = "batch",
        deadline_s: Optional[float] = None,
        mode: str = "features",
        trace_id: Optional[str] = None,
    ):
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"Unknown priority class {priority!r}; expected one of "
                f"{PRIORITY_CLASSES}"
            )
        payload = np.asarray(payload)
        if payload.ndim < 1 or payload.shape[0] < 1:
            raise ValueError(
                "Request payload must be a (rows, ...) array with >= 1 row"
            )
        self.id = next(_req_ids)
        #: per-router admission ordinal (set at submit)
        self.ordinal = self.id
        self.model = model
        self.payload = payload
        self.priority = priority
        self.deadline_at = (
            time.monotonic() + float(deadline_s) if deadline_s is not None else None
        )
        self.mode = mode
        #: 'canary' | 'primary' when a canary split applied to this
        #: request's model (the router sets it at submit), else None
        self.canary_arm: Optional[str] = None
        #: the precision rung this request serves at (the router sets it
        #: at submit from SPARKDL_SERVE_PRECISION[_<CLASS>]); part of the
        #: grouping key
        self.precision: str = "f32"
        #: whether the per-rung serve.precision.<rung>.* metrics record
        self.precision_armed: bool = False
        self.trace_id: str = trace_id or mint_trace_id()
        #: the stages' seconds (obs/trace.py SEGMENTS), written by the router
        self.trace_segments: Dict[str, float] = {s: 0.0 for s in SEGMENTS}
        #: when the admission queue released this request to the dispatcher
        self.dequeue_t: Optional[float] = None
        self.enqueue_t = time.monotonic()
        #: the admission's wall-clock stamp (a trace record's start)
        self.enqueue_unix = time.time()
        #: generate only: max_new_tokens, temperature, top_k, eos_id, seed
        #: (validated and filled by the router at submit)
        self.gen_params: Optional[Dict[str, Any]] = None
        #: generate only: the prompt's token count
        self.prompt_len: int = 0
        #: generate only: the KV-cache bytes reserved at admission
        self.kv_bytes: int = 0
        self._event = threading.Event()
        self._outputs: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        #: the router's release of this request's KV reservation: run once,
        #: by whichever path completes the request
        self._kv_release: Optional[Callable[[], None]] = None
        #: generate only: (token, index) pairs as they land, then None
        self._token_q: Optional["queue.Queue"] = (
            queue.Queue() if mode == "generate" else None
        )

    @property
    def rows(self) -> int:
        return int(self.payload.shape[0])

    @property
    def class_index(self) -> int:
        return PRIORITY_CLASSES.index(self.priority)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline_at is not None and (
            now if now is not None else time.monotonic()
        ) >= self.deadline_at

    def effective_priority(self, now: float, aging: float) -> float:
        """Base class index minus the aging credit: the sort key the
        admission queue serves in ascending order."""
        if aging <= 0:
            return float(self.class_index)
        return self.class_index - (now - self.enqueue_t) / aging

    # -- completion (router side) -------------------------------------------

    def _record_latency(self) -> None:
        dt = time.monotonic() - self.enqueue_t
        metrics.record_time(f"serve.latency.{self.priority}", dt)
        _recent_latency[self.priority].append(dt)
        if self.canary_arm is not None:
            metrics.record_time(f"serve.{self.canary_arm}.latency", dt)
        if self.precision_armed:
            metrics.record_time(f"serve.precision.{self.precision}.latency", dt)
        # the trace layer: the class's tail exemplars always, the record
        # when head-sampled or promoted (obs/trace.py owns the policy)
        record_serve_trace(self, dt)
        slo.note_ok(self.priority, dt)

    def set_result(self, outputs: np.ndarray) -> None:
        if self._event.is_set():
            return
        self._outputs = outputs
        self._record_latency()
        metrics.inc("serve.completed")
        self._complete()

    def set_error(self, exc: BaseException, count_failure: bool = True) -> None:
        """Fail the request. ``serve.failures`` means the serving path
        broke; deadline expiry has its own counter (``serve.expired``) and
        shutdown passes ``count_failure=False``."""
        if self._event.is_set():
            return
        self._error = exc
        expired = isinstance(exc, DeadlineExceeded)
        if count_failure and not expired:
            metrics.inc("serve.failures")
            if self.canary_arm is not None:
                metrics.inc(f"serve.{self.canary_arm}.failures")
        if count_failure:
            # one availability debit either way; a shutdown spends nothing
            slo.note_bad(self.priority, "expired" if expired else "failure")
            # a failed or expired request always stores its trace
            record_serve_trace(
                self, time.monotonic() - self.enqueue_t,
                status="expired" if expired else "error",
                error=f"{type(exc).__name__}: {exc}",
            )
        self._complete()

    def _complete(self) -> None:
        """Release the KV reservation, so that it is back before any
        waiter wakes, then wake the waiters and end the token stream."""
        self.release_kv()
        self._event.set()
        if self._token_q is not None:
            self._token_q.put(None)

    def release_kv(self) -> None:
        """Run the KV-release hook, at most once over the request's life
        (also called by the router when a reserved submit fails)."""
        release, self._kv_release = self._kv_release, None
        if release is not None:
            release()

    # -- streamed tokens (generate mode) -------------------------------------

    def push_token(self, token: int, index: int) -> None:
        """Engine side: publish one new token (``index``: its 0-based place
        among the new tokens). A no-op for other modes and once the request
        completed."""
        if self._token_q is not None and not self._event.is_set():
            self._token_q.put((int(token), int(index)))

    def iter_tokens(self, timeout: Optional[float] = None) -> Iterator[Tuple[int, int]]:
        """Caller side: yield ``(token, index)`` as the engine emits them,
        until the request completes; then re-raise its failure, as
        :meth:`result` would. ``timeout`` bounds the wait for EACH token
        (a stall bound, not a total budget)."""
        if self._token_q is None:
            raise ValueError("iter_tokens is only available for mode='generate' requests")
        while True:
            try:
                item = self._token_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.id} ({self.model}): no token within {timeout}s"
                ) from None
            if item is None:
                break
            yield item
        if self._error is not None:
            raise self._error

    # -- waiting (caller side) ----------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the router fulfils this request; re-raises its
        failure (device error, deadline expiry)."""
        if not self._event.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.id} ({self.model}/{self.priority}) still "
                f"pending after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._outputs


class AdmissionQueue:
    """Bounded, class-aware request queue: strict priority with aging.

    One FIFO deque per class keeps pops O(classes): within a class, age
    (and thus effective priority) is monotonic, so each class's BEST
    candidate is always its head and the queue only compares the three
    heads. ``put`` enforces the row capacity; ``pop`` fails expired
    requests instead of returning them."""

    def __init__(
        self,
        cap_rows: Optional[int] = None,
        aging_s_override: Optional[float] = None,
    ):
        self._cv = locksmith.condition("sparkdl_tpu_torch/serving/request.py::AdmissionQueue._cv")
        self._queues: Dict[str, List[Request]] = {
            cls: [] for cls in PRIORITY_CLASSES
        }
        self._rows = 0
        self._puts = 0  # admission generation: see put_generation()
        self._cap_rows = cap_rows
        self._aging = aging_s_override
        self._closed = False
        self._draining = False

    def _cap(self) -> int:
        return self._cap_rows if self._cap_rows is not None else queue_cap_rows()

    def _aging_s(self) -> float:
        return self._aging if self._aging is not None else aging_s()

    def depth(self) -> int:
        """Queued requests (all classes)."""
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def depth_rows(self) -> int:
        """Queued ROWS — the adaptive batcher's load signal."""
        with self._cv:
            return self._rows

    def put_generation(self) -> int:
        """Monotonic admission count. The router's batch-window loop
        polls this instead of re-scanning the queue every tick: no new
        put since the last scan means pop_matching cannot find anything
        new."""
        with self._cv:
            return self._puts

    def put(self, req: Request) -> None:
        """Admit or reject; never blocks. Raises
        :class:`AdmissionRejected` at capacity (and counts it) — shedding
        at admission keeps queueing delay bounded for everyone already
        admitted."""
        with self._cv:
            if self._closed:
                raise Closed("AdmissionQueue is closed")
            if self._draining:
                metrics.inc("serve.draining_rejects")
                raise Draining(
                    "admission is draining: queued and in-flight "
                    "requests are completing, no new work is accepted"
                )
            if self._rows + req.rows > self._cap():
                metrics.inc("serve.rejected")
                metrics.inc(f"serve.rejected.{req.priority}")
                raise AdmissionRejected(
                    f"admission queue at capacity ({self._rows} rows "
                    f"queued, cap {self._cap()}); request of {req.rows} "
                    "rows rejected"
                )
            req.enqueue_t = time.monotonic()
            req.enqueue_unix = time.time()
            self._queues[req.priority].append(req)
            self._rows += req.rows
            self._puts += 1
            metrics.inc("serve.admitted")
            metrics.inc(f"serve.requests.{req.priority}")
            metrics.gauge("serve.queue_depth", self._rows)
            self._cv.notify()

    def _pop_best_locked(self, now: float) -> Optional[Request]:
        aging = self._aging_s()
        best_cls, best_score = None, None
        for cls in PRIORITY_CLASSES:  # ties resolve strictest-first
            q = self._queues[cls]
            if not q:
                continue
            score = q[0].effective_priority(now, aging)
            if best_score is None or score < best_score:
                best_cls, best_score = cls, score
        if best_cls is None:
            return None
        req = self._queues[best_cls].pop(0)
        self._rows -= req.rows
        metrics.gauge("serve.queue_depth", self._rows)
        return req

    def pop(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Next request by effective priority, or None on timeout/close.
        Expired requests are failed here (``serve.expired``) and never
        returned — their rows free capacity immediately."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                now = time.monotonic()
                req = self._pop_best_locked(now)
                if req is not None:
                    if req.expired(now):
                        metrics.inc("serve.expired")
                        req.set_error(
                            DeadlineExceeded(
                                f"request {req.id} ({req.model}/"
                                f"{req.priority}) expired after "
                                f"{now - req.enqueue_t:.3f}s in queue"
                            )
                        )
                        continue
                    req.dequeue_t = now  # queue_wait's far edge
                    return req
                if self._closed:
                    return None
                wait = 0.1
                if deadline is not None:
                    wait = min(wait, deadline - now)
                    if wait <= 0:
                        return None
                self._cv.wait(timeout=wait)

    def pop_matching(self, pred, max_rows: int) -> List[Request]:
        """Drain additional queued requests satisfying ``pred`` (same
        model/geometry stream), best-effort and non-blocking, stopping
        before exceeding ``max_rows`` total. The router's group-assembly
        primitive: it respects class order within the matching set (the
        effective-priority sort), so a full batch under load is built
        from the most urgent matching requests. One O(n) scan + sort of
        the MATCHES + one rebuild per touched class — no per-pick
        ``list.remove``."""
        out: List[Request] = []
        taken = 0
        with self._cv:
            now = time.monotonic()
            aging = self._aging_s()
            matches = [
                r for q in self._queues.values() for r in q if pred(r)
            ]
            if not matches:
                return out
            matches.sort(
                key=lambda r: (r.effective_priority(now, aging), r.id)
            )
            removed = set()
            expired: List[Request] = []
            for req in matches:
                if req.expired(now):
                    removed.add(req.id)
                    expired.append(req)
                    continue
                if taken + req.rows > max_rows:
                    continue
                removed.add(req.id)
                req.dequeue_t = now  # queue_wait's far edge
                out.append(req)
                taken += req.rows
                if taken >= max_rows:
                    break
            if removed:
                for cls in PRIORITY_CLASSES:
                    q = self._queues[cls]
                    if any(r.id in removed for r in q):
                        self._queues[cls] = [
                            r for r in q if r.id not in removed
                        ]
                self._rows -= sum(r.rows for r in out) + sum(
                    r.rows for r in expired
                )
            metrics.gauge("serve.queue_depth", self._rows)
        for req in expired:
            metrics.inc("serve.expired")
            req.set_error(
                DeadlineExceeded(
                    f"request {req.id} ({req.model}/{req.priority}) "
                    f"expired in queue"
                )
            )
        return out

    def drain(self) -> None:
        """Flip to draining: every later :meth:`put` raises
        :class:`Draining` (503 at the HTTP layer) while ``pop`` /
        ``pop_matching`` keep serving what was already admitted — the
        accepted-work half of graceful shutdown. Monotonic and
        idempotent; ``close()`` still applies afterwards for the
        fail-what-remains path."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def close(self, exc: Optional[BaseException] = None) -> None:
        """Stop admitting; fail everything still queued (with ``exc`` or
        a generic shutdown error) so no caller blocks forever."""
        with self._cv:
            self._closed = True
            drained = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._rows = 0
            metrics.gauge("serve.queue_depth", 0)
            self._cv.notify_all()
        err = exc if exc is not None else Closed("serving shut down")
        for req in drained:
            req.set_error(err, count_failure=exc is not None)


__all__ = [
    "AdmissionQueue",
    "AdmissionRejected",
    "Closed",
    "DeadlineExceeded",
    "Draining",
    "PRIORITY_CLASSES",
    "Request",
    "aging_s",
    "queue_cap_rows",
    "recent_p95_s",
]
