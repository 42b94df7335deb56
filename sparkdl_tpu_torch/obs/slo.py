"""Live SLO engine: burn-rate alerts over the serving request stream.

The port of the JAX package's ``obs/slo.py``, with its names, knobs,
arithmetic and payloads. It answers what an operator pages on: is the
server meeting its latency and availability targets now, and how fast is
it burning the error budget?

- **Objectives per SLA class**, from knobs: ``SPARKDL_SLO_AVAIL[_<CLASS>]``
  (an availability target; failures, expiries and admission rejections
  spend the ``1 - target`` budget) and ``SPARKDL_SLO_P95_MS[_<CLASS>]`` (a
  latency target; a completion slower than it spends the 5% tail budget a
  p95 objective implies). Unset, the class is unarmed and the hooks cost
  two knob reads per event.
- **Two windows**: outcomes land in time-bucketed windows
  (``utils/metrics.WindowedCounter`` and ``WindowedReservoir``). Burn
  rate = (bad fraction over the window) / budget. A trip needs the fast
  window (``SPARKDL_SLO_FAST_S``, default 60 s) to burn at
  ``SPARKDL_SLO_BURN_FAST`` (default 14) and the slow window
  (``SPARKDL_SLO_SLOW_S``, default 1 h) at ``SPARKDL_SLO_BURN_SLOW``, over
  at least ``SPARKDL_SLO_MIN_REQUESTS`` fast-window events.
- **Sticky trips**: a trip writes a ``{"kind": "slo_alert"}`` JSONL event
  (``obs/export.append_jsonl``) naming the class, the objective, both
  windows and burn rates, sets the ``slo.alert.<class>`` gauge to 1 and
  bumps ``slo.trips.<class>``. It clears only when a later evaluation
  finds the condition false, with a ``{"kind": "slo_recovery"}`` event and
  ``slo.recoveries.<class>``.

Evaluation runs on every completion or failure (at most every 1/8 of the
fast window) and on every read (``GET /v1/slo``, ``Router.stats()``), so
a quiet server recovers as soon as anyone looks.

Not ported yet (ROADMAP Queue A item 4.11, the trace store): the JAX alert
names the class's current tail-exemplar trace ids and flushes the flight
recorder (``dump_on_failure``). Here the alert's ``exemplar_trace_ids``
is ``[]`` and nothing is dumped.

One plain leaf lock guards the windows and the trip state; events and
gauges are emitted after it is released.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import WindowedCounter, WindowedReservoir, metrics

#: the SLA classes the engine windows: ``serving/request.PRIORITY_CLASSES``,
#: not imported, so that obs stays importable below serving
CLASSES = ("interactive", "batch", "background")

#: bad-event kinds the availability objective counts; ``rejected`` is
#: admission shedding (429). Draining 503s never spend budget.
BAD_KINDS = ("failure", "expired", "rejected")

#: the error budget a p95 objective implies: 5% may exceed it
P95_BUDGET = 0.05


def _per_class_float(base: str, cls: str) -> Optional[float]:
    """The per-class override, then the base knob, else None (unarmed). An
    override that is set wins: an explicit ``0`` disarms that class under a
    global target."""
    for name in (f"{base}_{cls.upper()}", base):
        if knobs.get_raw(name) in (None, ""):
            continue
        v = knobs.get_float(name)
        return v if v else None
    return None


def slo_avail_target(cls: str) -> Optional[float]:
    """The availability objective of ``cls`` in (0, 1), or None; a value
    outside (0, 1) raises."""
    v = _per_class_float("SPARKDL_SLO_AVAIL", cls)
    if v is None:
        return None
    if not 0.0 < v < 1.0:
        raise ValueError(f"SPARKDL_SLO_AVAIL for {cls!r} must be in (0, 1), got {v}")
    return v


def slo_p95_target_s(cls: str) -> Optional[float]:
    """The latency objective of ``cls`` in seconds, or None."""
    v = _per_class_float("SPARKDL_SLO_P95_MS", cls)
    return v / 1e3 if v else None


def fast_window_s() -> float:
    return max(0.1, knobs.get_float("SPARKDL_SLO_FAST_S"))


def slow_window_s() -> float:
    """The slow window, at least the fast one."""
    return max(fast_window_s(), knobs.get_float("SPARKDL_SLO_SLOW_S"))


def burn_fast_threshold() -> float:
    return max(0.0, knobs.get_float("SPARKDL_SLO_BURN_FAST"))


def burn_slow_threshold() -> float:
    return max(0.0, knobs.get_float("SPARKDL_SLO_BURN_SLOW"))


def min_requests() -> int:
    return max(1, knobs.get_int("SPARKDL_SLO_MIN_REQUESTS"))


def slo_armed(cls: str) -> bool:
    """Whether any objective is set for ``cls``: the hooks' fast exit. A
    malformed knob counts as armed, so that it surfaces at evaluation."""
    try:
        return slo_avail_target(cls) is not None or slo_p95_target_s(cls) is not None
    except ValueError:
        return True


def _rounded(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}


class _ClassState:
    """One SLA class's windows and sticky trip state."""

    __slots__ = ("ok", "bad", "slow", "latency", "tripped", "trip_info")

    def __init__(self, horizon_s: float, bucket_s: float):
        self.ok = WindowedCounter(horizon_s, bucket_s)
        self.bad = WindowedCounter(horizon_s, bucket_s)
        #: ok completions over the latency target (a failure spends the
        #: availability budget, never both)
        self.slow = WindowedCounter(horizon_s, bucket_s)
        self.latency = WindowedReservoir(horizon_s, bucket_s)
        self.tripped = False
        self.trip_info: Optional[dict] = None


class SloEngine:
    """Burn-rate evaluator over the serving stream. ``note_ok`` and
    ``note_bad`` are the ingest hooks (request completion, the router's
    admission rejections); ``status()`` is the read surface. The window
    geometry is fixed at construction; targets and thresholds are read at
    each evaluation, so they can be retuned live."""

    def __init__(self, now: Optional[float] = None):
        self.fast_s = fast_window_s()
        self.slow_s = slow_window_s()
        # a quarter of the fast window: the fast read tracks "now", and an
        # hour-long slow window stays at about 240 buckets
        self.bucket_s = self.fast_s / 4.0
        self._lock = threading.Lock()
        self._classes: Dict[str, _ClassState] = {
            cls: _ClassState(self.slow_s, self.bucket_s) for cls in CLASSES
        }
        self._last_eval = (time.monotonic() if now is None else float(now)) - self.fast_s
        self._eval_every = max(0.02, self.fast_s / 8.0)

    # -- ingest ---------------------------------------------------------------

    def note_ok(self, cls: str, latency_s: float, now: Optional[float] = None) -> None:
        """One successful completion: good for availability, good or slow
        against the latency target. Unknown classes are ignored."""
        if cls not in self._classes:
            return
        t = time.monotonic() if now is None else float(now)
        target = slo_p95_target_s(cls)
        with self._lock:
            st = self._classes[cls]
            st.ok.add(1, now=t)
            st.latency.note(latency_s, now=t)
            if target is not None and latency_s > target:
                st.slow.add(1, now=t)
        self._maybe_evaluate(t)

    def note_bad(self, cls: str, kind: str, now: Optional[float] = None) -> None:
        """One availability-spending event (``BAD_KINDS``)."""
        if cls not in self._classes:
            return
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._classes[cls].bad.add(1, now=t)
        self._maybe_evaluate(t)

    # -- evaluation -----------------------------------------------------------

    @staticmethod
    def _burn(bad: float, total: float, budget: float) -> Optional[float]:
        """Bad fraction over budget; None with no traffic (silence is not
        an outage)."""
        if total <= 0 or budget <= 0:
            return None
        return (bad / total) / budget

    def _objectives_locked(self, cls: str, now: float) -> List[dict]:
        st = self._classes[cls]
        out: List[dict] = []
        ok_f = st.ok.total(self.fast_s, now=now)
        ok_s = st.ok.total(self.slow_s, now=now)
        bad_f = st.bad.total(self.fast_s, now=now)
        bad_s = st.bad.total(self.slow_s, now=now)
        avail = slo_avail_target(cls)
        if avail is not None:
            budget = 1.0 - avail
            out.append({
                "objective": "availability",
                "target": avail,
                "budget": budget,
                "fast_events": ok_f + bad_f,
                "burn_fast": self._burn(bad_f, ok_f + bad_f, budget),
                "burn_slow": self._burn(bad_s, ok_s + bad_s, budget),
            })
        target_s = slo_p95_target_s(cls)
        if target_s is not None:
            obj = {
                "objective": "latency_p95",
                "target_ms": round(target_s * 1e3, 3),
                "budget": P95_BUDGET,
                "fast_events": ok_f,
                "burn_fast": self._burn(st.slow.total(self.fast_s, now=now), ok_f, P95_BUDGET),
                "burn_slow": self._burn(st.slow.total(self.slow_s, now=now), ok_s, P95_BUDGET),
            }
            p95 = st.latency.percentile(95, self.fast_s, now=now)
            if p95 is not None:
                obj["observed_p95_ms"] = round(p95 * 1e3, 3)
            out.append(obj)
        return out

    def _maybe_evaluate(self, now: float) -> None:
        with self._lock:
            if now - self._last_eval < self._eval_every:
                return
        self.evaluate(now=now)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass: every class's burns, trip and recovery transitions,
        their events (after the lock). Returns the status payload."""
        t = time.monotonic() if now is None else float(now)
        fast_thr = burn_fast_threshold()
        slow_thr = burn_slow_threshold()
        floor = min_requests()
        status: Dict[str, dict] = {}
        transitions: List[dict] = []
        with self._lock:
            self._last_eval = t
            for cls, st in self._classes.items():
                if not slo_armed(cls):
                    if st.tripped:
                        # a tripped class was disarmed: clear it, naming why
                        st.tripped = False
                        info = st.trip_info or {"cls": cls}
                        st.trip_info = None
                        transitions.append({"event": "recovery", **info, "reason": "disarmed"})
                    continue
                objectives = self._objectives_locked(cls, t)
                worst = None
                condition = False
                for obj in objectives:
                    bf, bs = obj["burn_fast"], obj["burn_slow"]
                    obj["tripping"] = (
                        bf is not None and bs is not None and bf >= fast_thr
                        and bs >= slow_thr and obj["fast_events"] >= floor
                    )
                    condition = condition or obj["tripping"]
                    if bf is not None and (worst is None or bf > worst["burn_fast"]):
                        worst = obj
                if condition and not st.tripped:
                    st.tripped = True
                    hot = next(o for o in objectives if o["tripping"])
                    st.trip_info = {
                        "cls": cls,
                        "objective": hot["objective"],
                        "burn_fast": hot["burn_fast"],
                        "burn_slow": hot["burn_slow"],
                        "fast_window_s": self.fast_s,
                        "slow_window_s": self.slow_s,
                        "burn_fast_threshold": fast_thr,
                        "burn_slow_threshold": slow_thr,
                    }
                    transitions.append({"event": "trip", **st.trip_info})
                elif st.tripped and not condition:
                    st.tripped = False
                    info = st.trip_info or {"cls": cls}
                    st.trip_info = None
                    transitions.append({
                        "event": "recovery", **info,
                        "burn_fast_now": worst["burn_fast"] if worst else None,
                    })
                status[cls] = {
                    "tripped": st.tripped,
                    "objectives": [_rounded(obj) for obj in objectives],
                }
        for tr in transitions:
            self._emit_transition(tr)
        # every armed class publishes its gauge on every evaluation: a
        # healthy class reads 0 rather than being absent
        for cls, st in status.items():
            metrics.gauge(f"slo.alert.{cls}", 1 if st["tripped"] else 0)
        return {
            "armed": bool(status),
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
            "classes": status,
        }

    def status(self, now: Optional[float] = None) -> dict:
        """Evaluate and read: the payload of ``GET /v1/slo`` and of
        ``Router.stats()["slo"]``."""
        return self.evaluate(now=now)

    def window_totals(self, now: Optional[float] = None) -> dict:
        """Raw per-class window counts (``GET /v1/slo``'s ``windows``)."""
        t = time.monotonic() if now is None else float(now)
        out: Dict[str, dict] = {}
        with self._lock:
            for cls, st in self._classes.items():
                out[cls] = {
                    "ok_fast": st.ok.total(self.fast_s, now=t),
                    "bad_fast": st.bad.total(self.fast_s, now=t),
                    "slow_fast": st.slow.total(self.fast_s, now=t),
                    "ok_slow": st.ok.total(self.slow_s, now=t),
                    "bad_slow": st.bad.total(self.slow_s, now=t),
                    "slow_slow": st.slow.total(self.slow_s, now=t),
                }
        return out

    def tripped(self, cls: str) -> bool:
        with self._lock:
            st = self._classes.get(cls)
            return bool(st and st.tripped)

    # -- transitions (outside the engine lock) ---------------------------------

    @staticmethod
    def _emit_transition(tr: dict) -> None:
        from sparkdl_tpu_torch.obs.export import append_jsonl

        cls = tr["cls"]
        fields = _rounded({k: v for k, v in tr.items() if k != "event"})
        if tr["event"] == "trip":
            metrics.gauge(f"slo.alert.{cls}", 1)
            metrics.inc(f"slo.trips.{cls}")
            append_jsonl({
                "kind": "slo_alert", "ts": round(time.time(), 3), **fields,
                "exemplar_trace_ids": [],
            })
        else:
            metrics.gauge(f"slo.alert.{cls}", 0)
            metrics.inc(f"slo.recoveries.{cls}")
            append_jsonl({"kind": "slo_recovery", "ts": round(time.time(), 3), **fields})


_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> SloEngine:
    """The process-global engine, created at the window geometry of the
    moment (resize the windows, then :func:`reset`)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SloEngine()
        return _engine


def reset() -> None:
    """Drop every window and trip; a tripped class's gauge goes back to 0."""
    global _engine
    with _engine_lock:
        old, _engine = _engine, None
    if old is not None:
        for cls in CLASSES:
            if old.tripped(cls):
                metrics.gauge(f"slo.alert.{cls}", 0)


def note_ok(cls: str, latency_s: float, now: Optional[float] = None) -> None:
    """The completion hook: a no-op until an objective arms ``cls``. A
    malformed knob is swallowed here (this runs inside ``set_result``,
    before waiters wake) and raised on the read surfaces instead."""
    try:
        if slo_armed(cls):
            get_engine().note_ok(cls, latency_s, now=now)
    except ValueError:
        pass


def note_bad(cls: str, kind: str, now: Optional[float] = None) -> None:
    try:
        if slo_armed(cls):
            get_engine().note_bad(cls, kind, now=now)
    except ValueError:
        pass


def engine_status() -> Optional[dict]:
    """The status when any class is armed, else None."""
    if not any(slo_armed(cls) for cls in CLASSES):
        return None
    return get_engine().status()


def window_totals() -> Optional[dict]:
    """The per-class window counts when any class is armed, else None."""
    if not any(slo_armed(cls) for cls in CLASSES):
        return None
    return get_engine().window_totals()


__all__ = [
    "BAD_KINDS",
    "CLASSES",
    "P95_BUDGET",
    "SloEngine",
    "burn_fast_threshold",
    "burn_slow_threshold",
    "engine_status",
    "fast_window_s",
    "get_engine",
    "min_requests",
    "note_bad",
    "note_ok",
    "reset",
    "slo_armed",
    "slo_avail_target",
    "slo_p95_target_s",
    "slow_window_s",
    "window_totals",
]
