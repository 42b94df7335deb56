"""Metrics time series: the sampler that gives signals history, and the
fleet and memory-watermark rings.

A copy of the JAX package's ``obs/timeseries.py``. A
:class:`MetricsSampler` thread snapshots the registry every
``SPARKDL_OBS_SAMPLE_S`` seconds (default 1, ``0`` disables) into bounded
per-metric ring series (``SPARKDL_OBS_SERIES`` points each) and derives
windowed rates:

- every counter (and timer count) gets a ``<name>/s`` series;
- ``feeder.pad_ratio``: pad rows as a share of dispatched rows over the
  window;
- gauges are recorded as they are.

Each sample is also appended to the JSONL event log when
``SPARKDL_OBS_JSONL`` names a file. ``start()``/``stop()`` are
idempotent; ``stop()`` takes one final sample.

Two module-global rings sit beside it: the fused fleet samples the
gateway's fleet scrape appends (``obs/fleet.py``, ``SPARKDL_FLEET_RING``)
and the device-memory watermark advances the memory ledger appends
(``obs/memory.py``, ``SPARKDL_MEM_WATERMARK_RING``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from sparkdl_tpu_torch.runtime import knobs, locksmith
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 720


def sample_interval_s() -> float:
    try:
        return float(knobs.get_float("SPARKDL_OBS_SAMPLE_S"))
    except ValueError:
        return DEFAULT_INTERVAL_S


def series_capacity() -> int:
    try:
        return max(2, knobs.get_int("SPARKDL_OBS_SERIES"))
    except ValueError:
        return DEFAULT_CAPACITY


class MetricsSampler:
    """Background sampler: registry snapshots -> bounded ring series.

    Thread-safe; ``sample_once`` is also directly callable (tests, and
    the ``stop()`` tail sample) with an explicit timestamp."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        interval: Optional[float] = None,
        capacity: Optional[int] = None,
        jsonl_path: Optional[str] = None,
    ):
        self.registry = registry or metrics
        self.interval = (
            float(interval) if interval is not None else sample_interval_s()
        )
        self.capacity = (
            int(capacity) if capacity is not None else series_capacity()
        )
        self.jsonl_path = jsonl_path  # None => SPARKDL_OBS_JSONL per sample
        self._series: Dict[str, deque] = {}
        self._prev_cum: Dict[str, float] = {}
        self._prev_t: Optional[float] = None
        self._lock = locksmith.lock(
            "sparkdl_tpu_torch/obs/timeseries.py::MetricsSampler._lock"
        )
        # Separate lifecycle lock: start() takes a first sample, which
        # needs self._lock — one reentrant-free lock can't cover both.
        self._life_lock = locksmith.lock(
            "sparkdl_tpu_torch/obs/timeseries.py::MetricsSampler._life_lock"
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling -----------------------------------------------------------

    def _append_locked(self, name: str, t: float, v: float) -> None:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = deque(maxlen=self.capacity)
        s.append((t, float(v)))

    def sample_once(self, now: Optional[float] = None) -> dict:
        """Take one sample; returns the event dict (also appended to the
        JSONL log when configured)."""
        t = time.time() if now is None else float(now)
        # scalar_snapshot: no per-timer reservoir sorting under the
        # registry lock — the sampler only consumes scalar values, and it
        # runs every second for the life of the process.
        snap = self.registry.scalar_snapshot()
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        # Cumulative streams: counters plus each timer's event count —
        # one rate rule serves both (batches/s from span timers included).
        cumulative = dict(counters)
        for name, count in snap.get("timer_counts", {}).items():
            cumulative[f"{name}.count"] = float(count)
        rates: Dict[str, float] = {}
        with self._lock:
            dt = (t - self._prev_t) if self._prev_t is not None else None
            for name, v in sorted(cumulative.items()):
                self._append_locked(name, t, v)
                if dt and dt > 0:
                    dv = v - self._prev_cum.get(name, 0.0)
                    rate = max(0.0, dv) / dt
                    rates[f"{name}/s"] = rate
                    self._append_locked(f"{name}/s", t, rate)
            if dt and dt > 0:
                dpad = cumulative.get("feeder.pad_rows", 0.0) - (
                    self._prev_cum.get("feeder.pad_rows", 0.0)
                )
                drows = cumulative.get("feeder.rows", 0.0) - (
                    self._prev_cum.get("feeder.rows", 0.0)
                )
                if dpad + drows > 0:
                    ratio = dpad / (dpad + drows)
                    rates["feeder.pad_ratio"] = ratio
                    self._append_locked("feeder.pad_ratio", t, ratio)
            for name, v in sorted(gauges.items()):
                self._append_locked(name, t, v)
            self._prev_cum = cumulative
            self._prev_t = t
        from sparkdl_tpu_torch.obs import export

        event = {
            "kind": "sample",
            "ts": round(t, 3),
            "counters": counters,
            "gauges": gauges,
            "rates": {k: round(v, 4) for k, v in rates.items()},
        }
        rank = export.obs_rank()
        if rank is not None:
            event["rank"] = rank
        export.append_jsonl(event, self.jsonl_path)
        return event

    # -- lifecycle ----------------------------------------------------------

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "MetricsSampler":
        """Start the background thread (idempotent and race-safe:
        concurrent starts spawn exactly one thread). Takes an immediate
        first sample so the series is never empty while running."""
        with self._life_lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            # Each start gets its OWN stop event, passed to the thread: a
            # stop/start interleaving can then never revive an old thread
            # (its captured event stays set forever).
            stop = self._stop = threading.Event()
            try:
                self.sample_once()
            except Exception:
                pass  # a broken registry must not stop the thread starting
            self._thread = threading.Thread(
                target=self._run,
                args=(stop,),
                name="sparkdl-obs-sampler",
                daemon=True,
            )
            self._thread.start()
        return self

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception:
                pass  # sampling must never kill the thread mid-campaign

    def stop(self) -> None:
        """Stop the thread (idempotent) and take one tail sample so the
        terminal state — cleared gauges, final counters — lands in the
        series even when the last interval tick missed it."""
        with self._life_lock:
            self._stop.set()
            t, self._thread = self._thread, None
        if t is None:
            return
        t.join(timeout=self.interval + 5)
        try:
            self.sample_once()
        except Exception:
            pass

    # -- reading ------------------------------------------------------------

    def series(self) -> Dict[str, List[Tuple[float, float]]]:
        with self._lock:
            return {k: list(v) for k, v in self._series.items()}

    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            s = self._series.get(name)
            return s[-1] if s else None

    def as_dict(self) -> dict:
        """JSON-ready view (the ``/series`` HTTP endpoint payload)."""
        with self._lock:
            return {
                "interval_s": self.interval,
                "capacity": self.capacity,
                "series": {
                    k: [[round(t, 3), v] for t, v in pts]
                    for k, pts in self._series.items()
                },
            }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._prev_cum = {}
            self._prev_t = None


_sampler: Optional[MetricsSampler] = None
_sampler_lock = locksmith.lock(
    "sparkdl_tpu_torch/obs/timeseries.py::_sampler_lock"
)


def get_sampler() -> MetricsSampler:
    """The process-global sampler (created lazily, NOT started)."""
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            _sampler = MetricsSampler()
        return _sampler


def set_sampler(sampler: Optional[MetricsSampler]) -> None:
    global _sampler
    with _sampler_lock:
        _sampler = sampler


def start_sampler() -> Optional[MetricsSampler]:
    """Start the process-global sampler; returns None (and starts
    nothing) when sampling is disabled (``SPARKDL_OBS_SAMPLE_S=0``). An
    idle sampler picks up the current env interval/capacity on restart."""
    if sample_interval_s() <= 0:
        return None
    s = get_sampler()
    if not s.running():
        s.interval = sample_interval_s()
        s.capacity = series_capacity()
    return s.start()


def stop_sampler() -> None:
    with _sampler_lock:
        s = _sampler
    if s is not None:
        s.stop()


# -- fleet-sample ring --------------------------------------------------------
# Bounded history of fused fleet samples (obs/fleet.py appends one per
# scrape cycle), kept module-global (not on the gateway object) so read
# surfaces need no handle on the gateway to render history.

_fleet_ring: deque = deque()
_fleet_ring_lock = locksmith.lock(
    "sparkdl_tpu_torch/obs/timeseries.py::_fleet_ring_lock"
)


def fleet_ring_capacity() -> int:
    try:
        return max(2, knobs.get_int("SPARKDL_FLEET_RING"))
    except ValueError:
        return 360


def fleet_append(sample: dict) -> None:
    """Append one fused fleet sample, evicting oldest past capacity
    (capacity re-read per append so a retuned knob applies live)."""
    cap = fleet_ring_capacity()
    with _fleet_ring_lock:
        _fleet_ring.append(sample)
        while len(_fleet_ring) > cap:
            _fleet_ring.popleft()


def fleet_series() -> List[dict]:
    """Oldest-first copy of the banked fleet samples."""
    with _fleet_ring_lock:
        return list(_fleet_ring)


def fleet_clear() -> None:
    with _fleet_ring_lock:
        _fleet_ring.clear()


# -- memory-watermark ring ----------------------------------------------------
# Bounded history of device-memory watermark advances (obs/memory.py
# appends one sample whenever the device watermark moves up).
# Module-global for the same reason as the fleet ring.

_mem_ring: deque = deque()
_mem_ring_lock = locksmith.lock(
    "sparkdl_tpu_torch/obs/timeseries.py::_mem_ring_lock"
)


def mem_ring_capacity() -> int:
    try:
        return max(2, knobs.get_int("SPARKDL_MEM_WATERMARK_RING"))
    except ValueError:
        return 512


def mem_append(sample: dict) -> None:
    """Append one watermark sample, evicting oldest past capacity
    (capacity re-read per append so a retuned knob applies live)."""
    cap = mem_ring_capacity()
    with _mem_ring_lock:
        _mem_ring.append(sample)
        while len(_mem_ring) > cap:
            _mem_ring.popleft()


def mem_series() -> List[dict]:
    """Oldest-first copy of the banked watermark samples."""
    with _mem_ring_lock:
        return list(_mem_ring)


def mem_clear() -> None:
    with _mem_ring_lock:
        _mem_ring.clear()
