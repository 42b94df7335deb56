"""Process-global runtime metrics: counters, gauges and timers.

The subset of the JAX package's registry that the ported slices record
into, under the same names (``text.*``, ``transform.*``, ``feeder.*``,
``transfer.*``, ``serve.*``, ``gen.*``, ``slo.*``, ``mem.*``, ``util.*``),
and the time-bucketed windows the SLO engine and the utilization ledger
read (:class:`WindowedCounter`, :class:`WindowedReservoir`). Gauges keep their min and max too
(:meth:`MetricsRegistry.gauge_stats`). Timers keep a seeded reservoir of samples,
so their percentiles are exact up to ``RESERVOIR_SIZE`` observations and
a uniform-sample estimate above. Thread-safe: producer, owner, drainer
and serving threads all record.
"""

from __future__ import annotations

import random
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

#: samples kept per timer (the JAX registry's size)
RESERVOIR_SIZE = 512


def percentile_of_sorted(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation percentile (q in [0, 100]) over pre-sorted
    values; 0.0 for none."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q / 100.0 * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclass
class TimerStat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    samples: List[float] = field(default_factory=list, repr=False)
    _rng: Any = field(default=None, repr=False, compare=False)

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        # Algorithm R reservoir, seeded per stat so a replay reproduces
        # its percentiles
        if len(self.samples) < RESERVOIR_SIZE:
            self.samples.append(dt)
            return
        if self._rng is None:
            self._rng = random.Random(0xC0FFEE)
        j = self._rng.randrange(self.count)
        if j < RESERVOIR_SIZE:
            self.samples[j] = dt

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        return percentile_of_sorted(sorted(self.samples), q)

    def as_dict(self) -> dict:
        """The JAX package's timer payload: the reservoir rides along
        (sorted, rounded to 100 ns), so cross-rank tools merge timers by
        resampling (:func:`merge_timer_dicts`)."""
        vals = sorted(self.samples)
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_s": self.mean_s,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "p50_s": percentile_of_sorted(vals, 50),
            "p95_s": percentile_of_sorted(vals, 95),
            "p99_s": percentile_of_sorted(vals, 99),
            "samples": [round(v, 7) for v in vals],
        }


def merge_timer_dicts(dicts: Iterable[dict]) -> dict:
    """Count-weighted combination of :meth:`TimerStat.as_dict` payloads
    (one per rank): counts, totals, min and max exactly; percentiles from
    a count-weighted re-reservoir of the samples, or, where a payload has
    none, a count-weighted mean of the percentiles."""
    dicts = [d for d in dicts if d and d.get("count")]
    total_count = sum(int(d["count"]) for d in dicts)
    if not total_count:
        return {
            "count": 0, "total_s": 0.0, "mean_s": 0.0, "min_s": 0.0,
            "max_s": 0.0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0,
            "samples": [],
        }
    total_s = sum(float(d.get("total_s", 0.0)) for d in dicts)
    out = {
        "count": total_count,
        "total_s": total_s,
        "mean_s": total_s / total_count,
        "min_s": min(float(d.get("min_s", 0.0)) for d in dicts),
        "max_s": max(float(d.get("max_s", 0.0)) for d in dicts),
    }
    if all(d.get("samples") for d in dicts):
        rng = random.Random(0xC0FFEE)
        merged: List[float] = []
        for d in dicts:
            samples = list(d["samples"])
            want = max(1, round(RESERVOIR_SIZE * d["count"] / total_count))
            merged.extend(samples if len(samples) <= want else rng.sample(samples, want))
        if len(merged) > RESERVOIR_SIZE:
            merged = rng.sample(merged, RESERVOIR_SIZE)
        vals = sorted(merged)
        out["samples"] = vals
        for q, key in ((50, "p50_s"), (95, "p95_s"), (99, "p99_s")):
            out[key] = percentile_of_sorted(vals, q)
    else:
        out["samples"] = []
        for key in ("p50_s", "p95_s", "p99_s"):
            out[key] = sum(float(d.get(key, 0.0)) * d["count"] for d in dicts) / total_count
    return out


class WindowedCounter:
    """Time-bucketed event counter: the rolling-window half of the SLO
    engine's burn-rate arithmetic. Events land in ``bucket_s``-wide buckets
    and a read sums the buckets inside the asked-for window, so one
    structure answers both the fast and the slow window. Every method takes
    an explicit ``now`` (``time.monotonic()`` when omitted). Not locked:
    the caller serializes access under its own lock."""

    def __init__(self, horizon_s: float, bucket_s: float):
        self.horizon_s = float(horizon_s)
        self.bucket_s = max(1e-6, float(bucket_s))
        self._buckets: Dict[int, float] = {}

    def _index(self, now: float) -> int:
        return int(now / self.bucket_s)

    def _prune(self, now: float) -> None:
        # whole buckets older than the horizon expire at once
        floor = self._index(now - self.horizon_s)
        for idx in [i for i in self._buckets if i < floor]:
            del self._buckets[idx]

    def add(self, n: float = 1.0, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else float(now)
        self._prune(t)
        idx = self._index(t)
        self._buckets[idx] = self._buckets.get(idx, 0.0) + float(n)

    def total(self, window_s: float, now: Optional[float] = None) -> float:
        """Events in the trailing ``window_s`` (capped at the horizon); a
        bucket counts while any of it overlaps the window."""
        t = time.monotonic() if now is None else float(now)
        self._prune(t)
        floor = self._index(t - min(float(window_s), self.horizon_s))
        return sum(v for i, v in self._buckets.items() if i >= floor)

    def clear(self) -> None:
        self._buckets.clear()


class WindowedReservoir:
    """Timestamped latency samples under the same bucket ring as
    :class:`WindowedCounter`: per-bucket Algorithm R reservoirs, exact
    below ``cap_per_bucket`` observations per bucket and a seeded uniform
    sample above, so a windowed percentile ages out by time. Same ``now``
    and locking contract as :class:`WindowedCounter`."""

    def __init__(self, horizon_s: float, bucket_s: float, cap_per_bucket: int = 128):
        self.horizon_s = float(horizon_s)
        self.bucket_s = max(1e-6, float(bucket_s))
        self.cap = max(1, int(cap_per_bucket))
        #: bucket index -> [count, samples, rng]
        self._buckets: Dict[int, list] = {}

    def _index(self, now: float) -> int:
        return int(now / self.bucket_s)

    def _prune(self, now: float) -> None:
        floor = self._index(now - self.horizon_s)
        for idx in [i for i in self._buckets if i < floor]:
            del self._buckets[idx]

    def note(self, value: float, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else float(now)
        self._prune(t)
        idx = self._index(t)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = [0, [], None]
        b[0] += 1
        if len(b[1]) < self.cap:
            b[1].append(float(value))
            return
        if b[2] is None:
            b[2] = random.Random(0xC0FFEE ^ idx)
        j = b[2].randrange(b[0])
        if j < self.cap:
            b[1][j] = float(value)

    def _window_buckets(self, window_s: float, now: float) -> list:
        self._prune(now)
        floor = self._index(now - min(float(window_s), self.horizon_s))
        return [b for i, b in self._buckets.items() if i >= floor]

    def count(self, window_s: float, now: Optional[float] = None) -> int:
        """Observations in the window (the reservoirs bound memory, not
        the count)."""
        t = time.monotonic() if now is None else float(now)
        return sum(b[0] for b in self._window_buckets(window_s, t))

    def values(self, window_s: float, now: Optional[float] = None) -> List[float]:
        t = time.monotonic() if now is None else float(now)
        return [v for b in self._window_buckets(window_s, t) for v in b[1]]

    def percentile(self, q: float, window_s: float, now: Optional[float] = None) -> Optional[float]:
        """Windowed percentile of the retained samples; None for none."""
        vals = sorted(self.values(window_s, now))
        if not vals:
            return None
        return percentile_of_sorted(vals, q)


class MetricsRegistry:
    """Counters, gauges, and timers keyed by dotted names."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        #: per-gauge [last, min, max], so a burst between two reads shows
        self._gauge_stats: Dict[str, List[float]] = {}
        self._timers: Dict[str, TimerStat] = defaultdict(TimerStat)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        value = float(value)
        with self._lock:
            self._gauges[name] = value
            st = self._gauge_stats.get(name)
            if st is None:
                self._gauge_stats[name] = [value, value, value]
            else:
                st[0], st[1], st[2] = value, min(st[1], value), max(st[2], value)

    def gauge_stats(self, name: str) -> Optional[dict]:
        """``{"last", "min", "max"}`` of one gauge since the last reset, or
        None."""
        with self._lock:
            st = self._gauge_stats.get(name)
            return {"last": st[0], "min": st[1], "max": st[2]} if st else None

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].record(seconds)

    def record_times(self, name: str, seconds_list) -> None:
        """Bulk :meth:`record_time`: one lock acquisition for a group."""
        if not seconds_list:
            return
        with self._lock:
            stat = self._timers[name]
            for s in seconds_list:
                stat.record(s)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def timing(self, name: str) -> Optional[TimerStat]:
        with self._lock:
            return self._timers.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: v.as_dict() for k, v in self._timers.items()},
            }

    def scalar_snapshot(self) -> dict:
        """Counters, gauges and each timer's event count, without the
        timers' reservoirs: what the time-series sampler reads every
        interval."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timer_counts": {k: v.count for k, v in self._timers.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._gauge_stats.clear()
            self._timers.clear()


#: Process-global registry the transformers record into.
metrics = MetricsRegistry()


def _prom_name(name: str) -> str:
    return "sparkdl_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _label_line(line: str, label: str) -> str:
    """One ``key="value"`` label injected into a sample line, merged with
    a label set it already has; comment lines pass through."""
    if line.startswith("#"):
        return line
    name, _, rest = line.partition(" ")
    if name.endswith("}") and "{" in name:
        head, _, tail = name.rpartition("}")
        return f"{head},{label}}}{tail} {rest}"
    return f"{name}{{{label}}} {rest}"


def prometheus_text(registry: Optional[MetricsRegistry] = None,
                    rank: Optional[int] = None) -> str:
    """The registry as Prometheus 0.0.4 text: counters as ``<name>_total``,
    gauges as they are, timers as summaries (p50 and p95 quantiles,
    ``_sum`` in seconds, ``_count``). A ``rank`` stamps every sample line
    with ``rank="N"``, so the gateway's federated ``/metrics`` never
    collides one worker's families with another's."""
    snap = (registry or metrics).snapshot()
    lines = []
    for name, value in sorted(snap["counters"].items()):
        n = _prom_name(name) + "_total"
        lines += [f"# TYPE {n} counter", f"{n} {value}"]
    for name, value in sorted(snap["gauges"].items()):
        n = _prom_name(name)
        lines += [f"# TYPE {n} gauge", f"{n} {value}"]
    for name, t in sorted(snap["timers"].items()):
        n = _prom_name(name) + "_seconds"
        lines += [
            f"# TYPE {n} summary",
            f'{n}{{quantile="0.5"}} {t["p50_s"]}',
            f'{n}{{quantile="0.95"}} {t["p95_s"]}',
            f"{n}_sum {t['total_s']}",
            f"{n}_count {t['count']}",
        ]
    if rank is not None:
        label = f'rank="{int(rank)}"'
        lines = [_label_line(ln, label) for ln in lines]
    return "\n".join(lines) + "\n"
