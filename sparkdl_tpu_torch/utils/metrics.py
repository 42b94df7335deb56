"""Process-global runtime metrics: counters, gauges and timers.

The subset of the JAX package's registry that the ported slices record
into, under the same names (``text.*``, ``transform.*``, ``feeder.*``,
``transfer.*``, ``serve.*``, ``gen.*``). Gauges keep their min and max too
(:meth:`MetricsRegistry.gauge_stats`). Timers keep a seeded reservoir of samples,
so their percentiles are exact up to ``RESERVOIR_SIZE`` observations and
a uniform-sample estimate above. Thread-safe: producer, owner, drainer
and serving threads all record.
"""

from __future__ import annotations

import random
import re
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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
    samples: List[float] = field(default_factory=list, repr=False)
    _rng: Any = field(default=None, repr=False, compare=False)

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
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

    def percentile(self, q: float) -> float:
        return percentile_of_sorted(sorted(self.samples), q)

    def as_dict(self) -> dict:
        vals = sorted(self.samples)
        return {
            "count": self.count,
            "total_s": self.total_s,
            "p50_s": percentile_of_sorted(vals, 50),
            "p95_s": percentile_of_sorted(vals, 95),
        }


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


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as Prometheus 0.0.4 text: counters as ``<name>_total``,
    gauges as they are, timers as summaries (p50 and p95 quantiles,
    ``_sum`` in seconds, ``_count``)."""
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
    return "\n".join(lines) + "\n"
