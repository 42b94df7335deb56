"""Process-global runtime metrics: counters, gauges and timers.

The subset of the JAX package's registry that the ported slices record
into, under the same names (``text.tokens``, ``text.pad_tokens``,
``text.pad_ratio``, ``text.bucket_rows.<edge>``, ``text.truncated_rows``,
``transform.*``). Thread-safe: the batch producer thread records too.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict


@dataclass
class TimerStat:
    count: int = 0
    total_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt

    def as_dict(self) -> dict:
        return {"count": self.count, "total_s": self.total_s}


class MetricsRegistry:
    """Counters, gauges, and timers keyed by dotted names."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, TimerStat] = defaultdict(TimerStat)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].record(seconds)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

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
            self._timers.clear()


#: Process-global registry the transformers record into.
metrics = MetricsRegistry()
