"""Runtime lock sanitizer: order-recording proxies for the port's locks.

A copy of the JAX package's ``runtime/locksmith.py``. With
``SPARKDL_LOCK_SANITIZER=1`` (default off: the proxies cost a few dict
operations per acquisition, so the hot path stays plain), every lock
created through :func:`lock` / :func:`rlock` / :func:`condition` becomes
a proxy that records, per acquisition:

- the **observed held-before edge** (the lock at the top of this
  thread's held stack -> the lock being acquired). An edge that closes a
  cycle is reported at once (the ``locks.cycles`` counter and the cycle
  path): an ABBA order the run went through, caught before the
  interleaving that would deadlock.
- **held-too-long**: a lock held longer than ``SPARKDL_LOCK_HELD_MS`` at
  release is recorded (``locks.held_too_long``). ``Condition.wait``
  releases the lock, so wait loops never read as long holds.

:func:`report` publishes the counters, appends one ``{"kind": "locks"}``
event to the JSONL log, and returns the observed graph.
:func:`cross_check` compares the observed edges with a given static
held-before edge set (its transitive closure: a runtime edge is legal if
the static graph implies it). The port has no static analyzer of its
own; the caller supplies the edges.

Names are ``sparkdl_tpu_torch/<rel>::<name>`` or
``sparkdl_tpu_torch/<rel>::<Class>.<attr>``: the JAX package's names
with the package's own prefix, so one order maps onto the other by
replacing the prefix. Instance locks of one class share a name on
purpose: the hierarchy is per class, not per object.

Not proxied: the metrics-registry lock (a leaf acquired under nearly
everything), the obs leaf locks and stdlib-internal locks. The knob is
read at lock **creation**, so the sanitizer must be on before the
process builds the objects under test.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from sparkdl_tpu_torch.runtime import knobs


def sanitizer_enabled() -> bool:
    """``SPARKDL_LOCK_SANITIZER`` — default off; read at lock creation."""
    return knobs.get_flag("SPARKDL_LOCK_SANITIZER")


def held_threshold_s() -> float:
    """``SPARKDL_LOCK_HELD_MS`` (default 500): a lock released after a
    longer hold is recorded as held-too-long."""
    return max(0.0, knobs.get_float("SPARKDL_LOCK_HELD_MS")) / 1e3


class _Tracker:
    """Process-global observed-graph state. Internally uses a RAW
    threading.Lock — the tracker must never recurse into itself — and
    only touches the (unproxied) metrics registry, so recording can
    never re-enter a tracked acquisition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: per-thread held stacks, keyed by thread id and kept HERE (not
        #: in a threading.local) so a lock handed across threads —
        #: acquired on one, released on another, which threading.Lock
        #: permits — can still pop the ACQUIRER's entry instead of
        #: leaving it to poison every later edge from that thread.
        self._stacks: Dict[int, list] = {}
        #: (src, dst) -> count
        self.edges: Dict[Tuple[str, str], int] = {}
        self.cycles: List[List[str]] = []
        self._cycle_keys: Set[frozenset] = set()
        self.held_too_long: List[dict] = []
        self.acquisitions = 0

    # -- recording -----------------------------------------------------------

    def note_acquired(self, name: str, tid: Optional[int] = None) -> int:
        """Record an acquisition on this thread; returns the tid the
        matching release must name (the proxy remembers it)."""
        from sparkdl_tpu_torch.utils.metrics import metrics

        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            stack = self._stacks.setdefault(tid, [])
            new_edge = None
            if stack:
                top = stack[-1][0]
                if top != name:  # same-name nesting: reentrant or
                    # cross-instance — instance-collapsed nodes can't
                    # distinguish, skip it, as the JAX package does
                    new_edge = (top, name)
            stack.append((name, time.perf_counter()))
            self.acquisitions += 1
            if new_edge is not None and new_edge not in self.edges:
                self.edges[new_edge] = 0
                cycle = self._cycle_closed_locked(*new_edge)
                if cycle is not None:
                    key = frozenset(cycle)
                    if key not in self._cycle_keys:
                        self._cycle_keys.add(key)
                        self.cycles.append(cycle)
                        metrics.inc("locks.cycles")
            if new_edge is not None:
                self.edges[new_edge] += 1
                metrics.gauge("locks.edges_observed", len(self.edges))
        return tid

    def _cycle_closed_locked(
        self, src: str, dst: str
    ) -> Optional[List[str]]:
        """Does dst reach src over the observed edges? (The new
        src->dst edge then closes a cycle.) Returns the path."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        seen = {dst}
        path = {dst: None}
        frontier = [dst]
        while frontier:
            node = frontier.pop()
            for nxt in adj.get(node, ()):
                if nxt in seen:
                    continue
                seen.add(nxt)
                path[nxt] = node
                if nxt == src:
                    out = [src]
                    cur = path[src]
                    while cur is not None:
                        out.append(cur)
                        cur = path[cur]
                    out.reverse()
                    return out  # dst ... src (the back path)
                frontier.append(nxt)
        return None

    def note_released(self, name: str, tid: Optional[int] = None) -> None:
        from sparkdl_tpu_torch.utils.metrics import metrics

        if tid is None:
            tid = threading.get_ident()
        t0 = None
        with self._lock:
            stack = self._stacks.get(tid, [])
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    t0 = stack.pop(i)[1]
                    break
        if t0 is None:
            return  # release with no tracked acquire: nothing to attribute
        held = time.perf_counter() - t0
        if held > held_threshold_s():
            with self._lock:
                self.held_too_long.append(
                    {
                        "lock": name,
                        "held_s": round(held, 4),
                        "thread": threading.current_thread().name,
                    }
                )
            metrics.inc("locks.held_too_long")

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "acquisitions": self.acquisitions,
                "edges": sorted(self.edges),
                "edge_counts": {
                    f"{a} -> {b}": n for (a, b), n in sorted(
                        self.edges.items()
                    )
                },
                "cycles": [list(c) for c in self.cycles],
                "held_too_long": list(self.held_too_long),
            }

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.edges.clear()
            self.cycles.clear()
            self._cycle_keys.clear()
            self.held_too_long.clear()
            self.acquisitions = 0


_tracker = _Tracker()


class LockProxy:
    """Transparent stand-in for ``threading.Lock``/``RLock`` that
    records order and hold time. Context-manager, ``acquire(blocking,
    timeout)``, ``release``, ``locked`` — the full surface the runtime
    uses."""

    def __init__(self, name: str, inner=None, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        self._inner = inner if inner is not None else (
            threading.RLock() if reentrant else threading.Lock()
        )
        self._owner_tid: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner_tid = _tracker.note_acquired(self.name)
        return got

    def release(self) -> None:
        # name the ACQUIRER's stack: threading.Lock may legally be
        # released by a different thread than took it
        _tracker.note_released(self.name, self._owner_tid)
        self._inner.release()

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        # RLock grows .locked() only in 3.14; probe non-blocking. For
        # the probing thread itself a held RLock still reads unlocked
        # (reentrant acquire succeeds) — same answer a real "can I
        # take it" check would give.
        if inner.acquire(blocking=False):
            inner.release()
            return False
        return True

    def __enter__(self) -> "LockProxy":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ConditionProxy:
    """Order-recording ``threading.Condition``. ``wait``/``wait_for``
    release the lock for their duration — the tracker pops the hold (so
    a drainer parked in a wait loop never reads as a long hold) and
    re-records the acquisition on wakeup (re-checking order against
    whatever else the thread still holds)."""

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Condition(threading.Lock())

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _tracker.note_acquired(self.name)
        return got

    def release(self) -> None:
        # conditions are only ever released by their holder
        _tracker.note_released(self.name)
        self._inner.release()

    def __enter__(self) -> "ConditionProxy":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        _tracker.note_released(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _tracker.note_acquired(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _tracker.note_released(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _tracker.note_acquired(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def lock(name: str):
    """A named lock: plain ``threading.Lock`` unless the sanitizer is
    enabled at creation time. ``name``: ``<rel>::<name>`` or
    ``<rel>::<Class>.<attr>``."""
    if not sanitizer_enabled():
        return threading.Lock()
    return LockProxy(name)


def rlock(name: str):
    if not sanitizer_enabled():
        return threading.RLock()
    return LockProxy(name, reentrant=True)


def condition(name: str):
    """A named condition over its own (tracked) lock."""
    if not sanitizer_enabled():
        return threading.Condition(threading.Lock())
    return ConditionProxy(name)


# -- reading / verification ---------------------------------------------------


def observed_edges() -> Set[Tuple[str, str]]:
    return set(_tracker.snapshot()["edges"])


def observed_cycles() -> List[List[str]]:
    return [list(c) for c in _tracker.snapshot()["cycles"]]


def reset() -> None:
    """Clear the observed graph (tests)."""
    _tracker.reset()


def report(jsonl: bool = True) -> dict:
    """Snapshot of the observed lock behavior; appended to the obs
    JSONL event log as ``{"kind": "locks"}`` when configured."""
    snap = _tracker.snapshot()
    event = {
        "kind": "locks",
        "ts": round(time.time(), 3),
        "acquisitions": snap["acquisitions"],
        "edges": [f"{a} -> {b}" for (a, b) in snap["edges"]],
        "cycles": snap["cycles"],
        "held_too_long": snap["held_too_long"],
    }
    if jsonl:
        try:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl(event)
        except Exception:
            pass  # reporting must never break the run it observes
    return snap


def cross_check(static_edges: Set[Tuple[str, str]]) -> List[str]:
    """Observed edges absent from ``static_edges``' transitive closure:
    each one an order the static graph does not allow (or a lock named
    out of agreement with it)."""
    adj: Dict[str, Set[str]] = {}
    for a, b in static_edges:
        adj.setdefault(a, set()).add(b)

    reach_cache: Dict[str, Set[str]] = {}

    def reach(a: str) -> Set[str]:
        if a in reach_cache:
            return reach_cache[a]
        seen: Set[str] = set()
        frontier = [a]
        while frontier:
            node = frontier.pop()
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        reach_cache[a] = seen
        return seen

    problems = []
    for a, b in sorted(observed_edges()):
        if b not in reach(a):
            problems.append(
                f"runtime lock edge {a} -> {b} is absent from the "
                "static held-before graph"
            )
    return problems


__all__ = [
    "ConditionProxy",
    "LockProxy",
    "condition",
    "cross_check",
    "held_threshold_s",
    "lock",
    "observed_cycles",
    "observed_edges",
    "report",
    "reset",
    "rlock",
    "sanitizer_enabled",
]
