"""Device-memory ledger: what the serving path put on the card, and the
allocator's own count beside it.

The port of the JAX package's ``obs/memory.py``, with its names, metrics,
events and payloads. Every class of bytes the runtime knowingly places
on the device is attributed here, and the ledger is reconciled against
the allocator, so the gap between the two is a metric of its own.

- **Attribution**: resident parameters per model (residency load and
  evict), staged H2D input batches (the feeder's staging path), D2H
  readback buffers (the drain), and the generation engine's ``kv_cache``
  class (charged at slot assignment, freed when the sequence retires),
  summed with a running **watermark**. Counters
  ``mem.alloc_bytes_total.<class>`` / ``mem.free_bytes_total.<class>``,
  gauges ``mem.device_bytes.<device>``, ``mem.watermark_bytes.<device>``
  and ``mem.model_bytes.<name>``.
- **Reconciliation**: ground truth is ``torch.cuda.memory_allocated`` on
  CUDA (:func:`ground_truth_bytes`); ``mem.unattributed_bytes`` is ground
  truth minus tracked. What the allocator holds outside the ledger's
  classes lands there: activations in flight, each thread's cuBLAS
  workspace, the staging ring. On the CPU there is no probe: ground truth
  is None and no gap is published. The JAX package sizes
  ``jax.live_arrays()`` there; the port has no counterpart, and a test
  passes its own probe to :class:`MemoryLedger` instead. Residency feeds
  the bytes measured across a model's first load back into its budget and
  publishes ``mem.estimate_error.<name>``.
- **OOM forensics**: an allocation failure (``torch.cuda.OutOfMemoryError``,
  or the residency manager's budget refusal) during load, admission or
  dispatch calls :func:`record_oom`, which writes a ``{"kind": "oom"}``
  JSONL event with the per-model table, the watermarks and the last
  allocation events of a bounded ring (``SPARKDL_MEM_RING``).
- **Leak detection**: every evict checks that ground truth went back to
  its value before the load, within ``SPARKDL_MEM_LEAK_TOL_MB`` (the
  ledger itself returns exactly, by construction); a residue bumps
  ``mem.leaked_bytes`` and writes a ``{"kind": "mem_leak"}`` event. What
  outlives every model must exist before that baseline: a load makes
  sure the launch thread's cuBLAS workspaces exist first
  (``runtime/device.warm_launcher``).

Not ported: the JAX ledger's watermark history ring (``obs/timeseries.py``,
ROADMAP Queue A item 8) and the flight-recorder dump on an OOM (item
4.11), and the JAX ledger's mesh widths: every program of the port runs
on one device, accounted as device 0, and the JAX allocation events'
``width`` field is left out.
One plain leaf lock guards the tables; probes, registry writes and events
happen outside it.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics

#: substrings that mark an allocation failure in an error's text: the
#: allocators' phrasings and the residency manager's budget refusal (an
#: admitted OOM: the budget said no before the device could)
OOM_MARKERS = ("out of memory", "Out of memory", "OutOfMemory", "HBM budget")

#: the allocation-ring tail an ``{"kind": "oom"}`` event carries
OOM_RING_TAIL = 32

Probe = Callable[[], Tuple[Optional[int], Optional[str]]]


def mem_ring_capacity() -> int:
    """Allocation-event ring depth (``SPARKDL_MEM_RING``)."""
    try:
        return max(8, knobs.get_int("SPARKDL_MEM_RING"))
    except ValueError:
        return 256


def leak_tolerance_bytes() -> int:
    """Ground-truth slack an evict may leave before it counts as a leak
    (``SPARKDL_MEM_LEAK_TOL_MB``, default 8)."""
    try:
        mb = knobs.get_float("SPARKDL_MEM_LEAK_TOL_MB")
    except ValueError:
        return 8 * 2**20
    if mb is None or mb != mb or mb < 0:
        return 8 * 2**20
    return int(mb * 2**20)


def ground_truth_bytes() -> Tuple[Optional[int], Optional[str]]:
    """(bytes the CUDA caching allocator holds in live tensors, summed
    over the devices, ``"memory_allocated"``), or (None, None) without a
    CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    total = sum(torch.cuda.memory_allocated(d) for d in range(torch.cuda.device_count()))
    return int(total), "memory_allocated"


def is_oom_error(err: BaseException) -> bool:
    """Whether ``err`` is an allocation failure worth forensics:
    ``torch.cuda.OutOfMemoryError``, ``MemoryError``, or an error whose text
    carries an ``OOM_MARKERS`` entry (the residency budget refusal)."""
    import torch

    if isinstance(err, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    text = f"{type(err).__name__}: {err}"
    return any(marker in text for marker in OOM_MARKERS)


class _DeviceMem:
    __slots__ = ("resident", "staged_bytes", "readback_bytes", "kv_bytes", "watermark")

    def __init__(self):
        self.resident: Dict[str, int] = {}
        self.staged_bytes = 0
        self.readback_bytes = 0
        self.kv_bytes = 0
        self.watermark = 0

    def total(self) -> int:
        return sum(self.resident.values()) + self.staged_bytes + self.readback_bytes + self.kv_bytes


class MemoryLedger:
    """Tracked bytes on the device with a watermark and a bounded ring of
    allocation events. Every method takes an explicit ``now`` for tests;
    the registry counters move by the ledger's own increments. ``probe``:
    the ground-truth source (:func:`ground_truth_bytes` by default)."""

    def __init__(self, probe: Optional[Probe] = None):
        self._probe: Probe = probe or ground_truth_bytes
        self._lock = threading.Lock()
        #: device 0's tables, created by the first note (``status`` lists
        #: no device before it)
        self._dev: Optional[_DeviceMem] = None
        self._ring: deque = deque()
        self._leaked_bytes = 0
        self._leak_events = 0
        self._oom_events = 0
        self._last_truth: Tuple[Optional[int], Optional[str]] = (None, None)

    def ground_truth(self) -> Tuple[Optional[int], Optional[str]]:
        return self._probe()

    # -- locked primitives ----------------------------------------------------

    def _touch_locked(self) -> _DeviceMem:
        if self._dev is None:
            self._dev = _DeviceMem()
        return self._dev

    def _ring_locked(self, cap: int, event: dict) -> None:
        self._ring.append(event)
        while len(self._ring) > cap:
            self._ring.popleft()

    def _totals_locked(self) -> Tuple[int, int]:
        if self._dev is None:
            return 0, 0
        return self._dev.total(), self._dev.watermark

    @staticmethod
    def _publish(total: int, watermark: int) -> None:
        metrics.gauge("mem.device_bytes.0", total)
        metrics.gauge("mem.watermark_bytes.0", watermark)

    # -- ingest: resident parameters -------------------------------------------

    def note_model_loaded(self, name: str, nbytes: int,
                          estimate_bytes: Optional[int] = None,
                          now: Optional[float] = None) -> None:
        """A model became resident, ``nbytes`` on the device.
        ``estimate_bytes``: the estimate a measured charge replaced
        (published as ``mem.estimate_error.<name>``)."""
        t = time.time() if now is None else float(now)
        nbytes = max(0, int(nbytes))
        cap = mem_ring_capacity()
        with self._lock:
            st = self._touch_locked()
            st.resident[name] = st.resident.get(name, 0) + nbytes
            st.watermark = max(st.watermark, st.total())
            total, wm, model_total = st.total(), st.watermark, st.resident[name]
            self._ring_locked(cap, {"ts": round(t, 3), "op": "model_load", "model": name,
                                    "bytes": nbytes})
        self._publish(total, wm)
        metrics.gauge(f"mem.model_bytes.{name}", model_total)
        metrics.inc("mem.alloc_bytes_total.model", nbytes)
        if estimate_bytes is not None:
            metrics.gauge(f"mem.estimate_error.{name}", nbytes - int(estimate_bytes))

    def note_model_evicted(self, name: str, nbytes: int,
                           now: Optional[float] = None) -> None:
        """The matching release, with the charge noted at load."""
        t = time.time() if now is None else float(now)
        nbytes = max(0, int(nbytes))
        cap = mem_ring_capacity()
        with self._lock:
            st = self._touch_locked()
            model_total = max(0, st.resident.get(name, 0) - nbytes)
            if model_total:
                st.resident[name] = model_total
            else:
                st.resident.pop(name, None)
            total, wm = st.total(), st.watermark
            self._ring_locked(cap, {"ts": round(t, 3), "op": "model_evict", "model": name,
                                    "bytes": nbytes})
        self._publish(total, wm)
        metrics.gauge(f"mem.model_bytes.{name}", model_total)
        metrics.inc("mem.free_bytes_total.model", nbytes)

    # -- ingest: transfer buffers and the K/V cache ------------------------------

    def _note_transfer(self, cls: str, op: str, nbytes: int, sign: int,
                       now: Optional[float]) -> None:
        t = time.time() if now is None else float(now)
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        cap = mem_ring_capacity()
        with self._lock:
            st = self._touch_locked()
            if cls == "staged":
                st.staged_bytes = max(0, st.staged_bytes + sign * nbytes)
            elif cls == "kv_cache":
                st.kv_bytes = max(0, st.kv_bytes + sign * nbytes)
            else:
                st.readback_bytes = max(0, st.readback_bytes + sign * nbytes)
            st.watermark = max(st.watermark, st.total())
            total, wm = st.total(), st.watermark
            self._ring_locked(cap, {"ts": round(t, 3), "op": op, "bytes": nbytes})
        self._publish(total, wm)
        metrics.inc(
            f"mem.alloc_bytes_total.{cls}" if sign > 0 else f"mem.free_bytes_total.{cls}",
            nbytes,
        )

    def note_staged(self, nbytes: int, now: Optional[float] = None) -> None:
        """A staged H2D input batch on the device (the feeder's staging)."""
        self._note_transfer("staged", "stage", nbytes, 1, now)

    def release_staged(self, nbytes: int, now: Optional[float] = None) -> None:
        """The staged batch was dispatched (or reclaimed after a failure)."""
        self._note_transfer("staged", "stage_free", nbytes, -1, now)

    def note_kv_alloc(self, nbytes: int, now: Optional[float] = None) -> None:
        """A sequence's K/V block became resident (slot assignment)."""
        self._note_transfer("kv_cache", "kv_alloc", nbytes, 1, now)

    def note_kv_free(self, nbytes: int, now: Optional[float] = None) -> None:
        """The sequence retired: its exact charge returns."""
        self._note_transfer("kv_cache", "kv_free", nbytes, -1, now)

    def note_readback(self, nbytes: int, now: Optional[float] = None) -> None:
        """A device output entering the D2H drain."""
        self._note_transfer("readback", "readback", nbytes, 1, now)

    def release_readback(self, nbytes: int, now: Optional[float] = None) -> None:
        self._note_transfer("readback", "readback_free", nbytes, -1, now)

    # -- reconciliation and reading -----------------------------------------------

    def tracked_bytes(self) -> int:
        with self._lock:
            return self._totals_locked()[0]

    def reconcile(self) -> Optional[int]:
        """Probe ground truth and publish ``mem.unattributed_bytes``
        (ground truth minus tracked); None without a probe."""
        truth, source = self._probe()
        with self._lock:
            tracked, _ = self._totals_locked()
            self._last_truth = (truth, source)
        if truth is None:
            return None
        gap = int(truth) - int(tracked)
        metrics.gauge("mem.unattributed_bytes", gap)
        return gap

    def events_tail(self, n: int = OOM_RING_TAIL) -> List[dict]:
        with self._lock:
            return list(self._ring)[-max(0, int(n)):]

    def status(self, now: Optional[float] = None) -> Optional[dict]:
        """The ``GET /v1/memory`` body and ``Router.stats()["memory"]``,
        reconciled on every read; None when nothing was ever tracked."""
        t = time.time() if now is None else float(now)
        with self._lock:
            if self._dev is None:
                return None
        unattributed = self.reconcile()
        with self._lock:
            st = self._dev
            truth, source = self._last_truth
            return {
                "ts": round(t, 3),
                "devices": {"0": {
                    "resident_bytes": sum(st.resident.values()),
                    "staged_bytes": st.staged_bytes,
                    "readback_bytes": st.readback_bytes,
                    "kv_bytes": st.kv_bytes,
                    "device_bytes": st.total(),
                    "watermark_bytes": st.watermark,
                }},
                "models": dict(st.resident),
                "tracked_bytes": st.total(),
                "watermark_bytes": st.watermark,
                "ground_truth_bytes": truth,
                "ground_truth_source": source,
                "unattributed_bytes": unattributed,
                "leaked_bytes": self._leaked_bytes,
                "leak_events": self._leak_events,
                "oom_events": self._oom_events,
                "ring_events": len(self._ring),
            }

    # -- leak detection -------------------------------------------------------------

    def leak_check(self, name: str, baseline_truth: Optional[int],
                   baseline_tracked: Optional[int], now: Optional[float] = None) -> Optional[int]:
        """After an evict: ground truth must be back at the value before
        the load, moved by as much as the ledger moved since. A residue past
        ``SPARKDL_MEM_LEAK_TOL_MB`` is a leak. Returns the leaked bytes (0:
        clean), or None without ground truth."""
        if baseline_truth is None:
            return None
        t = time.time() if now is None else float(now)
        gc.collect()  # reference cycles holding the evicted module
        truth, _ = self._probe()
        if truth is None:
            return None
        tol = leak_tolerance_bytes()
        cap = mem_ring_capacity()
        with self._lock:
            tracked, _ = self._totals_locked()
        expected = int(baseline_truth) + (int(tracked) - int(baseline_tracked or 0))
        leaked = int(truth) - expected
        metrics.gauge("mem.unattributed_bytes", int(truth) - int(tracked))
        if leaked <= tol:
            return 0
        with self._lock:
            self._leaked_bytes += leaked
            self._leak_events += 1
            self._ring_locked(cap, {"ts": round(t, 3), "op": "leak", "model": name, "bytes": leaked})
        metrics.inc("mem.leaked_bytes", leaked)
        metrics.inc("mem.leak_events")
        from sparkdl_tpu_torch.obs.export import append_jsonl

        append_jsonl({
            "kind": "mem_leak",
            "ts": round(t, 3),
            "model": name,
            "leaked_bytes": int(leaked),
            "tolerance_bytes": int(tol),
            "ground_truth_bytes": int(truth),
            "tracked_bytes": int(tracked),
        })
        return leaked

    # -- OOM forensics ----------------------------------------------------------------

    def record_oom(self, phase: str, model: Optional[str], error: BaseException,
                   now: Optional[float] = None) -> None:
        """One ``{"kind": "oom"}`` event with the per-model table, the
        watermarks and the ring's tail; once per exception, so an error
        that travels load -> retry -> dispatch files once."""
        if getattr(error, "_sparkdl_oom_recorded", False):
            return
        try:
            error._sparkdl_oom_recorded = True
        except AttributeError:  # an exception type without a __dict__
            pass
        t = time.time() if now is None else float(now)
        status = self.status(now=t) or {}
        tail = self.events_tail(OOM_RING_TAIL)
        with self._lock:
            self._oom_events += 1
        metrics.inc("mem.oom_events")
        from sparkdl_tpu_torch.obs.export import append_jsonl

        append_jsonl({
            "kind": "oom",
            "ts": round(t, 3),
            "phase": phase,
            "model": model,
            "error": f"{type(error).__name__}: {error}",
            "models": status.get("models") or {},
            "devices": status.get("devices") or {},
            "tracked_bytes": status.get("tracked_bytes"),
            "watermark_bytes": status.get("watermark_bytes"),
            "ground_truth_bytes": status.get("ground_truth_bytes"),
            "recent_allocations": tail,
        })

    def clear(self) -> None:
        with self._lock:
            self._dev = None
            self._ring.clear()
            self._leaked_bytes = 0
            self._leak_events = 0
            self._oom_events = 0
            self._last_truth = (None, None)


_ledger: Optional[MemoryLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> MemoryLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = MemoryLedger()
        return _ledger


def reset() -> None:
    """Drop the ledger's live view; the registry counters stay monotone."""
    get_ledger().clear()


def note_model_loaded(name: str, nbytes: int, estimate_bytes: Optional[int] = None,
                      now: Optional[float] = None) -> None:
    get_ledger().note_model_loaded(name, nbytes, estimate_bytes=estimate_bytes, now=now)


def note_model_evicted(name: str, nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().note_model_evicted(name, nbytes, now=now)


def note_staged(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().note_staged(nbytes, now=now)


def release_staged(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().release_staged(nbytes, now=now)


def note_kv_alloc(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().note_kv_alloc(nbytes, now=now)


def note_kv_free(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().note_kv_free(nbytes, now=now)


def note_readback(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().note_readback(nbytes, now=now)


def release_readback(nbytes: int, now: Optional[float] = None) -> None:
    get_ledger().release_readback(nbytes, now=now)


def tracked_bytes() -> int:
    return get_ledger().tracked_bytes()


def ground_truth() -> Tuple[Optional[int], Optional[str]]:
    """Ground truth through the process ledger's probe."""
    return get_ledger().ground_truth()


def reconcile() -> Optional[int]:
    return get_ledger().reconcile()


def leak_check(name: str, baseline_truth: Optional[int], baseline_tracked: Optional[int],
               now: Optional[float] = None) -> Optional[int]:
    return get_ledger().leak_check(name, baseline_truth, baseline_tracked, now=now)


def record_oom(phase: str, model: Optional[str], error: BaseException,
               now: Optional[float] = None) -> None:
    get_ledger().record_oom(phase, model, error, now=now)


def memory_status(now: Optional[float] = None) -> Optional[dict]:
    """``GET /v1/memory``'s body; None when nothing was ever tracked."""
    return get_ledger().status(now=now)


__all__ = [
    "MemoryLedger",
    "OOM_MARKERS",
    "OOM_RING_TAIL",
    "get_ledger",
    "ground_truth",
    "ground_truth_bytes",
    "is_oom_error",
    "leak_check",
    "leak_tolerance_bytes",
    "mem_ring_capacity",
    "memory_status",
    "note_kv_alloc",
    "note_kv_free",
    "note_model_evicted",
    "note_model_loaded",
    "note_readback",
    "note_staged",
    "reconcile",
    "record_oom",
    "release_readback",
    "release_staged",
    "reset",
    "tracked_bytes",
]
