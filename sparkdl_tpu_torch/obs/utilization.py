"""Device-utilization ledger: busy and idle wall-clock on the device, and MFU.

The port of the JAX package's ``obs/utilization.py``: what fraction of
the wall clock the serving path keeps the card occupied, live, while the
server runs.

- The feeder notes each dispatch's host time as **busy**, each staged
  H2D claim's residual wait as **h2d** and each readback drain's residual
  as **d2h**, which is busy wall too: the drain waits for the rest of the
  program and its copy.
- What busy measures differs from the JAX package. A TPU program is one
  compiled executable, so its wall is the device's. An eager PyTorch
  forward issues its kernels one at a time from the host, and the card is
  idle in the gaps between them whenever the host issues slower than the
  card runs. On the port, busy is therefore **host dispatch occupancy**:
  the wall during which a forward was being issued to the card or its
  result waited for. It bounds the card's kernel time from above in that
  host-bound regime and is not the kernel-busy share, which only a
  profiler trace gives (``torch.profiler``; the chip smoke prints both).
  Events recorded on the compute stream would not close the gap: the
  stream's span between them holds the same host-bound gaps. ``status()``
  says so in ``busy_source``.
- Between two notes, ``busy`` gets ``min(program time, elapsed)`` and
  ``idle`` the rest, so ``busy + idle`` equals the observed wall by
  construction. Concurrent programs are truncated to the wall: busy is a
  union approximation, never above 100%.
- Monotone counters ``util.device_busy_ms.0``, ``util.device_idle_ms.0``,
  ``util.h2d_ms.0`` and ``util.d2h_ms.0``, a ``util.busy_frac`` gauge and,
  where the served model's analytic FLOPs are known (the registry's
  ``flops_fn`` / ``flops_per_item``, on the residency entry), a
  ``serve.mfu`` gauge: achieved FLOP/s over the last ``MFU_WINDOW_S``
  against the device's peak (``utils/flops.device_peak_flops``). The gauge
  is published as computed, not clamped to 1 as the JAX package does, so
  a FLOP count off by more than the peak shows. A device without a known
  peak, the CPU among them, publishes no MFU.

Every program of the port runs on one device, accounted as device 0. One
plain leaf lock; the registry is written after it is released.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from sparkdl_tpu_torch.utils.metrics import WindowedCounter, metrics

#: the window the serve.mfu gauge averages achieved FLOP/s over
MFU_WINDOW_S = 30.0


#: what ``busy`` measures on the port (see the module docstring)
BUSY_SOURCE = "host_dispatch"


def _local_device_kind() -> Optional[str]:
    """``utils/flops.local_device_kind``, behind a name of this module so
    a test can set the ledger's view of the device alone."""
    from sparkdl_tpu_torch.utils.flops import local_device_kind

    return local_device_kind()


class _DeviceState:
    __slots__ = ("busy_s", "idle_s", "h2d_s", "d2h_s", "first_t", "last_t")

    def __init__(self, now: float):
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.h2d_s = 0.0
        self.d2h_s = 0.0
        self.first_t = now
        self.last_t = now


class DeviceLedger:
    """Busy, idle and transfer accounting of device 0 with wall
    conservation. Every method takes an explicit ``now`` for tests; the
    registry counters move by the same increments as the ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        #: created by the first note (``status`` is None before it)
        self._dev: Optional[_DeviceState] = None
        self._flops = WindowedCounter(MFU_WINDOW_S, MFU_WINDOW_S / 16.0)
        self._flops_t0: Optional[float] = None
        self._peak: Optional[float] = None
        self._peak_resolved = False

    # -- ingest ---------------------------------------------------------------

    def _account_locked(self, busy_s: float, now: float) -> tuple:
        """Advance the device's clock to ``now``, ``busy_s`` of the
        elapsed span as busy. Returns (busy_inc, idle_inc), which sum to
        the elapsed wall."""
        st = self._dev
        if st is None:
            # first sight: the wall starts where this program started
            st = self._dev = _DeviceState(now - max(0.0, busy_s))
        elapsed = max(0.0, now - st.last_t)
        busy_inc = min(max(0.0, busy_s), elapsed)
        idle_inc = elapsed - busy_inc
        st.busy_s += busy_inc
        st.idle_s += idle_inc
        st.last_t = now
        return busy_inc, idle_inc

    def note_busy(self, busy_s: float, now: Optional[float] = None) -> None:
        """One program's busy time (its dispatch's host wall)."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            busy_inc, idle_inc = self._account_locked(busy_s, t)
        if busy_inc:
            metrics.inc("util.device_busy_ms.0", busy_inc * 1e3)
        if idle_inc:
            metrics.inc("util.device_idle_ms.0", idle_inc * 1e3)
        self._publish_busy_frac()

    def note_transfer(self, h2d_s: float = 0.0, d2h_s: float = 0.0,
                      now: Optional[float] = None) -> None:
        """Residual transfer waits, for attribution only: the H2D residual
        sits inside idle, the D2H residual inside the busy tail."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            st = self._dev
            if st is None:
                st = self._dev = _DeviceState(t)
            st.h2d_s += max(0.0, h2d_s)
            st.d2h_s += max(0.0, d2h_s)
        if h2d_s > 0:
            metrics.inc("util.h2d_ms.0", h2d_s * 1e3)
        if d2h_s > 0:
            metrics.inc("util.d2h_ms.0", d2h_s * 1e3)

    def note_flops(self, flops: float, now: Optional[float] = None) -> None:
        """Analytic FLOPs of one dispatch that landed (real rows x FLOPs per
        row at the bucket that ran); feeds ``serve.mfu``."""
        if flops <= 0:
            return
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._flops.add(float(flops), now=t)
            if self._flops_t0 is None:
                self._flops_t0 = t
            window_start = self._flops_t0
        self._publish_mfu(t, window_start)

    # -- publication ----------------------------------------------------------

    def _resolve_peak(self) -> Optional[float]:
        if not self._peak_resolved:
            from sparkdl_tpu_torch.utils.flops import device_peak_flops

            self._peak = device_peak_flops(_local_device_kind() or "")
            self._peak_resolved = True
        return self._peak

    def _publish_mfu(self, now: float, window_start: float) -> None:
        peak = self._resolve_peak()
        if not peak:
            return  # no known peak (the CPU): no MFU rather than a made-up one
        with self._lock:
            flops = self._flops.total(MFU_WINDOW_S, now=now)
        span_s = min(MFU_WINDOW_S, max(1e-3, now - window_start))
        metrics.gauge("serve.mfu", flops / span_s / peak)

    def _publish_busy_frac(self) -> None:
        with self._lock:
            st = self._dev
            busy, wall = (st.busy_s, st.last_t - st.first_t) if st is not None else (0.0, 0.0)
        if wall > 0:
            metrics.gauge("util.busy_frac", busy / wall)

    # -- reading --------------------------------------------------------------

    def status(self, now: Optional[float] = None) -> Optional[dict]:
        """The device's view with idle advanced to ``now`` (the tail since
        the last note is idle), or None before any dispatch.
        ``busy_source`` names what busy measures (:data:`BUSY_SOURCE`)."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            st = self._dev
            if st is None:
                return None
            tail_idle = max(0.0, t - st.last_t)
            wall = (st.last_t - st.first_t) + tail_idle
            busy_frac = round(st.busy_s / wall, 4) if wall > 0 else 0.0
            device = {
                "busy_ms": round(st.busy_s * 1e3, 3),
                "idle_ms": round((st.idle_s + tail_idle) * 1e3, 3),
                "h2d_ms": round(st.h2d_s * 1e3, 3),
                "d2h_ms": round(st.d2h_s * 1e3, 3),
                "wall_ms": round(wall * 1e3, 3),
                "busy_frac": busy_frac,
            }
        out = {"devices": {"0": device}, "busy_frac": busy_frac, "busy_source": BUSY_SOURCE}
        mfu = metrics.gauge_stats("serve.mfu")
        if mfu is not None:
            out["mfu"] = mfu["last"]
        return out

    def clear(self) -> None:
        with self._lock:
            self._dev = None
            self._flops.clear()
            self._flops_t0 = None


_ledger: Optional[DeviceLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> DeviceLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = DeviceLedger()
        return _ledger


def reset() -> None:
    """Drop the per-device state; the registry counters stay monotone."""
    get_ledger().clear()


def note_busy(busy_s: float, now: Optional[float] = None) -> None:
    get_ledger().note_busy(busy_s, now=now)


def note_transfer(h2d_s: float = 0.0, d2h_s: float = 0.0, now: Optional[float] = None) -> None:
    get_ledger().note_transfer(h2d_s=h2d_s, d2h_s=d2h_s, now=now)


def note_flops(flops: float, now: Optional[float] = None) -> None:
    get_ledger().note_flops(flops, now=now)


def utilization_status(now: Optional[float] = None) -> Optional[dict]:
    """``Router.stats()["utilization"]``; None before any dispatch."""
    return get_ledger().status(now=now)


__all__ = [
    "BUSY_SOURCE",
    "DeviceLedger",
    "MFU_WINDOW_S",
    "get_ledger",
    "note_busy",
    "note_flops",
    "note_transfer",
    "reset",
    "utilization_status",
]
