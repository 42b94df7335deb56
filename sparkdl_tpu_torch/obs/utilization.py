"""Device-utilization ledger: busy and idle wall-clock on the device, and MFU.

The port of the JAX package's ``obs/utilization.py``: what fraction of
the wall clock the serving path keeps the card occupied, live, while the
server runs.

- The feeder notes each dispatch's host time as **busy**, each staged
  H2D claim's residual wait as **h2d** and each readback drain's residual
  as **d2h**, which is busy wall too: the drain waits for the rest of the
  program and its copy.
- What busy measures on the card is the card's own **kernel-busy share**,
  as the JAX package's busy is a TPU program's wall: NVML's GPU
  utilization (the share of NVML's sample period in which a kernel ran,
  ``nvmlDeviceGetUtilizationRates`` polled every 50 ms), integrated over
  the ledger's window by :class:`NvmlBusyProbe`, which opens
  ``libnvidia-ml.so.1`` through ``ctypes`` (it ships with the NVIDIA
  kernel module's user libraries; ``pynvml`` is not needed). An eager
  forward issues its kernels one at a time, and the card idles between
  them whenever the host issues slower than the card runs, so the host's
  dispatch wall would read a host-bound worker as saturated; NVML does
  not. ``status()["busy_source"]`` is ``"nvml"`` there. NVML that cannot
  be opened on a machine with a card is an error naming it, never a
  silent fall back. Only where there is no card (the CPU tests) is busy
  the host dispatch occupancy (``busy_source``: ``"host_dispatch"``). A
  test injects its own probe (``DeviceLedger(busy_probe=...)``), as the
  memory ledger takes its probe.
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
from typing import Callable, Optional

from sparkdl_tpu_torch.utils.metrics import WindowedCounter, metrics

#: the window the serve.mfu gauge averages achieved FLOP/s over
MFU_WINDOW_S = 30.0


#: what ``busy`` measures where there is no card (see the module docstring)
BUSY_SOURCE = "host_dispatch"
#: what ``busy`` measures on the card: NVML's kernel-busy samples
NVML_SOURCE = "nvml"

#: a probe of the card's kernel-busy time: cumulative busy seconds since
#: the probe was made, monotone
BusyProbe = Callable[[], float]

_UNSET = object()


class NvmlBusyProbe:
    """Cumulative kernel-busy seconds of one CUDA device, from NVML.

    A daemon thread reads ``nvmlDeviceGetUtilizationRates`` (what
    ``nvidia-smi`` prints as utilization.gpu: the percent of NVML's sample
    period in which a kernel ran) every ``poll_s`` and integrates the
    reading over the time since the last one. The device is found by its
    PCI bus id (``torch.cuda.get_device_properties``), so
    ``CUDA_VISIBLE_DEVICES`` renumbering cannot pick the wrong card.
    Raises RuntimeError naming NVML when the library, its init, the device
    handle or the first read fail; a read that fails later in the polling
    thread is raised by the next call."""

    def __init__(self, device_index: int = 0, poll_s: float = 0.05):
        import ctypes

        import torch

        self._ct = ctypes
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise RuntimeError(
                f"NVML (libnvidia-ml.so.1) cannot be opened for util.busy_frac: {e}"
            ) from e
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        props = torch.cuda.get_device_properties(device_index)
        handle = ctypes.c_void_p()
        bus = getattr(props, "pci_bus_id", None)
        if bus is not None:
            bus_id = (f"{getattr(props, 'pci_domain_id', 0):08x}:{bus:02x}:"
                      f"{getattr(props, 'pci_device_id', 0):02x}.0").encode()
            self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(bus_id, ctypes.byref(handle)),
                        f"nvmlDeviceGetHandleByPciBusId_v2({bus_id.decode()})")
        else:
            uuid = f"GPU-{props.uuid}".encode()
            self._check(lib.nvmlDeviceGetHandleByUUID(uuid, ctypes.byref(handle)),
                        f"nvmlDeviceGetHandleByUUID({uuid.decode()})")
        self._handle = handle

        class _Rates(ctypes.Structure):
            _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]

        self._Rates = _Rates
        self._busy_s = 0.0
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._rate()  # fails loudly here if the read is refused
        self.poll_s = float(poll_s)
        self._last_t = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, name="sparkdl-nvml-busy", daemon=True)
        self._thread.start()

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = ""
            try:
                self._lib.nvmlErrorString.restype = self._ct.c_char_p
                msg = self._lib.nvmlErrorString(rc).decode()
            except Exception:
                pass
            raise RuntimeError(f"NVML {what} failed ({rc}: {msg}) for util.busy_frac")

    def _rate(self) -> float:
        rates = self._Rates()
        self._check(self._lib.nvmlDeviceGetUtilizationRates(self._handle, self._ct.byref(rates)),
                    "nvmlDeviceGetUtilizationRates")
        return min(100.0, float(rates.gpu)) / 100.0

    def _poll(self) -> None:
        try:
            while not self._stop.wait(self.poll_s):
                share = self._rate()
                now = time.monotonic()
                with self._lock:
                    self._busy_s += share * max(0.0, now - self._last_t)
                    self._last_t = now
        except Exception as e:  # handed to the next reader: busy must not freeze silently
            with self._lock:
                self._error = e

    def __call__(self) -> float:
        with self._lock:
            if self._error is not None:
                raise RuntimeError(f"NVML polling stopped: {self._error}") from self._error
            return self._busy_s

    def close(self) -> None:
        """Stop the polling thread (NVML stays initialized)."""
        self._stop.set()
        self._thread.join(timeout=5 * self.poll_s + 1.0)


def default_busy_probe() -> Optional[BusyProbe]:
    """NVML on the current CUDA device where there is a card; None (host
    dispatch occupancy) where there is none."""
    import torch

    if not torch.cuda.is_available():
        return None
    return NvmlBusyProbe(torch.cuda.current_device())


def _local_device_kind() -> Optional[str]:
    """``utils/flops.local_device_kind``, behind a name of this module so
    a test can set the ledger's view of the device alone."""
    from sparkdl_tpu_torch.utils.flops import local_device_kind

    return local_device_kind()


class _DeviceState:
    __slots__ = ("busy_s", "idle_s", "h2d_s", "d2h_s", "first_t", "last_t", "probe_s")

    def __init__(self, now: float, probe_s: float = 0.0):
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.h2d_s = 0.0
        self.d2h_s = 0.0
        self.first_t = now
        self.last_t = now
        #: the busy probe's reading credited so far (its reading at the
        #: window's start plus the busy credited since)
        self.probe_s = probe_s


class DeviceLedger:
    """Busy, idle and transfer accounting of device 0 with wall
    conservation. Every method takes an explicit ``now`` for tests; the
    registry counters move by the same increments as the ledger.

    ``busy_probe``: a :data:`BusyProbe` of the card's kernel-busy time
    (NVML, :func:`default_busy_probe`, resolved at the first note when
    not given); None, the host dispatch wall is busy."""

    def __init__(self, busy_probe=_UNSET):
        self._probe = busy_probe
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

    def _probe_locked(self) -> Optional[BusyProbe]:
        if self._probe is _UNSET:
            self._probe = default_busy_probe()
        return self._probe

    @property
    def busy_source(self) -> str:
        with self._lock:
            return BUSY_SOURCE if self._probe_locked() is None else NVML_SOURCE

    def _account_probe_locked(self, probe_s: float, now: float) -> tuple:
        """Advance the clock to ``now`` with the probe's busy not yet
        credited as busy, up to the elapsed wall. The probe moves in steps
        of its poll interval, so notes closer together than that see a
        step land in one short gap: what the gap cannot hold stays owed
        to the next notes, never dropped."""
        st = self._dev
        if st is None:
            st = self._dev = _DeviceState(now, probe_s)
        elapsed = max(0.0, now - st.last_t)
        busy_inc = min(max(0.0, probe_s - st.probe_s), elapsed)
        idle_inc = elapsed - busy_inc
        st.busy_s += busy_inc
        st.idle_s += idle_inc
        st.last_t = now
        st.probe_s += busy_inc
        return busy_inc, idle_inc

    def note_busy(self, busy_s: float, now: Optional[float] = None) -> None:
        """One program's dispatch wall: busy where there is no card; on the
        card the note only advances the clock and the probe gives busy."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            probe = self._probe_locked()
            if probe is None:
                busy_inc, idle_inc = self._account_locked(busy_s, t)
            else:
                busy_inc, idle_inc = self._account_probe_locked(probe(), t)
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
                probe = self._probe_locked()
                st = self._dev = _DeviceState(t, probe() if probe is not None else 0.0)
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
        ``busy_source`` names what busy measures (:data:`NVML_SOURCE` on
        the card, :data:`BUSY_SOURCE` where there is none)."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            st = self._dev
            if st is None:
                return None
            probe = self._probe_locked()
            tail = max(0.0, t - st.last_t)
            tail_busy = 0.0
            if probe is not None:  # the card's busy since the last note
                tail_busy = min(max(0.0, probe() - st.probe_s), tail)
            busy = st.busy_s + tail_busy
            wall = (st.last_t - st.first_t) + tail
            busy_frac = round(busy / wall, 4) if wall > 0 else 0.0
            source = BUSY_SOURCE if probe is None else NVML_SOURCE
            device = {
                "busy_ms": round(busy * 1e3, 3),
                "idle_ms": round((st.idle_s + tail - tail_busy) * 1e3, 3),
                "h2d_ms": round(st.h2d_s * 1e3, 3),
                "d2h_ms": round(st.d2h_s * 1e3, 3),
                "wall_ms": round(wall * 1e3, 3),
                "busy_frac": busy_frac,
            }
        out = {"devices": {"0": device}, "busy_frac": busy_frac, "busy_source": source}
        mfu = metrics.gauge_stats("serve.mfu")
        if mfu is not None:
            out["mfu"] = mfu["last"]
        return out

    def set_busy_probe(self, probe: Optional[BusyProbe]) -> None:
        """Swap the busy probe (None: host dispatch wall); the window
        restarts."""
        with self._lock:
            self._probe = probe
            self._dev = None

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
    "BusyProbe",
    "DeviceLedger",
    "NVML_SOURCE",
    "NvmlBusyProbe",
    "default_busy_probe",
    "MFU_WINDOW_S",
    "get_ledger",
    "note_busy",
    "note_flops",
    "note_transfer",
    "reset",
    "utilization_status",
]
