"""On-demand profiling on ``torch.profiler``.

The port of the JAX package's ``utils/profiler.py``:
:func:`capture_profile` records ``seconds`` of whatever the process runs
into a fresh run directory (what ``POST /admin/profile`` serves), and
:func:`annotate` names a region inside a capture
(``torch.profiler.record_function``).

A capture writes ``trace.json``, the Chrome trace of the profiler's
events. On the card it records CUDA activity through CUPTI, which sees
every kernel of the process whichever thread launched it. CPU op events
come from every thread where the installed torch offers
``profile_all_threads``, and else only from the capturing thread, so a
reader of the card's work reads the ``kernel`` events. A capture asked
for CUDA activity where the profiler cannot record it raises
:class:`ProfilerUnavailable`; it never falls back to a CPU-only trace.
One capture runs at a time per process: a second one, or a capture that
meets another active ``torch.profiler``, raises :class:`ProfilerBusy`.
"""

from __future__ import annotations

import os
import threading
import time

TRACE_FILE = "trace.json"


class ProfilerUnavailable(RuntimeError):
    """The profiler cannot record what was asked (no CUDA activity on
    this build, or it failed to start or stop); the endpoint answers
    501."""


class ProfilerBusy(RuntimeError):
    """A capture, or another ``torch.profiler``, is already running; the
    endpoint answers 409."""


_capture_lock = threading.Lock()
_capturing = False


def capture_profile(log_dir: str, seconds: float, cuda: bool = False) -> str:
    """Record ``seconds`` of this process's activity (CPU ops, and CUDA
    kernels and copies with ``cuda``) into a new timestamped run
    directory under ``log_dir``, as ``trace.json``; returns the run
    directory. Raises :class:`ProfilerBusy` or
    :class:`ProfilerUnavailable` (see the module docstring); a failed
    start leaves no directory behind."""
    global _capturing
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise ProfilerUnavailable(
                "torch.profiler cannot record CUDA activity on this build "
                f"(supported: {sorted(a.name for a in torch.profiler.supported_activities())})"
            )
        activities.append(ProfilerActivity.CUDA)
    with _capture_lock:
        if _capturing or torch.autograd.profiler._is_profiler_enabled:
            raise ProfilerBusy("a profiler capture is already running")
        _capturing = True
    try:
        run_dir = os.path.join(log_dir, time.strftime("profile-%Y%m%dT%H%M%S"))
        suffix = 1
        while os.path.exists(run_dir):
            suffix += 1
            run_dir = os.path.join(log_dir, time.strftime("profile-%Y%m%dT%H%M%S") + f"-{suffix}")
        prof = torch.profiler.profile(activities=activities, experimental_config=_all_threads())
        try:
            prof.start()
        except RuntimeError as e:
            raise ProfilerUnavailable(
                f"torch.profiler could not start: {type(e).__name__}: {e}"
            ) from e
        try:
            time.sleep(max(0.0, float(seconds)))
        finally:
            try:
                prof.stop()
            except RuntimeError as e:
                raise ProfilerUnavailable(
                    f"torch.profiler could not stop: {type(e).__name__}: {e}"
                ) from e
        os.makedirs(run_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(run_dir, TRACE_FILE))
        return run_dir
    finally:
        with _capture_lock:
            _capturing = False


def _all_threads():
    """Kineto's config that records the CPU ops of every thread (the
    router's launch and HTTP threads), or None where this torch has no
    such option."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def annotate(name: str):
    """A named region inside a capture, as a context manager or a
    decorator (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


__all__ = ["ProfilerBusy", "ProfilerUnavailable", "TRACE_FILE", "annotate", "capture_profile"]
