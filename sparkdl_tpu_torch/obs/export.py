"""The JSONL event log: one JSON object per line, appended; the gang rank.

The port of ``append_jsonl`` and ``obs_rank`` from the JAX package's
``obs/export.py``.
The serving control plane writes its events here (``slo_alert``,
``slo_recovery``, ``oom``, ``mem_leak``, ``canary_rollback``) to the file
``SPARKDL_OBS_JSONL`` names; unset, nothing is written. The flight
recorder and ``dump_on_failure`` are not ported yet (ROADMAP Queue A
item 4.11).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from sparkdl_tpu_torch.runtime import knobs

_jsonl_lock = threading.Lock()


def obs_rank() -> Optional[int]:
    """This process's gang rank for telemetry, or None: the serving
    gateway sets ``SPARKDL_OBS_RANK`` in each worker's environment, so its
    events, ``/metrics`` lines and replies are attributable."""
    try:
        return knobs.get_int("SPARKDL_OBS_RANK")
    except ValueError:
        return None


def jsonl_path() -> Optional[str]:
    return knobs.get_str("SPARKDL_OBS_JSONL") or None


def append_jsonl(event: dict, path: Optional[str] = None) -> Optional[str]:
    """Append ``event`` as one line to ``path`` (``SPARKDL_OBS_JSONL``
    unless given) with a single ``os.write`` on an ``O_APPEND`` descriptor,
    so writers sharing the file never tear each other's lines. Returns the
    path, or None when no log is configured or the write failed: the event
    log must not fail the path it observes."""
    path = path or jsonl_path()
    if not path:
        return None
    try:
        data = (json.dumps(event) + "\n").encode()
        with _jsonl_lock:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        return path
    except (OSError, TypeError, ValueError):
        return None


__all__ = ["append_jsonl", "jsonl_path", "obs_rank"]
