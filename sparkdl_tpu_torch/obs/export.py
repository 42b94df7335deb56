"""The flight recorder's exports: the obs snapshot, its Chrome trace,
the Prometheus text with tail exemplars, the JSONL event log and
dump-on-failure.

The port of the JAX package's ``obs/export.py``. Snapshot schema
(``"schema": 1``)::

    {
      "schema": 1, "generated_unix": <float>, "pid": <int>,
      "host": <str>, "rank": <int | null>,
      "reason": <str | null>,                 # set by dump_on_failure
      "spans": [SpanRecord.as_dict(), ...],   # the ring, oldest first
      "open_spans": [{"name", "age_s", "thread", "attrs"}, ...],
      "metrics": MetricsRegistry.snapshot(),
      "traces": [...], "exemplars": {...},    # obs/trace.py
      "slo": ..., "utilization": ..., "memory": ..., "fleet": ...
    }

The last four keys appear only where their ledgers hold something. The
Chrome trace is the ``chrome://tracing`` / Perfetto JSON object: one
complete event (``"ph": "X"``) per span, ``ts``/``dur`` in microseconds,
one track per thread.

The serving control plane writes its events (``slo_alert``,
``slo_recovery``, ``oom``, ``mem_leak``, ``canary_rollback``,
``obs_dump``, ``profile``) to the file ``SPARKDL_OBS_JSONL`` names;
unset, nothing is written.

:func:`dump_on_failure` writes the snapshot to a timestamped file under
``SPARKDL_OBS_DUMP_DIR`` (unset: no dump) on the failure edges: an SLO
trip (``obs/slo.py``), an OOM (``obs/memory.py``), a canary rollback and
an exhausted dispatch (``serving/router.py``), a failed partition
(``runtime/executor.py``) and a gang rank's exception
(``runtime/heartbeat.py``). It never raises: a broken disk must not
replace the original failure.
"""

from __future__ import annotations

import itertools
import json
import os
import platform
import threading
import time
from typing import Optional

from sparkdl_tpu_torch.obs import trace as request_trace
from sparkdl_tpu_torch.obs.spans import SpanRecorder, active_spans, get_recorder
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

SNAPSHOT_SCHEMA = 1

_jsonl_lock = threading.Lock()


def obs_rank() -> Optional[int]:
    """This process's gang rank for telemetry, or None: the serving
    gateway sets ``SPARKDL_OBS_RANK`` in each worker's environment, so its
    events, ``/metrics`` lines and replies are attributable."""
    try:
        return knobs.get_int("SPARKDL_OBS_RANK")
    except ValueError:
        return None


def snapshot(
    recorder: Optional[SpanRecorder] = None,
    registry: Optional[MetricsRegistry] = None,
    reason: Optional[str] = None,
    rank: Optional[int] = None,
) -> dict:
    """The span ring, the metrics registry, the trace store and the
    ledgers' status as one plain dict (the schema above)."""
    from sparkdl_tpu_torch.obs import memory as mem_mod
    from sparkdl_tpu_torch.obs import slo as slo_mod
    from sparkdl_tpu_torch.obs import timeseries as ts_mod
    from sparkdl_tpu_torch.obs import utilization as util_mod

    recorder = recorder or get_recorder()
    registry = registry or metrics
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "generated_unix": time.time(),
        "pid": os.getpid(),
        "host": platform.node(),
        "rank": rank if rank is not None else obs_rank(),
        "reason": reason,
        "spans": [rec.as_dict() for rec in recorder.spans()],
        "open_spans": active_spans(recorder),
        "metrics": registry.snapshot(),
        "traces": request_trace.get_store().records(),
        "exemplars": request_trace.get_exemplars().snapshot(),
    }
    try:
        slo_status = slo_mod.engine_status()
    except ValueError as e:
        # a malformed SPARKDL_SLO_* knob stays loud on /v1/slo; a snapshot
        # (a dump on a failure edge) is still written, carrying the error
        slo_status = {"armed": True, "error": str(e)}
    if slo_status is not None:
        snap["slo"] = slo_status
    util_status = util_mod.utilization_status()
    if util_status is not None:
        snap["utilization"] = util_status
    mem_status = mem_mod.memory_status()
    if mem_status is not None:
        snap["memory"] = mem_status
    fleet_hist = ts_mod.fleet_series()
    if fleet_hist:
        snap["fleet"] = {"latest": fleet_hist[-1], "samples": len(fleet_hist)}
    return snap


def atomic_write_json(path: str, obj, indent: Optional[int] = None) -> str:
    """tmp + rename: a reader never sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(tmp, path)
    return path


def write_snapshot(path: str, snap: Optional[dict] = None) -> str:
    return atomic_write_json(path, snap if snap is not None else snapshot(), indent=1)


def to_chrome_trace(
    snap: Optional[dict] = None,
    pid: Optional[int] = None,
    extra_args: Optional[dict] = None,
) -> dict:
    """Snapshot -> Chrome trace-event JSON object (``traceEvents``).
    ``pid`` overrides the event process id and ``extra_args`` merges into
    every complete event's args: the cross-rank merge renders each rank
    through this function (pid = rank)."""
    snap = snap if snap is not None else snapshot()
    pid = snap.get("pid", 0) if pid is None else pid
    extra_args = extra_args or {}
    events = []
    tids: dict = {}
    names: dict = {}
    for sp in snap.get("spans", []):
        tid = tids.setdefault(sp["thread_id"], len(tids))
        names.setdefault(sp["thread_id"], sp["thread_name"])
        events.append({
            "name": sp["name"],
            "ph": "X",
            "ts": sp["start_unix"] * 1e6,
            "dur": sp["dur_s"] * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {
                **extra_args,
                "span_id": sp["span_id"],
                "parent_id": sp["parent_id"],
                **sp.get("attrs", {}),
            },
        })
    for thread_id, tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": names.get(thread_id, str(thread_id))},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, snap: Optional[dict] = None) -> str:
    return atomic_write_json(path, to_chrome_trace(snap))


def prometheus_text(registry: Optional[MetricsRegistry] = None,
                    rank: Optional[int] = None) -> str:
    """The registry as Prometheus text (``utils/metrics.prometheus_text``)
    and, for the process-global registry, one labelled series per tail
    exemplar, ``<timer>_seconds_exemplar{trace_id="..."}``, so every tail
    number a scrape shows names a trace ``obs trace`` renders. A ``rank``
    stamps every sample line with ``rank="N"``."""
    from sparkdl_tpu_torch.utils import metrics as metrics_mod

    lines = [ln for ln in metrics_mod.prometheus_text(registry).splitlines() if ln]
    if registry is None:
        for name, entries in sorted(request_trace.get_exemplars().snapshot().items()):
            pn = metrics_mod._prom_name(name) + "_seconds_exemplar"
            lines.append(f"# TYPE {pn} gauge")
            for e in entries:
                lines.append(f'{pn}{{trace_id="{e["trace_id"]}"}} {e["value_s"]}')
    if rank is not None:
        label = f'rank="{int(rank)}"'
        lines = [metrics_mod._label_line(ln, label) for ln in lines]
    return "\n".join(lines) + "\n"


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


def dump_dir() -> Optional[str]:
    return knobs.get_str("SPARKDL_OBS_DUMP_DIR") or None


#: per-process dump sequence: two failures in the same second get
#: distinct file names
_DUMP_SEQ = itertools.count(1)


def dump_on_failure(reason: str, **context) -> Optional[str]:
    """Write the flight recorder (:func:`snapshot`, with ``reason``) to
    ``SPARKDL_OBS_DUMP_DIR`` as
    ``obs-<reason>-<stamp>-pid<pid>-t<thread>-<seq>.json`` and note it in
    the event log (``{"kind": "obs_dump"}``). ``context`` (the failing
    class, model or trace id) lands in the snapshot's ``"context"`` key
    and in the event. Returns the path, or None when no directory is set
    or the write failed: this runs on failure edges and never raises."""
    directory = dump_dir()
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S")
        path = os.path.join(
            directory,
            f"obs-{reason}-{stamp}-pid{os.getpid()}"
            f"-t{threading.get_ident()}-{next(_DUMP_SEQ)}.json",
        )
        snap = snapshot(reason=reason)
        if context:
            snap["context"] = context
        written = write_snapshot(path, snap)
        append_jsonl({
            "kind": "obs_dump",
            "ts": round(time.time(), 3),
            "reason": reason,
            "path": written,
            "rank": obs_rank(),
            **context,
        })
        return written
    except Exception:
        return None


__all__ = [
    "SNAPSHOT_SCHEMA",
    "append_jsonl",
    "atomic_write_json",
    "dump_dir",
    "dump_on_failure",
    "jsonl_path",
    "obs_rank",
    "prometheus_text",
    "snapshot",
    "to_chrome_trace",
    "write_chrome_trace",
    "write_snapshot",
]
