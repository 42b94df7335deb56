"""Per-rank snapshot drops: a gang rank's terminal telemetry beside its
heartbeat file.

The port of ``rank_snapshot_path``, ``write_rank_snapshot`` and
``load_rank_snapshots`` from the JAX package's ``obs/aggregate.py``. A
batch gang worker drops ``obs.rank.<r>.json`` into its heartbeat
directory on the way out (``worker._obs_services``), so a reader finds
every rank's counters there, the flash wrapper's
``kernel.flash_attention.launches.<dtype>`` among them. The files keep the JAX package's name and top-level keys
(``schema``, ``rank``, ``spans``, ``metrics``), so the JAX package's
loader reads them too. The port keeps no span ring buffer: ``spans`` is
empty and ``open_spans`` lists the spans open at the drop. The
cross-rank Chrome-trace merge, the straggler table and the periodic,
time-gated drop (``maybe_write_rank_snapshot``, ``SPARKDL_OBS_SNAP_S``)
are not ported (ROADMAP Queue A item 8, the obs tail).
"""

from __future__ import annotations

import json
import os
import platform
import re
import time
from typing import Dict, Optional

from sparkdl_tpu_torch.obs.export import obs_rank
from sparkdl_tpu_torch.utils.metrics import metrics

SNAPSHOT_SCHEMA = 1
_RANK_SNAP_RE = re.compile(r"^obs\.rank\.(\d+)\.json$")


def snapshot(rank: Optional[int] = None, reason: Optional[str] = None) -> dict:
    """This process's metrics registry, open spans and utilization view as
    one plain dict (the JAX package's snapshot keys, spans empty)."""
    from sparkdl_tpu_torch.obs.trace import active_spans
    from sparkdl_tpu_torch.obs.utilization import utilization_status

    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "generated_unix": time.time(),
        "pid": os.getpid(),
        "host": platform.node(),
        "rank": rank if rank is not None else obs_rank(),
        "reason": reason,
        "spans": [],
        "open_spans": active_spans(),
        "metrics": metrics.snapshot(),
    }
    util = utilization_status()
    if util is not None:
        snap["utilization"] = util
    return snap


def rank_snapshot_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"obs.rank.{int(rank)}.json")


def write_rank_snapshot(directory: str, rank: int, snap: Optional[dict] = None) -> str:
    """Write this process's snapshot as rank ``rank``'s drop, atomically
    (tmp + rename, like every file of the worker protocol)."""
    os.makedirs(directory, exist_ok=True)
    if snap is None:
        snap = snapshot(rank=int(rank))
    else:
        snap.setdefault("rank", int(rank))
    path = rank_snapshot_path(directory, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=1)
    os.replace(tmp, path)
    return path


def load_rank_snapshots(directory: str) -> Dict[int, dict]:
    """Every ``obs.rank.<r>.json`` drop in ``directory``, by rank; torn or
    foreign files are skipped."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = _RANK_SNAP_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(snap, dict) and "spans" in snap:
            out[int(m.group(1))] = snap
    return out


__all__ = [
    "load_rank_snapshots", "rank_snapshot_path", "snapshot", "write_rank_snapshot",
]
