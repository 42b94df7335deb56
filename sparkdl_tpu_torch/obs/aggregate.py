"""Cross-rank telemetry: per-rank snapshot drops, the merged Chrome
trace, merged metrics and stragglers.

The port of the JAX package's ``obs/aggregate.py``:

- a gang rank drops ``obs.rank.<r>.json`` (its obs snapshot,
  ``obs/export.snapshot``) beside its heartbeat file: periodically from
  the heartbeat writer (:func:`maybe_write_rank_snapshot`, at most once
  per ``SPARKDL_OBS_SNAP_S``, default 30 s), forced when the heartbeat
  ends, and on the way out of the batch worker (``_obs_services``);
- ``python -m sparkdl_tpu_torch.obs merge <dir>`` fuses the drops into
  one Chrome trace with a lane per rank (``pid`` = rank), each request's
  trace records as slices on a "requests" track and flow arrows joining
  one request's records across lanes (:func:`merge_chrome_trace`);
- :func:`rank_stage_rows` pivots the per-stage tables across ranks and
  flags a straggler: a stage whose slowest rank's per-span p95 exceeds
  the median p95 by ``SPARKDL_OBS_STRAGGLER_X`` and by
  ``SPARKDL_OBS_STRAGGLER_MIN_S`` (:func:`render_rank_report`);
- :func:`merged_metrics` combines the ranks' registries: counters sum,
  timers merge count-weighted (``utils/metrics.merge_timer_dicts``),
  gauges keep the worst last value and the max envelope.

The files keep the JAX package's name and keys, so either package's
reader reads the other's drops.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import defaultdict
from statistics import median
from typing import Dict, List, Optional

from sparkdl_tpu_torch.obs import export
from sparkdl_tpu_torch.obs.report import stage_rows
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import merge_timer_dicts

_RANK_SNAP_RE = re.compile(r"^obs\.rank\.(\d+)\.json$")


def straggler_min_gap_s() -> float:
    try:
        return knobs.get_float("SPARKDL_OBS_STRAGGLER_MIN_S")
    except ValueError:
        return 0.1


def straggler_factor() -> float:
    try:
        return max(1.0, knobs.get_float("SPARKDL_OBS_STRAGGLER_X"))
    except ValueError:
        return 1.5


def snap_interval_s() -> float:
    try:
        return knobs.get_float("SPARKDL_OBS_SNAP_S")
    except ValueError:  # malformed: the knob's declared default
        return float(knobs._default("SPARKDL_OBS_SNAP_S"))


def rank_snapshot_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"obs.rank.{int(rank)}.json")


def write_rank_snapshot(directory: str, rank: int, snap: Optional[dict] = None) -> str:
    """Write this process's snapshot as rank ``rank``'s drop, atomically
    (tmp + rename, like every file of the worker protocol)."""
    os.makedirs(directory, exist_ok=True)
    if snap is None:
        snap = export.snapshot(rank=int(rank))
    else:
        snap.setdefault("rank", int(rank))
    return export.write_snapshot(rank_snapshot_path(directory, rank), snap)


_last_drop: Dict[tuple, float] = {}
_drop_lock = threading.Lock()


def maybe_write_rank_snapshot(directory: str, rank: int, force: bool = False) -> Optional[str]:
    """The time-gated periodic drop: at most one per ``SPARKDL_OBS_SNAP_S``
    per (dir, rank), the first call always writes, and ``force`` writes on
    an exit path. An interval of 0 or less turns the periodic drops off.
    Never raises: this runs on the heartbeat path, and a full disk must not
    stop the beat."""
    try:
        interval = snap_interval_s()
        if interval <= 0 and not force:
            return None
        key = (os.path.abspath(directory), int(rank))
        now = time.monotonic()
        with _drop_lock:
            last = _last_drop.get(key)
            if not force and last is not None and now - last < interval:
                return None
            _last_drop[key] = now
        return write_rank_snapshot(directory, rank)
    except Exception:
        return None


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


# -- merge --------------------------------------------------------------------


#: The synthetic tid request-trace slices render under in each process
#: lane — far above any real thread index so the "requests" track sits
#: apart from the thread tracks.
_TRACE_TID = 9999


def _request_trace_events(rank: int, snap: dict) -> List[dict]:
    """One process lane's request-trace slices: a parent slice per
    trace record (gateway forwards and worker-side requests alike) plus
    the waterfall segments as nested child slices, so Perfetto
    renders the per-request waterfall inside the lane."""
    from sparkdl_tpu_torch.obs.trace import SEGMENTS

    events: List[dict] = []
    recs = snap.get("traces") or []
    for rec in recs:
        tid_short = (rec.get("trace_id") or "")[:8]
        start = float(rec.get("start_unix", 0.0))
        dur = max(float(rec.get("e2e_s", 0.0)), 1e-6)
        args = {
            "rank": rank,
            "trace_id": rec.get("trace_id"),
            "kind": rec.get("kind"),
            "status": rec.get("status"),
        }
        if rec.get("kind") == "gateway":
            args["attempts"] = rec.get("attempts")
            name = f"trace {tid_short} (gateway)"
        else:
            args.update(
                {
                    "model": rec.get("model"),
                    "cls": rec.get("cls"),
                    "rows": rec.get("rows"),
                }
            )
            name = f"trace {tid_short} ({rec.get('model')})"
        events.append(
            {
                "name": name,
                "ph": "X",
                "ts": start * 1e6,
                "dur": dur * 1e6,
                "pid": rank,
                "tid": _TRACE_TID,
                "args": args,
            }
        )
        segments = rec.get("segments") or {}
        offset = 0.0
        for seg in SEGMENTS:
            seg_dur = float(segments.get(seg, 0.0))
            if seg_dur <= 0.0:
                continue
            events.append(
                {
                    "name": seg,
                    "ph": "X",
                    "ts": (start + offset) * 1e6,
                    "dur": seg_dur * 1e6,
                    "pid": rank,
                    "tid": _TRACE_TID,
                    "args": {"trace_id": rec.get("trace_id")},
                }
            )
            offset += seg_dur
    if recs:
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": rank,
                "tid": _TRACE_TID,
                "args": {"name": "requests"},
            }
        )
    return events


def _trace_flow_events(snaps: Dict[int, dict]) -> List[dict]:
    """Chrome flow events binding one trace_id's records ACROSS process
    lanes — the line Perfetto draws from the gateway slice through each
    worker-side attempt. A trace seen in only one lane draws nothing
    (there is no flow to stitch)."""
    chains: Dict[str, List[tuple]] = {}
    for rank in sorted(snaps):
        for rec in snaps[rank].get("traces") or []:
            tid = rec.get("trace_id")
            if not tid:
                continue
            chains.setdefault(tid, []).append(
                (float(rec.get("start_unix", 0.0)), rank, rec)
            )
    events: List[dict] = []
    for tid, chain in sorted(chains.items()):
        if len(chain) < 2:
            continue
        chain.sort(key=lambda c: c[0])
        flow_id = _flow_id(tid)
        for i, (start, rank, rec) in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            ev = {
                "name": "request",
                "cat": "trace",
                "ph": ph,
                "id": flow_id,
                # bind inside the slice so Perfetto attaches the arrow
                "ts": (start + min(float(rec.get("e2e_s", 0.0)), 1e-3) / 2)
                * 1e6,
                "pid": rank,
                "tid": _TRACE_TID,
                "args": {"trace_id": tid},
            }
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)
    return events


def _flow_id(trace_id: str) -> int:
    """Stable 32-bit flow id from a trace id (Chrome flow ``id`` fields
    are numeric; the trace id itself rides ``args``)."""
    import hashlib

    return int.from_bytes(
        hashlib.sha1(trace_id.encode()).digest()[:4], "big"
    )


def _utilization_counter_events(rank: int, snap: dict) -> List[dict]:
    """One Chrome counter track per lane from the snapshot's
    utilization ledger: a ``ph: "C"`` sample per device at snapshot
    time, so the merged gang view renders each worker's busy/idle
    split as a counter row under its lane (Perfetto draws counters as
    bar tracks even from a single sample)."""
    util = snap.get("utilization") or {}
    devices = util.get("devices") or {}
    if not devices:
        return []
    ts = float(snap.get("generated_unix") or 0.0) * 1e6
    events: List[dict] = []
    for d, st in sorted(devices.items()):
        events.append(
            {
                "name": f"util device {d} (ms)",
                "ph": "C",
                "ts": ts,
                "pid": rank,
                "args": {
                    "busy_ms": st.get("busy_ms", 0.0),
                    "idle_ms": st.get("idle_ms", 0.0),
                    "h2d_ms": st.get("h2d_ms", 0.0),
                    "d2h_ms": st.get("d2h_ms", 0.0),
                },
            }
        )
    events.append(
        {
            "name": "util busy_frac",
            "ph": "C",
            "ts": ts,
            "pid": rank,
            "args": {"busy_frac": util.get("busy_frac", 0.0)},
        }
    )
    return events


def merge_chrome_trace(snaps: Dict[int, dict]) -> dict:
    """Fuse per-rank snapshots into one Chrome trace-event object with a
    labeled process lane per rank. Each rank's spans render through the
    SAME ``export.to_chrome_trace`` as single-process traces (with
    ``pid`` = rank and a ``rank`` arg on every event) — the merge adds
    only what has no single-process analogue: process lane labels,
    per-rank open spans as instant events (so a wedged rank's
    still-running stage is visible at the trace tail, not absent), each
    lane's request-trace slices (per-request waterfalls on a synthetic
    "requests" track), and flow events stitching one trace_id's records
    across lanes — a gateway re-dispatch after a worker death renders
    as two attempts joined by one flow."""
    events: List[dict] = []
    for rank in sorted(snaps):
        snap = snaps[rank]
        events.extend(
            export.to_chrome_trace(
                snap, pid=rank, extra_args={"rank": rank}
            )["traceEvents"]
        )
        events.extend(_request_trace_events(rank, snap))
        events.extend(_utilization_counter_events(rank, snap))
        gen = snap.get("generated_unix") or 0.0
        for osp in snap.get("open_spans", []):
            events.append(
                {
                    "name": f"OPEN {osp['name']}",
                    "ph": "i",
                    "s": "p",  # process-scoped instant marker
                    "ts": max(0.0, (gen - osp.get("age_s", 0.0))) * 1e6,
                    "pid": rank,
                    "tid": 0,
                    "args": {
                        "rank": rank,
                        "age_s": osp.get("age_s"),
                        **(osp.get("attrs") or {}),
                    },
                }
            )
        host = snap.get("host") or ""
        # a snapshot may carry a role (the gateway's drop does) so its
        # lane reads "gateway (...)" instead of a synthetic rank number
        role = snap.get("role")
        label = (role or f"rank {rank}") + (f" ({host})" if host else "")
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": rank,
                "args": {"name": label},
            }
        )
        events.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": rank,
                "args": {"sort_index": rank},
            }
        )
    events.extend(_trace_flow_events(snaps))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_merged_trace(path: str, snaps: Dict[int, dict]) -> str:
    return export.atomic_write_json(path, merge_chrome_trace(snaps))


def merged_metrics(snaps: Dict[int, dict]) -> dict:
    """One registry-shaped dict for the whole gang: counters sum, timers
    merge count-weighted (real reservoir resampling when the snapshots
    carry samples), gauges keep the across-rank max of last values (the
    fleet's worst depth) and the max envelope."""
    counters: Dict[str, float] = defaultdict(float)
    gauges: Dict[str, float] = {}
    gauge_stats: Dict[str, dict] = {}
    timer_lists: Dict[str, List[dict]] = defaultdict(list)
    for rank in sorted(snaps):
        m = snaps[rank].get("metrics") or {}
        for k, v in (m.get("counters") or {}).items():
            counters[k] += float(v)
        for k, v in (m.get("gauges") or {}).items():
            gauges[k] = max(gauges.get(k, float(v)), float(v))
        for k, st in (m.get("gauge_stats") or {}).items():
            cur = gauge_stats.get(k)
            if cur is None:
                gauge_stats[k] = dict(st)
            else:
                cur["min"] = min(cur["min"], st["min"])
                cur["max"] = max(cur["max"], st["max"])
                cur["last"] = max(cur["last"], st["last"])
        for k, td in (m.get("timers") or {}).items():
            timer_lists[k].append(td)
    return {
        "counters": dict(counters),
        "gauges": gauges,
        "gauge_stats": gauge_stats,
        "timers": {k: merge_timer_dicts(ds) for k, ds in timer_lists.items()},
    }


# -- straggler detection ------------------------------------------------------


def rank_stage_rows(
    snaps: Dict[int, dict], factor: Optional[float] = None
) -> List[dict]:
    """Pivot per-rank stage tables into one row per stage with straggler
    flags. Flagging compares per-span **p95**, not totals: totals are
    observation-window-sized, so a rank that died early (frozen
    snapshot) would make every still-running healthy rank look like a
    straggler — per-span cost is window-invariant, and a wedged-but-
    progressing rank's p95 is exactly what diverges. A stage is flagged
    when its slowest rank's p95 exceeds the across-rank median p95 by
    ``factor`` AND by an absolute gap above jitter; ranks that never
    recorded the stage are listed separately — a rank missing
    ``device_wait`` entirely is its own signal."""
    factor = factor if factor is not None else straggler_factor()
    per_rank_rows: Dict[int, Dict[str, dict]] = {
        rank: {r["stage"]: r for r in stage_rows(snap)}
        for rank, snap in snaps.items()
    }
    stages = sorted({s for rows in per_rank_rows.values() for s in rows})
    out: List[dict] = []
    for stage in stages:
        per_rank = {
            rank: {
                "count": rows[stage]["count"],
                "total_s": rows[stage]["total_s"],
                "p95_s": rows[stage]["p95_s"],
            }
            for rank, rows in per_rank_rows.items()
            if stage in rows
        }
        totals = {rank: d["total_s"] for rank, d in per_rank.items()}
        p95s = {rank: d["p95_s"] for rank, d in per_rank.items()}
        med_total = median(sorted(totals.values()))
        med_p95 = median(sorted(p95s.values()))
        slowest_rank = max(p95s, key=lambda r: p95s[r])
        slowest_p95 = p95s[slowest_rank]
        ratio = (slowest_p95 / med_p95) if med_p95 > 0 else None
        straggler = slowest_p95 - med_p95 > straggler_min_gap_s() and (
            med_p95 == 0 or slowest_p95 / med_p95 >= factor
        )
        out.append(
            {
                "stage": stage,
                "per_rank": per_rank,
                "median_s": med_total,
                "median_p95_s": med_p95,
                "slowest_rank": slowest_rank,
                "slowest_s": totals[slowest_rank],
                "slowest_p95_s": slowest_p95,
                "ratio": round(ratio, 3) if ratio is not None else None,
                "straggler": straggler,
                "missing_ranks": sorted(
                    r for r in per_rank_rows if r not in per_rank
                ),
            }
        )
    return out


def straggler_summary(
    snaps: Dict[int, dict], factor: Optional[float] = None
) -> List[dict]:
    """Just the flagged rows, compacted for embedding (heartbeat CLI)."""
    return [
        {
            "stage": r["stage"],
            "slowest_rank": r["slowest_rank"],
            "slowest_s": round(r["slowest_s"], 4),
            "median_s": round(r["median_s"], 4),
            "slowest_p95_s": round(r["slowest_p95_s"], 4),
            "median_p95_s": round(r["median_p95_s"], 4),
            "ratio": r["ratio"],
        }
        for r in rank_stage_rows(snaps, factor)
        if r["straggler"]
    ]


def render_rank_report(
    snaps: Dict[int, dict], factor: Optional[float] = None
) -> str:
    """Human-readable per-rank stage table: one column of stage totals
    per rank, median/slowest/ratio columns, ``<<`` marking flagged
    stragglers, plus each rank's still-open spans (what a quiet rank is
    doing RIGHT NOW)."""
    if not snaps:
        return "(no per-rank snapshots found)"
    factor = factor if factor is not None else straggler_factor()
    ranks = sorted(snaps)
    rows = rank_stage_rows(snaps, factor)
    header = (
        ["stage"]
        + [f"r{r}_s" for r in ranks]
        + ["median_s", "slowest", "ratio", "flag"]
    )
    table = [tuple(header)]
    for row in rows:
        cells = [row["stage"]]
        for r in ranks:
            d = row["per_rank"].get(r)
            cells.append(f"{d['total_s']:.3f}" if d else "-")
        cells.append(f"{row['median_s']:.3f}")
        cells.append(f"r{row['slowest_rank']}")
        cells.append(f"{row['ratio']:.2f}" if row["ratio"] is not None else "-")
        cells.append("<< straggler" if row["straggler"] else "")
        table.append(tuple(cells))
    widths = [
        max(len(row[c]) for row in table) for c in range(len(header))
    ]
    lines = []
    for i, row in enumerate(table):
        lines.append(
            "  ".join(
                cell.ljust(w) if c in (0, len(header) - 1) else cell.rjust(w)
                for c, (cell, w) in enumerate(zip(row, widths))
            ).rstrip()
        )
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    flagged = [r for r in rows if r["straggler"]]
    lines.append("")
    if flagged:
        for r in flagged:
            lines.append(
                f"straggler: stage '{r['stage']}' rank {r['slowest_rank']} "
                f"p95 {r['slowest_p95_s']:.3f}s vs median p95 "
                f"{r['median_p95_s']:.3f}s"
                + (f" ({r['ratio']:.2f}x)" if r["ratio"] is not None else "")
            )
    else:
        lines.append(
            f"no stragglers (threshold {factor:.2f}x median per-span p95)"
        )
    for rank in ranks:
        open_spans = snaps[rank].get("open_spans") or []
        for osp in open_spans:
            lines.append(
                f"rank {rank} OPEN: {osp['name']} "
                f"age {osp.get('age_s', 0):.1f}s {osp.get('attrs') or {}}"
            )
    for rank in ranks:
        util = snaps[rank].get("utilization") or {}
        if util.get("devices"):
            lines.append(
                f"rank {rank} utilization: chips busy "
                f"{util.get('busy_frac', 0.0):.1%} of wall-clock "
                f"({len(util['devices'])} device(s))"
            )
    return "\n".join(lines)


__all__ = [
    "load_rank_snapshots",
    "merge_chrome_trace",
    "merged_metrics",
    "rank_snapshot_path",
    "rank_stage_rows",
    "render_rank_report",
    "straggler_summary",
    "write_merged_trace",
    "write_rank_snapshot",
]
