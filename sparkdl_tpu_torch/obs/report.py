"""Per-stage breakdown report over an obs snapshot.

The port of the JAX package's ``obs/report.py``, the same functions on
the same snapshot keys. A section whose counters the port never records
(``compile_summary``: the port runs eager, with no compile cache) returns
None, as every section does when its counters are absent.

Aggregates the ring buffer's spans by stage name into count / total /
p50 / p95 / p99 / bytes/s rows, plus the host<->device *overlap ratio* —
the fraction of the smaller side's busy time that ran concurrently with
the other side. The three-stage software pipeline in
``transformers/execution.py`` exists to drive that ratio toward 1.0
(host assembly hidden under device compute); a low ratio with a busy
host column is the "chip idles during batch assembly" regression,
visible here without a profiler run.

Percentiles here are exact over the spans in the ring buffer (bounded by
``SPARKDL_OBS_RING``), unlike the registry timers' reservoir estimates —
the two agree within reservoir error.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from sparkdl_tpu_torch.utils.metrics import percentile_of_sorted as _percentile

# Stage classification for the overlap ratio: work burning host CPU vs
# work representing device/transfer time. executor/worker partition
# spans ENCLOSE both sides, so they belong to neither. drain_wait is the
# async-readback arm's residual D2H wait (device_wait renamed when the
# copy was already issued at dispatch time — see runtime/readback.py);
# stage_wait is the staged-H2D arm's residual wait claiming a device
# staging slot whose copy was issued at pack time (runtime/transfer.py).
HOST_STAGES = ("ingest",)
DEVICE_STAGES = ("h2d", "dispatch", "device_wait", "drain_wait", "stage_wait")


def _merged_intervals(
    spans: Iterable[dict], names: Tuple[str, ...]
) -> List[Tuple[float, float]]:
    ivs = sorted(
        (s["start_unix"], s["start_unix"] + s["dur_s"])
        for s in spans
        if s["name"] in names and s["dur_s"] > 0
    )
    merged: List[Tuple[float, float]] = []
    for lo, hi in ivs:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _intersection_s(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_ratio(spans: Iterable[dict]) -> Optional[float]:
    """Fraction of the smaller of (host busy, device busy) time that ran
    under the other side. None when either side recorded nothing."""
    spans = list(spans)
    host = _merged_intervals(spans, HOST_STAGES)
    dev = _merged_intervals(spans, DEVICE_STAGES)
    host_s = sum(hi - lo for lo, hi in host)
    dev_s = sum(hi - lo for lo, hi in dev)
    if host_s <= 0 or dev_s <= 0:
        return None
    return _intersection_s(host, dev) / min(host_s, dev_s)


def stage_rows(snap: dict) -> List[dict]:
    """Aggregate a snapshot's spans into one row per stage name."""
    by_name: Dict[str, List[dict]] = {}
    for sp in snap.get("spans", []):
        by_name.setdefault(sp["name"], []).append(sp)
    rows = []
    for name in sorted(by_name):
        group = by_name[name]
        durs = sorted(sp["dur_s"] for sp in group)
        total = sum(durs)
        nbytes = sum(
            float(sp["attrs"].get("bytes", 0) or 0) for sp in group
        )
        nrows = sum(float(sp["attrs"].get("rows", 0) or 0) for sp in group)
        rows.append(
            {
                "stage": name,
                "count": len(group),
                "total_s": total,
                "p50_s": _percentile(durs, 50),
                "p95_s": _percentile(durs, 95),
                "p99_s": _percentile(durs, 99),
                "rows": int(nrows),
                "bytes": int(nbytes),
                "bytes_per_s": (nbytes / total) if total > 0 else 0.0,
            }
        )
    return rows


def feeder_summary(snap: dict) -> Optional[dict]:
    """Shared-feeder counters from a snapshot's metrics registry, or None
    when the feeder never engaged. ``pad_frac`` is the fraction of all
    dispatched device rows that were padding — the number the
    cross-partition coalescing exists to drive toward zero (one tail
    flush per quiet period instead of one padded tail per partition)."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    batches = counters.get("feeder.coalesced_batches", 0)
    if not batches:
        return None
    rows = counters.get("feeder.rows", 0)
    pad = counters.get("feeder.pad_rows", 0)
    dispatched = rows + pad
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    out = {
        "coalesced_batches": int(batches),
        "rows": int(rows),
        "pad_rows": int(pad),
        "pad_frac": round(pad / dispatched, 4) if dispatched else 0.0,
        "flushes": int(counters.get("feeder.flushes", 0)),
    }
    hits = counters.get("feeder.readback_async_hits", 0)
    misses = counters.get("feeder.readback_async_misses", 0)
    if hits or misses:
        # Async-readback overlap attribution: a hit = the D2H copy had
        # already completed when the drain started (fully overlapped); a
        # miss = the drain still waited out a residual.
        out["readback_async_hits"] = int(hits)
        out["readback_async_misses"] = int(misses)
    s_hits = counters.get("transfer.stage_hits", 0)
    s_misses = counters.get("transfer.stage_misses", 0)
    if s_hits or s_misses:
        # Device-staging overlap attribution (the H2D mirror of the
        # readback pair): a hit = the staged copy had already landed
        # when dispatch claimed its slot; a miss = dispatch waited out
        # a residual (the stage_wait span carries the time).
        out["stage_hits"] = int(s_hits)
        out["stage_misses"] = int(s_misses)
    g_batches = counters.get("feeder.global_batches", 0)
    if g_batches:
        # Mesh arm: how many coalesced batches were GLOBAL batches (one
        # dispatch sharding rows over every chip in a mesh program).
        out["global_batches"] = int(g_batches)
    if "feeder.queue_depth" in gauges:
        out["last_queue_depth"] = int(gauges["feeder.queue_depth"])
    # Burst visibility: the owner zeroes the depth gauges on exit, so the
    # post-run "last" is 0 by design — the max envelope carries the burst.
    stats = (snap.get("metrics") or {}).get("gauge_stats") or {}
    if "feeder.queue_depth" in stats:
        out["peak_queue_depth"] = int(stats["feeder.queue_depth"]["max"])
    return out


def compile_summary(snap: dict) -> Optional[dict]:
    """Compile-cache attribution from a snapshot's registry, or None
    when no program builds were recorded (``compile.cache_hits`` /
    ``compile.cache_misses`` and the ``compile.warmup`` timer, which the
    JAX package's compile cache records). The port runs eager and records
    none of them, so on its own snapshots this is None."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    timers = (snap.get("metrics") or {}).get("timers") or {}
    hits = counters.get("compile.cache_hits", 0)
    misses = counters.get("compile.cache_misses", 0)
    warm = timers.get("compile.warmup")
    if not (hits or misses or (warm and warm.get("count"))):
        return None
    out = {
        "cache_hits": int(hits),
        "cache_misses": int(misses),
    }
    if warm and warm.get("count"):
        out["warmup"] = {
            "builds": int(warm["count"]),
            "total_s": round(warm.get("total_s", 0.0), 3),
            "mean_s": round(warm.get("mean_s", 0.0), 3),
        }
    return out


def text_summary(snap: dict) -> Optional[dict]:
    """Sequence-bucketing counters from a snapshot's registry, or None
    when no text rows were routed. ``pad_ratio`` is bucket-edge padding
    as a fraction of all dispatched TOKENS — the number the length
    buckets exist to drive down from the pad-to-maxLength path's >50%
    (the row-tail batch padding below it rides ``feeder.pad_rows``);
    ``bucket_rows`` maps each elected bucket edge to the rows it
    served, and ``truncated_rows`` counts rows that lost tokens to the
    top edge — the documented lossy case."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    tokens = counters.get("text.tokens", 0)
    pad = counters.get("text.pad_tokens", 0)
    truncated = counters.get("text.truncated_rows", 0)
    if not (tokens or pad or truncated):
        return None
    buckets = {
        int(name.rsplit(".", 1)[-1]): int(v)
        for name, v in counters.items()
        if name.startswith("text.bucket_rows.")
    }
    dispatched = tokens + pad
    return {
        "tokens": int(tokens),
        "pad_tokens": int(pad),
        "pad_ratio": round(pad / dispatched, 4) if dispatched else 0.0,
        "truncated_rows": int(truncated),
        "bucket_rows": dict(sorted(buckets.items())),
    }


def sql_summary(snap: dict) -> Optional[dict]:
    """SQL optimizer counters from a snapshot's registry, or None when
    no query touched the optimizer surface. ``batches``/``batch_rows``
    are the catalog-UDF dispatches routed through the vectorized arm
    (under feeder coalescing a batch count BELOW the partition count is
    the cross-partition-packing proof); ``pruned_cols`` and
    ``skipped_rows`` are what projection/predicate pushdown avoided
    materializing; ``vectorized`` is the arm the LAST planned UDF query
    ran under (the ``SPARKDL_SQL_VECTORIZE`` A/B gauge)."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    batches = counters.get("sql.udf.batches", 0)
    batch_rows = counters.get("sql.udf.batch_rows", 0)
    pruned = counters.get("sql.pushdown.pruned_cols", 0)
    skipped = counters.get("sql.pushdown.skipped_rows", 0)
    vec = gauges.get("sql.udf.vectorized")
    if not (batches or batch_rows or pruned or skipped or vec is not None):
        return None
    out = {
        "batches": int(batches),
        "batch_rows": int(batch_rows),
        "pruned_cols": int(pruned),
        "skipped_rows": int(skipped),
    }
    if vec is not None:
        out["vectorized"] = bool(vec)
    return out


def serving_summary(snap: dict) -> Optional[dict]:
    """Online-serving counters/latencies from a snapshot's registry, or
    None when the serving layer never admitted a request. Per-class p95
    comes from the ``serve.latency.<class>`` timer reservoirs — the
    numbers the router's adaptive batch window steers against — and the
    ``serve.batch_rows`` min/max pair shows the adaptive range the
    batcher actually used (min = latency-mode rung, max = geometry
    under load)."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    admitted = counters.get("serve.admitted", 0)
    if not admitted:
        return None
    timers = (snap.get("metrics") or {}).get("timers") or {}
    out = {
        "admitted": int(admitted),
        "completed": int(counters.get("serve.completed", 0)),
        "rejected": int(counters.get("serve.rejected", 0)),
        "expired": int(counters.get("serve.expired", 0)),
        "failures": int(counters.get("serve.failures", 0)),
        "dispatches": int(counters.get("serve.dispatches", 0)),
        "pad_rows": int(counters.get("serve.pad_rows", 0)),
        "evictions": int(counters.get("serve.evictions", 0)),
        "model_loads": int(counters.get("serve.model_loads", 0)),
        "by_class": {},
    }
    exemplars = snap.get("exemplars") or {}
    for cls in ("interactive", "batch", "background"):
        t = timers.get(f"serve.latency.{cls}")
        if not t or not t.get("count"):
            continue
        out["by_class"][cls] = {
            "count": int(t["count"]),
            "p50_ms": round(t.get("p50_s", 0.0) * 1e3, 2),
            "p95_ms": round(t.get("p95_s", 0.0) * 1e3, 2),
            "p99_ms": round(t.get("p99_s", 0.0) * 1e3, 2),
        }
        # Tail exemplar: the slowest completion this class's reservoir
        # kept, with the trace id `obs trace <id>` dissects — every
        # tail number in the report links to a concrete waterfall.
        ex = (exemplars.get(f"serve.latency.{cls}") or [None])[0]
        if ex:
            out["by_class"][cls]["p99_exemplar"] = ex["trace_id"]
    rows = timers.get("serve.batch_rows")
    if rows and rows.get("count"):
        out["batch_rows"] = {
            "dispatches": int(rows["count"]),
            "min": int(rows.get("min_s", 0)),
            "mean": round(rows.get("mean_s", 0.0), 1),
            "max": int(rows.get("max_s", 0)),
        }
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    chip_rows = counters.get("serve.mesh.chip_rows", 0)
    if chip_rows or gauges.get("serve.mesh.width", 0) > 1:
        # feeder.global_batches deliberately NOT repeated here: it is
        # feeder-wide (any batch_multiplier>1 stream, serving or not)
        # and lives in feeder_summary; this block only claims what the
        # ROUTER dispatched.
        out["mesh"] = {
            "width": int(gauges.get("serve.mesh.width", 0)),
            "chip_rows": int(chip_rows),
        }
    precision_arms = {}
    for name, v in counters.items():
        if not name.startswith("serve.precision."):
            continue
        rest = name[len("serve.precision."):]
        arm, _, field = rest.rpartition(".")
        if field in ("requests", "rows") and arm:
            precision_arms.setdefault(arm, {})[field] = int(v)
    if precision_arms:
        for arm, d in precision_arms.items():
            t = timers.get(f"serve.precision.{arm}.latency")
            if t and t.get("count"):
                d["p95_ms"] = round(t.get("p95_s", 0.0) * 1e3, 2)
        out["precision"] = dict(sorted(precision_arms.items()))
    drains = int(counters.get("serve.drains", 0))
    if drains:
        out["drain"] = {
            "drains": drains,
            "rejected_while_draining": int(
                counters.get("serve.draining_rejects", 0)
            ),
        }
    canary = int(counters.get("serve.canary.requests", 0))
    primary = int(counters.get("serve.primary.requests", 0))
    if canary or primary:
        out["canary"] = {
            "canary_requests": canary,
            "primary_requests": primary,
            "canary_failures": int(
                counters.get("serve.canary.failures", 0)
            ),
            "primary_failures": int(
                counters.get("serve.primary.failures", 0)
            ),
            "rollbacks": int(counters.get("serve.canary.rollbacks", 0)),
        }
        for arm in ("canary", "primary"):
            t = timers.get(f"serve.{arm}.latency")
            if t and t.get("count"):
                out["canary"][f"{arm}_p95_ms"] = round(
                    t.get("p95_s", 0.0) * 1e3, 2
                )
    return out


def generation_summary(snap: dict) -> Optional[dict]:
    """Autoregressive-generation counters from a snapshot's registry,
    or None when no generate request ran. Continuous batching shows up
    as ``joins`` (sequences that enrolled into an already-running
    decode batch) and ``slot_reuse`` (a retired sequence's slot handed
    to a newcomer); the KV-cache pressure story is ``kv_rejected``
    (reservations the device-memory budget refused at admission — the 429s that
    would otherwise have been device OOMs). The ``gen.prefill_ms`` /
    ``gen.decode_step_ms`` reservoirs record MILLISECOND values, so
    their quantiles are used as-is (no s->ms rescale)."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    seqs = counters.get("gen.seqs", 0)
    rejected = counters.get("gen.kv_rejected", 0)
    if not seqs and not rejected:
        return None
    timers = (snap.get("metrics") or {}).get("timers") or {}
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    out = {
        "seqs": int(seqs),
        "tokens_out": int(counters.get("gen.tokens_out", 0)),
        "decode_steps": int(counters.get("gen.decode_steps", 0)),
        "joins": int(counters.get("gen.joins", 0)),
        "slot_reuse": int(counters.get("gen.slot_reuse", 0)),
        "kv_rejected": int(rejected),
        "kv_bytes": int(gauges.get("gen.kv_bytes", 0)),
        "active_seqs": int(gauges.get("gen.active_seqs", 0)),
    }
    for label, name in (
        ("prefill", "gen.prefill_ms"),
        ("decode_step", "gen.decode_step_ms"),
    ):
        t = timers.get(name)
        if t and t.get("count"):
            out[label] = {
                "count": int(t["count"]),
                "mean_ms": round(t.get("mean_s", 0.0), 2),
                "p95_ms": round(t.get("p95_s", 0.0), 2),
            }
    return out


def gateway_summary(snap: dict) -> Optional[dict]:
    """Serving-gang routing counters from a snapshot's registry, or None
    when no gateway handled a request in this process. Worker-side
    serving metrics live in the workers' own registries — this block is
    the gateway's view: how often requests were re-dispatched off a
    dying worker and whether any were unroutable."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    requests = counters.get("gateway.requests", 0)
    if not requests:
        return None
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    out = {
        "requests": int(requests),
        "retries": int(counters.get("gateway.retries", 0)),
        "rerouted": int(counters.get("gateway.rerouted", 0)),
        "unroutable": int(counters.get("gateway.unroutable", 0)),
    }
    if "gateway.ready_workers" in gauges:
        out["ready_workers"] = int(gauges["gateway.ready_workers"])
    return out


def fleet_summary(snap: dict) -> Optional[dict]:
    """Fused fleet view from a snapshot, or None when no fleet scrape
    ever ran in this process (everything but the gateway). Prefers the
    snapshot's ``"fleet"`` key (the latest fused sample off the fleet
    ring); falls back to the ``fleet.*`` aggregate gauges."""
    live = snap.get("fleet")
    if live and live.get("latest"):
        latest = live["latest"]
        return {
            "ready_workers": int(latest.get("ready_workers", 0)),
            "stale_workers": int(latest.get("stale_workers", 0)),
            "busy_frac": latest.get("busy_frac"),
            "req_per_s": latest.get("req_per_s"),
            "tripped": list(latest.get("tripped") or []),
            "samples": int(live.get("samples", 0)),
        }
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    if "fleet.ready_workers" not in gauges:
        return None
    tripped = [
        name[len("fleet.slo.alert."):]
        for name, v in gauges.items()
        if name.startswith("fleet.slo.alert.") and v
    ]
    return {
        "ready_workers": int(gauges["fleet.ready_workers"]),
        "stale_workers": int(gauges.get("fleet.stale_workers", 0)),
        "busy_frac": gauges.get("fleet.busy_frac"),
        "req_per_s": gauges.get("fleet.req_per_s"),
        "tripped": sorted(tripped),
        "samples": 0,
    }


def trace_summary(snap: dict) -> Optional[dict]:
    """Request-tracing activity from a snapshot, or None when no trace
    was ever sampled/stored in this process. ``queue_wait``/
    ``group_wait`` are the admission-side halves of the per-request
    waterfall (the device-side halves live in the stage table) — the
    pair that names "admission backlog" vs "device" when a serving
    number moves."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    traces = snap.get("traces") or []
    sampled = counters.get("trace.sampled", 0)
    records = counters.get("trace.records", 0)
    if not (sampled or records or traces):
        return None
    out = {
        "sampled": int(sampled),
        "records": int(records),
        "retained": len(traces),
        "exemplars": int(counters.get("trace.exemplars", 0)),
        "stitched_attempts": int(
            counters.get("trace.stitched_attempts", 0)
        ),
    }
    timers = (snap.get("metrics") or {}).get("timers") or {}
    for seg, name in (
        ("queue_wait", "serve.queue_wait"),
        ("group_wait", "serve.group_wait"),
    ):
        t = timers.get(name)
        if t and t.get("count"):
            out[seg] = {
                "mean_ms": round(t.get("mean_s", 0.0) * 1e3, 2),
                "p95_ms": round(t.get("p95_s", 0.0) * 1e3, 2),
            }
    return out


def slo_summary(snap: dict) -> Optional[dict]:
    """Burn-rate SLO status from a snapshot, or None when no objective
    was ever armed. Prefers the snapshot's live ``"slo"`` key (written
    by ``export.snapshot`` when ``SPARKDL_SLO_*`` objectives are
    configured — burn rates included); falls back to the sticky
    ``slo.alert.<class>`` gauges + trip counters for snapshots from
    writers that predate the key."""
    live = snap.get("slo")
    if live and live.get("armed"):
        out = {
            "fast_window_s": live.get("fast_window_s"),
            "slow_window_s": live.get("slow_window_s"),
            "classes": {},
        }
        for cls, st in (live.get("classes") or {}).items():
            row = {"tripped": bool(st.get("tripped"))}
            for obj in st.get("objectives") or []:
                key = (
                    "availability"
                    if obj.get("objective") == "availability"
                    else "latency"
                )
                row[key] = {
                    "burn_fast": obj.get("burn_fast"),
                    "burn_slow": obj.get("burn_slow"),
                }
                if "observed_p95_ms" in obj:
                    row[key]["observed_p95_ms"] = obj["observed_p95_ms"]
            out["classes"][cls] = row
        return out
    counters = (snap.get("metrics") or {}).get("counters") or {}
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    classes = {}
    for cls in ("interactive", "batch", "background"):
        trips = counters.get(f"slo.trips.{cls}", 0)
        alert = gauges.get(f"slo.alert.{cls}")
        if not trips and alert is None:
            continue
        classes[cls] = {
            "tripped": bool(alert),
            "trips": int(trips),
            "recoveries": int(counters.get(f"slo.recoveries.{cls}", 0)),
        }
    return {"classes": classes} if classes else None


def utilization_summary(snap: dict) -> Optional[dict]:
    """Device-utilization roll-up from a snapshot, or None when no
    device ever dispatched. Prefers the live ``"utilization"`` key (the
    ledger's conservation-checked view, tail idle included); falls back
    to the monotone ``util.*`` counters. ``dominant_wait`` names the
    larger of the admission-side wait reservoirs — the one-line answer
    to "the chips are idle: where is the time?"."""
    live = snap.get("utilization")
    counters = (snap.get("metrics") or {}).get("counters") or {}
    if live:
        out = {
            "busy_frac": live.get("busy_frac", 0.0),
            "devices": live.get("devices") or {},
        }
        if "mfu" in live:
            out["mfu"] = live["mfu"]
    else:
        devices: Dict[str, dict] = {}
        for name, v in counters.items():
            for field in (
                "device_busy_ms", "device_idle_ms", "h2d_ms", "d2h_ms",
            ):
                prefix = f"util.{field}."
                if name.startswith(prefix):
                    d = name[len(prefix):]
                    devices.setdefault(d, {})[
                        field.replace("device_", "")
                    ] = round(float(v), 3)
        if not devices:
            return None
        busy = sum(d.get("busy_ms", 0.0) for d in devices.values())
        wall = busy + sum(d.get("idle_ms", 0.0) for d in devices.values())
        out = {
            "busy_frac": round(busy / wall, 4) if wall > 0 else 0.0,
            "devices": dict(sorted(devices.items())),
        }
    timers = (snap.get("metrics") or {}).get("timers") or {}
    waits = {
        seg: t.get("total_s", 0.0)
        for seg, name in (
            ("queue_wait", "serve.queue_wait"),
            ("group_wait", "serve.group_wait"),
        )
        if (t := timers.get(name)) and t.get("count")
    }
    if waits:
        out["dominant_wait"] = max(waits, key=waits.get)
    return out


def memory_summary(snap: dict) -> Optional[dict]:
    """Device-memory roll-up from a snapshot, or None when nothing was
    ever tracked. Prefers the live ``"memory"`` key (the ledger's
    ground-truth-reconciled view); falls back to the ``mem.*`` gauge
    families for snapshots from writers without the key."""
    live = snap.get("memory")
    if live:
        return {
            "tracked_bytes": int(live.get("tracked_bytes") or 0),
            "watermark_bytes": int(live.get("watermark_bytes") or 0),
            "unattributed_bytes": live.get("unattributed_bytes"),
            "ground_truth_source": live.get("ground_truth_source"),
            "leaked_bytes": int(live.get("leaked_bytes") or 0),
            "oom_events": int(live.get("oom_events") or 0),
            "models": live.get("models") or {},
            "devices": live.get("devices") or {},
        }
    gauges = (snap.get("metrics") or {}).get("gauges") or {}
    counters = (snap.get("metrics") or {}).get("counters") or {}
    devices: Dict[str, dict] = {}
    for name, v in gauges.items():
        for field, prefix in (
            ("device_bytes", "mem.device_bytes."),
            ("watermark_bytes", "mem.watermark_bytes."),
        ):
            if name.startswith(prefix):
                devices.setdefault(name[len(prefix):], {})[field] = int(v)
    models = {
        name[len("mem.model_bytes."):]: int(v)
        for name, v in gauges.items()
        if name.startswith("mem.model_bytes.")
    }
    if not devices and not models:
        return None
    return {
        "tracked_bytes": sum(
            d.get("device_bytes", 0) for d in devices.values()
        ),
        "watermark_bytes": max(
            (d.get("watermark_bytes", 0) for d in devices.values()),
            default=0,
        ),
        "unattributed_bytes": gauges.get("mem.unattributed_bytes"),
        "ground_truth_source": None,
        "leaked_bytes": int(counters.get("mem.leaked_bytes", 0)),
        "oom_events": int(counters.get("mem.oom_events", 0)),
        "models": models,
        "devices": dict(sorted(devices.items())),
    }


def resilience_summary(snap: dict) -> Optional[dict]:
    """Recovery-activity counters from a snapshot's registry, or None
    when the run was failure-free (the common case should print
    nothing). A nonzero row here is the report-level cue to go read the
    JSONL event log, where every retry-exhaustion/fault/restart has a
    structured record."""
    counters = (snap.get("metrics") or {}).get("counters") or {}
    out = {
        key: int(counters.get(name, 0))
        for key, name in (
            ("retries", "executor.partition.retries"),
            ("retry_exhausted", "executor.partition.retry_exhausted"),
            ("fatal_errors", "executor.partition.fatal_errors"),
            ("faults_injected", "faults.injected"),
            ("supervisor_restarts", "supervisor.restarts"),
            ("ranks_killed", "supervisor.ranks_killed"),
            ("partitions_resumed", "worker.partitions.resumed"),
        )
    }
    return out if any(out.values()) else None


def stage_summary(snap: dict) -> dict:
    """Compact per-stage dict (ms-denominated) for embedding in BENCH
    records: small enough for a one-line JSON, rich enough to attribute
    a regression to a stage without rerunning under a profiler."""
    out = {}
    for row in stage_rows(snap):
        out[row["stage"]] = {
            "n": row["count"],
            "total_ms": round(row["total_s"] * 1e3, 1),
            "p50_ms": round(row["p50_s"] * 1e3, 2),
            "p95_ms": round(row["p95_s"] * 1e3, 2),
            "p99_ms": round(row["p99_s"] * 1e3, 2),
            **(
                {"mb_per_s": round(row["bytes_per_s"] / 2**20, 1)}
                if row["bytes"]
                else {}
            ),
        }
    ratio = overlap_ratio(snap.get("spans", []))
    if ratio is not None:
        out["_overlap"] = round(ratio, 3)
    return out


def _fmt_bytes_per_s(v: float) -> str:
    if v <= 0:
        return "-"
    for unit in ("B/s", "KB/s", "MB/s", "GB/s"):
        if v < 1024 or unit == "GB/s":
            return f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}GB/s"


def render_report(snap: dict) -> str:
    """Human-readable per-stage table + overlap line for a snapshot."""
    rows = stage_rows(snap)
    header = (
        "stage", "count", "total_s", "p50_ms", "p95_ms", "p99_ms",
        "rows", "throughput",
    )
    table: List[Tuple[str, ...]] = [header]
    for r in rows:
        table.append(
            (
                r["stage"],
                str(r["count"]),
                f"{r['total_s']:.3f}",
                f"{r['p50_s'] * 1e3:.2f}",
                f"{r['p95_s'] * 1e3:.2f}",
                f"{r['p99_s'] * 1e3:.2f}",
                str(r["rows"]) if r["rows"] else "-",
                _fmt_bytes_per_s(r["bytes_per_s"]),
            )
        )
    widths = [max(len(row[c]) for row in table) for c in range(len(header))]
    lines = []
    for i, row in enumerate(table):
        lines.append(
            "  ".join(
                cell.ljust(w) if c == 0 else cell.rjust(w)
                for c, (cell, w) in enumerate(zip(row, widths))
            )
        )
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    if not rows:
        lines.append("(no spans recorded)")
    ratio = overlap_ratio(snap.get("spans", []))
    if ratio is not None:
        lines.append("")
        lines.append(
            f"host/device overlap: {ratio:.1%} of the smaller side's busy "
            "time ran concurrently with the other"
        )
    feeder = feeder_summary(snap)
    if feeder is not None:
        lines.append("")
        lines.append(
            "shared feeder: {coalesced_batches} coalesced batches, "
            "{rows} rows, {pad_rows} pad rows ({pct:.1%} of dispatched), "
            "{flushes} tail flushes".format(
                pct=feeder["pad_frac"], **feeder
            )
        )
        hits = feeder.get("readback_async_hits", 0)
        misses = feeder.get("readback_async_misses", 0)
        if hits or misses:
            lines.append(
                "async readback: {h} copies complete at drain, {m} still "
                "pending ({pct:.1%} of drains fully overlapped)".format(
                    h=hits, m=misses, pct=hits / (hits + misses)
                )
            )
        s_hits = feeder.get("stage_hits", 0)
        s_misses = feeder.get("stage_misses", 0)
        if s_hits or s_misses:
            lines.append(
                "device staging: {h} H2D copies landed before dispatch "
                "needed them, {m} waited ({pct:.1%} of dispatches fully "
                "overlapped)".format(
                    h=s_hits,
                    m=s_misses,
                    pct=s_hits / (s_hits + s_misses),
                )
            )
    compiled = compile_summary(snap)
    if compiled is not None:
        lines.append("")
        line = (
            "compile cache: {cache_hits} hits / {cache_misses} misses"
        ).format(**compiled)
        if "warmup" in compiled:
            line += (
                "; warmup {total_s}s over {builds} build(s)"
            ).format(**compiled["warmup"])
        lines.append(line)
    text = text_summary(snap)
    if text is not None:
        lines.append("")
        lines.append(
            "text bucketing: {tokens} tokens + {pad_tokens} bucket-edge "
            "pad ({pad_ratio:.1%} of dispatched), {truncated_rows} rows "
            "truncated".format(**text)
        )
        if text["bucket_rows"]:
            lines.append(
                "  rows per bucket: "
                + ", ".join(
                    f"{edge}:{rows}"
                    for edge, rows in text["bucket_rows"].items()
                )
            )
    sqlopt = sql_summary(snap)
    if sqlopt is not None:
        lines.append("")
        line = (
            "sql: {batch_rows} UDF rows in {batches} device batches; "
            "pushdown pruned {pruned_cols} col(s), skipped "
            "{skipped_rows} rows"
        ).format(**sqlopt)
        if "vectorized" in sqlopt:
            line += "; arm=" + (
                "vectorized" if sqlopt["vectorized"] else "row"
            )
        lines.append(line)
    serving = serving_summary(snap)
    if serving is not None:
        lines.append("")
        cls_bits = ", ".join(
            f"{cls} p95 {stats['p95_ms']:.1f}ms (n={stats['count']})"
            + (
                f" [trace {stats['p99_exemplar']}]"
                if "p99_exemplar" in stats
                else ""
            )
            for cls, stats in serving["by_class"].items()
        )
        lines.append(
            "serving: {admitted} admitted / {completed} completed "
            "({rejected} rejected, {expired} expired, {failures} failed), "
            "{dispatches} dispatches, {pad_rows} pad rows, "
            "{model_loads} model loads, {evictions} evictions".format(
                **serving
            )
        )
        if cls_bits:
            lines.append(f"  latency: {cls_bits}")
        if "batch_rows" in serving:
            br = serving["batch_rows"]
            lines.append(
                "  adaptive batch rung: min {min} / mean {mean} / max "
                "{max} rows over {dispatches} dispatches".format(**br)
            )
        if "mesh" in serving:
            lines.append(
                "  mesh: width {width}, {chip_rows} rows/chip "
                "dispatched".format(**serving["mesh"])
            )
        if "precision" in serving:
            bits = []
            for arm, d in serving["precision"].items():
                bit = f"{arm}: {d.get('requests', 0)} req"
                if "p95_ms" in d:
                    bit += f" (p95 {d['p95_ms']}ms)"
                bits.append(bit)
            lines.append("  precision arms: " + ", ".join(bits))
        if "drain" in serving:
            lines.append(
                "  drain: {drains} drain(s), "
                "{rejected_while_draining} submit(s) 503'd while "
                "draining".format(**serving["drain"])
            )
        if "canary" in serving:
            cn = serving["canary"]
            line = (
                "  canary: {canary_requests} canary / "
                "{primary_requests} primary requests "
                "({canary_failures} / {primary_failures} failures, "
                "{rollbacks} rollback(s))".format(**cn)
            )
            if "canary_p95_ms" in cn and "primary_p95_ms" in cn:
                line += (
                    "; p95 {0}ms vs {1}ms".format(
                        cn["canary_p95_ms"], cn["primary_p95_ms"]
                    )
                )
            lines.append(line)
    generation = generation_summary(snap)
    if generation is not None:
        lines.append("")
        lines.append(
            "generation: {seqs} sequence(s), {tokens_out} tokens over "
            "{decode_steps} decode step(s); {joins} mid-batch join(s), "
            "{slot_reuse} slot reuse(s), {kv_rejected} KV "
            "reservation(s) refused".format(**generation)
        )
        timing_bits = []
        for label in ("prefill", "decode_step"):
            if label in generation:
                timing_bits.append(
                    "{0} mean {mean_ms}ms / p95 {p95_ms}ms "
                    "(n={count})".format(label, **generation[label])
                )
        if timing_bits:
            lines.append("  " + ", ".join(timing_bits))
        if generation["kv_bytes"] or generation["active_seqs"]:
            lines.append(
                "  resident now: {active_seqs} active seq(s), "
                "{0:.1f}MB KV reserved".format(
                    generation["kv_bytes"] / 2**20, **generation
                )
            )
    tracing = trace_summary(snap)
    if tracing is not None:
        lines.append("")
        line = (
            "request tracing: {sampled} sampled, {records} stored "
            "({retained} retained), {exemplars} tail exemplars, "
            "{stitched_attempts} stitched re-dispatch(es)".format(
                **tracing
            )
        )
        lines.append(line)
        wait_bits = []
        for seg in ("queue_wait", "group_wait"):
            if seg in tracing:
                wait_bits.append(
                    "{0} mean {mean_ms}ms / p95 {p95_ms}ms".format(
                        seg, **tracing[seg]
                    )
                )
        if wait_bits:
            lines.append("  " + ", ".join(wait_bits))
    slo = slo_summary(snap)
    if slo is not None:
        lines.append("")
        bits = []
        for cls, st in sorted((slo.get("classes") or {}).items()):
            bit = f"{cls}: " + ("TRIPPED" if st.get("tripped") else "ok")
            burn_bits = []
            for key, label in (
                ("availability", "avail"), ("latency", "latency"),
            ):
                obj = st.get(key) or {}
                if obj.get("burn_fast") is not None:
                    burn_bits.append(
                        f"{label} burn {obj['burn_fast']}x fast"
                        + (
                            f"/{obj['burn_slow']}x slow"
                            if obj.get("burn_slow") is not None
                            else ""
                        )
                    )
            if burn_bits:
                bit += " (" + ", ".join(burn_bits) + ")"
            elif "trips" in st:
                bit += (
                    f" ({st['trips']} trip(s), "
                    f"{st.get('recoveries', 0)} recovered)"
                )
            bits.append(bit)
        lines.append("slo: " + ("; ".join(bits) if bits else "armed, no traffic"))
    util = utilization_summary(snap)
    if util is not None:
        lines.append("")
        line = (
            "utilization: chips busy {pct:.1%} of wall-clock".format(
                pct=util.get("busy_frac", 0.0)
            )
        )
        if util.get("dominant_wait"):
            line += f", idle dominated by {util['dominant_wait']}"
        if util.get("mfu") is not None:
            line += f", mfu {util['mfu']:.1%}"
        lines.append(line)
        dev_bits = []
        for d, st in sorted(util.get("devices", {}).items()):
            dev_bits.append(
                "d{0}: busy {1:.0f}ms / idle {2:.0f}ms (h2d {3:.0f}ms, "
                "d2h {4:.0f}ms)".format(
                    d,
                    st.get("busy_ms", 0.0),
                    st.get("idle_ms", 0.0),
                    st.get("h2d_ms", 0.0),
                    st.get("d2h_ms", 0.0),
                )
            )
        if dev_bits:
            lines.append("  " + ", ".join(dev_bits))
    mem = memory_summary(snap)
    if mem is not None:
        lines.append("")
        line = (
            "memory: {0:.1f}MB tracked, watermark {1:.1f}MB".format(
                mem["tracked_bytes"] / 2**20,
                mem["watermark_bytes"] / 2**20,
            )
        )
        if mem.get("unattributed_bytes") is not None:
            line += ", unattributed {0:+.1f}MB".format(
                mem["unattributed_bytes"] / 2**20
            )
            if mem.get("ground_truth_source"):
                line += f" ({mem['ground_truth_source']})"
        if mem.get("leaked_bytes"):
            line += ", LEAKED {0:.1f}MB".format(
                mem["leaked_bytes"] / 2**20
            )
        if mem.get("oom_events"):
            line += f", {mem['oom_events']} OOM event(s)"
        lines.append(line)
        model_bits = [
            "{0} {1:.1f}MB".format(name, b / 2**20)
            for name, b in sorted(mem.get("models", {}).items())
        ]
        if model_bits:
            lines.append("  resident: " + ", ".join(model_bits))
    gateway = gateway_summary(snap)
    if gateway is not None:
        lines.append("")
        line = (
            "gateway: {requests} requests routed, {rerouted} "
            "re-dispatched off dying workers, {retries} overload "
            "retries, {unroutable} unroutable".format(**gateway)
        )
        if "ready_workers" in gateway:
            line += f"; {gateway['ready_workers']} worker(s) ready"
        lines.append(line)
    fleet = fleet_summary(snap)
    if fleet is not None:
        lines.append("")
        line = (
            "fleet: {ready_workers} fresh worker(s), "
            "{stale_workers} stale".format(**fleet)
        )
        if fleet.get("busy_frac") is not None:
            line += f", busy {fleet['busy_frac']:.1%}"
        if fleet.get("req_per_s") is not None:
            line += f", {fleet['req_per_s']:.1f} req/s"
        line += (
            f"; SLO alerts: {', '.join(fleet['tripped'])}"
            if fleet.get("tripped")
            else "; no fleet SLO alert"
        )
        lines.append(line)
    resilience = resilience_summary(snap)
    if resilience is not None:
        lines.append("")
        lines.append(
            "resilience: {retries} partition retries "
            "({retry_exhausted} exhausted, {fatal_errors} fatal), "
            "{faults_injected} injected faults, {supervisor_restarts} "
            "gang restarts ({ranks_killed} ranks killed), "
            "{partitions_resumed} partitions resumed".format(**resilience)
        )
    return "\n".join(lines)
