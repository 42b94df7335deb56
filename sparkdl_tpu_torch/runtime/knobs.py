"""The ``SPARKDL_*`` env knobs this package reads, each declared once.

A copy of the part of the JAX package's knob registry that the ported
slices read, with the same names, defaults and accessor semantics:

- an unset (or, for numeric knobs, empty) value falls back to the
  declared default;
- a flag is on unless its value is empty, ``0`` or ``off``;
- a malformed number raises ``ValueError`` naming the knob;
- reading an undeclared ``SPARKDL_*`` name raises ``KeyError``; names
  outside the ``SPARKDL_`` prefix (a test's retry prefix) pass through.

Knobs read per event (not cached), so tests can flip them live.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

#: name -> (kind, default as the raw string an unset variable behaves as)
_KNOBS: Dict[str, Tuple[str, Optional[str]]] = {
    # transformers/execution.py: the in-flight window, and the router
    # of concurrent partitions into the shared feeder (0/off: each
    # partition runs its own pipeline, the A/B arm)
    "SPARKDL_PREFETCH_PER_DEVICE": ("int", "2"),
    "SPARKDL_SHARED_FEEDER": ("flag", "1"),
    # transformers/image_model.py: image rows ship at their source
    # geometry and the resize runs on the device (opt-in A/B arm)
    "SPARKDL_DEVICE_PREPROC": ("flag", "0"),
    # runtime/executor.py: the partition retry family
    # (resilience/policy.policy_from_env)
    "SPARKDL_EXEC_RETRY_ATTEMPTS": ("int", None),
    "SPARKDL_EXEC_RETRY_BASE_MS": ("float", None),
    "SPARKDL_EXEC_RETRY_MAX_MS": ("float", None),
    "SPARKDL_EXEC_RETRY_DEADLINE_S": ("float", None),
    "SPARKDL_EXEC_RETRY_SEED": ("int", None),
    # udf/registry.py and sql.py: the SQL optimizer arm (batched UDF
    # dispatch through the shared feeder, projection and predicate
    # pushdown); 0/off: the row-path planner, the A/B arm
    "SPARKDL_SQL_VECTORIZE": ("flag", "1"),
    # dataframe/frame.py: fail-fast row cap for the relational actions
    # that collect to the host (join, set operations, distinct); 0: none
    "SPARKDL_DRIVER_COLLECT_MAX_ROWS": ("int", "5000000"),
    # runtime/native.py: set, the C++ image bridge is not used (PIL
    # decodes; read at every call)
    "SPARKDL_TPU_NO_NATIVE": ("flag", None),
    # text/bucketing.py
    "SPARKDL_TEXT_BUCKETING": ("flag", "1"),
    "SPARKDL_TEXT_BUCKETS": ("str", "half"),
    "SPARKDL_TEXT_MIN_BUCKET": ("int", "16"),
    # runtime/transfer.py: staged H2D on the copy stream (A/B arm), and
    # the staged copies riding ahead of dispatch (read at feeder
    # construction: it sizes the buffer ring)
    "SPARKDL_DEVICE_STAGE": ("flag", "1"),
    "SPARKDL_DEVICE_STAGE_DEPTH": ("int", "2"),
    # runtime/readback.py: dispatch-time D2H + drainer thread (A/B arm)
    "SPARKDL_ASYNC_READBACK": ("flag", "1"),
    # runtime/feeder.py
    "SPARKDL_MAX_FEEDERS": ("int", "8"),
    "SPARKDL_FEEDER_LINGER_MS": ("float", "20"),
    "SPARKDL_FEEDER_IDLE_S": ("float", "30"),
    # serving/router.py
    "SPARKDL_SERVE_MAX_BATCH": ("int", "32"),
    "SPARKDL_SERVE_WINDOW_MS": ("float", "2"),
    "SPARKDL_SERVE_TARGET_P95_MS": ("float", None),
    "SPARKDL_SERVE_TARGET_P95_MS_INTERACTIVE": ("float", None),
    "SPARKDL_SERVE_TARGET_P95_MS_BATCH": ("float", None),
    "SPARKDL_SERVE_TARGET_P95_MS_BACKGROUND": ("float", None),
    "SPARKDL_SERVE_WORKERS": ("int", "4"),
    "SPARKDL_SERVE_DISPATCH_TIMEOUT_S": ("float", "120"),
    # the SPARKDL_SERVE_RETRY family (resilience/policy.policy_from_env)
    "SPARKDL_SERVE_RETRY_ATTEMPTS": ("int", None),
    "SPARKDL_SERVE_RETRY_BASE_MS": ("float", None),
    "SPARKDL_SERVE_RETRY_MAX_MS": ("float", None),
    "SPARKDL_SERVE_RETRY_DEADLINE_S": ("float", None),
    "SPARKDL_SERVE_RETRY_SEED": ("int", None),
    # serving/request.py
    "SPARKDL_SERVE_AGING_S": ("float", "5"),
    "SPARKDL_SERVE_QUEUE_CAP": ("int", "4096"),
    # serving/server.py and serving/__main__.py
    "SPARKDL_SERVE_PORT": ("int", None),
    "SPARKDL_SERVE_BIND": ("str", "127.0.0.1"),
    "SPARKDL_SERVE_HTTP_TIMEOUT_S": ("float", "300"),
    "SPARKDL_SERVE_RETRY_AFTER_S": ("float", "1"),
    # serving/residency.py
    "SPARKDL_SERVE_HBM_BUDGET_MB": ("float", None),
    # graph/precision.py
    "SPARKDL_SERVE_PRECISION": ("str", "f32"),
    "SPARKDL_SERVE_PRECISION_INTERACTIVE": ("str", None),
    "SPARKDL_SERVE_PRECISION_BATCH": ("str", None),
    "SPARKDL_SERVE_PRECISION_BACKGROUND": ("str", None),
    # serving/generation.py: decode slots per generation stream, and the
    # default and cap of a request's max_new_tokens (the bound its KV
    # reservation is computed from)
    "SPARKDL_GEN_MAX_SEQS": ("int", "8"),
    "SPARKDL_GEN_MAX_NEW_TOKENS": ("int", "64"),
    # serving/router.py: the canary rollout (both _MODEL and _VERSION set
    # engage it; _WEIGHT is the Bresenham split, _TRIP_RATE the canary
    # failure rate that rolls it back once _MIN_REQUESTS were seen)
    "SPARKDL_SERVE_CANARY_MODEL": ("str", None),
    "SPARKDL_SERVE_CANARY_VERSION": ("str", None),
    "SPARKDL_SERVE_CANARY_WEIGHT": ("float", "0.1"),
    "SPARKDL_SERVE_CANARY_TRIP_RATE": ("float", "0.5"),
    "SPARKDL_SERVE_CANARY_MIN_REQUESTS": ("int", "20"),
    # obs/slo.py: availability and p95 objectives, the base knob for
    # every class and a per-class override (an explicit 0 disarms that
    # class), and the burn-rate windows and thresholds
    "SPARKDL_SLO_AVAIL": ("float", None),
    "SPARKDL_SLO_AVAIL_INTERACTIVE": ("float", None),
    "SPARKDL_SLO_AVAIL_BATCH": ("float", None),
    "SPARKDL_SLO_AVAIL_BACKGROUND": ("float", None),
    "SPARKDL_SLO_P95_MS": ("float", None),
    "SPARKDL_SLO_P95_MS_INTERACTIVE": ("float", None),
    "SPARKDL_SLO_P95_MS_BATCH": ("float", None),
    "SPARKDL_SLO_P95_MS_BACKGROUND": ("float", None),
    "SPARKDL_SLO_FAST_S": ("float", "60"),
    "SPARKDL_SLO_SLOW_S": ("float", "3600"),
    "SPARKDL_SLO_BURN_FAST": ("float", "14"),
    "SPARKDL_SLO_BURN_SLOW": ("float", "14"),
    "SPARKDL_SLO_MIN_REQUESTS": ("int", "10"),
    # obs/memory.py: the allocation-event ring and the leak tolerance
    "SPARKDL_MEM_RING": ("int", "256"),
    "SPARKDL_MEM_LEAK_TOL_MB": ("float", "8"),
    # obs/spans.py: span recording (0/off: spans are no-ops) and the
    # span ring's depth
    "SPARKDL_OBS": ("flag", "1"),
    "SPARKDL_OBS_RING": ("int", "4096"),
    # obs/export.py: the JSONL event log (unset: no events written), the
    # gang rank that tags events, /metrics lines and heartbeats, and the
    # flight recorder's dump directory (unset: failures dump nothing)
    "SPARKDL_OBS_JSONL": ("str", None),
    "SPARKDL_OBS_RANK": ("int", None),
    "SPARKDL_OBS_DUMP_DIR": ("str", None),
    # obs/aggregate.py: the least seconds between a rank's periodic
    # snapshot drops (0: off; exit drops are still forced), and the
    # straggler test (slowest vs median p95 factor, and the absolute gap
    # also required)
    "SPARKDL_OBS_SNAP_S": ("float", "30"),
    "SPARKDL_OBS_STRAGGLER_X": ("float", "1.5"),
    "SPARKDL_OBS_STRAGGLER_MIN_S": ("float", "0.1"),
    # obs/serve.py: the pull exporter's port (rank r binds port + r;
    # unset, 0 or malformed: off) and bind address
    "SPARKDL_OBS_PORT": ("int", None),
    "SPARKDL_OBS_BIND": ("str", "127.0.0.1"),
    # obs/timeseries.py: the sampler's interval (0: off) and points kept
    # per series; the fleet-sample and memory-watermark rings
    "SPARKDL_OBS_SAMPLE_S": ("float", "1"),
    "SPARKDL_OBS_SERIES": ("int", "720"),
    "SPARKDL_FLEET_RING": ("int", "360"),
    "SPARKDL_MEM_WATERMARK_RING": ("int", "512"),
    # obs/trace.py: head-sampling rate, the trace store's depth and the
    # slowest completions kept per class as tail exemplars
    "SPARKDL_TRACE_SAMPLE": ("float", "0.01"),
    "SPARKDL_TRACE_RING": ("int", "512"),
    "SPARKDL_TRACE_EXEMPLARS": ("int", "4"),
    # serving/server.py: where POST /admin/profile writes its captures
    # (unset: a temporary directory made once per process)
    "SPARKDL_PROFILE_DIR": ("str", None),
    # runtime/locksmith.py: order-recording lock proxies (read at lock
    # creation) and the held-too-long threshold
    "SPARKDL_LOCK_SANITIZER": ("flag", "0"),
    "SPARKDL_LOCK_HELD_MS": ("float", "500"),
    # resilience/faults.py: the fault plan, the claim directory shared
    # across processes and generations, and the p= coin's seed
    "SPARKDL_FAULT_PLAN": ("str", None),
    "SPARKDL_FAULT_STATE": ("str", None),
    "SPARKDL_FAULT_SEED": ("int", "0"),
    # resilience/supervisor.py: the generation and resume flag it exports
    # to every rank, and its restart budget (policy_from_env)
    "SPARKDL_GANG_GENERATION": ("int", None),
    "SPARKDL_GANG_RESUME": ("flag", None),
    "SPARKDL_SUPERVISOR_RETRY_ATTEMPTS": ("int", None),
    "SPARKDL_SUPERVISOR_RETRY_BASE_MS": ("float", None),
    "SPARKDL_SUPERVISOR_RETRY_MAX_MS": ("float", None),
    "SPARKDL_SUPERVISOR_RETRY_DEADLINE_S": ("float", None),
    "SPARKDL_SUPERVISOR_RETRY_SEED": ("int", None),
    # serving/__main__.py: how long a drained worker waits for accepted work
    "SPARKDL_SERVE_DRAIN_TIMEOUT_S": ("float", "30"),
    # serving/gateway.py: gang size, health poll, the pending window a
    # request waits for a ready worker, the per-attempt forward bound, the
    # re-dispatch policy, affinity routing, autoscale and canary waves
    "SPARKDL_GATEWAY_WORKERS": ("int", "2"),
    "SPARKDL_GATEWAY_HEALTH_S": ("float", "0.25"),
    "SPARKDL_GATEWAY_PENDING_S": ("float", "30"),
    "SPARKDL_GATEWAY_FORWARD_TIMEOUT_S": ("float", "300"),
    "SPARKDL_GATEWAY_RETRY_ATTEMPTS": ("int", None),
    "SPARKDL_GATEWAY_RETRY_BASE_MS": ("float", None),
    "SPARKDL_GATEWAY_RETRY_MAX_MS": ("float", None),
    "SPARKDL_GATEWAY_RETRY_DEADLINE_S": ("float", None),
    "SPARKDL_GATEWAY_RETRY_SEED": ("int", None),
    "SPARKDL_GATEWAY_AFFINITY": ("flag", "0"),
    "SPARKDL_GATEWAY_AFFINITY_REPLICAS": ("int", "64"),
    "SPARKDL_GATEWAY_SPILL_BUSY": ("float", "0.9"),
    "SPARKDL_FLEET_AUTOSCALE": ("flag", "0"),
    "SPARKDL_FLEET_COOLDOWN_S": ("float", "30"),
    "SPARKDL_FLEET_MIN_WORKERS": ("int", "1"),
    "SPARKDL_FLEET_MAX_WORKERS": ("int", "4"),
    "SPARKDL_SERVE_CANARY_WAVES": ("str", None),
    "SPARKDL_SERVE_CANARY_WAVE_S": ("float", "10"),
    # obs/fleet.py: scrape cadence and bound, staleness, the recommender's
    # cadence and its busy thresholds
    "SPARKDL_FLEET_SCRAPE_S": ("float", "1.0"),
    "SPARKDL_FLEET_SCRAPE_TIMEOUT_S": ("float", "2.0"),
    "SPARKDL_FLEET_STALE_S": ("float", "10.0"),
    "SPARKDL_FLEET_RECOMMEND_S": ("float", "10.0"),
    "SPARKDL_FLEET_SCALE_UP_BUSY": ("float", "0.8"),
    "SPARKDL_FLEET_SCALE_DOWN_BUSY": ("float", "0.2"),
}


def _default(name: str) -> Optional[str]:
    if name not in _KNOBS:
        if not name.startswith("SPARKDL_"):
            return None
        raise KeyError(f"{name} is not a declared knob of sparkdl_tpu_torch")
    return _KNOBS[name][1]


def get_raw(name: str) -> Optional[str]:
    """The env value as set, or None when unset: no default applied."""
    _default(name)
    return os.environ.get(name)


def get_str(name: str) -> Optional[str]:
    """String value with the declared default applied."""
    default = _default(name)
    v = os.environ.get(name)
    return default if v is None else v


def _effective(name: str) -> Optional[str]:
    default = _default(name)
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else raw


def get_int(name: str) -> Optional[int]:
    raw = _effective(name)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        f = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not numeric") from None
    if not f.is_integer():
        raise ValueError(f"{name}={raw!r} is not an integer")
    return int(f)


def get_float(name: str) -> Optional[float]:
    raw = _effective(name)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not numeric") from None


def get_port(name: str) -> Optional[int]:
    """A TCP port knob: a positive int, or None when unset, ``0`` or
    malformed (0 means off; an ephemeral bind is asked for in code)."""
    try:
        port = get_int(name)
    except ValueError:
        return None
    if port is None or port <= 0:
        return None
    return port


def get_flag(name: str) -> bool:
    """True unless the effective value is unset, empty, ``0`` or ``off``."""
    v = get_str(name)
    return v is not None and v not in ("", "0", "off")
