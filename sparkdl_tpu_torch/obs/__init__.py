"""The flight recorder and the serving control plane's telemetry.

The port of the JAX package's ``obs`` package:

- spans (``obs/spans.py``): nestable, per-thread timed regions feeding
  the ``span.<name>`` timers and a bounded ring of closed spans;
- request traces (``obs/trace.py``): trace ids, the trace store, tail
  exemplars and the per-request waterfall;
- exports (``obs/export.py``): the obs snapshot, its Chrome trace, the
  Prometheus text, the JSONL event log and ``dump_on_failure``;
- reports (``obs/report.py``, ``obs/aggregate.py``): the per-stage table
  and the section summaries, and the cross-rank merge with stragglers;
- the serving control plane: the SLO engine (``obs/slo.py``), the
  device-memory and utilization ledgers (``obs/memory.py``,
  ``obs/utilization.py``), the metrics time series
  (``obs/timeseries.py``) and the gateway's fleet plane
  (``obs/fleet.py``);
- the pull exporter (``obs/serve.py``, ``SPARKDL_OBS_PORT``) and the CLI,
  ``python -m sparkdl_tpu_torch.obs`` (``report``, ``trace``, ``slo``,
  ``fleet``, ``mem``, ``chrome``, ``merge``, ``snapshot``, ``serve``).
"""

from sparkdl_tpu_torch.obs.spans import (
    SpanRecord,
    SpanRecorder,
    active_spans,
    compact_status,
    get_recorder,
    obs_enabled,
    span,
)
from sparkdl_tpu_torch.obs.export import (
    append_jsonl,
    dump_on_failure,
    prometheus_text,
    snapshot,
    to_chrome_trace,
    write_chrome_trace,
    write_snapshot,
)
from sparkdl_tpu_torch.obs.report import (
    compile_summary,
    feeder_summary,
    fleet_summary,
    gateway_summary,
    generation_summary,
    memory_summary,
    render_report,
    resilience_summary,
    serving_summary,
    slo_summary,
    stage_summary,
    trace_summary,
    utilization_summary,
)
from sparkdl_tpu_torch.obs.trace import (
    SEGMENTS,
    TRACE_HEADER,
    coerce_trace_id,
    collect_trace,
    mint_trace_id,
    render_waterfall,
    trace_sampled,
)
from sparkdl_tpu_torch.obs.timeseries import (
    MetricsSampler,
    fleet_clear,
    fleet_series,
    get_sampler,
    mem_clear,
    mem_series,
    start_sampler,
    stop_sampler,
)

__all__ = [
    "MetricsSampler",
    "SEGMENTS",
    "SpanRecord",
    "SpanRecorder",
    "TRACE_HEADER",
    "active_spans",
    "append_jsonl",
    "coerce_trace_id",
    "collect_trace",
    "compact_status",
    "compile_summary",
    "dump_on_failure",
    "feeder_summary",
    "fleet_clear",
    "fleet_series",
    "fleet_summary",
    "gateway_summary",
    "generation_summary",
    "get_recorder",
    "get_sampler",
    "mem_clear",
    "mem_series",
    "memory_summary",
    "mint_trace_id",
    "obs_enabled",
    "prometheus_text",
    "render_report",
    "render_waterfall",
    "resilience_summary",
    "serving_summary",
    "slo_summary",
    "snapshot",
    "span",
    "stage_summary",
    "utilization_summary",
    "start_sampler",
    "stop_sampler",
    "to_chrome_trace",
    "trace_sampled",
    "trace_summary",
    "write_chrome_trace",
    "write_snapshot",
]
