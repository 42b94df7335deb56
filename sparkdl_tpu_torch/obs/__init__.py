"""Observability: trace ids and timing spans (``obs/trace.py``), and the
serving control plane: the SLO engine (``obs/slo.py``), the device-memory
and utilization ledgers (``obs/memory.py``, ``obs/utilization.py``) and
the JSONL event log they write to (``obs/export.py``)."""

from sparkdl_tpu_torch.obs.trace import (
    TRACE_HEADER,
    coerce_trace_id,
    mint_trace_id,
    span,
)

__all__ = ["TRACE_HEADER", "coerce_trace_id", "mint_trace_id", "span"]
