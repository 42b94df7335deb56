"""Observability: trace ids and timing spans (``obs/trace.py``)."""

from sparkdl_tpu_torch.obs.trace import (
    TRACE_HEADER,
    coerce_trace_id,
    mint_trace_id,
    span,
)

__all__ = ["TRACE_HEADER", "coerce_trace_id", "mint_trace_id", "span"]
