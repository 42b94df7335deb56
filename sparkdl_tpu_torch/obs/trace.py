"""Request trace identity and a timing span.

A trimmed copy of the JAX package's ``obs/trace.py``: the trace id that
every serving request carries (minted here or taken from the inbound
``X-Sparkdl-Trace`` header), and :func:`span`, which times a block into
the metrics registry as ``span.<name>``. The trace store, the tail
exemplars and the per-request waterfall are not ported yet.
"""

from __future__ import annotations

import itertools
import re
import time
import uuid
from contextlib import contextmanager
from typing import Iterator, Optional

from sparkdl_tpu_torch.utils.metrics import metrics

#: HTTP header that carries a trace id between hops
TRACE_HEADER = "X-Sparkdl-Trace"

#: a served request's stages, in order, seconds each (``Request.trace_segments``);
#: ``decode`` is the wall of the decode steps a generate request rode, 0
#: for every other request
SEGMENTS = (
    "queue_wait",
    "group_wait",
    "stage_wait",
    "dispatch",
    "decode",
    "drain_wait",
    "scatter",
)

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{4,64}$")

#: a random 8-hex process prefix + a 32-bit sequence: unique for the
#: life of the process at a fraction of uuid4's cost per request
_MINT_PREFIX = uuid.uuid4().hex[:8]
_mint_counter = itertools.count()


def mint_trace_id() -> str:
    """A fresh 16-hex trace id."""
    return f"{_MINT_PREFIX}{next(_mint_counter) & 0xFFFFFFFF:08x}"


def coerce_trace_id(raw: Optional[str]) -> str:
    """The header value when it parses as hex (lowercased, dashes
    stripped), else a freshly minted id."""
    if raw:
        candidate = raw.strip().lower().replace("-", "")
        if _TRACE_ID_RE.match(candidate):
            return candidate
    return mint_trace_id()


class Span:
    """An open span: ``add`` attaches attributes learned inside it."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def add(self, **attrs) -> None:
        self.attrs.update(attrs)


@contextmanager
def span(name: str, **attrs) -> Iterator[Span]:
    """Time the block on the host clock into ``span.<name>`` (recorded
    whether the block returns or raises)."""
    sp = Span(name, attrs)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        metrics.record_time(f"span.{name}", time.perf_counter() - t0)


__all__ = ["SEGMENTS", "TRACE_HEADER", "Span", "coerce_trace_id", "mint_trace_id", "span"]
