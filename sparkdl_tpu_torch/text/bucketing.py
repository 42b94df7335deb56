"""Sequence-length bucketing: length-aware batch geometries for text.

A copy of the JAX package's ``text/bucketing.py`` with the same ladder
edges and metrics. Padding every row to ``maxLength`` wastes most
dispatched tokens on a corpus of mixed lengths, so a small ladder of
bucket edges is elected up front; each row pads only to the smallest edge
>= its length, and rows run in per-bucket batches.

Ladder election (``bucket_ladder``):

- ``pow2``: powers of two from ``SPARKDL_TEXT_MIN_BUCKET`` up to
  ``max_length``;
- ``half`` (default): powers of two plus the 3*2^k midpoints
  (16, 24, 32, 48, 64, ...);
- an explicit comma list (``SPARKDL_TEXT_BUCKETS=32,48,64``).

``max_length`` always caps the ladder (longer rows truncate to it,
counted in ``text.truncated_rows``), and edges at or under
``SPARKDL_TEXT_MIN_BUCKET`` collapse into one smallest bucket.

Metrics: ``text.bucket_rows.<edge>`` counts rows routed per edge,
``text.tokens`` / ``text.pad_tokens`` split dispatched tokens into real
and bucket-edge padding, and the ``text.pad_ratio`` gauge holds the last
run's pad fraction.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics


def bucketing_enabled() -> bool:
    """``SPARKDL_TEXT_BUCKETING`` gates the length-aware text path;
    ``0``/``off`` restores pad-to-``maxLength``."""
    return knobs.get_flag("SPARKDL_TEXT_BUCKETING")


def min_bucket() -> int:
    return max(1, knobs.get_int("SPARKDL_TEXT_MIN_BUCKET"))


def _pow2_edges(lo: int, hi: int) -> List[int]:
    edges = []
    e = 1
    while e < hi:
        e <<= 1
        if e >= lo:
            edges.append(e)
    return edges


def _half_edges(lo: int, hi: int) -> List[int]:
    # powers of two AND the 3*2^k midpoints: 16, 24, 32, 48, 64, ...
    edges = set(_pow2_edges(lo, hi))
    e = 3
    while e < hi:
        if lo <= e:
            edges.add(e)
        e <<= 1
    return sorted(edges)


def _parse_edges(spec: str) -> List[int]:
    try:
        edges = sorted({int(tok) for tok in spec.split(",") if tok.strip()})
    except ValueError:
        raise ValueError(
            f"SPARKDL_TEXT_BUCKETS={spec!r}: expected 'pow2', 'half', "
            "or a comma list of integer edges (e.g. '32,48,64')"
        ) from None
    if any(e < 1 for e in edges):
        raise ValueError(
            f"SPARKDL_TEXT_BUCKETS={spec!r}: edges must be >= 1"
        )
    return edges


def bucket_ladder(max_length: int, spec: Optional[str] = None) -> Tuple[int, ...]:
    """The elected bucket edges for ``max_length``, ascending, top edge
    always exactly ``max_length``. ``spec`` overrides the
    ``SPARKDL_TEXT_BUCKETS`` knob ('pow2' | 'half' | comma list)."""
    max_length = int(max_length)
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    spec = spec if spec is not None else knobs.get_str("SPARKDL_TEXT_BUCKETS")
    lo = min(min_bucket(), max_length)
    if spec == "pow2":
        edges = _pow2_edges(lo, max_length)
    elif spec in ("half", "", None):
        edges = _half_edges(lo, max_length)
    else:
        edges = [e for e in _parse_edges(spec) if lo <= e]
    edges = [e for e in edges if e < max_length]
    ladder = (lo, *edges, max_length) if lo < max_length else (max_length,)
    out: List[int] = []
    for e in ladder:  # dedupe in order (lo may equal the first edge)
        if not out or e > out[-1]:
            out.append(e)
    return tuple(out)


def bucket_for(length: int, ladder: Sequence[int]) -> int:
    """Smallest ladder edge >= ``length``; the top edge for anything
    longer (the caller truncates to it)."""
    for e in ladder:
        if length <= e:
            return e
    return ladder[-1]


def next_bucket(length: int) -> int:
    """Smallest grid edge >= ``length`` on the configured ladder grid,
    uncapped (the serving router's sequence bucket). An explicit comma
    ladder returns ``length`` itself past its last edge."""
    length = max(int(length), min_bucket())
    spec = knobs.get_str("SPARKDL_TEXT_BUCKETS")
    if spec not in ("pow2", "half", "", None):
        for e in _parse_edges(spec):
            if length <= e:
                return e
        return length
    e = 1
    while e < length:
        e <<= 1
    if spec == "pow2" or e <= min_bucket():
        return e
    mid = 3 * (e >> 2)  # the half-octave midpoint under e
    return mid if length <= mid and mid >= min_bucket() else e


def run_bucketed(
    cells: Sequence,
    tokenize: Callable[[str], Sequence[int]],
    device_fn: Callable,
    batch_size: int,
    max_length: int,
    prefetch: Optional[int] = None,
    ladder: Optional[Sequence[int]] = None,
) -> List[Optional[np.ndarray]]:
    """Length-aware equivalent of the pad-to-``max_length`` text loop,
    with the same per-cell output contract as ``run_batched``: ndarray
    rows, None where the cell was null or tokenization failed.

    Tokenization runs once, up front (lengths decide routing); rows then
    run per bucket through ``run_batched_shared``, largest bucket first.
    """
    from sparkdl_tpu_torch.transformers.execution import start_batched_shared
    from sparkdl_tpu_torch.transformers.text import pad_or_truncate

    n = len(cells)
    out: List[Optional[np.ndarray]] = [None] * n
    if n == 0:
        return out
    ladder = tuple(ladder) if ladder is not None else bucket_ladder(max_length)
    # bucket edge -> ([original row index], [token id list])
    routed: dict = {}
    for i, text in enumerate(cells):
        if text is None:
            continue
        try:
            ids = tokenize(text)
        except Exception:  # noqa: BLE001 — a failed row becomes None
            continue
        idxs, rows = routed.setdefault(bucket_for(len(ids), ladder), ([], []))
        idxs.append(i)
        rows.append(ids)
    if not routed:
        return out
    real_tokens = 0
    pad_tokens = 0
    pending = []
    for b in sorted(routed, reverse=True):
        idxs, rows = routed[b]
        metrics.inc(f"text.bucket_rows.{b}", len(idxs))
        for ids in rows:
            k = min(len(ids), b)
            real_tokens += k
            pad_tokens += b - k

        def to_batch(chunk, _b=b):
            batch = np.zeros((len(chunk), _b), np.int32)
            for j, ids in enumerate(chunk):
                batch[j] = pad_or_truncate(ids, _b)
            return batch, np.ones((len(chunk),), bool)

        # every bucket is submitted before any is waited on: on the shared
        # feeder a bucket's partial batch then goes out as soon as each
        # partition has submitted its rows, not when the last partition
        # has worked through the buckets before it
        pending.append((idxs, start_batched_shared(
            rows, to_batch, device_fn, batch_size, prefetch=prefetch
        )))
    for idxs, results in pending:
        for i, y in zip(idxs, results()):
            out[i] = y
    metrics.inc("text.tokens", real_tokens)
    metrics.inc("text.pad_tokens", pad_tokens)
    dispatched = real_tokens + pad_tokens
    if dispatched:
        metrics.gauge("text.pad_ratio", pad_tokens / dispatched)
    return out
