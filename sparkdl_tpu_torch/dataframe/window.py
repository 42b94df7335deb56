"""pyspark-style window specifications: ``Window.partitionBy("k")
.orderBy("v")`` consumed by ``Column.over``.

The port's copy of the JAX package's ``dataframe/window.py``. A spec
compiles onto the SQL layer's ``Window`` node, so the Column API and SQL
text (``... OVER (PARTITION BY ...)``) run through one window engine
(``sql.SQLContext._apply_window_items``): Spark's default frame for ordered
windows (RANGE, UNBOUNDED PRECEDING..CURRENT ROW with peers), physical
``ROWS BETWEEN`` frames, value ``RANGE BETWEEN`` frames over one key, nulls
first ascending.

A spec is immutable: every builder method returns a new spec, so specs
can be shared and extended safely (``base = Window.partitionBy("k");
w1 = base.orderBy("v"); w2 = base.orderBy("t")``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

__all__ = ["Window", "WindowSpec"]

# pyspark's sentinel values (Long.Min/MaxValue); any offset at or past
# them means "unbounded on that side"
_UNBOUNDED_PRECEDING = -(1 << 63)
_UNBOUNDED_FOLLOWING = (1 << 63) - 1


def _partition_key(c: Any):
    """A PARTITION BY entry: column-name string, or the Column's
    expression tree (materialized to a hidden column by the engine)."""
    from sparkdl_tpu_torch.dataframe.column import Column

    if isinstance(c, str):
        return c
    if isinstance(c, Column):
        if c._is_pred():
            raise TypeError(
                "A boolean condition cannot be a PARTITION BY key; "
                "compute it with withColumn first"
            )
        plain = c._plain_name()
        return plain if plain is not None else c._expr
    raise TypeError(
        f"partitionBy takes column names or Columns, got {type(c).__name__}"
    )


def _order_key(c: Any) -> Tuple[Any, bool]:
    """An ORDER BY entry: (key, ascending), honoring .asc()/.desc()."""
    from sparkdl_tpu_torch.dataframe.column import Column

    if isinstance(c, str):
        return c, True
    if isinstance(c, Column):
        if c._is_pred():
            raise TypeError(
                "A boolean condition cannot be an ORDER BY key; "
                "compute it with withColumn first"
            )
        asc = True if c._sort is None else c._sort
        plain = c._plain_name()
        return (plain if plain is not None else c._expr), asc
    raise TypeError(
        f"orderBy takes column names or Columns, got {type(c).__name__}"
    )


def _flat(cols) -> list:
    if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
        return list(cols[0])
    return list(cols)


class WindowSpec:
    """An immutable window specification under construction."""

    def __init__(
        self,
        partition_by: List[Any],
        order_by: List[Tuple[Any, bool]],
        frame: Optional[Tuple[Optional[Any], Optional[Any]]],
        frame_kind: str = "rows",
    ):
        self._partition_by = partition_by
        self._order_by = order_by
        self._frame = frame  # (lo, hi) offsets, None side = unbounded
        self._frame_kind = frame_kind  # 'rows' | 'range'

    def partitionBy(self, *cols: Any) -> "WindowSpec":
        return WindowSpec(
            self._partition_by + [_partition_key(c) for c in _flat(cols)],
            self._order_by,
            self._frame,
            self._frame_kind,
        )

    def orderBy(self, *cols: Any) -> "WindowSpec":
        return WindowSpec(
            self._partition_by,
            self._order_by + [_order_key(c) for c in _flat(cols)],
            self._frame,
            self._frame_kind,
        )

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        """Physical-row frame: offsets relative to the current row;
        ``Window.unboundedPreceding`` / ``currentRow`` /
        ``unboundedFollowing`` as in pyspark."""
        lo = None if start <= _UNBOUNDED_PRECEDING else int(start)
        hi = None if end >= _UNBOUNDED_FOLLOWING else int(end)
        if lo is not None and hi is not None and lo > hi:
            raise ValueError(
                f"rowsBetween: start ({start}) must not be after end ({end})"
            )
        return WindowSpec(self._partition_by, self._order_by, (lo, hi))

    def rangeBetween(self, start, end) -> "WindowSpec":
        """Logical frame by ORDER-BY-VALUE distance (pyspark
        ``rangeBetween``): ``rangeBetween(-3, 0)`` frames rows whose
        key lies within 3 of the current row's, against the sort
        direction. Value-offset frames require exactly one ORDER BY
        key (enforced at computation, Spark's rule); offsets may be
        fractional for float keys."""
        if start <= _UNBOUNDED_PRECEDING and end == 0:
            # exactly the engine's default frame for ordered windows
            return WindowSpec(self._partition_by, self._order_by, None)
        if start <= _UNBOUNDED_PRECEDING and end >= _UNBOUNDED_FOLLOWING:
            return WindowSpec(
                self._partition_by, self._order_by, (None, None)
            )
        lo = None if start <= _UNBOUNDED_PRECEDING else start
        hi = None if end >= _UNBOUNDED_FOLLOWING else end
        if lo is not None and hi is not None and lo > hi:
            raise ValueError(
                f"rangeBetween: start ({start}) must not be after "
                f"end ({end})"
            )
        return WindowSpec(
            self._partition_by, self._order_by, (lo, hi), "range"
        )


class Window:
    """Namespace of window-spec entry points (pyspark ``Window``)."""

    unboundedPreceding = _UNBOUNDED_PRECEDING
    unboundedFollowing = _UNBOUNDED_FOLLOWING
    currentRow = 0

    @staticmethod
    def partitionBy(*cols: Any) -> WindowSpec:
        return WindowSpec([], [], None).partitionBy(*cols)

    @staticmethod
    def orderBy(*cols: Any) -> WindowSpec:
        return WindowSpec([], [], None).orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec([], [], None).rowsBetween(start, end)

    @staticmethod
    def rangeBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec([], [], None).rangeBetween(start, end)
