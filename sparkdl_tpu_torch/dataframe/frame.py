"""A minimal partitioned DataFrame.

The part of the JAX package's DataFrame that the text, image, training,
SQL and model-selection slices drive: a frame is a list of partitions
(each a ``{column: list}`` dict) plus a lazy plan of partition-wise ops.
Actions run the plan over the partitions through the default executor
(``runtime/executor.py``): several at once, results in partition order,
with bounded retry. :meth:`DataFrame.iterPartitions` runs them one at a
time instead, keeping one in memory (the streamed trainer's feed, and
:meth:`DataFrame.limit`, which stops at the partition that fills it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

Partition = Dict[str, list]


def _part_num_rows(part: Partition) -> int:
    if not part:
        return 0
    return len(next(iter(part.values())))


def partition_row_spans(total_rows: int, num_partitions: int):
    """(start, end) row span of each partition in the balanced split
    (sizes differ by at most 1)."""
    num_partitions = (
        max(1, min(num_partitions, total_rows)) if total_rows else 1
    )
    base, rem = divmod(total_rows, num_partitions)
    spans = []
    start = 0
    for k in range(num_partitions):
        size = base + (1 if k < rem else 0)
        spans.append((start, start + size))
        start += size
    return spans


def _take(values: list, indices: Sequence[int]) -> list:
    return [values[i] for i in indices]


def _run_plan(ops, columns: List[str], part: Partition) -> Partition:
    for op in ops:
        part = op(part)
    return {c: part[c] for c in columns}


class Row(dict):
    """A result row; attribute access mirrors pyspark Row ergonomics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class DataFrame:
    def __init__(
        self,
        partitions: Sequence[Partition],
        columns: Sequence[str],
        ops: Optional[List[Callable[[Partition], Partition]]] = None,
    ):
        self._source: List[Partition] = list(partitions)
        self._columns: List[str] = list(columns)
        self._ops: List[Callable[[Partition], Partition]] = list(ops or [])

    @staticmethod
    def fromColumns(
        columns: Dict[str, Sequence[Any]], numPartitions: int = 1
    ) -> "DataFrame":
        names = list(columns)
        if not names:
            return DataFrame([], [])
        n = len(columns[names[0]])
        for c in names:
            if len(columns[c]) != n:
                raise ValueError("All columns must have the same length")
        parts: List[Partition] = [
            {c: list(columns[c][start:end]) for c in names}
            for start, end in partition_row_spans(n, numPartitions)
        ]
        return DataFrame(parts, names)

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def numPartitions(self) -> int:
        return len(self._source)

    def partitionRowCounts(self) -> List[int]:
        """Per-partition SOURCE row counts: pre-plan, no op executed (the
        trainer's step count, identical on every rank)."""
        return [_part_num_rows(p) for p in self._source]

    def _with_op(
        self, op: Callable[[Partition], Partition], columns: List[str]
    ) -> "DataFrame":
        return DataFrame(self._source, columns, self._ops + [op])

    def select(self, *cols: str) -> "DataFrame":
        """Project onto column names (a single list argument expands)."""
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        wanted = list(cols)
        missing = [c for c in wanted if c not in self._columns]
        if missing:
            raise KeyError(f"No such columns: {missing}")

        def op(part: Partition) -> Partition:
            return {c: part[c] for c in wanted}

        return self._with_op(op, wanted)

    def drop(self, *cols: str) -> "DataFrame":
        keep = [c for c in self._columns if c not in cols]
        return self.select(*keep)

    def withColumn(self, name: str, fn: Callable[[Row], Any]) -> "DataFrame":
        """Row-wise UDF column: ``fn`` gets each row as a :class:`Row`."""

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            out = dict(part)
            out[name] = [fn(Row({c: part[c][i] for c in part})) for i in range(n)]
            return out

        cols = self._columns + ([name] if name not in self._columns else [])
        return self._with_op(op, cols)

    def filter(self, fn: Callable[[Row], Any]) -> "DataFrame":
        """Keep the rows where ``fn`` (a row-callable over every column)
        is truthy."""

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            keep = [
                i for i in range(n) if fn(Row({c: part[c][i] for c in part}))
            ]
            return {c: _take(part[c], keep) for c in part}

        return self._with_op(op, self._columns)

    def filterOnColumns(
        self,
        fn: Callable[[Row], Any],
        cols: Sequence[str],
        on_skipped: Optional[Callable[[int], None]] = None,
    ) -> "DataFrame":
        """Pushdown filter: ``fn`` sees Rows holding ONLY ``cols``, and the
        survivors are taken across every column, so a cell of another
        column is read only for a row that stays (the SQL planner's
        cheap-predicate-first arm). ``on_skipped`` receives each
        partition's count of dropped rows."""
        missing = [c for c in cols if c not in self._columns]
        if missing:
            raise KeyError(f"No such columns: {missing}")
        pred_cols = list(cols)

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            keep = [
                i
                for i in range(n)
                if fn(Row({c: part[c][i] for c in pred_cols}))
            ]
            if len(keep) == n:
                return part
            if on_skipped is not None:
                on_skipped(n - len(keep))
            return {c: _take(part[c], keep) for c in part}

        return self._with_op(op, self._columns)

    def limit(self, n: int) -> "DataFrame":
        """The first ``n`` rows in partition-then-row order, as one
        partition. Runs the plan now, partition by partition, and stops
        at the partition that fills ``n``."""
        taken: Partition = {c: [] for c in self._columns}
        remaining = max(0, n)
        if remaining:
            for part in self.iterPartitions():
                k = min(remaining, _part_num_rows(part))
                for c in self._columns:
                    taken[c].extend(part[c][i] for i in range(k))
                remaining -= k
                if not remaining:
                    break
        if remaining == max(0, n):
            return DataFrame([], self._columns)
        return DataFrame([taken], self._columns)

    def orderBy(self, *cols: str, ascending: Any = True) -> "DataFrame":
        """Sort rows globally by scalar key columns (Spark ``orderBy``):
        ``ascending`` is one bool or one per key; nulls come first
        ascending and last descending. The sort is stable and runs on
        the collected keys; the rows are split again into as many
        partitions as the frame had."""
        if not cols:
            raise ValueError("orderBy needs at least one column")
        asc = (
            list(ascending)
            if isinstance(ascending, (list, tuple))
            else [ascending] * len(cols)
        )
        if len(asc) != len(cols):
            raise ValueError(
                f"ascending has {len(asc)} entries for {len(cols)} columns"
            )
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in orderBy")
        merged = self.collectColumns()
        n = len(merged[self._columns[0]]) if self._columns else 0
        order = list(range(n))
        # one stable pass per key, minor key first; the null rank keeps
        # None out of comparisons and below every value, so after
        # ``reverse`` nulls come last
        for c, a in list(zip(cols, asc))[::-1]:
            vals = merged[c]
            order.sort(
                key=lambda i: (0, 0) if vals[i] is None else (1, vals[i]),
                reverse=not a,
            )
        return DataFrame.fromColumns(
            {c: _take(merged[c], order) for c in self._columns},
            numPartitions=max(1, self.numPartitions),
        )

    def union(self, other: "DataFrame") -> "DataFrame":
        """Rows of both frames (the same column set), each side's
        partitions kept: this frame's first (Spark ``union``)."""
        if set(self._columns) != set(other._columns):
            raise ValueError(
                f"union requires matching columns: {self._columns} vs "
                f"{other._columns}"
            )
        left = self._execute()
        right = [{c: p[c] for c in self._columns} for p in other._execute()]
        return DataFrame(left + right, self._columns)

    def cache(self) -> "DataFrame":
        """Run the plan now; a frame over the materialized partitions."""
        return DataFrame(self._execute(), self._columns)

    def createOrReplaceTempView(self, name: str) -> None:
        """Register this frame under ``name`` in the default SQL context
        (``sparkdl_tpu_torch.sql.sql``)."""
        from sparkdl_tpu_torch import sql as _sql

        _sql.registerDataFrameAsTable(self, name)

    def mapPartitions(
        self, fn: Callable[[Partition], Partition], columns: List[str]
    ) -> "DataFrame":
        """Partition-wise op whose result holds ``columns``."""
        return self._with_op(fn, list(columns))

    def randomSplit(
        self, weights: Sequence[float], seed: int = 0
    ) -> List["DataFrame"]:
        """Split rows randomly by normalized ``weights``. Deterministic for a
        seed: each row draws a uniform sample from one seeded stream in
        (partition, row) order, the same draws as the JAX package's."""
        if any(w < 0 for w in weights) or sum(weights) <= 0:
            raise ValueError(f"Invalid split weights: {weights}")
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])
        rng = np.random.default_rng(seed)
        out_parts: List[List[Partition]] = [[] for _ in weights]
        for part in self._execute():
            draws = rng.random(_part_num_rows(part))
            # first bound >= draw, clipped: a draw one ulp past bounds[-1]
            # must not drop the row
            buckets = np.minimum(
                np.searchsorted(bounds, draws, side="left"), len(weights) - 1
            )
            for b in range(len(weights)):
                idx = np.flatnonzero(buckets == b)
                out_parts[b].append(
                    {c: [part[c][i] for i in idx] for c in self._columns}
                )
        return [DataFrame(ps, self._columns) for ps in out_parts]

    def withColumnPartition(
        self, name: str, fn: Callable[[Partition], Dict[str, list]]
    ) -> "DataFrame":
        """Partition-wise column producer: ``fn`` sees the whole partition
        column-dict and returns ``{name: values}``, one value per row —
        the batched path every model transformer uses."""

        def op(part: Partition) -> Partition:
            out = dict(part)
            produced = fn(part)
            n = _part_num_rows(part)
            for k, v in produced.items():
                if len(v) != n:
                    raise ValueError(
                        f"withColumnPartition fn returned {len(v)} values for "
                        f"column {k!r}, expected {n}"
                    )
                out[k] = list(v)
            return out

        cols = self._columns + ([name] if name not in self._columns else [])
        return self._with_op(op, cols)

    def _execute(self) -> List[Partition]:
        from sparkdl_tpu_torch.runtime.executor import default_executor

        ops, cols = self._ops, self._columns
        return default_executor().map_partitions(
            lambda _i, part: _run_plan(ops, cols, part),
            self._source,
            count_rows=_part_num_rows,
        )

    def iterPartitions(
        self, order: Optional[Sequence[int]] = None
    ) -> Iterator[Partition]:
        """Run the plan partition by partition, yielding each result and
        keeping none, with the executor's attempt budget per partition.
        ``order``: visit only these partition indices, in this order (the
        streamed trainer's epoch shuffle)."""
        from sparkdl_tpu_torch.runtime.executor import (
            PartitionTaskError,
            default_executor,
        )

        max_failures = default_executor().max_failures
        indices = range(len(self._source)) if order is None else order
        for i in indices:
            for _attempt in range(max_failures):
                try:
                    result = _run_plan(self._ops, self._columns, self._source[i])
                    break
                except Exception as e:  # noqa: BLE001 — retried, then raised
                    last_err = e
            else:
                raise PartitionTaskError(i, max_failures, last_err)
            yield result

    def collect(self) -> List[Row]:
        rows: List[Row] = []
        for part in self._execute():
            for i in range(_part_num_rows(part)):
                rows.append(Row({c: part[c][i] for c in part}))
        return rows

    def collectColumns(self) -> Dict[str, list]:
        """Collect as a single column-dict (partitions concatenated)."""
        out: Dict[str, list] = {c: [] for c in self._columns}
        for part in self._execute():
            for c in self._columns:
                out[c].extend(part[c])
        return out

    def count(self) -> int:
        if not self._ops:
            return sum(_part_num_rows(p) for p in self._source)
        return sum(_part_num_rows(p) for p in self._execute())

    def __repr__(self) -> str:
        return (
            f"DataFrame(columns={self._columns}, "
            f"partitions={len(self._source)}, pending_ops={len(self._ops)})"
        )
