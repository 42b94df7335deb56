"""A minimal partitioned DataFrame.

The part of the JAX package's DataFrame that the text, image, training,
SQL and model-selection slices drive: a frame is a list of partitions
(each a ``{column: list}`` dict) plus a lazy plan of partition-wise ops.
Actions run the plan over the partitions through the default executor
(``runtime/executor.py``): several at once, results in partition order,
with bounded retry. :meth:`DataFrame.iterPartitions` runs them one at a
time instead, keeping one in memory (the streamed trainer's feed, and
:meth:`DataFrame.limit`, which stops at the partition that fills it).

Files: :meth:`DataFrame.readParquet`, :meth:`DataFrame.scanParquet`
(lazy partitions over row spans, reading only the footer up front),
:meth:`DataFrame.writeParquet` (streamed, one row group per partition) and
:meth:`DataFrame.fromArrowFiles` (lazy, one partition per Arrow IPC
file), over the port's own readers and writers (``dataframe/parquet.py``,
``dataframe/arrow_ipc.py``): the port never imports ``pyarrow``, so the
JAX package's ``fromArrow``/``toArrow``, which take and return ``pyarrow``
Tables, have no counterpart. A tensor column read from a file is one
contiguous numpy block ``(rows, *shape)`` in its partition, as the JAX
package's ``TensorColumn`` is; indexing it gives row views.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Partition = Dict[str, list]


def _part_num_rows(part: Partition) -> int:
    rows = getattr(part, "num_rows", None)
    if rows is not None:
        return int(rows)
    if not part:
        return 0
    return len(next(iter(part.values())))


class LazyPartition(Mapping):
    """A partition backed by a file: a column is read on its first access
    and :meth:`release` drops what was read, so a file-backed frame never
    holds every partition at once. A Mapping, not a dict, so ``dict(part)``
    in an op goes through ``__getitem__`` and reads."""

    def __init__(self, columns: Sequence[str]):
        self._lazy_columns = list(columns)
        self._data: Dict[str, Any] = {}

    def _read(self, names: List[str]) -> Dict[str, Any]:
        raise NotImplementedError

    def __getitem__(self, key):
        if key not in self._data:
            if key not in self._lazy_columns:
                raise KeyError(key)
            self._data.update(self._read([key]))
        return self._data[key]

    def __iter__(self):
        return iter(self._lazy_columns)

    def __len__(self) -> int:
        return len(self._lazy_columns)

    def __contains__(self, key) -> bool:
        return key in self._lazy_columns

    def release(self) -> None:
        self._data = {}


class LazyArrowPartition(LazyPartition):
    """One partition = one Arrow IPC file (the gang's gather layout); the
    whole file is read on the first access."""

    def __init__(self, path: str, columns: Sequence[str]):
        super().__init__(columns)
        self._path = path

    def _read(self, names: List[str]) -> Dict[str, Any]:
        from sparkdl_tpu_torch.dataframe.arrow_ipc import read_file

        return read_file(self._path)[1]

    @property
    def num_rows(self) -> int:
        if not self._lazy_columns:
            return 0
        return len(self[self._lazy_columns[0]])


class LazyParquetPartition(LazyPartition):
    """One partition = one row span of a Parquet file; a column access
    decodes that column in the row groups that meet the span and no
    other."""

    def __init__(self, path: str, span: Tuple[int, int], columns: Sequence[str]):
        super().__init__(columns)
        self._path = path
        self._span = (int(span[0]), int(span[1]))
        self._pf = None

    @property
    def num_rows(self) -> int:
        return self._span[1] - self._span[0]

    def _read(self, names: List[str]) -> Dict[str, Any]:
        if self._pf is None:
            from sparkdl_tpu_torch.dataframe.parquet import ParquetFile

            self._pf = ParquetFile(self._path)
        return self._pf.read_rows(self._span[0], self._span[1], names)

    def release(self) -> None:
        super().release()
        self._pf = None


def _split(columns: Dict[str, Any], names: List[str], num_partitions: int) -> List[Partition]:
    """Balanced partitions of whole columns; a numpy block stays a block."""
    n = len(columns[names[0]]) if names else 0
    return [
        {c: columns[c][start:end] for c in names}
        for start, end in partition_row_spans(n, num_partitions)
    ]


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

    @staticmethod
    def readParquet(path: str, numPartitions: int = 1) -> "DataFrame":
        """The whole Parquet file, split into ``numPartitions`` balanced
        partitions (``dataframe/parquet.py``)."""
        from sparkdl_tpu_torch.dataframe.parquet import ParquetFile

        pf = ParquetFile(path)
        names = pf.column_names
        return DataFrame(_split(pf.read(), names, numPartitions), names)

    @staticmethod
    def scanParquet(path: str, numPartitions: int = 1) -> "DataFrame":
        """A lazy Parquet scan: one partition per balanced row span, each
        reading only the row groups that meet its span, on first access.
        Only the footer is read here; streaming actions and the streamed
        trainer hold one partition at a time."""
        from sparkdl_tpu_torch.dataframe.parquet import ParquetFile

        pf = ParquetFile(path)
        names = pf.column_names
        spans = partition_row_spans(pf.num_rows, numPartitions)
        return DataFrame(
            [LazyParquetPartition(path, span, names) for span in spans], names
        )

    @staticmethod
    def fromArrowFiles(paths: Sequence[str]) -> "DataFrame":
        """One lazy partition per Arrow IPC file, in the order given; only
        the first file's schema is read here."""
        from sparkdl_tpu_torch.dataframe.arrow_ipc import read_schema

        paths = list(paths)
        if not paths:
            return DataFrame([], [])
        names = [f.name for f in read_schema(paths[0])]
        return DataFrame([LazyArrowPartition(p, names) for p in paths], names)

    def writeParquet(self, path: str, compression: str = "snappy") -> None:
        """Streaming Parquet writer: partitions run, convert and write one
        at a time, one row group each (empty partitions are skipped).
        Every partition must convert to the schema of the first (a null
        column takes any type); one that converts otherwise raises rather
        than writing a file its readers would reject."""
        from sparkdl_tpu_torch.dataframe.arrow_ipc import infer_field, unify_field
        from sparkdl_tpu_torch.dataframe.parquet import ParquetWriter

        writer = ParquetWriter(path, compression=compression)
        try:
            for part in self.iterPartitions():
                if _part_num_rows(part) == 0:
                    continue
                fields = [infer_field(c, part[c]) for c in self._columns]
                if writer.fields is None:
                    writer.fields = fields
                else:
                    unified = [unify_field(a, b) for a, b in zip(writer.fields, fields)]
                    if any(u is None for u in unified):
                        raise ValueError(
                            "writeParquet: partition schema diverged from the "
                            f"first partition's ({fields} vs {writer.fields}); "
                            "make the column uniformly shaped (or write one "
                            "partition to force a single global conversion)"
                        )
                writer.write({c: part[c] for c in self._columns})
            if writer.fields is None:  # no non-empty partition: still a valid file
                empty = {c: [] for c in self._columns}
                writer.fields = [infer_field(c, []) for c in self._columns]
                writer.write(empty)
        finally:
            writer.close()

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

    def __getattr__(self, name: str):
        """pyspark's attribute column access: ``df.x`` is a Column
        (``df.filter(df.x > 3)``); reached only when no real attribute
        matches."""
        if name.startswith("_"):
            raise AttributeError(name)
        cols = self.__dict__.get("_columns")
        if cols is not None and name in cols:
            from sparkdl_tpu_torch import sql as _sql
            from sparkdl_tpu_torch.dataframe.column import Column

            return Column(_sql.Col(name))
        raise AttributeError(f"'DataFrame' object has no attribute {name!r} (and no such column)")

    def __getitem__(self, key):
        """``df["x"]`` is a Column; ``df[["a", "b"]]`` a projection."""
        if isinstance(key, str):
            if key not in self._columns:
                raise KeyError(f"No such column {key!r}")
            from sparkdl_tpu_torch import sql as _sql
            from sparkdl_tpu_torch.dataframe.column import Column

            return Column(_sql.Col(key))
        if isinstance(key, (list, tuple)):
            return self.select(*key)
        raise TypeError(f"DataFrame indices are column names or lists, got {type(key).__name__}")

    def select(self, *cols) -> "DataFrame":
        """Project by name, or by Column expression
        (``df.select("a", (F.col("v") * 2).alias("d"))``); a single list
        argument expands. Every item reads the frame as it was: computed
        items land under temporary names and are renamed at the end, so
        an alias that shadows an input column cannot change a later item."""
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        if any(not isinstance(c, str) for c in cols):
            from sparkdl_tpu_torch.dataframe.column import Column

            df = self
            names: List[str] = []
            rename: List[Tuple[str, str]] = []
            for i, c in enumerate(cols):
                if isinstance(c, str):
                    names.append(c)
                    continue
                if not isinstance(c, Column):
                    raise TypeError(f"select() takes column names or Columns, got {type(c).__name__}")
                plain = c._plain_name()
                if plain is not None and c._alias in (None, plain):
                    names.append(plain)  # a bare reference: nothing to compute
                    continue
                tmp = f"__sel_{i}"
                df = df.withColumn(tmp, c)
                names.append(tmp)
                rename.append((tmp, c._output_name()))
            out = df.select(*names)
            for tmp, final in rename:
                out = out.withColumnRenamed(tmp, final)
            return out
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

    def withColumn(self, name: str, fn) -> "DataFrame":
        """Row-wise column: ``fn`` is a row-callable, which gets each row
        as a :class:`Row`, or a Column expression; a condition Column
        gives a True/False/None cell per row. A Column that calls a
        catalog UDF dispatches it batched through the SQL layer."""
        if not callable(fn):
            from sparkdl_tpu_torch.dataframe.column import Column

            if not isinstance(fn, Column):
                raise TypeError(f"withColumn() takes a row-callable or a Column, got {type(fn).__name__}")
            if fn._has_catalog_call():
                if fn._is_pred():
                    raise TypeError(
                        "A UDF inside a condition is not supported directly; compute the UDF "
                        "value with withColumn first, then compare that"
                    )
                from sparkdl_tpu_torch import sql as _sql

                out = _sql._apply_expr(self, fn._expr, name)
                return out.select(*(self._columns + ([name] if name not in self._columns else [])))
            fn = fn._row_fn()

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            out = dict(part)
            out[name] = [fn(Row({c: part[c][i] for c in part})) for i in range(n)]
            return out

        cols = self._columns + ([name] if name not in self._columns else [])
        return self._with_op(op, cols)

    def filter(self, fn) -> "DataFrame":
        """Keep the rows where ``fn`` holds: a row-callable over every
        column (truthy), or a condition Column (``df.filter(F.col("x") >
        3)``) under SQL's three-valued logic, where unknown never keeps a
        row. UDF calls inside a condition materialize batched first, as
        in SQL's WHERE."""
        if not callable(fn):
            from sparkdl_tpu_torch.dataframe.column import Column

            if not isinstance(fn, Column):
                raise TypeError(f"filter() takes a row-callable or a Column condition, got {type(fn).__name__}")
            if fn._is_pred() and fn._has_catalog_call():
                from sparkdl_tpu_torch import sql as _sql

                tmp: List[str] = []
                pred, df = _sql._materialize_pred_calls(copy.deepcopy(fn._expr), self, tmp)
                out = df.filter(lambda r, node=pred: _sql._eval_pred3(node, r) is True)
                return out.drop(*tmp) if tmp else out
            fn = fn._filter_fn()

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

    def orderBy(self, *cols, ascending: Any = True) -> "DataFrame":
        """Sort rows globally by scalar keys (Spark ``orderBy``):
        ``ascending`` is one bool or one per key; nulls come first
        ascending and last descending unless a key says otherwise (an
        ``ascending`` entry may be a ``sql.SortDir`` with ``nulls_first``).
        Keys may be Columns: ``asc()``/``desc()`` and their
        ``_nulls_first``/``_nulls_last`` forms win over ``ascending``, and
        expression keys sort on hidden columns, dropped afterwards. The
        sort is stable and runs on the collected keys; the rows are split
        again into as many partitions as the frame had."""
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
        if any(not isinstance(c, str) for c in cols):
            from sparkdl_tpu_torch import sql as _sql
            from sparkdl_tpu_torch.dataframe.column import Column

            df = self
            names: List[str] = []
            asc_out: List[Any] = []
            tmp: List[str] = []
            for c, a in zip(cols, asc):
                if isinstance(c, str):
                    names.append(c)
                    asc_out.append(a)
                    continue
                if not isinstance(c, Column):
                    raise TypeError(f"orderBy keys are names or Columns, got {type(c).__name__}")
                if c._sort is not None:
                    a = c._sort if c._sort_nulls is None else _sql.SortDir(c._sort, c._sort_nulls)
                plain = c._plain_name()
                if plain is not None:
                    names.append(plain)
                    asc_out.append(a)
                    continue
                # a computed key always sorts on a fresh name: an
                # expression named like a column must not sort by it
                name = f"__ordcol_{len(tmp)}"
                df = df.withColumn(name, c)
                tmp.append(name)
                names.append(name)
                asc_out.append(a)
            out = df.orderBy(*names, ascending=asc_out)
            return out.drop(*tmp) if tmp else out
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in orderBy")
        merged = self.collectColumns()
        n = len(merged[self._columns[0]]) if self._columns else 0
        order = list(range(n))
        # one stable pass per key, minor key first; the null rank keeps
        # None out of comparisons and places nulls below (0) or above (2)
        # every value, which after ``reverse`` gives all four
        # direction x nulls placements
        for c, a in list(zip(cols, asc))[::-1]:
            vals = merged[c]
            asc_b = bool(a)
            nulls_first = getattr(a, "nulls_first", None)
            if nulls_first is None:
                nulls_first = asc_b
            if asc_b:
                null_rank = 0 if nulls_first else 2
            else:
                null_rank = 2 if nulls_first else 0
            order.sort(
                key=lambda i: (null_rank, 0) if vals[i] is None else (1, vals[i]),
                reverse=not asc_b,
            )
        return DataFrame.fromColumns(
            {c: _take(merged[c], order) for c in self._columns},
            numPartitions=max(1, self.numPartitions),
        )

    def sort(self, *cols, ascending: Any = True) -> "DataFrame":
        """Alias of :meth:`orderBy` (Spark ``sort``)."""
        return self.orderBy(*cols, ascending=ascending)

    def where(self, fn) -> "DataFrame":
        """Alias of :meth:`filter` (Spark ``where``)."""
        return self.filter(fn)

    def withColumns(self, colsMap: Dict[str, Any]) -> "DataFrame":
        """Add or replace several columns at once (Spark ``withColumns``):
        every value (a row-callable or a Column) sees the original row,
        so new columns cannot read each other. Replaced columns keep their
        position; new ones append in order."""
        names = list(colsMap)
        tmps = {c: f"__wc_{i}" for i, c in enumerate(names)}
        df = self
        for c, fn in colsMap.items():
            df = df.withColumn(tmps[c], fn)
        order = [tmps.get(c, c) for c in self._columns]
        order += [tmps[c] for c in names if c not in self._columns]
        df = df.select(*order)
        for c in names:
            df = df.withColumnRenamed(tmps[c], c)
        return df

    def withColumnRenamed(self, existing: str, new: str) -> "DataFrame":
        """Rename a column (Spark ``withColumnRenamed``); a no-op when the
        column does not exist."""
        if existing not in self._columns or existing == new:
            return self
        if new in self._columns:
            raise ValueError(f"Column {new!r} already exists")

        def op(part: Partition) -> Partition:
            return {(new if c == existing else c): part[c] for c in part}

        return self._with_op(op, [new if c == existing else c for c in self._columns])

    def withColumnsRenamed(self, colsMap: Dict[str, str]) -> "DataFrame":
        """Rename several columns at once, simultaneously (``{'a': 'b',
        'b': 'c'}`` maps the original a to b and the original b to c);
        missing names are ignored."""
        mapping = {old: new for old, new in colsMap.items() if old in self._columns and old != new}
        if not mapping:
            return self
        new_cols = [mapping.get(c, c) for c in self._columns]
        dups = {c for c in new_cols if new_cols.count(c) > 1}
        if dups:
            raise ValueError(f"withColumnsRenamed produces duplicate columns {sorted(dups)}")

        def op(part: Partition) -> Partition:
            return {mapping.get(c, c): part[c] for c in part}

        return self._with_op(op, new_cols)

    def toDF(self, *names: str) -> "DataFrame":
        """Rename every column by position (pyspark ``toDF``); duplicate
        names are refused."""
        if len(names) != len(self._columns):
            raise ValueError(f"toDF got {len(names)} names for {len(self._columns)} columns")
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            raise ValueError(f"toDF duplicate column name(s) {sorted(dups)}")
        mapping = dict(zip(self._columns, names))

        def op(part: Partition) -> Partition:
            return {mapping[c]: part[c] for c in part}

        return self._with_op(op, list(names))

    def selectExpr(self, *exprs: str) -> "DataFrame":
        """Project SQL expression strings (Spark ``selectExpr``):
        ``df.selectExpr("price * qty AS total", "label")``, in the SQL
        layer's expression grammar, catalog UDFs included. Every item reads
        the input frame; ``"*"`` passes every column through."""
        from sparkdl_tpu_torch import sql as _sql

        df = self
        parsed: List[Tuple[Any, str]] = []
        for text in exprs:
            if text.strip() == "*":
                parsed.extend((None, c) for c in self._columns)
                continue
            parser = _sql._Parser(_sql._tokenize(text))
            item = parser.select_item()
            if parser.peek()[0] != "eof":
                raise ValueError(f"Trailing tokens in selectExpr item {text!r}")
            if item.expr == "*" or isinstance(item.expr, _sql.QualifiedStar):
                raise ValueError(f"selectExpr takes '*' alone, not {text!r}")
            parsed.append((item, item.alias or _sql._expr_name(item.expr)))
        items: List[Tuple[str, str]] = []
        for i, (item, name) in enumerate(parsed):
            if item is None:
                items.append((name, name))
                continue
            tmp = f"__selexpr_{i}"
            df = _sql._apply_expr(df, item.expr, tmp)
            items.append((tmp, name))
        finals = [n for _, n in items]
        dups = {n for n in finals if finals.count(n) > 1}
        if dups:
            raise ValueError(f"Duplicate output column(s) in selectExpr: {sorted(dups)}")
        df = df.select(*[t for t, _ in items])
        for tmp, name in items:
            df = df.withColumnRenamed(tmp, name)
        return df

    def transform(self, func, *args, **kwargs) -> "DataFrame":
        """Chain a frame-to-frame function (pyspark ``transform``)."""
        out = func(self, *args, **kwargs)
        if not isinstance(out, DataFrame):
            raise TypeError(f"transform function must return a DataFrame, got {type(out).__name__}")
        return out

    # -- schema ------------------------------------------------------------------

    def _schema_samples(self) -> Dict[str, Any]:
        """The first non-null cell of each column, streaming partitions
        until every column has one."""
        samples: Dict[str, Any] = {}
        for part in self.iterPartitions():
            n = _part_num_rows(part)
            for c in self._columns:
                if c in samples:
                    continue
                col = part[c]
                for i in range(n):
                    if col[i] is not None:
                        samples[c] = col[i]
                        break
            if len(samples) == len(self._columns):
                break
        return samples

    @property
    def dtypes(self) -> List[Tuple[str, str]]:
        """(name, type) pairs inferred from each column's first non-null
        cell, in Spark's vocabulary: bigint, double, string, boolean,
        binary, date, timestamp, array, struct, ``tensor<dtype>[shape]``
        for an ndarray cell, unknown for a column of nulls."""
        import datetime

        samples = self._schema_samples()

        def tname(v) -> str:
            if v is None:
                return "unknown"
            if isinstance(v, (bool, np.bool_)):  # before the int checks
                return "boolean"
            if isinstance(v, (int, np.integer)):
                return "bigint"
            if isinstance(v, (float, np.floating)):
                return "double"
            if isinstance(v, str):
                return "string"
            if isinstance(v, bytes):
                return "binary"
            if isinstance(v, datetime.datetime):
                return "timestamp"
            if isinstance(v, datetime.date):
                return "date"
            if isinstance(v, np.ndarray):
                return f"tensor<{v.dtype}>{list(v.shape)}"
            if isinstance(v, (list, tuple)):
                return "array"
            if isinstance(v, dict):
                return "struct"
            return type(v).__name__

        return [(c, tname(samples.get(c))) for c in self._columns]

    @property
    def schema(self):
        """The inferred schema as a ``StructType`` of :attr:`dtypes`; every
        field is nullable."""
        from sparkdl_tpu_torch.dataframe.types import StructField, StructType

        return StructType([StructField(c, t, True) for c, t in self.dtypes])

    def printSchema(self) -> None:
        """Print the inferred schema tree (Spark ``printSchema``): the
        type of each column's first non-null cell."""
        samples = self._schema_samples()
        lines = ["root"]
        for c in self._columns:
            sample = samples.get(c)
            if sample is None:
                tname = "unknown"
            elif isinstance(sample, np.ndarray):
                tname = f"tensor<{sample.dtype}>{list(sample.shape)}"
            else:
                tname = type(sample).__name__
            lines.append(f" |-- {c}: {tname} (nullable = true)")
        print("\n".join(lines))

    # -- row access ---------------------------------------------------------------

    def head(self, n: int = 1) -> List["Row"]:
        """The first ``n`` rows; runs partitions until it has them."""
        return self.limit(n).collect() if n > 0 else []

    def take(self, n: int) -> List["Row"]:
        """First ``n`` rows (Spark ``take``)."""
        return self.head(n)

    def first(self) -> Optional["Row"]:
        """The first row, or None on an empty frame (Spark ``first``)."""
        rows = self.head(1)
        return rows[0] if rows else None

    def tail(self, num: int) -> List["Row"]:
        """The last ``num`` rows, streamed through a ``num``-deep window."""
        if num <= 0:
            return []
        from collections import deque

        window: deque = deque(maxlen=num)
        for part in self.iterPartitions():
            for i in range(_part_num_rows(part)):
                window.append(Row({c: part[c][i] for c in self._columns}))
        return list(window)

    def isEmpty(self) -> bool:
        """Whether the frame has no rows; stops at the first row."""
        return not self.head(1)

    def show(self, n: int = 20, truncate: int = 20) -> None:
        """Print the first ``n`` rows as an aligned text table (Spark
        ``show``). ``truncate``: the widest cell (0: no limit); array and
        struct cells print as a shape or field summary."""

        def render(v):
            if v is None:
                return "null"
            if isinstance(v, np.ndarray):
                s = f"array{list(v.shape)}:{v.dtype}"
            elif isinstance(v, dict):
                s = "{" + ", ".join(sorted(v)) + "}"
            elif isinstance(v, float):
                s = f"{v:.6g}"
            else:
                s = str(v)
            if truncate and len(s) > truncate:
                s = s[:truncate] if truncate <= 3 else s[: truncate - 3] + "..."
            return s

        rows = self.head(n + 1)  # one more than shown tells whether there are more
        more = len(rows) > n
        rows = rows[:n]
        cols = self._columns
        cells = [[render(r.get(c)) for c in cols] for r in rows]
        widths = [
            max(len(c), *(len(row[i]) for row in cells)) if cells else len(c)
            for i, c in enumerate(cols)
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        fmt = "|" + "|".join(f" {{:<{w}}} " for w in widths) + "|"
        print(sep)
        print(fmt.format(*cols))
        print(sep)
        for row in cells:
            print(fmt.format(*row))
        print(sep)
        if more:
            print(f"only showing top {len(rows)} rows")

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
            src = self._source[i]
            for _attempt in range(max_failures):
                try:
                    result = _run_plan(self._ops, self._columns, src)
                    break
                except Exception as e:  # noqa: BLE001 — retried, then raised
                    last_err = e
            else:
                raise PartitionTaskError(i, max_failures, last_err)
            if isinstance(src, LazyPartition):
                src.release()  # a streaming pass keeps no file's columns
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
