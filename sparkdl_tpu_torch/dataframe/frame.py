"""A minimal partitioned DataFrame.

The part of the JAX package's DataFrame that the text, image, training,
SQL and model-selection slices drive, with its relational methods
(grouping and the streaming aggregate engine, joins, set operations,
``distinct``, ``offset``), its windows and generators, its statistics
(``describe``, ``summary``, ``corr``, ``cov``, ``approxQuantile``,
``crosstab``, ``freqItems``, ``sample``, ``sampleBy``, ``df.stat``), NA
handling (``dropna``, ``fillna``, ``replace``, ``df.na``), partitioning
(``repartition``, ``repartitionByRange``, a lazy ``coalesce``,
``sortWithinPartitions``, ``melt``) and views: a frame is a list of
partitions (each a ``{column: list}`` dict) plus a lazy plan of
partition-wise ops, some of which (``rand``, ``monotonically_increasing_id``,
``sampleBy``) also take the source partition's index.
Actions run the plan over the partitions through the default executor
(``runtime/executor.py``): several at once, results in partition order,
with bounded retry. :meth:`DataFrame.iterPartitions` runs them one at a
time instead, keeping one in memory (the streamed trainer's feed, and
:meth:`DataFrame.limit`, which stops at the partition that fills it).

Files: CSV and JSON lines through the stdlib (:meth:`DataFrame.writeCSV`,
:meth:`DataFrame.readCSV`, :meth:`DataFrame.writeJSON`,
:meth:`DataFrame.readJSON`, and ``df.write``/``spark.read`` over them in
``session.py``), :meth:`DataFrame.readParquet`, :meth:`DataFrame.scanParquet`
(lazy partitions over row spans, reading only the footer up front),
:meth:`DataFrame.writeParquet` (streamed, one row group per partition) and
:meth:`DataFrame.fromArrowFiles` (lazy, one partition per Arrow IPC
file), over the port's own readers and writers (``dataframe/parquet.py``,
``dataframe/arrow_ipc.py``): the port never imports ``pyarrow``, so the
JAX package's ``fromArrow``/``toArrow``/``toArrowBatches``/``mapInArrow``,
which take and return ``pyarrow`` Tables, have no counterpart.

pandas: :meth:`DataFrame.toPandas`, :meth:`DataFrame.mapInPandas`,
:meth:`GroupedData.applyInPandas` and ``cogroup(...).applyInPandas``
import pandas inside the call, never at import, so every other path runs
where pandas is not installed. ``toPandas`` builds the frame itself with
the dtypes the JAX package's ``toArrow().to_pandas()`` gives (see
:func:`_pandas_series`). A tensor column read from a file is one contiguous numpy block
``(rows, *shape)`` in its partition, as the JAX package's
``TensorColumn`` is; indexing it gives row views.
"""

from __future__ import annotations

import copy
import math
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


def _guard_collect(df: "DataFrame", action: str) -> None:
    """Fail fast before a relational action that collects to the host
    (join, set operation, distinct) reads a source frame of more rows
    than ``SPARKDL_DRIVER_COLLECT_MAX_ROWS`` (0: no guard). A planned
    frame passes: its post-plan size is unknowable from metadata."""
    from sparkdl_tpu_torch.runtime import knobs

    limit = knobs.get_int("SPARKDL_DRIVER_COLLECT_MAX_ROWS")
    if not limit or df._ops:
        return
    rows = sum(df.partitionRowCounts())
    if rows > limit:
        raise ValueError(
            f"{action} collects to the host and this frame has "
            f"{rows:,} source rows "
            f"(> SPARKDL_DRIVER_COLLECT_MAX_ROWS={limit:,}). At this scale "
            "use the streaming surfaces instead: filter/select/withColumn "
            "+ iterPartitions/writeParquet stay bounded, and groupBy/SQL "
            "aggregation streams partition-wise. Set "
            "SPARKDL_DRIVER_COLLECT_MAX_ROWS=0 to disable this guard."
        )


def _cell_key(v):
    """Hashable key for an arbitrary cell value: tensors hash by
    shape/dtype/bytes, image structs and lists recursively. Shared by
    distinct() and groupBy() so tensor/struct key columns work in both."""
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    if isinstance(v, dict):  # image structs and friends
        return tuple((k, _cell_key(v[k])) for k in sorted(v))
    if isinstance(v, (list, tuple)):
        return tuple(_cell_key(x) for x in v)
    return v


def _pandas_cells(series) -> list:
    """A pandas column back to frame cells: a scalar NaN, NaT or NA becomes
    None (a numeric pandas column holds a null as NaN); containers (lists,
    arrays, dicts) pass through."""
    import pandas as pd

    out = []
    for v in series:
        if not isinstance(v, (list, tuple, dict, np.ndarray)) and pd.isna(v):
            out.append(None)
        else:
            out.append(v)
    return out


def _cell_kind(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, str):
        return "str"
    if isinstance(v, bytes):
        return "bytes"
    import datetime

    if isinstance(v, datetime.datetime):
        return "ts"
    if isinstance(v, datetime.date):
        return "date"
    if isinstance(v, (list, tuple)) or (isinstance(v, np.ndarray) and v.ndim >= 1):
        return "list"
    if isinstance(v, dict):
        return "struct"
    return "object"


def _arrow_kind(values) -> tuple:
    """The type Arrow would infer for a column of cells (``pa.array``, as
    the JAX package's ``toArrow`` builds it): ``("null",)``, ``("bool",)``,
    ``("int", dtype)``, ``("float", dtype)``, ``("str",)``, ``("bytes",)``,
    ``("ts",)``, ``("date",)``, ``("list", inner)``, ``("struct", [(key,
    kind), ...])``, or ``("object",)`` for a mix Arrow refuses. A numeric
    column of numpy scalars of one dtype keeps it; python numbers are int64
    or float64, and ints beside floats are float64."""
    cells = [v for v in values if v is not None]
    if not cells:
        return ("null",)
    kinds = {_cell_kind(v) for v in cells}
    if len(kinds) == 1 and kinds <= {"bool", "str", "bytes", "ts", "date"}:
        return (kinds.pop(),)
    if kinds <= {"int", "float"}:
        kind = "int" if kinds == {"int"} else "float"
        dtypes = {v.dtype for v in cells if isinstance(v, np.generic)}
        if len(dtypes) == 1 and all(isinstance(v, np.generic) for v in cells):
            return (kind, dtypes.pop())
        return (kind, np.dtype(np.int64 if kind == "int" else np.float64))
    if kinds == {"list"}:
        elems = [x for v in cells for x in (v.tolist() if isinstance(v, np.ndarray) else v)]
        return ("list", _arrow_kind(elems))
    if kinds == {"struct"}:
        keys: List[Any] = []
        for d in cells:
            keys.extend(k for k in d if k not in keys)
        return ("struct", [(k, _arrow_kind([d.get(k) for d in cells])) for k in keys])
    return ("object",)


def _pandas_value(v, kind: tuple):
    """One cell inside a list or struct as Arrow's ``to_pandas`` gives it:
    a list as a numpy array, a struct as a dict of every field, a numpy
    scalar as a python one."""
    if v is None:
        return None
    if kind[0] == "list":
        return _numpy_list(v.tolist() if isinstance(v, np.ndarray) else v, kind[1])
    if kind[0] == "struct":
        return {k: _pandas_value(v.get(k), sub) for k, sub in kind[1]}
    return v.item() if isinstance(v, np.generic) else v


def _numpy_list(elems, kind: tuple) -> np.ndarray:
    """A list cell as the numpy array Arrow's ``to_pandas`` gives: ints with
    a null become float64 with NaN, bools with a null and every
    non-numeric kind an object array."""
    has_null = any(e is None for e in elems)
    if kind[0] == "float" or (kind[0] == "int" and has_null):
        dtype = kind[1] if kind[0] == "float" else np.float64
        return np.array([np.nan if e is None else e for e in elems], dtype=dtype)
    if kind[0] == "int" or (kind[0] == "bool" and not has_null):
        return np.array(elems, dtype=kind[1] if kind[0] == "int" else bool)
    out = np.empty(len(elems), dtype=object)
    for i, e in enumerate(elems):
        out[i] = _pandas_value(e, kind)
    return out


def _pandas_series(values, pd):
    """One collected column as the pandas Series that the JAX package's
    ``toArrow().to_pandas()`` gives for it:

    - a column of numeric numpy arrays of one shape and dtype (the JAX
      package's ``TensorColumn``) is a tensor column: each row an array of
      that dtype, flattened (Arrow's fixed-shape tensor), or the scalars
      themselves when the rows are 0-d;
    - ints are int64 (a column of numpy scalars keeps their dtype), and
      float64 with NaN when one is null; floats are float64 (or their
      numpy dtype) with NaN;
    - bools are bool, and objects with None when one is null;
    - strings are pandas' default string dtype; timestamps datetime64;
      bytes and dates objects;
    - list cells are numpy arrays of the column's element type; struct
      (dict) cells are dicts of every field seen;
    - a column of nothing but nulls, or of a mix Arrow refuses, holds its
      cells as objects."""
    vals = list(values)
    n = len(vals)
    if vals and all(isinstance(v, np.ndarray) and v.dtype.kind in "fiub" for v in vals):
        shape, dtype = vals[0].shape, vals[0].dtype
        if all(v.shape == shape and v.dtype == dtype for v in vals):
            block = np.stack(vals)
            if block.ndim == 1:
                return pd.Series(block)
            rows = np.empty(n, dtype=object)
            for i in range(n):
                rows[i] = np.ascontiguousarray(block[i]).reshape(-1)
            return pd.Series(rows, dtype=object)
    kind = _arrow_kind(vals)
    has_null = any(v is None for v in vals)
    if kind[0] in ("int", "float"):
        if kind[0] == "int" and not has_null:
            return pd.Series(np.array(vals, dtype=kind[1]))
        dtype = kind[1] if kind[0] == "float" else np.float64
        return pd.Series(np.array([np.nan if v is None else v for v in vals], dtype=dtype))
    if kind[0] == "bool":
        if not has_null:
            return pd.Series(np.array(vals, dtype=bool))
        return pd.Series([None if v is None else bool(v) for v in vals], dtype=object)
    if kind[0] in ("str", "ts"):
        return pd.Series(vals)
    cells = np.empty(n, dtype=object)
    for i, v in enumerate(vals):
        cells[i] = _pandas_value(v, kind) if kind[0] in ("list", "struct") else v
    return pd.Series(cells, dtype=object)


def _split_ddl_fields(s: str) -> List[str]:
    """Split a DDL schema string on top-level commas only, so that
    parameterized and nested types (``map<string,int>``,
    ``decimal(10,2)``, ``array<struct<...>>``) stay with their field."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _schema_names(schema) -> List[str]:
    """Column names from a pyspark-style schema: a list or tuple of names,
    or a DDL string (``"id long, name string"``) whose type words,
    parameterized and nested ones too, are accepted and ignored (the
    frame is dynamically typed)."""
    if isinstance(schema, (list, tuple)):
        names = [str(c) for c in schema]
    elif isinstance(schema, str):
        import re

        # a name ends at whitespace or a colon: "a int", "a: int", "a:int"
        names = [
            re.split(r"[:\s]", piece.strip(), maxsplit=1)[0]
            for piece in _split_ddl_fields(schema)
            if piece.strip()
        ]
    else:
        raise TypeError(
            "schema must be a list of column names or a DDL string "
            f"('id long, name string'), got {type(schema).__name__}"
        )
    if not names:
        raise ValueError("schema declares no columns")
    dups = {n for n in names if names.count(n) > 1}
    if dups:
        raise ValueError(f"Duplicate schema columns: {sorted(dups)}")
    return names


def _json_cell(v):
    """The JSON form of a cell: numpy scalars and arrays unwrap, through
    list, tuple and dict cells too (embeddings hold numpy floats)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_json_cell(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_cell(x) for k, x in v.items()}
    return v


def _gen_nondet(node, index: int, n: int) -> list:
    """Values for one partition of a partition-seeded generator
    (Column API NondetNode): pyspark's monotonically_increasing_id
    layout (partition index << 33 + row offset), and seed+partition
    deterministic uniform/normal draws for rand/randn."""
    if node.kind == "mono_id":
        return [(index << 33) + j for j in range(n)]
    if node.kind == "spark_partition_id":
        return [index] * n
    # mask: SeedSequence rejects negative entropy, and hash-derived
    # seeds are frequently negative
    seed = (0 if node.seed is None else int(node.seed)) & (2 ** 64 - 1)
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    if node.kind == "rand":
        return [float(v) for v in rng.random(n)]
    if node.kind == "randn":
        return [float(v) for v in rng.standard_normal(n)]
    raise ValueError(f"Unknown generator kind {node.kind!r}")


def _run_plan(ops, columns: List[str], part: Partition, index: int = 0) -> Partition:
    """Run the pending op chain over one partition and project to
    ``columns``, the one execution body of every action. Ops marked
    ``_indexed`` also receive the source partition's index (the
    partition-seeded ids and draws need it)."""
    for op in ops:
        part = op(part, index) if getattr(op, "_indexed", False) else op(part)
    return {c: part[c] for c in columns}


def _serial_plan(ops, source) -> bool:
    """Whether a plan holds an op marked ``_serial``
    (``withColumnPartition(..., serial=True)``), also inside a coalesced
    partition's pending ops."""
    return any(getattr(op, "_serial", False) for op in ops) or any(
        isinstance(p, _CoalescedPartition) and _serial_plan(p._child_ops, ())
        for p in source
    )


class _CoalescedPartition(Mapping):
    """Several source partitions presented as one, the parent frame's
    pending ops run over each child, with the child's own index, at the
    first access: the lazy half of :meth:`DataFrame.coalesce`. File-backed
    children release as they are read; :meth:`release` drops the merge."""

    def __init__(self, children, ops, cols, base_index: int = 0):
        self._children = list(children)
        self._child_ops = list(ops)
        self._cols = list(cols)
        self._base_index = base_index  # the first child's index in the parent
        self._data: Optional[Dict[str, list]] = None

    def _ensure(self) -> None:
        if self._data is not None:
            return
        merged: Dict[str, list] = {c: [] for c in self._cols}
        for off, child in enumerate(self._children):
            cur = _run_plan(self._child_ops, self._cols, child, self._base_index + off)
            for c in self._cols:
                merged[c].extend(list(cur[c]))
            if isinstance(child, LazyPartition):
                child.release()
        self._data = merged

    def __getitem__(self, key):
        self._ensure()
        return self._data[key]

    def __iter__(self):
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)

    def release(self) -> None:
        self._data = None


class Row(dict):
    """A result row; attribute access mirrors pyspark Row ergonomics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def asDict(self, recursive: bool = False) -> dict:
        """A plain dict copy (pyspark ``Row.asDict``); ``recursive`` also
        converts Rows nested in the cells, inside lists and dicts too."""
        if not recursive:
            return dict(self)

        def conv(v):
            if isinstance(v, Row):
                return v.asDict(True)
            if isinstance(v, list):
                return [conv(x) for x in v]
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            return v

        return {k: conv(v) for k, v in self.items()}


class DataFrame:
    def __init__(
        self,
        partitions: Sequence[Partition],
        columns: Sequence[str],
        ops: Optional[List[Callable[[Partition], Partition]]] = None,
        first_index: int = 0,
    ):
        self._source: List[Partition] = list(partitions)
        self._columns: List[str] = list(columns)
        self._ops: List[Callable[[Partition], Partition]] = list(ops or [])
        # the index of the first source partition within the frame it was
        # cut from (the batch worker's one-partition frames): indexed ops
        # see first_index + i
        self._first_index = first_index

    # correlation name from .alias(); read only by the join paths, and
    # deliberately NOT propagated through transformations — alias right
    # before joining, like the idiom it exists for
    _alias_name: Optional[str] = None

    def alias(self, name: str) -> "DataFrame":
        """Attach a correlation name for joins (pyspark ``alias``):
        ``df.alias("x").join(df.alias("y"), on="k")``. On a
        name-colliding join of two aliased frames, colliding non-key
        columns surface qualified as ``<alias>.<col>``, the SQL layer's
        self-join spelling."""
        if not name or not isinstance(name, str):
            raise ValueError(f"alias needs a non-empty name, got {name!r}")
        out = DataFrame(self._source, self._columns, list(self._ops), self._first_index)
        out._alias_name = name
        return out

    def colRegex(self, colName: str) -> list:
        """The columns whose name fully matches the regex (pyspark
        ``colRegex``, backticks optional), as Columns for ``select``:
        ``df.select(df.colRegex("`^v.*`"))``."""
        import re

        from sparkdl_tpu_torch import sql as _sql
        from sparkdl_tpu_torch.dataframe.column import Column

        pat = colName.strip()
        if pat.startswith("`") and pat.endswith("`"):
            pat = pat[1:-1]
        rx = re.compile(pat)
        return [Column(_sql.Col(c)) for c in self._columns if rx.fullmatch(c)]

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
    def fromRows(rows: Sequence[Dict[str, Any]], numPartitions: int = 1) -> "DataFrame":
        """Rows as dicts; the first row's keys are the columns."""
        if not rows:
            return DataFrame([], [])
        names = list(rows[0])
        return DataFrame.fromColumns({c: [r[c] for r in rows] for c in names}, numPartitions)

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
        return DataFrame(self._source, columns, self._ops + [op], self._first_index)

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

    def _apply_window_cols(self, cols: list) -> Tuple["DataFrame", list]:
        """Column-API windows (``F.row_number().over(Window...)``):
        compute every window-bearing Column through the SQL window
        engine (ONE engine for sql() text and .over — semantics cannot
        drift), widening the frame with hidden ``__win``/operand
        columns and rewriting those Columns to plain references. The
        caller's final projection drops the hidden columns. Returns
        (frame, cols) unchanged when nothing carries a window."""
        from sparkdl_tpu_torch import sql as _sql
        from sparkdl_tpu_torch.dataframe.column import Column

        items: list = []
        positions: list = []
        for i, c in enumerate(cols):
            if not (isinstance(c, Column) and c._has_window()):
                continue
            if c._is_pred():
                raise TypeError(
                    f"Window condition {c._output_name()!r} is not "
                    "supported directly; compute the window value with "
                    "withColumn first and compare that, or wrap the "
                    "comparison in F.when(...)"
                )
            # deepcopy: the engine materializes operand expressions IN
            # PLACE on the Window nodes; user-held Columns stay pure so
            # re-using one against another frame re-resolves cleanly
            expr = copy.deepcopy(c._expr)
            for w in _sql._iter_windows(expr):
                if _sql._window_needs_order(w.fn) and not w.order_by:
                    raise TypeError(
                        f"Window function {w.fn}() needs a bound, "
                        "ordered window: call .over(Window"
                        ".partitionBy(...).orderBy(...))"
                    )
            items.append(_sql.SelectItem(expr, c._output_name()))
            positions.append(i)
        if not items:
            return self, list(cols)
        df = _sql.SQLContext._apply_window_items(self, items)
        out = list(cols)
        for item, i in zip(items, positions):
            out[i] = Column(item.expr, item.alias)
        return df, out

    def select(self, *cols) -> "DataFrame":
        """Project by name, or by Column expression
        (``df.select("a", (F.col("v") * 2).alias("d"))``); a single list
        argument expands. Every item reads the frame as it was: computed
        items land under temporary names and are renamed at the end, so
        an alias that shadows an input column cannot change a later item."""
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        if any(not isinstance(c, str) for c in cols):
            from sparkdl_tpu_torch.dataframe.column import (
                Column,
                ExplodeNode,
                JsonTupleNode,
                StackNode,
            )

            n_explodes = sum(
                1
                for c in cols
                if isinstance(c, Column)
                and isinstance(c._expr, (ExplodeNode, StackNode, JsonTupleNode))
            )
            if n_explodes > 1:
                raise ValueError(
                    "Only one generator (explode/stack/json_tuple) is "
                    "allowed per select"
                )
            if n_explodes:
                if any(isinstance(c, Column) and c._has_window() for c in cols):
                    raise ValueError(
                        "A generator (explode) and a window function "
                        "cannot share one select; split into two selects"
                    )
                return self._select_with_explode(list(cols))

            base, wcols = self._apply_window_cols(list(cols))
            if base is not self:
                return base.select(*wcols)

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

    def _select_with_explode(self, cols: list) -> "DataFrame":
        """select with ONE generator item (F.explode/explode_outer/
        posexplode/stack/json_tuple): every non-generator item resolves
        against the input frame as in plain select; each input row then
        emits the generator's rows (a tuple of output cells per row),
        with plain items repeated alongside. Lazy — a per-partition op
        like every projection."""
        from sparkdl_tpu_torch import sql_builtins as _sqlmod
        from sparkdl_tpu_torch.dataframe.column import (
            Column,
            ExplodeNode,
            JsonTupleNode,
            StackNode,
        )

        df = self
        # (src cols, output names, kind): kind 'plain' carries the
        # source cell; generator kinds emit tuples via gen_rows below
        items: List[Tuple[List[str], List[str], str]] = []
        outer = False
        gen_node = None
        for i, c in enumerate(cols):
            if isinstance(c, str):
                if c not in self._columns:
                    raise KeyError(f"No such column {c!r}")
                items.append(([c], [c], "plain"))
                continue
            if not isinstance(c, Column):
                raise TypeError(
                    "select() takes column names or Columns, got "
                    f"{type(c).__name__}"
                )
            if isinstance(c._expr, ExplodeNode):
                tmp = f"__exp_{i}"
                df = df.withColumn(tmp, Column(c._expr.inner))
                node = gen_node = c._expr
                if node.with_pos:
                    if isinstance(c._alias, tuple):
                        fnames = list(c._alias)
                    elif c._alias is not None:
                        raise ValueError(
                            "posexplode produces two columns; alias "
                            "both: .alias('pos', 'col')"
                        )
                    else:
                        fnames = ["pos", "col"]
                    items.append(([tmp], fnames, "posex"))
                else:
                    items.append(([tmp], [c._output_name()], "ex"))
                outer = node.outer
                continue
            if isinstance(c._expr, StackNode):
                node = gen_node = c._expr
                srcs = []
                for j, arg in enumerate(node.args):
                    tmp = f"__stk_{i}_{j}"
                    df = df.withColumn(tmp, Column(arg))
                    srcs.append(tmp)
                if isinstance(c._alias, tuple):
                    fnames = list(c._alias)
                elif c._alias is not None:
                    fnames = [c._alias]  # width-1 stack, single alias
                else:
                    fnames = [f"col{j}" for j in range(node.width)]
                if len(fnames) != node.width:
                    raise ValueError(
                        f"stack produces {node.width} columns; got "
                        f"{len(fnames)} alias name(s)"
                    )
                items.append((srcs, fnames, "stack"))
                continue
            if isinstance(c._expr, JsonTupleNode):
                node = gen_node = c._expr
                tmp = f"__jt_{i}"
                df = df.withColumn(tmp, Column(node.src))
                if isinstance(c._alias, tuple):
                    fnames = list(c._alias)
                elif c._alias is not None:
                    fnames = [c._alias]
                else:
                    fnames = [f"c{j}" for j in range(len(node.fields))]
                if len(fnames) != len(node.fields):
                    raise ValueError(
                        f"json_tuple produces {len(node.fields)} "
                        f"columns; got {len(fnames)} alias name(s)"
                    )
                items.append(([tmp], fnames, "jt"))
                continue
            plain = c._plain_name()
            if plain is not None and c._alias in (None, plain):
                items.append(([plain], [plain], "plain"))
                continue
            tmp = f"__sel_{i}"
            df = df.withColumn(tmp, c)
            items.append(([tmp], [c._output_name()], "plain"))
        finals = [f for _, fs, _ in items for f in fs]
        dups = {f for f in finals if finals.count(f) > 1}
        if dups:
            raise ValueError(
                f"Duplicate output column(s) in select: {sorted(dups)}"
            )
        gen_srcs, gen_fs, gen_kind = next(
            (s, fs, k) for s, fs, k in items if k != "plain"
        )

        def gen_rows(part, i) -> Optional[List[tuple]]:
            """The generator's output tuples for input row i; None
            drops the row (non-outer explode of null/empty)."""
            if gen_kind in ("ex", "posex"):
                arr = part[gen_srcs[0]][i]
                if isinstance(arr, np.ndarray):
                    # tensor-block rows explode too (a uniform-length
                    # list column may be stored columnar)
                    arr = list(arr)
                if arr is None or (
                    isinstance(arr, (list, tuple)) and len(arr) == 0
                ):
                    if not outer:
                        return None  # explode drops null/empty rows
                    return [(None, None)] if gen_kind == "posex" else [
                        (None,)
                    ]
                if not isinstance(arr, (list, tuple)):
                    raise TypeError(
                        f"explode needs list cells; column "
                        f"{gen_srcs[0]!r} holds {type(arr).__name__}"
                    )
                if gen_kind == "posex":
                    return list(enumerate(arr))
                return [(e,) for e in arr]
            if gen_kind == "stack":
                vals = [part[s][i] for s in gen_srcs]
                w = gen_node.width
                rows = []
                for r in range(gen_node.n):
                    rows.append(tuple(
                        vals[r * w + j] if r * w + j < len(vals) else None
                        for j in range(w)
                    ))
                return rows
            # json_tuple: one output row, k LITERAL top-level key
            # lookups off a single json.loads (Spark: 'a.b' is the
            # literal key, never a path)
            js = part[gen_srcs[0]][i]
            if js is None:
                return [(None,) * len(gen_node.fields)]
            return [_sqlmod._json_tuple_row(js, gen_node.fields)]

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            out: Dict[str, list] = {f: [] for f in finals}
            for i in range(n):
                rows = gen_rows(part, i)
                if rows is None:
                    continue
                for tup in rows:
                    for srcs, fs, kind in items:
                        if kind == "plain":
                            out[fs[0]].append(part[srcs[0]][i])
                        else:
                            for f, v in zip(fs, tup):
                                out[f].append(v)
            return out

        return df._with_op(op, finals)

    def drop(self, *cols: str) -> "DataFrame":
        keep = [c for c in self._columns if c not in cols]
        return self.select(*keep)

    def withColumn(self, name: str, fn) -> "DataFrame":
        """Row-wise column: ``fn`` is a row-callable, which gets each row
        as a :class:`Row`, or a Column expression; a condition Column
        gives a True/False/None cell per row. A Column that calls a
        catalog UDF dispatches it batched through the SQL layer, a window
        Column through the SQL window engine, and a partition-seeded one
        (``F.rand``, ...) with the source partition's index."""
        cols = self._columns + ([name] if name not in self._columns else [])
        if not callable(fn):
            from sparkdl_tpu_torch.dataframe.column import (
                Column,
                ExplodeNode,
                JsonTupleNode,
                NondetNode,
                StackNode,
            )

            if not isinstance(fn, Column):
                raise TypeError(f"withColumn() takes a row-callable or a Column, got {type(fn).__name__}")
            if isinstance(fn._expr, (ExplodeNode, StackNode, JsonTupleNode)):
                raise TypeError(
                    "generators (explode/stack/json_tuple) change the "
                    "row/column shape and only work as select items, "
                    "not withColumn"
                )
            if isinstance(fn._expr, NondetNode):
                node = fn._expr

                def nop(part: Partition, index: int) -> Partition:
                    out = dict(part)
                    out[name] = _gen_nondet(node, index, _part_num_rows(part))
                    return out

                nop._indexed = True
                return self._with_op(nop, cols)
            if fn._has_window():
                base, (c2,) = self._apply_window_cols([fn])
                return base.withColumn(name, c2).select(*cols)  # drops the hidden window columns
            if fn._has_catalog_call():
                if fn._is_pred():
                    raise TypeError(
                        "A UDF inside a condition is not supported directly; compute the UDF "
                        "value with withColumn first, then compare that"
                    )
                from sparkdl_tpu_torch import sql as _sql

                return _sql._apply_expr(self, fn._expr, name).select(*cols)
            fn = fn._row_fn()

        def op(part: Partition) -> Partition:
            n = _part_num_rows(part)
            out = dict(part)
            out[name] = [fn(Row({c: part[c][i] for c in part})) for i in range(n)]
            return out

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

    def dropna(
        self,
        how: str = "any",
        thresh: Optional[int] = None,
        subset: Optional[Sequence[str]] = None,
    ) -> "DataFrame":
        """Drop rows with nulls (pyspark ``dropna``) among ``subset`` (all
        columns by default): ``how='any'`` drops a row with any null,
        ``'all'`` one whose cells there are all null; ``thresh=k`` keeps
        the rows with at least k non-nulls, whatever ``how`` says. The
        older ``dropna([cols])`` and ``dropna('col')`` forms still work."""
        if isinstance(how, (list, tuple)):
            subset, how = how, "any"
        elif isinstance(how, str) and how not in ("any", "all"):
            if how in self._columns:
                # a column named any or all takes pyspark's meaning
                subset, how = [how], "any"
            else:
                raise ValueError(
                    f"dropna how must be 'any' or 'all' (or a column "
                    f"name for the legacy positional form), got {how!r}"
                )
        if isinstance(subset, str):
            subset = [subset]
        cols = list(subset) if subset is not None else list(self._columns)
        missing = [c for c in cols if c not in self._columns]
        if missing:
            raise KeyError(f"dropna: no such column(s) {missing}")
        if thresh is not None:
            k = int(thresh)
            return self.filter(lambda r: sum(r[c] is not None for c in cols) >= k)
        if how == "any":
            return self.filter(lambda r: all(r[c] is not None for c in cols))
        if how == "all":
            return self.filter(lambda r: any(r[c] is not None for c in cols))
        raise ValueError(f"dropna how must be 'any' or 'all', got {how!r}")

    def fillna(self, value, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """Replace nulls (pyspark ``fillna``) with a scalar, in ``subset``
        (all columns by default), or per column from a dict (``subset``
        then ignored, as in pyspark). Unlike Spark, a scalar fills a
        column whatever its cells' type: there is no schema to scope it.
        Lazy."""
        if isinstance(value, dict):
            fills = dict(value)
        else:
            if isinstance(subset, str):
                subset = [subset]
            cols = list(subset) if subset is not None else list(self._columns)
            fills = {c: value for c in cols}
        missing = [c for c in fills if c not in self._columns]
        if missing:
            raise KeyError(f"fillna: no such column(s) {missing}")

        def fill(part: Partition) -> Partition:
            out = dict(part)
            for c, v in fills.items():
                cells = part[c]
                if any(x is None for x in cells):
                    out[c] = [v if x is None else x for x in cells]
            return out

        return self._with_op(fill, self._columns)

    @property
    def na(self) -> "_NAFunctions":
        """pyspark's ``df.na``: ``drop``, ``fill`` and ``replace``."""
        return _NAFunctions(self)

    def replace(self, to_replace, value=None, subset=None) -> "DataFrame":
        """Replace cell values (pyspark ``replace``): a scalar by a
        scalar, a list by a list (pairwise), or by an ``{old: new}`` dict.
        Nulls stay (that is :meth:`fillna`'s work)."""
        if isinstance(to_replace, dict):
            if value is not None:
                raise ValueError("value must be omitted when to_replace is a dict")
            pairs = list(to_replace.items())
        elif isinstance(to_replace, (list, tuple)):
            if not isinstance(value, (list, tuple)) or len(value) != len(to_replace):
                raise ValueError("list to_replace needs a value list of equal length")
            pairs = list(zip(to_replace, value))
        else:
            if value is None:
                # a forgotten value must not null the cells out
                raise ValueError(
                    "value argument is required for scalar/list "
                    "to_replace (use fillna/dropna for nulls)"
                )
            pairs = [(to_replace, value)]
        # keyed by (is bool, value): False == 0 and hash(False) == hash(0),
        # so a plain dict would let replace(0, x) rewrite boolean cells
        mapping = {(isinstance(old, bool), old): new for old, new in pairs}
        cols = list(subset) if subset else list(self._columns)
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in replace")
        col_set = set(cols)

        def swap(v):
            if v is None:
                return None
            try:
                return mapping.get((isinstance(v, bool), v), v)
            except TypeError:  # an unhashable cell (arrays, structs) stays
                return v

        def op(part: Partition) -> Partition:
            return {c: ([swap(v) for v in part[c]] if c in col_set else part[c]) for c in part}

        return self._with_op(op, list(self._columns))

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
        layer's expression grammar, catalog UDFs and windows included. Every
        item reads the input frame; ``"*"`` passes every column through."""
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
        witems = [item for item, _ in parsed if item is not None and _sql._contains_window(item.expr)]
        if witems:
            # one window engine run for every window item, as in sql():
            # the items are rewritten in place to plain references
            df = _sql.SQLContext._apply_window_items(df, witems)
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

        return list(deque(self.toLocalIterator(), maxlen=num))

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

    def unionAll(self, other: "DataFrame") -> "DataFrame":
        """Alias of :meth:`union` (pyspark keeps both; neither dedups)."""
        return self.union(other)

    def unionByName(
        self, other: "DataFrame", allowMissingColumns: bool = False
    ) -> "DataFrame":
        """Union matching columns by name (Spark ``unionByName``); with
        ``allowMissingColumns`` either side's absent columns fill with
        nulls instead of erroring."""
        mine, theirs = set(self._columns), set(other._columns)
        if mine != theirs and not allowMissingColumns:
            raise ValueError(
                f"unionByName requires the same column names: "
                f"{sorted(mine ^ theirs)} differ (pass "
                "allowMissingColumns=True to null-fill)"
            )
        all_cols = list(self._columns) + [c for c in other._columns if c not in mine]

        def widen(df: "DataFrame") -> "DataFrame":
            for c in all_cols:
                if c not in df.columns:
                    df = df.withColumn(c, lambda r: None)
            return df.select(*all_cols)

        return widen(self).union(widen(other))

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows present in both frames (Spark ``intersect``)."""
        return self._set_op(other, keep_present=True)

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows of this frame not in ``other`` (Spark
        ``subtract`` / SQL EXCEPT)."""
        return self._set_op(other, keep_present=False)

    def exceptAll(self, other: "DataFrame") -> "DataFrame":
        """Multiset difference (Spark ``exceptAll``): each left row
        survives max(left_count - right_count, 0) times, in left order."""
        return self._multiset_op(other, keep_matched=False)

    def intersectAll(self, other: "DataFrame") -> "DataFrame":
        """Multiset intersection (Spark ``intersectAll``): each row
        survives min(left_count, right_count) times."""
        return self._multiset_op(other, keep_matched=True)

    def _set_op_prologue(self, other: "DataFrame", what: str):
        """Shared validation + collection for the set/multiset ops:
        returns (cols, mine, n_mine, theirs, n_theirs)."""
        if set(self._columns) != set(other._columns):
            raise ValueError(
                f"set operation requires matching columns: "
                f"{self._columns} vs {other._columns}"
            )
        _guard_collect(self, what)
        _guard_collect(other, what)
        cols = self._columns
        mine = self.collectColumns()
        theirs = other.collectColumns()
        n_mine = len(mine[cols[0]]) if cols else 0
        n_theirs = len(theirs[cols[0]]) if cols else 0
        return cols, mine, n_mine, theirs, n_theirs

    def _multiset_op(self, other: "DataFrame", keep_matched: bool) -> "DataFrame":
        from collections import Counter

        cols, mine, n, theirs, n_other = self._set_op_prologue(other, "exceptAll/intersectAll")
        budget = Counter(tuple(_cell_key(theirs[c][i]) for c in cols) for i in range(n_other))
        keep: List[int] = []
        for i in range(n):
            k = tuple(_cell_key(mine[c][i]) for c in cols)
            matched = budget[k] > 0
            if matched:
                budget[k] -= 1
            if matched == keep_matched:
                keep.append(i)
        return DataFrame.fromColumns(
            {c: _take(mine[c], keep) for c in cols}, numPartitions=max(1, self.numPartitions)
        )

    def _set_op(self, other: "DataFrame", keep_present: bool) -> "DataFrame":
        cols, mine, n, theirs, n_other = self._set_op_prologue(other, "intersect/subtract")
        other_keys = {tuple(_cell_key(theirs[c][i]) for c in cols) for i in range(n_other)}
        seen = set()
        keep: List[int] = []
        for i in range(n):
            k = tuple(_cell_key(mine[c][i]) for c in cols)
            if k in seen:
                continue
            seen.add(k)
            if (k in other_keys) == keep_present:
                keep.append(i)
        return DataFrame.fromColumns(
            {c: _take(mine[c], keep) for c in cols}, numPartitions=max(1, self.numPartitions)
        )

    def distinct(self) -> "DataFrame":
        """Deduplicate rows, first occurrence wins (tensor cells compare
        by shape, dtype and bytes)."""
        return self._drop_duplicates(self._columns, "distinct")

    def _drop_duplicates(self, key_cols, action: str) -> "DataFrame":
        _guard_collect(self, action)
        merged = self.collectColumns()
        cols = self._columns
        n = len(merged[cols[0]]) if cols else 0
        seen = set()
        keep: List[int] = []
        for i in range(n):
            k = tuple(_cell_key(merged[c][i]) for c in key_cols)
            if k not in seen:
                seen.add(k)
                keep.append(i)
        return DataFrame.fromColumns(
            {c: _take(merged[c], keep) for c in cols}, numPartitions=max(1, self.numPartitions)
        )

    def dropDuplicates(self, subset: Optional[List[str]] = None) -> "DataFrame":
        """Deduplicate rows, optionally keying on a column subset; first
        occurrence wins (Spark ``dropDuplicates``)."""
        if subset is None:
            return self.distinct()
        for c in subset:
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in dropDuplicates")
        return self._drop_duplicates(list(subset), "dropDuplicates")

    drop_duplicates = dropDuplicates  # pyspark offers both spellings

    def offset(self, n: int) -> "DataFrame":
        """Skip the first ``n`` rows (pyspark 3.4 ``offset``), streaming
        partitions; the partitions that remain are the new frame's."""
        if n < 0:
            raise ValueError(f"offset must be non-negative, got {n}")
        if n == 0:
            return self
        out_parts: List[Partition] = []
        remaining = n
        for part in self.iterPartitions():
            rows = _part_num_rows(part)
            if remaining >= rows:
                remaining -= rows
                continue
            if remaining:
                part = {c: _take(part[c], list(range(remaining, rows))) for c in part}
                remaining = 0
            out_parts.append(part)
        if not out_parts:
            return DataFrame([], self._columns)
        return DataFrame(out_parts, self._columns)

    # -- grouping ------------------------------------------------------------------

    def _grouping_keys(self, cols, what: str):
        """Resolve groupBy/rollup/cube keys: names stay names; expression
        Columns (``F.window(...)``, ``F.col("v") % 2``) materialize under
        their output name first (Spark groups by the expression)."""
        from sparkdl_tpu_torch.dataframe.column import Column

        df = self
        names: List[str] = []
        for c in cols:
            if isinstance(c, str):
                if c not in df._columns:
                    raise KeyError(f"Unknown column {c!r} in {what}")
                names.append(c)
                continue
            if not isinstance(c, Column):
                raise TypeError(f"{what} keys are names or Columns, got {type(c).__name__}")
            plain = c._plain_name()
            if plain is not None and c._alias in (None, plain):
                if plain not in df._columns:
                    raise KeyError(f"Unknown column {plain!r} in {what}")
                names.append(plain)
                continue
            name = c._output_name()
            if name in df._columns:
                # materializing the key would shadow the existing column:
                # aggregates over that name would read the key
                raise ValueError(
                    f"{what} expression key {name!r} collides with an "
                    "existing column; alias the key to a fresh name"
                )
            df = df.withColumn(name, c)
            names.append(name)
        return df, names

    def groupBy(self, *cols) -> "GroupedData":
        """Group rows by key columns or expression Columns (Spark
        ``groupBy``); see :class:`GroupedData`."""
        df, names = self._grouping_keys(cols, "groupBy")
        return GroupedData(df, names)

    groupby = groupBy  # pyspark offers both spellings

    def rollup(self, *cols) -> "GroupedData":
        """Hierarchical subtotals (Spark ``rollup``): aggregates over
        (k1..kn), (k1..kn-1), ..., (), keys outside a set null."""
        df, names = self._grouping_keys(cols, "rollup")
        return GroupedData(df, names, mode="rollup")

    def cube(self, *cols) -> "GroupedData":
        """All grouping-set combinations of the keys (Spark ``cube``)."""
        df, names = self._grouping_keys(cols, "cube")
        return GroupedData(df, names, mode="cube")

    def groupingSets(self, groupingSets, *cols) -> "GroupedData":
        """Explicit grouping sets (pyspark 3.4 ``groupingSets``):
        ``df.groupingSets([["a", "b"], ["a"], []], "a", "b")``; keys absent
        from a set emit null."""
        df, names = self._grouping_keys(cols, "groupingSets")
        if not names:
            raise ValueError("groupingSets needs at least one key column")
        from sparkdl_tpu_torch.dataframe.column import Column

        def member_name(m) -> str:
            if isinstance(m, Column):
                # `m not in names` would force Column.__eq__ into bool
                plain = m._plain_name()
                if plain is None:
                    raise ValueError(
                        "groupingSets members must be plain column "
                        "references (expressions go in the key list)"
                    )
                return plain
            return m

        sets: List[Tuple[str, ...]] = []
        for gs in groupingSets:
            members = [member_name(m) for m in ([gs] if isinstance(gs, (str, Column)) else list(gs))]
            bad = [m for m in members if m not in names]
            if bad:
                raise ValueError(f"groupingSets members {bad} are not among the key columns {names}")
            sets.append(tuple(members))
        if not sets:
            raise ValueError("groupingSets needs at least one set")
        return GroupedData(df, names, mode="sets", explicit_sets=sets)

    def agg(self, *exprs) -> "DataFrame":
        """Global aggregation without grouping (Spark ``df.agg``): one
        row."""
        return GroupedData(self, []).agg(*exprs)

    # -- joins -----------------------------------------------------------------------

    def _qualify_overlap(self, other: "DataFrame", overlap: set):
        """When both frames carry distinct .alias() names, resolve a
        column collision by renaming each colliding column to
        ``<alias>.<col>`` on its side (the SQL layer's self-join
        spelling); None when aliases cannot disambiguate."""
        la, ra = self._alias_name, other._alias_name
        if not la or not ra or la == ra:
            return None
        targets = [(f"{la}.{c}", f"{ra}.{c}") for c in sorted(overlap)]
        if any(lt in self._columns or rt in other._columns for lt, rt in targets):
            return None  # a qualified name is taken: the ambiguity error
        left2, right2 = self, other
        for c, (lt, rt) in zip(sorted(overlap), targets):
            left2 = left2.withColumnRenamed(c, lt)
            right2 = right2.withColumnRenamed(c, rt)
        return left2, right2

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        """Cartesian product (Spark ``crossJoin``); column names must not
        collide, unless both frames are aliased, which qualifies them."""
        overlap = set(self._columns) & set(other._columns)
        if overlap:
            qualified = self._qualify_overlap(other, overlap)
            if qualified is not None:
                left2, right2 = qualified
                return left2.crossJoin(right2)
            raise ValueError(
                f"crossJoin column name collision: {sorted(overlap)}; "
                "rename with withColumnRenamed first, or alias both "
                "frames (df.alias('x'))"
            )
        _guard_collect(self, "crossJoin")
        _guard_collect(other, "crossJoin")
        left = self.collectColumns()
        right = other.collectColumns()
        ln = len(left[self._columns[0]]) if self._columns else 0
        rn = len(right[other._columns[0]]) if other._columns else 0
        out: Dict[str, list] = {}
        for c in self._columns:
            out[c] = [left[c][i] for i in range(ln) for _ in range(rn)]
        for c in other._columns:
            out[c] = [right[c][j] for _ in range(ln) for j in range(rn)]
        return DataFrame.fromColumns(out, numPartitions=max(1, self.numPartitions))

    def _join_on_columns(self, conds: list, other: "DataFrame", how: str) -> "DataFrame":
        """Equi-join from Column conditions: each must be
        F.col('a') == F.col('b') (or a bare F.col('k') meaning a same-named
        key); '&'-combined conditions expand. Differing key names rename
        the right key onto the left's, so the output keeps one merged key
        column under the left name (the SQL JOIN rule)."""
        from sparkdl_tpu_torch import sql as _sql
        from sparkdl_tpu_torch.dataframe.column import Column

        pairs: List[Tuple[str, str]] = []

        def add_pred(node) -> None:
            if isinstance(node, _sql.BoolOp) and node.op == "and":
                for p in node.parts:
                    add_pred(p)
                return
            if (
                isinstance(node, _sql.Predicate)
                and node.op == "="
                and isinstance(node.col, _sql.Col)
                and isinstance(node.value, _sql.Col)
            ):
                pairs.append((node.col.name, node.value.name))
                return
            raise ValueError(
                "join(on=Column) takes equality conditions between "
                "column references — F.col('a') == F.col('b'), several "
                "combined with & — not arbitrary predicates"
            )

        for c in conds:
            if isinstance(c, str):
                pairs.append((c, c))
                continue
            if not isinstance(c, Column):
                raise TypeError(f"join key must be a name or Column, got {type(c).__name__}")
            if c._is_pred():
                add_pred(c._expr)
                continue
            plain = c._plain_name()
            if plain is None:
                raise ValueError(
                    "A non-condition join Column must be a bare column "
                    "reference (same-named key on both sides)"
                )
            pairs.append((plain, plain))

        right = other
        keys: List[str] = []
        for ln, rn in pairs:
            if ln not in self._columns and rn in self._columns:
                ln, rn = rn, ln  # condition written right == left
            if ln not in self._columns:
                raise KeyError(f"Join key {ln!r} not found on the left side")
            if rn not in other._columns:
                raise KeyError(f"Join key {rn!r} not found on the right side")
            if ln != rn:
                if ln in right._columns:
                    raise ValueError(
                        f"Cannot join on {ln!r} == {rn!r}: the right "
                        f"side also has a column named {ln!r}; rename "
                        "it with withColumnRenamed first"
                    )
                right = right.withColumnRenamed(rn, ln)
            keys.append(ln)
        return self.join(right, on=keys, how=how)

    def _semi_join(self, other: "DataFrame", keys: List[str], anti: bool) -> "DataFrame":
        """LEFT SEMI / LEFT ANTI join: keep left rows with at least one
        key match (semi) or none (anti); the output holds the left
        columns only. Null keys never match, so null-keyed left rows drop
        under semi and survive under anti, like Spark."""
        for k in keys:
            if k not in self._columns or k not in other._columns:
                raise KeyError(f"Join key {k!r} missing from a side")
        _guard_collect(self, "join")
        _guard_collect(other, "join")
        left = self.collectColumns()
        right = other.select(*keys).collectColumns()
        n_left = len(left[self._columns[0]]) if self._columns else 0
        n_right = len(right[keys[0]]) if keys else 0
        rkeys = [right[k] for k in keys]
        # null-keyed right tuples may enter the set: a left tuple with
        # any null is excluded below, so they never match
        table = {tuple(_cell_key(col[j]) for col in rkeys) for j in range(n_right)}
        lkeys = [left[k] for k in keys]
        keep: List[int] = []
        for i in range(n_left):
            raw = [col[i] for col in lkeys]
            matched = not any(v is None for v in raw) and tuple(_cell_key(v) for v in raw) in table
            if matched != anti:
                keep.append(i)
        return DataFrame.fromColumns(
            {c: _take(left[c], keep) for c in self._columns}, numPartitions=max(1, self.numPartitions)
        )

    def join(self, other: "DataFrame", on, how: str = "inner") -> "DataFrame":
        """Equi-join on key column(s) (Spark ``join``): ``how`` is
        'inner', 'left', 'right', 'outer'/'full', 'left_semi' or
        'left_anti' (and their aliases). Null keys never match. Non-key
        column names must not collide, unless both frames are aliased.

        A join collects both sides to the host. Output
        order: left rows in order, each followed by its matches in right
        order; unmatched left rows (left/outer) in place; then, for a
        full outer join, the unmatched right rows in right order.

        ``on`` may also be Column equality conditions
        (``on=F.col("a") == F.col("b")``, several combined with ``&`` or
        passed as a list)."""
        if not isinstance(on, str):
            cand = list(on) if isinstance(on, (list, tuple)) else [on]
            if any(not isinstance(x, str) for x in cand):
                return self._join_on_columns(cand, other, how)
        keys = [on] if isinstance(on, str) else list(on)
        if not keys:
            raise ValueError("join needs at least one key column")
        aliases = {
            "left_outer": "left", "leftouter": "left",
            "right_outer": "right", "rightouter": "right",
            "full_outer": "outer", "fullouter": "outer", "full": "outer",
            "cross": "cross",
            "semi": "left_semi", "leftsemi": "left_semi",
            "anti": "left_anti", "leftanti": "left_anti",
        }
        how = aliases.get(how, how)
        if how == "cross":
            raise ValueError("Use crossJoin() for cross joins")
        if how in ("left_semi", "left_anti"):
            return self._semi_join(other, keys, anti=how == "left_anti")
        overlap_pre = set(self._columns) & set(other._columns) - set(keys)
        if overlap_pre:
            # before the right-join swap: qualification renames columns,
            # and the swap's reordering select must see the final names
            qualified = self._qualify_overlap(other, overlap_pre)
            if qualified is not None:
                left2, right2 = qualified
                return left2.join(right2, on=keys, how=how)
        if how == "right":
            # a left join with the sides swapped, columns reordered back
            # to (left cols, right non-key cols)
            swapped = other.join(self, on=keys, how="left")
            order = list(self._columns) + [c for c in other._columns if c not in keys]
            return swapped.select(*order)
        if how not in ("inner", "left", "outer"):
            raise ValueError(f"Unsupported join type {how!r}")
        for k in keys:
            if k not in self._columns or k not in other._columns:
                raise KeyError(f"Join key {k!r} missing from a side")
        overlap = set(self._columns) & set(other._columns) - set(keys)
        if overlap:
            raise ValueError(
                f"Ambiguous non-key columns on both sides: "
                f"{sorted(overlap)}; rename with withColumnRenamed "
                "first, or alias both frames (df.alias('x'))"
            )

        _guard_collect(self, "join")
        _guard_collect(other, "join")
        left = self.collectColumns()
        right = other.collectColumns()
        n_left = len(left[self._columns[0]]) if self._columns else 0
        n_right = len(right[other._columns[0]]) if other._columns else 0

        # hash the right side on the key tuple (None keys never match)
        table: Dict[Tuple, List[int]] = {}
        rkeys = [right[k] for k in keys]
        for j in range(n_right):
            kt = tuple(col[j] for col in rkeys)
            if any(v is None for v in kt):
                continue
            table.setdefault(kt, []).append(j)

        lkeys = [left[k] for k in keys]
        li: List[Optional[int]] = []
        ri: List[Optional[int]] = []
        matched_right: set = set()
        for i in range(n_left):
            kt = tuple(col[i] for col in lkeys)
            matches = table.get(kt, []) if not any(v is None for v in kt) else []
            if matches:
                for j in matches:
                    li.append(i)
                    ri.append(j)
                    matched_right.add(j)
            elif how in ("left", "outer"):
                li.append(i)
                ri.append(None)
        if how == "outer":
            # right rows nobody matched (null-keyed ones included) append
            # with a null left side, in right-side order
            for j in range(n_right):
                if j not in matched_right:
                    li.append(None)
                    ri.append(j)

        right_cols = [c for c in other._columns if c not in keys]
        out: Dict[str, Any] = {}
        if any(i is None for i in li):
            rkeys_by_col = {k: right[k] for k in keys}
            for c in self._columns:
                col = left[c]
                if c in rkeys_by_col:
                    # key columns surface the right key for right-only
                    # rows (one merged key column, Spark's using-join)
                    out[c] = [rkeys_by_col[c][j] if i is None else col[i] for i, j in zip(li, ri)]
                else:
                    out[c] = [None if i is None else col[i] for i in li]
        else:
            for c in self._columns:
                out[c] = _take(left[c], li)
        if any(j is None for j in ri):
            for c in right_cols:
                col = right[c]
                out[c] = [None if j is None else col[j] for j in ri]
        else:
            for c in right_cols:
                out[c] = _take(right[c], ri)
        return DataFrame.fromColumns(out, numPartitions=max(1, self.numPartitions))

    def cache(self) -> "DataFrame":
        """Run the plan now; a frame over the materialized partitions."""
        return DataFrame(self._execute(), self._columns)

    def createOrReplaceTempView(self, name: str) -> None:
        """Register this frame under ``name`` in the default SQL context
        (``sparkdl_tpu_torch.sql.sql``)."""
        from sparkdl_tpu_torch import sql as _sql

        _sql.registerDataFrameAsTable(self, name)

    def createTempView(self, name: str) -> None:
        """:meth:`createOrReplaceTempView` that refuses to replace a view
        (pyspark); the check and the registration are one step under the
        context's lock."""
        from sparkdl_tpu_torch import sql as _sql

        if not _sql._default._register_if_absent(self, name):
            raise ValueError(f"Temp view {name!r} already exists; use createOrReplaceTempView to overwrite")

    def createGlobalTempView(self, name: str) -> None:
        """Register under the ``global_temp`` database (pyspark
        ``createGlobalTempView``): ``SELECT ... FROM global_temp.<name>``.
        One process is the one global scope."""
        from sparkdl_tpu_torch import sql as _sql

        if not _sql._default._register_if_absent(self, f"global_temp.{name}"):
            raise ValueError(
                f"Global temp view {name!r} already exists; use "
                "createOrReplaceGlobalTempView to overwrite"
            )

    def createOrReplaceGlobalTempView(self, name: str) -> None:
        from sparkdl_tpu_torch import sql as _sql

        _sql.registerDataFrameAsTable(self, f"global_temp.{name}")

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
        self, name: str, fn: Callable[[Partition], Dict[str, list]],
        serial: bool = False,
    ) -> "DataFrame":
        """Partition-wise column producer: ``fn`` sees the whole partition
        column-dict and returns ``{name: values}``, one value per row —
        the batched path every model transformer uses. ``serial``: every
        action over the result runs its partitions one at a time, in index
        order (a ``single_stream`` model, whose collectives pair each batch
        with the other processes' batch of the same place in that order)."""

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

        op._serial = serial
        cols = self._columns + ([name] if name not in self._columns else [])
        return self._with_op(op, cols)

    def _execute(self) -> List[Partition]:
        from sparkdl_tpu_torch.runtime.executor import default_executor

        ops, cols, first = self._ops, self._columns, self._first_index
        return default_executor().map_partitions(
            lambda i, part: _run_plan(ops, cols, part, first + i),
            self._source,
            count_rows=_part_num_rows,
            sequential=_serial_plan(ops, self._source),
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
                    result = _run_plan(self._ops, self._columns, src, self._first_index + i)
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

    # -- statistics ------------------------------------------------------------

    def _co_moments(self, col1: str, col2: str, action: str):
        """One streamed pass over the (col1, col2) pairs: null pairs skip,
        and the sums are shifted by the first pair (corr and cov do not
        move under a shift; the plain sum of squares cancels
        catastrophically on data with a large mean). Returns (n, sx, sy,
        sxx, syy, sxy)."""
        for c in (col1, col2):
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in {action}")
        sx = sy = sxx = syy = sxy = 0.0
        n = 0
        ox = oy = None
        for part in self.iterPartitions():
            a, b = part[col1], part[col2]
            for i in range(_part_num_rows(part)):
                x, y = a[i], b[i]
                if x is None or y is None:
                    continue
                if ox is None:
                    ox, oy = x, y
                dx, dy = x - ox, y - oy
                n += 1
                sx += dx
                sy += dy
                sxx += dx * dx
                syy += dy * dy
                sxy += dx * dy
        return n, sx, sy, sxx, syy, sxy

    def corr(self, col1: str, col2: str) -> Optional[float]:
        """Pearson correlation of two numeric columns (pyspark ``corr``),
        in one streamed pass; null pairs skip; fewer than two pairs or no
        variance gives None."""
        n, sx, sy, sxx, syy, sxy = self._co_moments(col1, col2, "corr")
        if n < 2:
            return None
        vx = sxx - sx * sx / n
        vy = syy - sy * sy / n
        if vx <= 0 or vy <= 0:
            return None
        return (sxy - sx * sy / n) / math.sqrt(vx * vy)

    def cov(self, col1: str, col2: str) -> Optional[float]:
        """Sample covariance of two numeric columns (pyspark ``cov``),
        streamed; null pairs skip; fewer than two pairs gives None."""
        n, sx, sy, _, _, sxy = self._co_moments(col1, col2, "cov")
        if n < 2:
            return None
        return (sxy - sx * sy / n) / (n - 1)

    @property
    def stat(self) -> "DataFrameStatFunctions":
        """pyspark's ``df.stat``: approxQuantile, corr, cov, crosstab,
        freqItems, sampleBy."""
        return DataFrameStatFunctions(self)

    def approxQuantile(self, col, probabilities, relativeError: float = 0.0):
        """Quantiles of numeric columns as data points (pyspark
        ``approxQuantile``), computed exactly whatever ``relativeError``
        asks: the element of rank ``ceil(p * n) - 1`` of the sorted
        non-null values. An all-null column gives []; a list of columns a
        list of results."""
        probs = list(probabilities)
        for p in probs:
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(f"probability {p} outside [0, 1]")
        if float(relativeError) < 0:
            raise ValueError("relativeError must be >= 0")
        cols = [col] if isinstance(col, str) else list(col)
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"No such column {c!r}")
        _guard_collect(self, "approxQuantile")
        merged = self.select(*cols).collectColumns()
        out = []
        for c in cols:
            vals = sorted(v for v in merged[c] if v is not None)
            if not vals:
                out.append([])
                continue
            n = len(vals)
            out.append([float(vals[min(n - 1, max(0, math.ceil(float(p) * n) - 1))]) for p in probs])
        return out[0] if isinstance(col, str) else out

    def crosstab(self, col1: str, col2: str) -> "DataFrame":
        """Pairwise counts (pyspark ``crosstab``): a row per distinct
        ``col1`` value, a count column per distinct ``col2`` value (as
        strings, sorted), the first column named ``<col1>_<col2>``."""
        for c in (col1, col2):
            if c not in self._columns:
                raise KeyError(f"No such column {c!r}")
        _guard_collect(self, "crosstab")
        merged = self.select(col1, col2).collectColumns()
        counts: Dict[Tuple[str, str], int] = {}
        for a, b in zip(merged[col1], merged[col2]):
            k = (str(a), str(b))
            counts[k] = counts.get(k, 0) + 1
        rows = sorted({a for a, _ in counts})
        col_vals = sorted({b for _, b in counts})
        label = f"{col1}_{col2}"
        if label in col_vals:
            # a value named like the label column would replace it
            raise ValueError(
                f"crosstab: a {col2!r} value equals the label column "
                f"name {label!r}; rename a column first"
            )
        out: Dict[str, list] = {label: rows}
        for b in col_vals:
            out[b] = [counts.get((a, b), 0) for a in rows]
        return DataFrame.fromColumns(out, numPartitions=max(1, self.numPartitions))

    def freqItems(self, cols, support: float = 0.01) -> "DataFrame":
        """The values of each column that occur in more than ``support``
        of the rows, as one row of list cells named ``<col>_freqItems``
        (pyspark ``freqItems``, computed exactly). Nulls never count."""
        if not 0.0 < float(support) <= 1.0:
            raise ValueError(f"support must be in (0, 1], got {support}")
        cols = list(cols)
        for c in cols:
            if c not in self._columns:
                raise KeyError(f"No such column {c!r}")
        _guard_collect(self, "freqItems")
        merged = self.select(*cols).collectColumns()
        n = len(merged[cols[0]]) if cols else 0
        out: Dict[str, list] = {}
        for c in cols:
            counts: Dict[Any, int] = {}
            order: List[Any] = []
            for v in merged[c]:
                if v is None:
                    continue
                k = _cell_key(v)
                if k not in counts:
                    order.append((k, v))
                counts[k] = counts.get(k, 0) + 1
            out[f"{c}_freqItems"] = [[v for k, v in order if counts[k] > support * n]]
        return DataFrame.fromColumns(out, numPartitions=1)

    def sampleBy(self, col: str, fractions: Dict[Any, float], seed: Any = None) -> "DataFrame":
        """Stratified sample without replacement (pyspark ``sampleBy``):
        a row stays with its stratum's fraction (an absent stratum keeps
        nothing). Lazy; each partition draws from
        ``SeedSequence([seed, partition index])``."""
        if col not in self._columns:
            raise KeyError(f"No such column {col!r}")
        fr = {}
        for k, f in fractions.items():
            f = float(f)
            if not 0.0 <= f <= 1.0:
                raise ValueError(f"fraction for stratum {k!r} outside [0, 1]: {f}")
            fr[k] = f
        base_seed = (0 if seed is None else int(seed)) & (2 ** 64 - 1)

        def op(part: Partition, index: int) -> Partition:
            n = _part_num_rows(part)
            u = np.random.default_rng(np.random.SeedSequence([base_seed, index])).random(n)
            keys = part[col]
            keep = [i for i in range(n) if fr.get(keys[i], 0.0) > u[i]]
            return {c: _take(part[c], keep) for c in part}

        op._indexed = True
        return self._with_op(op, self._columns)

    def sample(self, *args, **kwargs) -> "DataFrame":
        """Each row kept with probability ``fraction`` (pyspark
        ``sample``), the rows :meth:`randomSplit` puts in its first
        bucket for the seed. Takes ``sample(fraction, seed=0)`` and
        ``sample(withReplacement, fraction[, seed])``; sampling with
        replacement raises."""
        params = list(args)
        with_replacement = kwargs.pop("withReplacement", None)
        if params and isinstance(params[0], bool):
            with_replacement = params.pop(0)
        if with_replacement:
            raise NotImplementedError("sample(withReplacement=True) is not supported")
        fraction = kwargs.pop("fraction", None)
        if fraction is None:
            if not params:
                raise TypeError("sample() missing 'fraction'")
            fraction = params.pop(0)
        if "seed" in kwargs:
            seed = kwargs.pop("seed")
        else:
            seed = params.pop(0) if params else 0
        if params or kwargs:
            raise TypeError(f"sample() got unexpected arguments: {params or kwargs}")
        if isinstance(fraction, bool) or not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"fraction must be in [0, 1]: {fraction!r}")
        fraction = float(fraction)
        kept, _ = self.randomSplit([fraction, 1.0 - fraction], seed=int(seed))
        return kept

    def summary(self, *stats: str) -> "DataFrame":
        """Extended describe (pyspark ``summary``) over the numeric
        columns: count, mean, stddev (ddof 1), min, 25%, 50%, 75%, max by
        default, or the statistics named, any ``N%`` among them
        (``np.percentile``, linear interpolation). Runs the plan once."""
        import numbers

        wanted_stats = list(stats) or ["count", "mean", "stddev", "min", "25%", "50%", "75%", "max"]
        known = {"count", "mean", "stddev", "min", "max"}
        for s in wanted_stats:  # before any execution
            if s not in known and not s.endswith("%"):
                raise ValueError(f"Unknown summary statistic {s!r}")
        merged = self.collectColumns()

        def is_num(v):
            return isinstance(v, numbers.Number) and not isinstance(v, bool)

        num_cols = [
            c
            for c in self._columns
            if (vals := [v for v in merged[c] if v is not None]) and all(is_num(v) for v in vals)
        ]
        out: Dict[str, List[Any]] = {"summary": wanted_stats}
        for c in num_cols:
            vals = np.asarray([v for v in merged[c] if v is not None], dtype=float)
            n = int(vals.size)
            col_out: List[Any] = []
            for s in wanted_stats:
                if s.endswith("%"):
                    col_out.append(float(np.percentile(vals, float(s[:-1]))) if n else None)
                elif s == "count":
                    col_out.append(n)
                elif s == "mean":
                    col_out.append(float(vals.mean()) if n else None)
                elif s == "stddev":
                    col_out.append(float(vals.std(ddof=1)) if n > 1 else None)
                elif s == "min":
                    col_out.append(float(vals.min()) if n else None)
                else:  # max
                    col_out.append(float(vals.max()) if n else None)
            out[c] = col_out
        return DataFrame.fromColumns(out)

    def describe(self, *cols: str) -> "DataFrame":
        """count, mean, stddev (ddof 1), min and max (pyspark
        ``describe``) of every numeric column, numpy scalars included, or
        of the columns named: a named non-numeric column gets count, min
        and max, its mean and stddev null."""
        import numbers

        merged = self.collectColumns()

        def is_num(v):
            return isinstance(v, numbers.Number) and not isinstance(v, bool)

        def all_numeric(c):
            vals = [v for v in merged[c] if v is not None]
            return bool(vals) and all(is_num(v) for v in vals)

        wanted = list(cols) if cols else [c for c in self._columns if all_numeric(c)]
        for c in wanted:
            if c not in self._columns:
                raise KeyError(f"Unknown column {c!r} in describe")
        out: Dict[str, List[Any]] = {"summary": ["count", "mean", "stddev", "min", "max"]}
        for c in wanted:
            vals = merged[c]
            cnt = aggregate_values("count", vals)
            mean = aggregate_values("avg", vals) if all_numeric(c) else None
            std = None
            if mean is not None and cnt > 1:
                std = math.sqrt(sum((v - mean) ** 2 for v in vals if v is not None) / (cnt - 1))
            try:
                lo = aggregate_values("min", vals)
                hi = aggregate_values("max", vals)
            except TypeError:  # cells that do not order
                lo = hi = None
            out[c] = [cnt, mean, std, lo, hi]
        return DataFrame.fromColumns(out)

    # -- partitioning ------------------------------------------------------------

    def repartition(self, numPartitions: int) -> "DataFrame":
        """Collect and split again into ``numPartitions`` balanced
        partitions (there is no shuffle)."""
        return DataFrame.fromColumns(self.collectColumns(), numPartitions)

    def repartitionByRange(self, numPartitions, *cols) -> "DataFrame":
        """Range partitioning (pyspark ``repartitionByRange``): sort by the
        keys (names or ``asc()``/``desc()`` Columns; ascending, nulls
        first by default) and cut the sorted rows into ``numPartitions``
        contiguous ranges. ``repartitionByRange("v")`` keeps the partition
        count. A global sort, on the host like :meth:`orderBy`."""
        if not isinstance(numPartitions, int) or isinstance(numPartitions, bool):
            cols = (numPartitions,) + cols
            numPartitions = self.numPartitions
        if numPartitions < 1:
            raise ValueError("repartitionByRange needs >= 1 partition")
        if not cols:
            raise ValueError("repartitionByRange needs at least one key column")
        return DataFrame.fromColumns(self.orderBy(*cols).collectColumns(), numPartitions)

    def coalesce(self, numPartitions: int) -> "DataFrame":
        """Fewer partitions (pyspark ``coalesce``), never more. Lazy,
        unlike :meth:`repartition`: contiguous source partitions merge
        into one whose pending ops run at its first access."""
        if numPartitions < 1:
            raise ValueError("coalesce needs at least one partition")
        n = self.numPartitions
        if numPartitions >= n:
            return self
        base, extra = divmod(n, numPartitions)
        parts = []
        idx = 0
        for b in range(numPartitions):
            size = base + (1 if b < extra else 0)
            parts.append(_CoalescedPartition(
                self._source[idx: idx + size], self._ops, self._columns, self._first_index + idx))
            idx += size
        return DataFrame(parts, self._columns)

    def sortWithinPartitions(self, *cols, ascending: Any = True) -> "DataFrame":
        """Sort each partition on its own (pyspark
        ``sortWithinPartitions``), lazily, with :meth:`orderBy`'s keys and
        null placement (first ascending, last descending). Keys are names
        or plain ``asc()``/``desc()`` Columns."""
        if not cols:
            raise ValueError("sortWithinPartitions needs a column")
        from sparkdl_tpu_torch.dataframe.column import Column

        asc_in = list(ascending) if isinstance(ascending, (list, tuple)) else [ascending] * len(cols)
        if len(asc_in) != len(cols):
            raise ValueError(f"ascending has {len(asc_in)} entries for {len(cols)} columns")
        keys: List[Tuple[str, bool, int]] = []
        for c, a in zip(cols, asc_in):
            if isinstance(c, Column):
                if c._sort is not None:
                    a = c._sort
                    if c._sort_nulls is not None:
                        from sparkdl_tpu_torch import sql as _sql

                        a = _sql.SortDir(c._sort, c._sort_nulls)
                plain = c._plain_name()
                if plain is None:
                    raise TypeError(
                        "sortWithinPartitions keys must be plain columns; "
                        "compute expressions with withColumn first"
                    )
                c = plain
            if c not in self._columns:
                raise KeyError(f"No such column {c!r}")
            asc_b = bool(a)
            nf = getattr(a, "nulls_first", None)
            if nf is None:
                nf = asc_b
            rank = (0 if nf else 2) if asc_b else (2 if nf else 0)
            keys.append((c, asc_b, rank))

        def op(part: Partition) -> Partition:
            order = list(range(_part_num_rows(part)))
            for name, asc, rank in reversed(keys):  # stable, last key first
                col = part[name]
                order.sort(key=lambda i, c=col, r=rank: (r, 0) if c[i] is None else (1, c[i]), reverse=not asc)
            return {c: _take(part[c], order) for c in part}

        return self._with_op(op, self._columns)

    def melt(
        self,
        ids: Sequence[str],
        values: Optional[Sequence[str]] = None,
        variableColumnName: str = "variable",
        valueColumnName: str = "value",
    ) -> "DataFrame":
        """Unpivot (pyspark ``melt``/``unpivot``): the id columns repeat
        and each value column (every non-id column by default) becomes one
        output row of (variable, value). Lazy, partition by partition."""
        if isinstance(ids, str):
            ids = [ids]
        ids = list(ids)
        for c in ids:
            if c not in self._columns:
                raise KeyError(f"Unknown id column {c!r} in melt")
        if values is None:
            values = [c for c in self._columns if c not in ids]
        else:
            values = [values] if isinstance(values, str) else list(values)
            for c in values:
                if c not in self._columns:
                    raise KeyError(f"Unknown value column {c!r} in melt")
        if not values:
            raise ValueError("melt needs at least one value column")
        out_cols = ids + [variableColumnName, valueColumnName]
        dups = {c for c in out_cols if out_cols.count(c) > 1}
        if dups:
            raise ValueError(
                f"melt output column collision: {sorted(dups)}; pick "
                "different variable/value names"
            )

        def op(part: Partition) -> Partition:
            out: Dict[str, list] = {c: [] for c in out_cols}
            for i in range(_part_num_rows(part)):
                for vcol in values:
                    for idc in ids:
                        out[idc].append(part[idc][i])
                    out[variableColumnName].append(vcol)
                    out[valueColumnName].append(part[vcol][i])
            return out

        return self._with_op(op, out_cols)

    unpivot = melt

    # -- actions and the plan ------------------------------------------------------

    def toLocalIterator(self) -> Iterator[Row]:
        """Rows in frame order, one partition in memory at a time (pyspark
        ``toLocalIterator``)."""
        for part in self.iterPartitions():
            for i in range(_part_num_rows(part)):
                yield Row({c: part[c][i] for c in self._columns})

    def foreachPartition(self, fn: Callable[[Partition], None]) -> None:
        """``fn`` over each partition's result, streamed (pyspark
        ``foreachPartition``)."""
        for part in self.iterPartitions():
            fn(part)

    def foreach(self, fn: Callable[[Row], Any]) -> None:
        """``fn`` over every row for its side effects (pyspark
        ``foreach``), a partition at a time."""

        def per_part(part):
            for i in range(_part_num_rows(part)):
                fn(Row({c: part[c][i] for c in part}))

        self.foreachPartition(per_part)

    def toJSON(self) -> List[str]:
        """One JSON document per row (pyspark ``toJSON``, collected: there
        is no RDD to return); a cell JSON cannot hold is written as its
        ``str``."""
        import json

        return [json.dumps(r.asDict(), default=str) for r in self.collect()]

    def explain(self, extended: Any = None, mode: Optional[str] = None) -> None:
        """Print the pending plan (pyspark ``explain``): the columns, the
        source partition count and each queued partition op."""
        del extended, mode
        lines = [
            f"DataFrame[{', '.join(self._columns)}]",
            f"  partitions: {self.numPartitions}",
            f"  pending ops: {len(self._ops)}",
        ]
        for i, op in enumerate(self._ops):
            lines.append(f"    [{i}] {getattr(op, '__qualname__', repr(op))}")
        print("\n".join(lines))

    def hint(self, name: str, *parameters) -> "DataFrame":
        """Accepted and ignored: there is one join strategy (a hash join
        on the host), so a hint has nothing to steer."""
        return self

    def persist(self, storageLevel: Any = None) -> "DataFrame":
        """:meth:`cache` whatever the level: there is one tier, host
        memory."""
        del storageLevel
        return self.cache()

    def unpersist(self, blocking: bool = False) -> "DataFrame":
        """Returns the frame: materialized partitions are freed with it."""
        del blocking
        return self

    def checkpoint(self, eager: bool = True) -> "DataFrame":
        """Cut the pending plan by materializing now (pyspark
        ``checkpoint``); lazy or eager, the same."""
        del eager
        return self.cache()

    localCheckpoint = checkpoint

    def isLocal(self) -> bool:
        """True: every action runs in this process."""
        return True

    @property
    def isStreaming(self) -> bool:
        """False: there is no streaming engine."""
        return False

    @property
    def sparkSession(self):
        """The process's active session, created on demand (pyspark
        ``df.sparkSession``)."""
        from sparkdl_tpu_torch.session import SparkSession

        return SparkSession.builder.getOrCreate()

    def inputFiles(self) -> List[str]:
        """The files behind a lazy scan's partitions
        (:meth:`scanParquet`, :meth:`fromArrowFiles`); [] for a frame in
        memory."""
        out: List[str] = []
        for p in self._source:
            path = getattr(p, "_path", None)
            if path is not None:
                out.append(str(path))
        return out

    def to(self, schema) -> "DataFrame":
        """Conform to a schema's column list (pyspark ``to``): the
        schema's order, a null column for each name the frame lacks;
        types are accepted and ignored."""
        names = _schema_names(schema)
        df = self
        for c in names:
            if c not in df._columns:
                df = df.withColumn(c, lambda r: None)
        return df.select(*names)

    def withMetadata(self, columnName: str, metadata: dict) -> "DataFrame":
        """Checked and dropped: nothing here reads column metadata."""
        if columnName not in self._columns:
            raise KeyError(f"No such column {columnName!r}")
        if not isinstance(metadata, dict):
            raise TypeError("metadata must be a dict")
        return self

    def sameSemantics(self, other: "DataFrame") -> bool:
        """True for the same frame, or one over the same partition objects
        with the same ops (by identity) and columns. Never a false
        positive; false negatives are allowed, as in pyspark."""
        if self is other:
            return True
        return (
            isinstance(other, DataFrame)
            and len(self._source) == len(other._source)
            and all(a is b for a, b in zip(self._source, other._source))
            and len(self._ops) == len(other._ops)
            and all(a is b for a, b in zip(self._ops, other._ops))
            and self._columns == other._columns
        )

    def semanticHash(self) -> int:
        return hash((tuple(map(id, self._source)), tuple(map(id, self._ops)), tuple(self._columns)))

    # -- line files ------------------------------------------------------------------

    def writeCSV(self, path: str, header: bool = True) -> None:
        """Streamed CSV (one partition in memory); a null is an empty
        field. Scalar columns only: tensor and list cells belong in
        Parquet."""
        import csv

        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            if header:
                w.writerow(self._columns)
            for part in self.iterPartitions():
                for i in range(_part_num_rows(part)):
                    w.writerow(["" if part[c][i] is None else part[c][i] for c in self._columns])

    @staticmethod
    def readCSV(
        path: str, header: bool = True, inferSchema: bool = True, numPartitions: int = 1
    ) -> "DataFrame":
        """A CSV file: an empty field is null; with ``inferSchema`` a cell
        is an int, else a float, else a string, numbers read strictly (no
        ``_``, no surrounding whitespace). Without a header the columns
        are ``_c0``, ``_c1``, ..."""
        import csv

        def conv(s: str):
            if s == "":
                return None
            if not inferSchema:
                return s
            # int() and float() take underscores and whitespace, which
            # would turn an id-like string into a number ('12_34' -> 1234)
            if s != s.strip() or "_" in s:
                return s
            try:
                return int(s)
            except ValueError:
                pass
            try:
                return float(s)
            except ValueError:
                return s

        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]  # blank lines skip
        if not rows:
            return DataFrame([], [])
        if header:
            names, data = list(rows[0]), rows[1:]
            dups = {n for n in names if names.count(n) > 1}
            if dups:
                raise ValueError(
                    f"readCSV: duplicate header column(s) {sorted(dups)}; "
                    "the frame requires unique names"
                )
        else:
            names = [f"_c{i}" for i in range(len(rows[0]))]
            data = rows
        cols = {name: [conv(r[i]) if i < len(r) else None for r in data] for i, name in enumerate(names)}
        return DataFrame.fromColumns(cols, numPartitions=numPartitions)

    def writeJSON(self, path: str) -> None:
        """Streamed JSON lines, one object per row: a null is JSON null,
        list, dict and numpy cells are written natively."""
        import json

        with open(path, "w") as f:
            for part in self.iterPartitions():
                for i in range(_part_num_rows(part)):
                    f.write(json.dumps({c: _json_cell(part[c][i]) for c in self._columns}))
                    f.write("\n")

    @staticmethod
    def readJSON(path: str, numPartitions: int = 1) -> "DataFrame":
        """JSON lines: the columns are the union of the keys, in the order
        first seen; a missing key is null."""
        import json

        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        if not records:
            return DataFrame([], [])
        names: List[str] = []
        for r in records:
            for k in r:
                if k not in names:
                    names.append(k)
        return DataFrame.fromColumns({c: [r.get(c) for r in records] for c in names}, numPartitions=numPartitions)

    @property
    def write(self):
        """pyspark's writer: ``df.write.mode(...).parquet/csv/json/text``."""
        from sparkdl_tpu_torch.session import DataFrameWriter

        return DataFrameWriter(self)

    def toPandas(self):
        """The whole frame as a pandas DataFrame, with the dtypes the JAX
        package's ``toArrow().to_pandas()`` gives (:func:`_pandas_series`);
        the port builds it without pyarrow."""
        import pandas as pd

        cols = self.collectColumns()
        return pd.DataFrame({c: _pandas_series(cols[c], pd) for c in self._columns})

    def mapInPandas(self, func, schema) -> "DataFrame":
        """A per-partition pandas transform (pyspark ``mapInPandas``):
        ``func`` receives an iterator of pandas DataFrames (one per
        partition here) and yields DataFrames; the row count may change.
        ``schema`` declares the output columns: a list, or a DDL string
        whose types are accepted and ignored. Lazy and partition-local."""
        out_cols = _schema_names(schema)

        def op(part: Partition) -> Partition:
            import pandas as pd

            pdf = pd.DataFrame({c: list(part[c]) for c in part})
            frames = list(func(iter([pdf])))
            for f in frames:
                if not isinstance(f, pd.DataFrame):
                    raise TypeError(
                        "mapInPandas function must yield pandas DataFrames, "
                        f"got {type(f).__name__}"
                    )
                # each yielded frame is checked: concat's column union would
                # fill a frame that lacks a declared column with NaN whenever
                # a sibling frame has it
                missing = [c for c in out_cols if c not in f.columns]
                if missing:
                    raise ValueError(
                        f"mapInPandas output is missing declared columns {missing}; "
                        f"got {list(f.columns)}"
                    )
            if not frames:
                return {c: [] for c in out_cols}
            out = pd.concat(frames, ignore_index=True)
            return {c: _pandas_cells(out[c]) for c in out_cols}

        return self._with_op(op, list(out_cols))

    def __repr__(self) -> str:
        return (
            f"DataFrame(columns={self._columns}, "
            f"partitions={len(self._source)}, pending_ops={len(self._ops)})"
        )


class _NAFunctions:
    """pyspark's ``DataFrameNaFunctions``, the ``df.na`` accessor."""

    def __init__(self, df: DataFrame):
        self._df = df

    def drop(
        self, how: str = "any", thresh: Optional[int] = None, subset: Optional[Sequence[str]] = None
    ) -> DataFrame:
        return self._df.dropna(how=how, thresh=thresh, subset=subset)

    def fill(self, value, subset: Optional[Sequence[str]] = None) -> DataFrame:
        return self._df.fillna(value, subset=subset)

    def replace(self, to_replace, value=None, subset=None) -> DataFrame:
        return self._df.replace(to_replace, value, subset)


class DataFrameStatFunctions:
    """pyspark's ``df.stat``, over the frame's own statistics methods."""

    def __init__(self, df: DataFrame):
        self._df = df

    def approxQuantile(self, col, probabilities, relativeError=0.0):
        return self._df.approxQuantile(col, probabilities, relativeError)

    def corr(self, col1: str, col2: str, method: str = "pearson"):
        if method != "pearson":
            raise ValueError(f"Only pearson correlation is supported (pyspark likewise), got {method!r}")
        return self._df.corr(col1, col2)

    def cov(self, col1: str, col2: str):
        return self._df.cov(col1, col2)

    def crosstab(self, col1: str, col2: str) -> DataFrame:
        return self._df.crosstab(col1, col2)

    def freqItems(self, cols, support: float = 0.01) -> DataFrame:
        return self._df.freqItems(cols, support)

    def sampleBy(self, col, fractions, seed=None) -> DataFrame:
        return self._df.sampleBy(col, fractions, seed)


# -- the aggregate engine ----------------------------------------------------




# aliases normalize before dispatch: Spark's _samp spellings ARE the
# defaults, and approx_count_distinct runs exact here (rsd accepted and
# ignored — the host-scale engine has no need for HyperLogLog)
_AGG_ALIASES = {
    "stddev_samp": "stddev",
    "var_samp": "variance",
    "approx_count_distinct": "count_distinct",
    "every": "bool_and",
    "any_value": "first",
}


def _agg_spec_key(fn: str, params) -> str:
    """Encode call-level parameters into the spec's fn string
    ('percentile:[0.5]') — the (fn, col) spec tuple is the only channel
    the streaming engine sees. Paired with :func:`_agg_params`; both
    the SQL planner and GroupedData._agg_columns encode through here."""
    if params is None:
        return fn
    import json

    return fn + ":" + json.dumps(params)


def _agg_base_fn(fn: str) -> str:
    """The base name of a (possibly parameterized) spec key — CHEAP,
    for the per-row update path (no JSON decode)."""
    return fn.split(":", 1)[0] if ":" in fn else fn


def _agg_params(fn: str):
    """Decode a spec key into (base_fn, params); only the finalization
    path needs the decoded parameters."""
    if ":" in fn:
        import json

        base, blob = fn.split(":", 1)
        return base, json.loads(blob)
    return fn, None


def _agg_init(fn: str):
    fn = _agg_base_fn(fn)
    fn = _AGG_ALIASES.get(fn, fn)
    if fn in ("stddev_pop", "var_pop"):
        return (0, 0.0, 0.0)  # Welford, population finalization
    if fn in ("skewness", "kurtosis"):
        return (0, 0.0, 0.0, 0.0, 0.0)  # (n, mean, M2, M3, M4)
    if fn == "sum_distinct":
        return set()
    if fn in ("percentile", "percentile_approx"):
        return []  # exact: holds the group's values, like median
    if fn in ("corr", "covar_pop", "covar_samp"):
        # online co-moments over packed [x, y] cells:
        # (n, mean_x, mean_y, C_xy, M2_x, M2_y)
        return (0, 0.0, 0.0, 0.0, 0.0, 0.0)
    if fn in ("bool_and", "bool_or"):
        return None  # null when no non-null inputs (Spark)
    if fn == "mode":
        return {}  # value -> [count, first_seen_index, value]
    if fn == "count":
        return 0
    if fn == "count_distinct":
        return set()  # cell keys seen; memory O(distinct values)
    if fn == "avg":
        return (None, 0)  # (running sum, non-null count)
    if fn in ("stddev", "variance"):
        return (0, 0.0, 0.0)  # Welford: (n, mean, M2)
    if fn in ("sum", "min", "max"):
        return None
    if fn == "collect_list":
        return []  # memory O(values) per group, documented
    if fn == "median":
        return []  # exact median: holds the group's values
    if fn == "collect_set":
        return ([], set())  # (first-occurrence order, seen cell keys)
    if fn in ("first", "last"):
        return (False, None)  # (seen a non-null, value)
    raise ValueError(
        f"Unknown aggregate {fn!r}; see sql._AGGREGATES for the "
        "supported set"
    )


def _agg_update(fn: str, acc, v, star: bool):
    fn = _agg_base_fn(fn)  # no JSON decode on the per-row hot path
    fn = _AGG_ALIASES.get(fn, fn)
    if fn == "count":
        return acc + (1 if star or v is not None else 0)
    if v is None:  # SUM/AVG/MIN/MAX/COUNT(DISTINCT) skip nulls
        return acc
    if fn in ("stddev_pop", "var_pop"):
        n, mean, m2 = acc
        n += 1
        d = v - mean
        mean += d / n
        m2 += d * (v - mean)
        return (n, mean, m2)
    if fn in ("skewness", "kurtosis"):
        # one-pass central moments (Pebay's update), numerically stable
        n1, mean, m2, m3, m4 = acc
        n = n1 + 1
        d = v - mean
        dn = d / n
        dn2 = dn * dn
        t1 = d * dn * n1
        mean += dn
        m4 += t1 * dn2 * (n * n - 3 * n + 3) + 6 * dn2 * m2 - 4 * dn * m3
        m3 += t1 * dn * (n - 2) - 3 * dn * m2
        m2 += t1
        return (n, mean, m2, m3, m4)
    if fn == "sum_distinct":
        acc.add(v)
        return acc
    if fn in ("percentile", "percentile_approx"):
        acc.append(v)
        return acc
    if fn in ("corr", "covar_pop", "covar_samp"):
        # v is a packed [x, y] cell; a null in EITHER slot skips the
        # pair (Spark drops incomplete observations)
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            return acc
        x, y = v
        if x is None or y is None:
            return acc
        n, mx, my, cxy, m2x, m2y = acc
        n += 1
        dx = x - mx
        mx += dx / n
        # UPDATED mean_x against the PREVIOUS mean_y — the standard
        # online co-moment update; using the stale dx here inflates C
        cxy += (x - mx) * (y - my)
        dy = y - my
        my += dy / n
        m2x += dx * (x - mx)
        m2y += dy * (y - my)
        return (n, mx, my, cxy, m2x, m2y)
    if fn in ("bool_and", "bool_or"):
        b = bool(v)
        if acc is None:
            return b
        return (acc and b) if fn == "bool_and" else (acc or b)
    if fn == "mode":
        key = _cell_key(v)
        ent = acc.get(key)
        if ent is None:
            acc[key] = [1, len(acc), v]
        else:
            ent[0] += 1
        return acc
    if fn == "count_distinct":
        acc.add(_cell_key(v))
        return acc
    if fn == "sum":
        return v if acc is None else acc + v
    if fn == "avg":
        s, c = acc
        return (v if s is None else s + v, c + 1)
    if fn in ("stddev", "variance"):
        n, mean, m2 = acc
        n += 1
        d = v - mean
        mean += d / n
        m2 += d * (v - mean)
        return (n, mean, m2)  # Welford: numerically stable streaming
    if fn == "min":
        return v if acc is None or v < acc else acc
    if fn == "max":
        return v if acc is None or v > acc else acc
    if fn in ("collect_list", "median"):
        acc.append(v)
        return acc
    if fn == "collect_set":
        order, seen = acc
        key = _cell_key(v)
        if key not in seen:
            seen.add(key)
            order.append(v)
        return acc
    if fn == "first":
        return acc if acc[0] else (True, v)
    if fn == "last":
        return (True, v)
    raise ValueError(
        f"Unknown aggregate {fn!r}; see sql._AGGREGATES for the "
        "supported set"
    )


def _percentile_of(s, p: float, discrete: bool):
    """p in [0, 1] over SORTED s: continuous linear interpolation
    (Spark percentile) or the actual element at ceil(p*n)-1 (Spark
    percentile_approx with exact accuracy)."""
    n = len(s)
    if discrete:
        idx = max(0, min(n - 1, math.ceil(p * n) - 1))
        return s[idx]
    pos = p * (n - 1)
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    if lo == hi:
        return s[lo]
    frac = pos - lo
    return s[lo] * (1 - frac) + s[hi] * frac


def _agg_final(fn: str, acc):
    fn, params = _agg_params(fn)
    fn = _AGG_ALIASES.get(fn, fn)
    if fn in ("stddev_pop", "var_pop"):
        n, _, m2 = acc
        if n < 1:
            return None
        var = m2 / n
        return math.sqrt(var) if fn == "stddev_pop" else var
    if fn in ("skewness", "kurtosis"):
        n, _, m2, m3, m4 = acc
        if n < 1:
            return None
        if m2 == 0:
            return float("nan")  # zero variance (Spark divides by it)
        if fn == "skewness":
            return math.sqrt(n) * m3 / m2 ** 1.5
        return n * m4 / (m2 * m2) - 3.0  # excess kurtosis (Spark)
    if fn == "sum_distinct":
        return sum(acc) if acc else None
    if fn in ("percentile", "percentile_approx"):
        if not acc:
            return None
        s = sorted(acc)
        discrete = fn == "percentile_approx"
        pcts = params[0] if params else 0.5
        if isinstance(pcts, list):
            return [_percentile_of(s, float(p), discrete) for p in pcts]
        return _percentile_of(s, float(pcts), discrete)
    if fn in ("corr", "covar_pop", "covar_samp"):
        n, _, _, cxy, m2x, m2y = acc
        if fn == "covar_pop":
            return None if n < 1 else cxy / n
        if fn == "covar_samp":
            return None if n < 2 else cxy / (n - 1)
        if n < 1:
            return None
        den = math.sqrt(m2x * m2y)
        return float("nan") if den == 0 else cxy / den
    if fn in ("bool_and", "bool_or"):
        return acc
    if fn == "mode":
        if not acc:
            return None
        # highest count wins; ties break on first occurrence (Spark
        # leaves tie order undefined)
        return min(acc.values(), key=lambda e: (-e[0], e[1]))[2]
    if fn == "avg":
        s, c = acc
        return None if c == 0 else s / c
    if fn in ("stddev", "variance"):
        # sample statistics (Spark's stddev = stddev_samp); fewer than
        # two non-null values -> null
        n, _, m2 = acc
        if n < 2:
            return None
        var = m2 / (n - 1)
        return math.sqrt(var) if fn == "stddev" else var
    if fn == "count_distinct":
        return len(acc)
    if fn == "collect_list":
        # COPY: running-frame windows snapshot per row while the same
        # accumulator keeps growing — the live list must not leak out
        return list(acc)
    if fn == "median":
        if not acc:
            return None
        if any(
            isinstance(x, bool) or not isinstance(x, (int, float))
            for x in acc
        ):
            # a clear error on ANY group shape — not a data-dependent
            # crash only when a group happens to have an even count
            raise ValueError(
                "median requires numeric values (Spark rejects "
                "non-numeric median at analysis time)"
            )
        s = sorted(acc)
        n = len(s)
        mid = n // 2
        # Spark median = percentile(0.5): midpoint interpolation
        return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2
    if fn == "collect_set":
        return list(acc[0])  # first-occurrence order (Spark: undefined)
    if fn in ("first", "last"):
        return acc[1]
    return acc


def streaming_group_agg(
    df: "DataFrame",
    keys: Sequence[str],
    specs: Sequence[Tuple[str, Optional[str]]],
):
    """Grouped aggregation streamed partition-at-a-time: memory is
    O(groups), never O(rows) — the scale path for GROUP BY over
    ImageNet-sized frames (shared by ``GroupedData.agg`` and the SQL
    layer). ``specs`` is ``[(fn, col)]`` with ``col=None`` for COUNT(*).
    Exception: ``count_distinct`` holds a per-group set of distinct
    cell keys — memory O(distinct values), worst case O(rows) on a
    mostly-unique column.

    Returns ``(key_rows, agg_columns)``: the original key-value tuples in
    first-appearance order, and one value list per spec. Null semantics
    match :func:`aggregate_values` exactly; group identity uses
    :func:`_cell_key`, so tensor/struct keys group by content."""
    keys = list(keys)
    needed = sorted(set(keys) | {c for _, c in specs if c is not None})
    if not needed and not df._ops:
        # pure COUNT(*) on an op-free frame: a row count needs no column
        # data at all — answer from metadata (parquet footers / column
        # lengths), zero decode
        total = sum(df.partitionRowCounts())
        return [()], [[total] for _ in specs]
    proj = df.select(*needed) if needed else df
    groups: Dict[Tuple, list] = {}  # cell-key tuple -> [orig_keys, accs]
    order: List[Tuple] = []
    for part in proj.iterPartitions():
        m = _part_num_rows(part)
        keycols = [part[k] for k in keys]
        speccols = [
            part[c] if c is not None else None for _, c in specs
        ]
        for i in range(m):
            kt_orig = tuple(col[i] for col in keycols)
            kt = tuple(_cell_key(v) for v in kt_orig)
            g = groups.get(kt)
            if g is None:
                g = groups[kt] = [
                    kt_orig, [_agg_init(fn) for fn, _ in specs]
                ]
                order.append(kt)
            accs = g[1]
            for j, (fn, c) in enumerate(specs):
                v = None if speccols[j] is None else speccols[j][i]
                accs[j] = _agg_update(fn, accs[j], v, star=c is None)
    if not keys and not groups:
        # global aggregate over zero rows still yields ONE row (Spark's
        # one-row global-aggregate semantics)
        groups[()] = [(), [_agg_init(fn) for fn, _ in specs]]
        order.append(())
    key_rows = [groups[kt][0] for kt in order]
    agg_columns = [
        [_agg_final(fn, groups[kt][1][j]) for kt in order]
        for j, (fn, _) in enumerate(specs)
    ]
    return key_rows, agg_columns


def aggregate_values(fn: str, values) -> Any:
    """One SQL-style aggregate over raw values: COUNT counts non-nulls;
    SUM/AVG/MIN/MAX skip nulls and return null for empty/all-null input.
    Thin wrapper over the streaming accumulators, so the one-shot and
    streamed paths cannot drift."""
    acc = _agg_init(fn)
    for v in values:
        acc = _agg_update(fn, acc, v, star=False)
    return _agg_final(fn, acc)



class GroupedData:
    """Result of :meth:`DataFrame.groupBy` — pyspark's dict-form ``agg``.

    ``agg({"score": "avg", "*": "count"})`` yields one row per group
    with columns named ``avg(score)`` / ``count(*)`` after the group
    keys. Null is a valid group key; aggregate null semantics follow
    :func:`aggregate_values`. Unlike orderBy/join, aggregation STREAMS
    partition-at-a-time over only the referenced columns — memory is
    O(groups), so it works at any row count.
    """

    def __init__(
        self, df: DataFrame, keys: List[str], mode: str = "groupby",
        explicit_sets: Optional[List[Tuple[str, ...]]] = None,
    ):
        self._df = df
        self._keys = keys
        self._mode = mode  # 'groupby' | 'rollup' | 'cube' | 'sets'
        self._explicit_sets = explicit_sets

    def _grouping_sets(self) -> List[Tuple[str, ...]]:
        """The key subsets this grouping mode aggregates over, FULL set
        first (it defines the output schema for the union)."""
        keys = tuple(self._keys)
        if self._mode == "rollup":
            return [keys[:i] for i in range(len(keys), -1, -1)]
        if self._mode == "cube":
            import itertools as _it

            sets: List[Tuple[str, ...]] = []
            for r in range(len(keys), -1, -1):
                sets.extend(_it.combinations(keys, r))
            return sets
        if self._mode == "sets":
            return list(self._explicit_sets or [])
        return [keys]

    def agg(self, *exprs) -> DataFrame:
        """Two pyspark forms: the dict form
        (``agg({"score": "avg", "*": "count"})``) and the Column form
        (``agg(F.sum("v").alias("s"), F.countDistinct("k"))``, aggregate
        args may be expressions — ``F.sum(F.col("p") * F.col("q"))``).

        Under rollup/cube, the aggregation runs once per grouping set
        (each a streamed groupBy) and unions the results with
        null-filled key columns on subtotal rows, like SQL GROUP BY
        ROLLUP/CUBE."""
        if self._mode != "groupby":
            frames: List[DataFrame] = []
            out_cols: Optional[List[str]] = None
            for s in self._grouping_sets():
                part = GroupedData(self._df, list(s)).agg(*exprs)
                if out_cols is None:  # full-key frame defines the schema
                    out_cols = list(self._keys) + [
                        c for c in part.columns if c not in self._keys
                    ]
                for k in self._keys:
                    if k not in part.columns:
                        part = part.withColumn(k, lambda r: None)
                frames.append(part.select(*out_cols))
            df = frames[0]
            for f in frames[1:]:
                df = df.unionAll(f)
            return df
        if len(exprs) == 1 and isinstance(exprs[0], dict):
            return self._agg_dict(exprs[0])
        if not exprs:
            raise ValueError("agg needs at least one aggregate")
        return self._agg_columns(list(exprs))

    def _agg_columns(self, exprs: list) -> DataFrame:
        from sparkdl_tpu_torch import sql as _sql
        from sparkdl_tpu_torch.dataframe.column import Column

        df = self._df
        specs: List[Tuple[str, Optional[str]]] = []
        names: List[str] = []
        for c in exprs:
            if not isinstance(c, Column):
                raise TypeError(
                    "agg() takes aggregate Columns (F.sum, F.count, ...)"
                    f" or one dict, got {type(c).__name__}"
                )
            e = c._expr
            if not (
                isinstance(e, _sql.Call)
                and e.fn.lower() in _sql._AGGREGATES
            ):
                raise ValueError(
                    f"agg() Columns must be single aggregate calls; got "
                    f"{c._output_name()!r}"
                )
            fn = e.fn.lower()
            if e.distinct:
                fn = "sum_distinct" if fn == "sum" else "count_distinct"
            fn = _agg_spec_key(fn, getattr(e, "_params", None))
            if e.arg == "*":
                if fn != "count":
                    raise ValueError(f"{fn}(*) is not valid; only count(*)")
                col = None
            elif isinstance(e.arg, _sql.Col):
                col = e.arg.name
                if col not in df.columns:
                    raise KeyError(f"Unknown column {col!r} in agg")
            else:
                # aggregate over an expression: validate column refs
                # eagerly (a typo must fail at plan time, not as a
                # retried partition task) and materialize the arg under
                # the SQL planner's collision-proof helper name
                _sql._check_expr_columns(e.arg, df.columns)
                col = f"__sql_aggarg_{_sql._expr_name(e.arg)}"
                if col not in df.columns:
                    df = _sql._apply_expr(df, e.arg, col)
            specs.append((fn, col))
            names.append(c._alias or _sql._expr_name(e))
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            raise ValueError(
                f"Duplicate aggregate output name(s) {sorted(dups)}; "
                "disambiguate with .alias()"
            )
        key_rows, agg_cols = streaming_group_agg(df, self._keys, specs)
        out: Dict[str, List[Any]] = {
            k: [kr[j] for kr in key_rows]
            for j, k in enumerate(self._keys)
        }
        for name, vals in zip(names, agg_cols):
            if name in out:
                raise ValueError(f"Duplicate aggregate column {name!r}")
            out[name] = vals
        return DataFrame.fromColumns(out)

    def _agg_dict(self, exprs: Dict[str, str]) -> DataFrame:
        if not exprs:
            raise ValueError("agg needs at least one column: fn entry")
        from sparkdl_tpu_torch import sql as _sql

        for col, fn in exprs.items():
            if (
                fn.lower() not in _sql._AGGREGATES
                and fn.lower() != "count_distinct"
            ) or fn.lower() in (
                # parameterized/two-column forms need the Column API
                "percentile", "percentile_approx", "corr", "covar_pop",
                "covar_samp",
            ):
                raise ValueError(f"Unknown aggregate {fn!r} for {col!r}")
            if col != "*" and col not in self._df.columns:
                raise KeyError(f"Unknown column {col!r} in agg")
            if col == "*" and fn.lower() != "count":
                raise ValueError(f"{fn}(*) is not valid; only count(*)")

        specs = [
            (fn.lower(), None if col == "*" else col)
            for col, fn in exprs.items()
        ]
        key_rows, agg_cols = streaming_group_agg(
            self._df, self._keys, specs
        )
        out: Dict[str, List[Any]] = {
            k: [kr[j] for kr in key_rows]
            for j, k in enumerate(self._keys)
        }
        for (fn, col), vals in zip(specs, agg_cols):
            name = f"{fn}(*)" if col is None else f"{fn}({col})"
            if name in out:
                raise ValueError(f"Duplicate aggregate column {name!r}")
            out[name] = vals
        return DataFrame.fromColumns(out)

    def pivot(
        self, pivot_col: str, values: Optional[List[Any]] = None
    ) -> "PivotedGroupedData":
        """Pivot a column's values into output columns (pyspark
        ``groupBy(...).pivot(col[, values]).agg(...)``). ``values``
        fixes the output columns; omitted, distinct observed values are
        discovered (and sorted) from the data like pyspark does."""
        if pivot_col not in self._df.columns:
            raise KeyError(f"Unknown column {pivot_col!r} in pivot")
        if pivot_col in self._keys:
            raise ValueError(
                f"pivot column {pivot_col!r} is already a group key"
            )
        return PivotedGroupedData(
            self._df, self._keys, pivot_col,
            list(values) if values is not None else None,
        )

    def applyInPandas(self, func, schema) -> DataFrame:
        """A grouped-map pandas transform (pyspark ``applyInPandas``):
        ``func`` receives each group as one pandas DataFrame (keys
        included), or ``(key, pdf)`` when it takes two positional
        parameters, and returns a DataFrame; the outputs concatenate in
        first-occurrence group order. ``schema`` declares the output
        columns (a list or a DDL string, types ignored). The whole frame is
        collected to the host (collect-guarded), like a join."""
        if self._mode != "groupby":
            raise ValueError("applyInPandas works on groupBy(), not rollup/cube")
        if not self._keys:
            raise ValueError("applyInPandas needs grouping keys")
        import pandas as pd

        out_cols = _schema_names(schema)
        wants_key = _sniff_pos_arity(func, default=1) >= 2
        df = self._df
        merged, groups, order, raw_keys = _collect_groups(df, self._keys, "applyInPandas")
        frames = []
        for kt in order:
            idxs = groups[kt]
            pdf = pd.DataFrame({c: [merged[c][i] for i in idxs] for c in df.columns})
            out = func(raw_keys[kt], pdf) if wants_key else func(pdf)
            frames.append(_validated_pandas_frame(out, out_cols, "applyInPandas"))
        return _assemble_pandas_output(frames, out_cols, df.numPartitions)

    def cogroup(self, other: "GroupedData") -> "CoGroupedData":
        """Pair two grouped frames by key for a joint pandas transform
        (pyspark ``groupBy(...).cogroup(other.groupBy(...))``); the two key
        lists must be of one length (the names may differ: keys pair by
        position, as in pyspark)."""
        if not isinstance(other, GroupedData):
            raise TypeError(f"cogroup takes a GroupedData, got {type(other).__name__}")
        if self._mode != "groupby" or other._mode != "groupby":
            raise ValueError("cogroup works on groupBy(), not rollup/cube")
        if len(self._keys) != len(other._keys) or not self._keys:
            raise ValueError(
                "cogroup needs the same number of (non-zero) grouping keys on "
                f"both sides; got {self._keys} vs {other._keys}"
            )
        return CoGroupedData(self, other)

    def count(self) -> DataFrame:
        """Group sizes as a ``count`` column (pyspark ``groupBy().count()``)."""
        return self.agg({"*": "count"}).withColumnRenamed("count(*)", "count")

    def avg(self, *cols: str) -> DataFrame:
        return self.agg({c: "avg" for c in cols})

    mean = avg  # pyspark alias

    def sum(self, *cols: str) -> DataFrame:
        return self.agg({c: "sum" for c in cols})

    def min(self, *cols: str) -> DataFrame:
        return self.agg({c: "min" for c in cols})

    def max(self, *cols: str) -> DataFrame:
        return self.agg({c: "max" for c in cols})



def _sniff_pos_arity(func, default: int) -> int:
    """The positional-parameter count of a pandas transform: pyspark
    dispatches ``func(pdf)`` against ``func(key, pdf)`` (and the cogroup
    pair forms) on it; a callable whose signature cannot be read gets
    ``default``."""
    import inspect

    try:
        return len([
            p
            for p in inspect.signature(func).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ])
    except (TypeError, ValueError):
        return default


def _collect_groups(df: "DataFrame", keys, what: str):
    """Host-side grouping shared by applyInPandas and cogroup: collect
    (guarded), bucket row indexes by ``_cell_key`` tuples, and keep the
    first-occurrence order and the raw key values."""
    _guard_collect(df, what)
    merged = df.collectColumns()
    n = len(merged[df.columns[0]]) if df.columns else 0
    groups: Dict[Tuple, List[int]] = {}
    order: List[Tuple] = []
    raw: Dict[Tuple, Tuple] = {}
    key_cols = [merged[k] for k in keys]
    for i in range(n):
        kt = tuple(_cell_key(col[i]) for col in key_cols)
        if kt not in groups:
            groups[kt] = []
            order.append(kt)
            raw[kt] = tuple(col[i] for col in key_cols)
        groups[kt].append(i)
    return merged, groups, order, raw


def _validated_pandas_frame(out, out_cols, what: str):
    import pandas as pd

    if not isinstance(out, pd.DataFrame):
        raise TypeError(f"{what} function must return a pandas DataFrame, got {type(out).__name__}")
    missing = [c for c in out_cols if c not in out.columns]
    if missing:
        raise ValueError(f"{what} output is missing declared columns {missing}; got {list(out.columns)}")
    return out[out_cols]


def _assemble_pandas_output(frames, out_cols, numPartitions: int) -> DataFrame:
    import pandas as pd

    if not frames:
        return DataFrame.fromColumns({c: [] for c in out_cols})
    cat = pd.concat(frames, ignore_index=True)
    return DataFrame.fromColumns(
        {c: _pandas_cells(cat[c]) for c in out_cols}, numPartitions=max(1, numPartitions)
    )


class CoGroupedData:
    """``a.groupBy(k).cogroup(b.groupBy(k))`` (pyspark
    ``PandasCogroupedOps``): each key present on either side makes one
    ``func(left_pdf, right_pdf)`` call, or ``func(key, left_pdf,
    right_pdf)``; the absent side arrives as an empty pandas DataFrame with
    that side's columns. Host-side like applyInPandas (collect-guarded)."""

    def __init__(self, left: GroupedData, right: GroupedData):
        self._left = left
        self._right = right

    def applyInPandas(self, func, schema) -> DataFrame:
        import pandas as pd

        out_cols = _schema_names(schema)
        wants_key = _sniff_pos_arity(func, default=2) >= 3
        lm, lg, lo, lraw = _collect_groups(self._left._df, self._left._keys, "cogroup.applyInPandas")
        rm, rg, ro, rraw = _collect_groups(self._right._df, self._right._keys, "cogroup.applyInPandas")
        lcols = list(self._left._df.columns)
        rcols = list(self._right._df.columns)
        keys = list(lo) + [k for k in ro if k not in lg]

        def pdf_of(merged, groups, cols, kt):
            idxs = groups.get(kt, [])
            return pd.DataFrame({c: [merged[c][i] for i in idxs] for c in cols})

        frames = []
        for kt in keys:
            left_pdf = pdf_of(lm, lg, lcols, kt)
            right_pdf = pdf_of(rm, rg, rcols, kt)
            if wants_key:
                out = func(lraw.get(kt, rraw.get(kt)), left_pdf, right_pdf)
            else:
                out = func(left_pdf, right_pdf)
            frames.append(_validated_pandas_frame(out, out_cols, "cogroup.applyInPandas"))
        return _assemble_pandas_output(frames, out_cols, self._left._df.numPartitions)


_NO_VALUE = object()  # pivot sentinel: row's value not in configured set


class PivotedGroupedData:
    """``groupBy(keys).pivot(col)`` intermediate: aggregation runs the
    same streamed engine with the pivot column as an extra group key,
    then reshapes on the host (memory O(groups x values)). Column naming
    follows pyspark: just the pivot value for a single aggregate,
    ``<value>_<agg(col)>`` for several; combinations absent from the
    data come back null."""

    def __init__(
        self,
        df: DataFrame,
        keys: List[str],
        pivot_col: str,
        values: Optional[List[Any]],
    ):
        self._df = df
        self._keys = keys
        self._pivot = pivot_col
        self._values = values

    def agg(self, *exprs) -> DataFrame:
        """Both GroupedData.agg forms work here: the dict form and
        aggregate Columns (pivot("k").agg(F.sum("v").alias("s")))."""
        inner = GroupedData(
            self._df, self._keys + [self._pivot]
        ).agg(*exprs)
        # aggregate output names come FROM the inner frame (everything
        # after the group keys + pivot column), so pivot can never drift
        # from GroupedData.agg's naming scheme
        agg_names = [
            c
            for c in inner.columns
            if c not in self._keys and c != self._pivot
        ]
        rows = inner.collect()
        if self._values is not None:
            values = self._values
        else:
            seen = {r[self._pivot] for r in rows}
            # discovered values sort like pyspark; None (a valid group
            # key) orders last
            values = sorted(
                (v for v in seen if v is not None),
                key=lambda v: (str(type(v)), v),
            ) + ([None] if None in seen else [])
        single = len(agg_names) == 1

        def canonical(v):
            """The configured value this row's pivot cell matches, by
            VALUE equality (1 matches 1.0) but never across bool/int
            (True must not match 1) — row matching and column naming
            must use the same representative or cells silently drop."""
            for cv in values:
                if v is None or cv is None:
                    if v is None and cv is None:
                        return cv
                    continue
                if isinstance(cv, bool) != isinstance(v, bool):
                    continue
                if cv == v:
                    return cv
            return _NO_VALUE

        def out_name(v, agg_name):
            base = "null" if v is None else str(v)
            return base if single else f"{base}_{agg_name}"

        cells: Dict[tuple, Dict[str, Any]] = {}
        key_order: List[tuple] = []
        for r in rows:
            k = tuple(_cell_key(r[key]) for key in self._keys)
            if k not in cells:
                cells[k] = {key: r[key] for key in self._keys}
                key_order.append(k)
            cv = canonical(r[self._pivot])
            if cv is _NO_VALUE:
                continue  # excluded pivot value
            for agg_name in agg_names:
                cells[k][out_name(cv, agg_name)] = r[agg_name]
        out: Dict[str, List[Any]] = {
            key: [cells[k][key] for k in key_order] for key in self._keys
        }
        for v in values:
            for agg_name in agg_names:
                name = out_name(v, agg_name)
                if name in out:
                    raise ValueError(
                        f"Duplicate pivot output column {name!r}"
                    )
                out[name] = [
                    cells[k].get(name) for k in key_order
                ]
        return DataFrame.fromColumns(out)

    def count(self) -> DataFrame:
        return self.agg({"*": "count"})

    def avg(self, *cols: str) -> DataFrame:
        return self.agg({c: "avg" for c in cols})

    mean = avg  # pyspark alias

    def sum(self, *cols: str) -> DataFrame:
        return self.agg({c: "sum" for c in cols})

    def min(self, *cols: str) -> DataFrame:
        return self.agg({c: "min" for c in cols})

    def max(self, *cols: str) -> DataFrame:
        return self.agg({c: "max" for c in cols})
