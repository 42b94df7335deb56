"""``SparkSession``: the entry point that scoring scripts start from.

Port of the JAX package's ``session.py``: ``SparkSession.builder...
getOrCreate()`` (one process-wide session; builder options are recorded
and have no engine effect), ``createDataFrame`` (rows with a list of names
or a DDL string as the schema), ``sql``/``table`` over the default SQL
context, ``spark.udf.register`` for row-wise Python UDFs, ``spark.read``
and ``df.write`` (Parquet on the port's own reader and writer, CSV, JSON
lines and text), ``spark.range``, ``spark.catalog`` over the registered
views, ``spark.conf`` and ``stop``. ``createDataFrame`` also takes a pandas
DataFrame, spotted by its type's module, so no other input imports pandas.

    spark = SparkSession.builder.appName("scoring").getOrCreate()
    registerKerasImageUDF("mnv2", "MobileNetV2")
    spark.read.parquet("images.parquet").createOrReplaceTempView("images")
    spark.sql("SELECT mnv2(image) AS probs FROM images").write.parquet("probs.parquet")
"""

from __future__ import annotations

import inspect
import os
import threading
from typing import Any, Dict, NamedTuple, Optional

from sparkdl_tpu_torch.dataframe import DataFrame

__all__ = ["SparkSession", "DataFrameReader", "DataFrameWriter"]


class DataFrameReader:
    """``spark.read``: the format readers over the DataFrame's
    constructors. ``csv`` defaults to ``header=False``, as pyspark does;
    ``option("header", "true")`` or ``csv(path, header=True)`` opt in."""

    def __init__(self, options: Optional[Dict[str, Any]] = None):
        self._options: Dict[str, Any] = dict(options or {})
        self._format = "parquet"  # what load() reads

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key.lower()] = value
        return self

    def options(self, **opts: Any) -> "DataFrameReader":
        for k, v in opts.items():
            self.option(k, v)
        return self

    def _num_partitions(self) -> int:
        return int(self._options.get("numpartitions", self._options.get("num_partitions", 1)))

    def parquet(self, path: str) -> DataFrame:
        return DataFrame.readParquet(path, numPartitions=self._num_partitions())

    def csv(self, path: str, header: Optional[bool] = None, **_: Any) -> DataFrame:
        if header is None:
            opt = self._options.get("header", False)
            header = str(opt).lower() in ("true", "1") or opt is True
        return DataFrame.readCSV(path, header=header, numPartitions=self._num_partitions())

    def json(self, path: str) -> DataFrame:
        return DataFrame.readJSON(path, numPartitions=self._num_partitions())

    def text(self, path: str) -> DataFrame:
        """One row per line in a ``value`` column (pyspark
        ``spark.read.text``): lines end at \\n only (a trailing \\r is
        stripped), so a U+2028 stays inside its row, as in Spark."""
        with open(path, "r", encoding="utf-8", newline="") as fh:
            raw = fh.read()
        lines = raw.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # the trailing newline, not an empty last row
        lines = [ln[:-1] if ln.endswith("\r") else ln for ln in lines]
        return DataFrame.fromColumns({"value": lines}, numPartitions=self._num_partitions())

    def format(self, source: str) -> "DataFrameReader":
        """``read.format("parquet").load(path)``. The format has an
        attribute of its own: an option named 'format' changes nothing."""
        src = source.lower()
        if src not in ("parquet", "csv", "json", "text"):
            raise ValueError(f"Unsupported read format {source!r}; supported: parquet, csv, json, text")
        self._format = src
        return self

    def load(self, path: str) -> DataFrame:
        return getattr(self, self._format)(path)


class DataFrameWriter:
    """``df.write``. ``mode`` takes 'overwrite' and 'error(ifexists)', and
    the default is pyspark's errorifexists: existing output is never
    overwritten unless asked."""

    def __init__(self, df: DataFrame, mode: str = "errorifexists"):
        self._df = df
        self._mode = mode
        self._format = "parquet"  # what save() writes

    def mode(self, saveMode: str) -> "DataFrameWriter":
        saveMode = saveMode.lower()
        if saveMode not in ("overwrite", "error", "errorifexists"):
            raise ValueError(
                f"Unsupported save mode {saveMode!r}; this engine "
                "writes whole files (overwrite / errorifexists)"
            )
        # changes the writer and returns it, as pyspark's does:
        # `w = df.write; w.mode("overwrite"); w.parquet(p)` works
        self._mode = saveMode
        return self

    def _check(self, path: str) -> None:
        if self._mode in ("error", "errorifexists") and os.path.exists(path):
            raise FileExistsError(f"Path {path!r} already exists (mode=errorifexists)")

    def parquet(self, path: str) -> None:
        self._check(path)
        self._df.writeParquet(path)

    def csv(self, path: str, header: bool = False, **_: Any) -> None:
        # header=False, pyspark's default and the reader's, so that a
        # write and a read with no options round-trip (DataFrame.writeCSV
        # keeps header=True)
        self._check(path)
        self._df.writeCSV(path, header=header)

    def json(self, path: str) -> None:
        self._check(path)
        self._df.writeJSON(path)

    def text(self, path: str) -> None:
        """One line per row of the frame's single column (pyspark
        ``df.write.text``)."""
        cols = self._df.columns
        if len(cols) != 1:
            raise ValueError(f"write.text requires exactly one column, got {cols}")
        self._check(path)
        with open(path, "w", encoding="utf-8") as fh:
            for r in self._df.toLocalIterator():
                v = r[cols[0]]
                fh.write(("" if v is None else str(v)) + "\n")

    def format(self, source: str) -> "DataFrameWriter":
        src = source.lower()
        if src not in ("parquet", "csv", "json", "text"):
            raise ValueError(f"Unsupported write format {source!r}; supported: parquet, csv, json, text")
        self._format = src
        return self

    def save(self, path: str) -> None:
        getattr(self, self._format)(path)


class _UdfRegistrar:
    """``spark.udf``: ``register(name, f)`` puts a row-wise Python
    function in the process-global catalog, callable from ``sql``."""

    def register(self, name: str, f, returnType: Any = None):
        del returnType  # dynamically typed
        from sparkdl_tpu_torch import udf as _catalog

        try:
            sig = inspect.signature(f)
        except (TypeError, ValueError):
            sig = None  # not introspectable: registered as it is
        if sig is not None:
            params = sig.parameters.values()
            pos = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            required = sum(1 for p in pos if p.default is p.empty)
            varargs = any(p.kind is p.VAR_POSITIONAL for p in params)
            # the catalog calls f(cell): it must take one positional
            # argument, checked here rather than at the first SQL call
            if not (required <= 1 and (pos or varargs)):
                raise ValueError(
                    f"spark.udf.register({name!r}): the SQL dialect "
                    f"dispatches one column per UDF; the function "
                    f"requires {required} positional arguments — wrap "
                    "multi-input logic over a struct/array column"
                )
        _catalog.register(
            name,
            lambda cells: [f(v) for v in cells],
            doc=f"spark.udf.register({name!r})",
        )
        return f


class _Builder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}

    def appName(self, name: str) -> "_Builder":
        self._conf["spark.app.name"] = name
        return self

    def master(self, url: str) -> "_Builder":
        self._conf["spark.master"] = url
        return self

    def config(self, key: Optional[str] = None, value: Any = None, **kw) -> "_Builder":
        if key is not None:
            self._conf[key] = value
        self._conf.update(kw)
        return self

    def enableHiveSupport(self) -> "_Builder":
        return self  # accepted; there is no Hive here

    def getOrCreate(self) -> "SparkSession":
        return SparkSession._get_or_create(dict(self._conf))


class SparkSession:
    """The process-wide session (pyspark's active session)."""

    _active: Optional["SparkSession"] = None
    _lock = threading.Lock()

    class _BuilderAccessor:
        def __get__(self, obj, objtype=None) -> _Builder:
            return _Builder()

    builder = _BuilderAccessor()

    def __init__(self, conf: Dict[str, Any]):
        self.conf = RuntimeConf(conf)
        self.udf = _UdfRegistrar()

    @classmethod
    def _get_or_create(cls, conf: Dict[str, Any]) -> "SparkSession":
        with cls._lock:
            if cls._active is None:
                cls._active = cls(conf)
            else:
                cls._active.conf.update(conf)
            return cls._active

    @classmethod
    def getActiveSession(cls) -> Optional["SparkSession"]:
        return cls._active

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader()

    def createDataFrame(self, data, schema=None) -> DataFrame:
        """A list of dicts (the union of their keys), a list of tuples with
        a list of column names or a DDL string (``"id long, name
        string"``, types ignored) as ``schema``, a column dict, or a pandas
        DataFrame (its columns' cells as they are)."""
        if type(data).__module__.split(".")[0] == "pandas":
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                return DataFrame.fromColumns({c: list(data[c]) for c in data.columns})
        if isinstance(data, dict):
            return DataFrame.fromColumns(data)
        rows = list(data)
        if not rows:
            raise ValueError(
                "createDataFrame needs at least one row (this engine "
                "infers columns from data, not from schema types)"
            )
        if isinstance(rows[0], dict):
            cols: list = []
            for r in rows:
                for c in r:
                    if c not in cols:
                        cols.append(c)
            return DataFrame.fromColumns({c: [r.get(c) for r in rows] for c in cols})
        if schema is None:
            raise ValueError(
                "createDataFrame from tuples needs column names: "
                "createDataFrame(rows, ['a', 'b'])"
            )
        from sparkdl_tpu_torch.dataframe.frame import _schema_names

        names = _schema_names(schema)
        return DataFrame.fromColumns(
            {name: [row[i] for row in rows] for i, name in enumerate(names)}
        )

    def sql(self, query: str) -> DataFrame:
        from sparkdl_tpu_torch import sql as _sql

        return _sql.sql(query)

    def table(self, name: str) -> DataFrame:
        from sparkdl_tpu_torch import sql as _sql

        return _sql._default.table(name)

    def range(
        self, start: int, end: Optional[int] = None, step: int = 1, numPartitions: Optional[int] = None
    ) -> DataFrame:
        """pyspark ``spark.range``: one int64 ``id`` column over [start,
        end) by ``step``; ``range(n)`` is ``range(0, n)``. The column is a
        numpy array, not boxed ints."""
        import numpy as np

        if end is None:
            start, end = 0, start
        vals = np.arange(int(start), int(end), int(step), dtype=np.int64)
        return DataFrame.fromColumns({"id": vals}, numPartitions=numPartitions or 1)

    @property
    def catalog(self) -> "_Catalog":
        return _Catalog()

    def newSession(self) -> "SparkSession":
        """The views and UDFs are the process's, so a new session is the
        same engine under a copy of the conf."""
        return SparkSession(dict(self.conf))

    @property
    def sparkContext(self):
        raise AttributeError(
            "There is no SparkContext/RDD layer in sparkdl_tpu_torch: the "
            "DataFrame is the bottom of the stack. Partition-level "
            "access: df.foreachPartition / df.toLocalIterator / "
            "DataFrame.fromColumns(..., numPartitions=N)"
        )

    def stop(self) -> None:
        with SparkSession._lock:
            SparkSession._active = None

    @property
    def version(self) -> str:
        import sparkdl_tpu_torch

        return sparkdl_tpu_torch.__version__


class CatalogDatabase(NamedTuple):
    """The fields of pyspark's ``Database`` that scripts read."""

    name: str
    catalog: str = "spark_catalog"
    description: str = ""
    locationUri: str = ""


class CatalogColumn(NamedTuple):
    """The fields of pyspark's catalog ``Column`` that scripts read."""

    name: str
    description: str = ""
    dataType: str = ""
    nullable: bool = True
    isPartition: bool = False
    isBucket: bool = False


class CatalogTable(NamedTuple):
    """The fields of pyspark's ``Table`` that scripts read
    (``[t.name for t in spark.catalog.listTables()]``)."""

    name: str
    database: str
    tableType: str = "TEMPORARY"
    isTemporary: bool = True


_NO_DEFAULT = object()


class RuntimeConf(dict):
    """``spark.conf`` (pyspark's RuntimeConfig ``get``/``set``/``unset``)
    as a dict: a missing key without a default raises, as in pyspark, so
    a script's ``except`` fallback still runs."""

    def get(self, key: str, default: Any = _NO_DEFAULT) -> Any:  # type: ignore[override]
        if default is _NO_DEFAULT:
            if key not in self:
                raise KeyError(f"No such config key: {key!r} (pass a default to get a fallback instead)")
            return self[key]
        return dict.get(self, key, default)

    def set(self, key: str, value: Any) -> None:
        self[key] = value

    def unset(self, key: str) -> None:
        self.pop(key, None)

    def isModifiable(self, key: str) -> bool:
        return True  # no key is locked by the engine


class AnalysisException(Exception):
    """Stands for pyspark's ``AnalysisException``: a catalog lookup that
    misses raises it."""


class _Catalog:
    """``spark.catalog`` over the default SQL context's views. A view
    registered as ``global_temp.<name>`` is in the ``global_temp``
    database, every other in ``default``."""

    @staticmethod
    def _candidates(tableName: str, dbName: Optional[str]):
        """The registered names that (tableName, dbName) may mean: the one
        rule of tableExists and listColumns."""
        out = {tableName}
        if dbName is not None:
            out.add(f"{dbName}.{tableName}")
            if dbName == "default":
                out.add(tableName)
        if tableName.startswith("default."):
            out.add(tableName[len("default."):])
        return out

    def _resolve(self, tableName: str, dbName: Optional[str]):
        from sparkdl_tpu_torch import sql as _sql

        hits = self._candidates(tableName, dbName) & set(_sql._default.tables())
        return next(iter(hits)) if hits else None

    def listTables(self, dbName: Optional[str] = None):
        from sparkdl_tpu_torch import sql as _sql

        out = []
        for full in _sql._default.tables():
            db, _, name = full.rpartition(".")
            db = db or "default"
            if dbName is not None and db != dbName:
                continue
            out.append(CatalogTable(name=name, database=db))
        return out

    def tableExists(self, tableName: str, dbName: Optional[str] = None) -> bool:
        """pyspark's one- and two-argument forms; ``default.t`` is the
        view registered as ``t``, as listTables shows it."""
        return self._resolve(tableName, dbName) is not None

    def listColumns(self, tableName: str, dbName: Optional[str] = None):
        """The columns of a view, by tableExists' rule, as named tuples
        (``[c.name for c in ...]``); a miss raises
        :class:`AnalysisException`, as in pyspark."""
        from sparkdl_tpu_torch import sql as _sql

        resolved = self._resolve(tableName, dbName)
        if resolved is None:
            raise AnalysisException(
                f"Table or view not found: {tableName}" + (f" (database {dbName})" if dbName else "")
            )
        return [CatalogColumn(name=c) for c in _sql._default.table(resolved).columns]

    def dropTempView(self, viewName: str) -> bool:
        from sparkdl_tpu_torch import sql as _sql

        # one step under the context's lock: no check-then-drop race
        return _sql._default.dropTempTable(viewName)

    def dropGlobalTempView(self, viewName: str) -> bool:
        return self.dropTempView(f"global_temp.{viewName}")

    def currentDatabase(self) -> str:
        return "default"

    def listDatabases(self):
        return [CatalogDatabase(name="default"), CatalogDatabase(name="global_temp")]
