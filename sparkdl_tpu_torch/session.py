"""``SparkSession``: the entry point that scoring scripts start from.

Port of the part of the JAX package's ``session.py`` that SQL scoring
uses: ``SparkSession.builder...getOrCreate()`` (one process-wide
session; builder options are recorded and have no engine effect),
``createDataFrame``, ``sql`` and ``table`` over the default SQL context,
``spark.udf.register`` for row-wise Python UDFs, and ``stop``. The
readers, writers and ``spark.catalog`` wait for ROADMAP Queue A item 8.

    spark = SparkSession.builder.appName("scoring").getOrCreate()
    registerKerasImageUDF("mnv2", "MobileNetV2")
    images.createOrReplaceTempView("images")
    spark.sql("SELECT mnv2(image) AS probs FROM images").collect()
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Dict, Optional

from sparkdl_tpu_torch.dataframe import DataFrame

__all__ = ["SparkSession"]


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
        self.conf = dict(conf)
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

    def createDataFrame(self, data, schema=None) -> DataFrame:
        """A list of dicts (the union of their keys), a list of tuples with
        a list of column names as ``schema``, or a column dict."""
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
        if not isinstance(schema, (list, tuple)):
            raise TypeError(
                "schema must be a list of column names (DDL strings wait "
                "for ROADMAP Queue A item 8)"
            )
        names = [str(c) for c in schema]
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            raise ValueError(f"Duplicate schema columns: {sorted(dups)}")
        return DataFrame.fromColumns(
            {name: [row[i] for row in rows] for i, name in enumerate(names)}
        )

    def sql(self, query: str) -> DataFrame:
        from sparkdl_tpu_torch import sql as _sql

        return _sql.sql(query)

    def table(self, name: str) -> DataFrame:
        from sparkdl_tpu_torch import sql as _sql

        return _sql._default.table(name)

    def stop(self) -> None:
        with SparkSession._lock:
            SparkSession._active = None
