"""The relational core of the port's DataFrame/Column surface
(``sparkdl_tpu_torch/dataframe/frame.py``, ``dataframe/column.py``,
``functions.py``) against the JAX package's on the CPU.

- ``groupBy``/``rollup``/``cube``/``groupingSets`` with ``agg`` in both
  forms (aggregate Columns: every ``F`` aggregate; the dict form) and the
  ``count``/``avg``/``sum``/``min``/``max`` shortcuts, ``pivot`` with and
  without values, global ``df.agg``, ``F.window`` time-window keys;
- ``join`` with every ``how`` (and its aliases), on names, lists and
  Column conditions, self-joins of ``alias``-ed frames, ``crossJoin``;
- ``distinct``, ``dropDuplicates``, ``union``/``unionAll``/``unionByName``,
  ``intersect``, ``subtract``, ``exceptAll``, ``intersectAll``, ``offset``;
- the aggregate engine itself (``streaming_group_agg``,
  ``aggregate_values``) over the same values;
- the SQL text and the Column surface agree on the same relational
  computation (the JAX package's ``tests/test_surface_consistency.py``).

Frames hold NULL and NaN cells, duplicate and NULL keys, three partitions.
Rows compare exactly (NaN equal to NaN) and in order: the JAX package
fixes every order here (groups in first-appearance order, joins left-major,
set operations in first-occurrence order), except a discovered pivot's
columns, which both sort. A call the JAX package refuses, the port refuses
with the same error. Nothing stays refused: the pandas surfaces give the
JAX package's rows too.
"""

import datetime
import math

import numpy as np
import pytest

from sparkdl_tpu import functions as JF
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.dataframe import frame as jax_frame
from sparkdl_tpu.sql import SQLContext as JaxSQLContext
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.dataframe import frame as port_frame
from sparkdl_tpu_torch.sql import SQLContext

NAN = float("nan")


def facts():
    return {
        "id": list(range(12)),
        "k": ["a", "b", None, "a", "c", "b", "a", None, "d", "c", "a", "b"],
        "g": [1, 2, 1, None, 2, 1, 3, 2, None, 1, 3, 2],
        "v": [1.5, -2.0, NAN, None, 4.25, 0.5, -1.0, 3.0, None, 2.5, 7.0, -0.75],
        "n": [3, None, 7, 1, 1, 4, 9, None, 2, 6, 3, 5],
        "s": ["x", "y", "x", None, "z", "y", "x", "w", "z", None, "y", "x"],
        "flag": [True, False, None, True, True, False, None, False, True, True, False, True],
        "ts": [datetime.datetime(2024, 1, 1, 10, m) for m in (0, 4, 9, 12, 15, 21, 29, 30, 44, 45, 51, 59)],
    }


def dims():
    return {"k": ["a", "b", "c", "e", None], "label": ["alpha", "beta", "gamma", "eps", "nil"],
            "w": [10, 20, None, 40, 50]}


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, np.ndarray):
        return [_norm(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return _norm(v.item())
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def rows(df):
    return [{k: _norm(v) for k, v in r.items()} for r in df.collect()]


def outcome(run):
    try:
        out = run()
        return "rows", (out.columns, rows(out))
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return "error", (type(e).__name__, str(e))


class Side:
    """One package's frames and ``F`` module."""

    def __init__(self, frame_cls, fmod):
        self.t = frame_cls.fromColumns(facts(), numPartitions=3)
        self.d = frame_cls.fromColumns(dims(), numPartitions=2)
        self.F = fmod
        self.cls = frame_cls


@pytest.fixture(scope="module")
def sides():
    return Side(DataFrame, F), Side(JaxDataFrame, JF)


def same(sides, build):
    """``build(side)`` gives the same columns and rows (or the same error)
    on both packages."""
    ours, ref = sides
    got, want = outcome(lambda: build(ours)), outcome(lambda: build(ref))
    assert got == want
    return got


#: (name, build): each builds one relational computation on a Side
CASES = [
    # aggregate Columns
    ("count star", lambda s: s.t.groupBy("k").agg(s.F.count("*").alias("c"), s.F.count("v"))),
    ("count default", lambda s: s.t.groupBy("g").agg(s.F.count())),
    ("sum avg min max", lambda s: s.t.groupBy("k").agg(s.F.sum("n"), s.F.avg("v"), s.F.min("v"), s.F.max("s"))),
    ("mean", lambda s: s.t.groupBy("g").agg(s.F.mean("n").alias("m"))),
    ("moments", lambda s: s.t.groupBy("g").agg(
        s.F.stddev("v"), s.F.variance("n"), s.F.stddev_pop("n"), s.F.var_pop("v"), s.F.stddev_samp("n"),
        s.F.var_samp("n"), s.F.skewness("n"), s.F.kurtosis("n"))),
    ("distinct aggregates", lambda s: s.t.groupBy("g").agg(
        s.F.countDistinct("k"), s.F.sumDistinct("n").alias("sd"), s.F.sum_distinct("g").alias("sg"),
        s.F.approx_count_distinct("s"), s.F.approxCountDistinct("k", 0.05).alias("ack"))),
    ("count_distinct alias", lambda s: s.t.agg(s.F.count_distinct("s").alias("ds"))),
    ("percentiles", lambda s: s.t.groupBy("k").agg(
        s.F.percentile_approx("n", 0.5).alias("p50"), s.F.percentile("n", [0.25, 0.75]).alias("pq"),
        s.F.percentile_approx("v", [0.1, 0.9], 100).alias("pv"), s.F.median("n"))),
    ("collections", lambda s: s.t.groupBy("k").agg(
        s.F.collect_list("n"), s.F.collect_set("s"), s.F.array_agg("g").alias("ag"), s.F.first("s"),
        s.F.last("n"), s.F.any_value("v"), s.F.mode("s"))),
    ("co-statistics", lambda s: s.t.groupBy("g").agg(
        s.F.corr("n", "v"), s.F.covar_pop("n", "id"), s.F.covar_samp(s.F.col("id"), s.F.col("n")))),
    ("boolean aggregates", lambda s: s.t.groupBy("k").agg(
        s.F.bool_and("flag"), s.F.bool_or(s.F.col("n") > 4).alias("bo"), s.F.every(s.F.col("id") < 10).alias("ev"),
        s.F.count_if(s.F.col("n") > 2).alias("ci"))),
    ("aggregate of an expression", lambda s: s.t.groupBy("g").agg(
        s.F.sum(s.F.col("n") * s.F.col("id")).alias("w"), s.F.avg(s.F.coalesce("v", s.F.lit(0.0))).alias("av"))),
    ("expression key", lambda s: s.t.groupBy((s.F.col("id") % 3).alias("r")).agg(s.F.sum("n"))),
    ("column key", lambda s: s.t.groupBy(s.F.col("k"), "g").agg(s.F.count("*"))),
    ("dict form", lambda s: s.t.groupBy("k").agg({"n": "sum", "v": "max", "*": "count"})),
    ("dict count distinct", lambda s: s.t.groupBy("g").agg({"k": "count_distinct"})),
    ("shortcuts", lambda s: s.t.groupBy("k").count()),
    ("avg shortcut", lambda s: s.t.groupBy("g").avg("n", "v")),
    ("mean shortcut", lambda s: s.t.groupby("g").mean("id")),
    ("sum shortcut", lambda s: s.t.groupBy("s").sum("n")),
    ("min max shortcuts", lambda s: s.t.groupBy("k").min("id").join(s.t.groupBy("k").max("id"), "k")),
    ("global agg", lambda s: s.t.agg(s.F.count("*"), s.F.sum("n"), s.F.avg("v"))),
    ("global agg dict", lambda s: s.t.agg({"n": "avg"})),
    ("global agg of no rows", lambda s: s.t.filter(s.F.col("id") > 99).agg(s.F.count("*"), s.F.sum("n"))),
    ("rollup", lambda s: s.t.rollup("k", "g").agg(s.F.count("*").alias("c"), s.F.sum("n"))),
    ("cube", lambda s: s.t.filter(s.F.col("id") < 8).cube("k", "s").count()),
    ("grouping sets", lambda s: s.t.groupingSets([["k", "g"], ["k"], []], "k", "g").agg(s.F.avg("n"))),
    ("grouping sets of columns", lambda s: s.t.groupingSets([[s.F.col("g")], "k"], "k", "g").agg(s.F.max("v"))),
    ("pivot with values", lambda s: s.t.groupBy("k").pivot("s", ["x", "y", "q"]).agg(s.F.sum("n"))),
    ("pivot discovered", lambda s: s.t.groupBy("g").pivot("k").count()),
    ("pivot two aggregates", lambda s: s.t.groupBy("g").pivot("s", ["x", "y"]).agg(
        s.F.min("id").alias("lo"), s.F.max("id").alias("hi"))),
    ("pivot shortcuts", lambda s: s.t.groupBy("k").pivot("g", [1, 2]).avg("n")),
    ("time window key", lambda s: s.t.groupBy(s.F.window("ts", "15 minutes")).agg(s.F.count("*").alias("c"))),
    ("time window with start", lambda s: s.t.groupBy(s.F.window("ts", "20 minutes", startTime="5 minutes"), "k")
     .agg(s.F.sum("n").alias("sn"))),
    # joins
    ("inner join", lambda s: s.t.join(s.d, "k")),
    ("inner join list", lambda s: s.t.join(s.d, ["k"], "inner")),
    ("left join", lambda s: s.t.join(s.d, "k", "left")),
    ("left outer join", lambda s: s.t.join(s.d, on="k", how="left_outer")),
    ("right join", lambda s: s.t.join(s.d, "k", "right")),
    ("right outer join", lambda s: s.t.join(s.d, "k", "rightouter")),
    ("full outer join", lambda s: s.t.join(s.d, "k", "outer")),
    ("full join", lambda s: s.t.join(s.d, "k", "full")),
    ("full_outer join", lambda s: s.t.join(s.d, "k", "full_outer")),
    ("left semi join", lambda s: s.t.join(s.d, "k", "left_semi")),
    ("semi join", lambda s: s.t.join(s.d, "k", "semi")),
    ("left anti join", lambda s: s.t.join(s.d, "k", "left_anti")),
    ("anti join", lambda s: s.t.join(s.d, "k", "leftanti")),
    ("join on a condition", lambda s: s.t.join(s.d.withColumnRenamed("k", "dk"), s.F.col("k") == s.F.col("dk"))),
    ("join on a reversed condition", lambda s: s.t.join(
        s.d.withColumnRenamed("k", "dk"), s.F.col("dk") == s.F.col("k"), "left")),
    ("join on two conditions", lambda s: s.t.join(
        s.t.select(s.F.col("id").alias("i2"), s.F.col("g").alias("g2"), "s"),
        (s.F.col("id") == s.F.col("i2")) & (s.F.col("g") == s.F.col("g2")), "inner").drop("s")),
    ("join on a bare column", lambda s: s.t.select("k", "id").join(s.d, s.F.col("k"))),
    ("self join of aliases", lambda s: s.t.alias("a").join(s.t.alias("b"), "k").select("k", "a.id", "b.id")),
    ("join collision", lambda s: s.t.join(s.t, "k")),
    ("cross join", lambda s: s.d.select("label").crossJoin(s.t.select("id").filter(s.F.col("id") < 3))),
    ("cross join of aliases", lambda s: s.d.alias("x").crossJoin(s.d.alias("y")).select("x.k", "y.k")),
    ("cross join refused", lambda s: s.t.join(s.d, "k", "cross")),
    ("broadcast hint", lambda s: s.t.join(s.F.broadcast(s.d), "k", "left")),
    ("join then group", lambda s: s.t.join(s.d, "k").groupBy("label").agg(s.F.sum("n").alias("sn"))),
    # set operations, distinct and offset
    ("distinct", lambda s: s.t.select("k", "g").distinct()),
    ("drop duplicates", lambda s: s.t.dropDuplicates(["k"])),
    ("drop duplicates snake", lambda s: s.t.drop_duplicates(["g", "s"])),
    ("drop duplicates all", lambda s: s.t.select("s").dropDuplicates()),
    ("union", lambda s: s.t.select("k").union(s.d.select("k"))),
    ("union all", lambda s: s.t.select("k", "id").unionAll(s.d.select("k", s.F.col("w").alias("id")))),
    ("union by name", lambda s: s.t.select("k", "n").unionByName(s.t.select("n", "k").filter(s.F.col("n") > 4))),
    ("union by name missing", lambda s: s.t.select("k", "n").unionByName(s.d, allowMissingColumns=True)),
    ("union by name refused", lambda s: s.t.select("k", "n").unionByName(s.d)),
    ("intersect", lambda s: s.t.select("k").intersect(s.d.select("k"))),
    ("subtract", lambda s: s.t.select("k").subtract(s.d.select("k"))),
    ("except all", lambda s: s.t.select("k").exceptAll(s.d.select("k"))),
    ("intersect all", lambda s: s.t.select("s").intersectAll(s.t.filter(s.F.col("g") > 1).select("s"))),
    ("offset", lambda s: s.t.offset(5)),
    ("offset past the end", lambda s: s.t.offset(40)),
    ("offset after a sort", lambda s: s.t.orderBy(s.F.col("n").desc()).offset(7).select("id", "n")),
    ("limit then offset", lambda s: s.t.limit(6).offset(2)),
]


@pytest.mark.parametrize("build", [b for _, b in CASES], ids=[n for n, _ in CASES])
def test_relational_calls_equal_the_jax_package(sides, build):
    same(sides, build)


#: calls the JAX package refuses: the port refuses them with its error
REFUSED = [
    ("aggregate in select", lambda s: s.t.select(s.F.sum("n"))),
    ("aggregate in filter", lambda s: s.t.filter(s.F.max("n") > 1)),
    ("aggregate in withColumn", lambda s: s.t.withColumn("x", s.F.count("*"))),
    ("agg of a non-aggregate", lambda s: s.t.groupBy("k").agg(s.F.col("n"))),
    ("star of sum", lambda s: s.F.sum("*")),
    ("agg of nothing", lambda s: s.t.groupBy("k").agg()),
    ("duplicate agg names", lambda s: s.t.groupBy("k").agg(s.F.sum("n"), s.F.sum("n"))),
    ("unknown agg column", lambda s: s.t.groupBy("k").agg(s.F.sum("nope"))),
    ("unknown dict aggregate", lambda s: s.t.groupBy("k").agg({"n": "percentile"})),
    ("unknown key", lambda s: s.t.groupBy("nope")),
    ("expression key collision", lambda s: s.t.groupBy((s.F.col("n") + 1).alias("id"))),
    ("pivot on a key", lambda s: s.t.groupBy("k").pivot("k")),
    ("grouping set member", lambda s: s.t.groupingSets([["s"]], "k")),
    ("percentile out of range", lambda s: s.F.percentile("n", 1.5)),
    ("first with nulls", lambda s: s.F.first("n", ignorenulls=False)),
    ("sliding window", lambda s: s.F.window("ts", "10 minutes", "5 minutes")),
    ("ambiguous join", lambda s: s.t.join(s.t.select("k", "n"), "k")),
    ("unknown join key", lambda s: s.t.join(s.d, "nope")),
    ("join type", lambda s: s.t.join(s.d, "k", "sideways")),
    ("join predicate", lambda s: s.t.join(s.d, s.F.col("k") > s.F.col("label"))),
    ("cross join collision", lambda s: s.t.crossJoin(s.d)),
    ("set operation columns", lambda s: s.t.select("k").intersect(s.d.select("label"))),
    ("negative offset", lambda s: s.t.offset(-1)),
    ("drop duplicates unknown", lambda s: s.t.dropDuplicates(["nope"])),
]


@pytest.mark.parametrize("build", [b for _, b in REFUSED], ids=[n for n, _ in REFUSED])
def test_refused_calls_fail_as_the_jax_package_fails(sides, build):
    kind, _ = same(sides, lambda s: _as_frame(build(s)))
    assert kind == "error"


def _as_frame(x):
    """A builder that only constructs a Column or GroupedData is forced to
    a frame (or its error) so both packages compare on it."""
    return x if hasattr(x, "collect") else x.agg({"*": "count"}) if hasattr(x, "agg") else x._expr


@pytest.mark.parametrize("fn", ["count", "sum", "avg", "min", "max", "stddev", "variance", "stddev_pop", "var_pop",
                                "skewness", "kurtosis", "collect_list", "collect_set", "first", "last", "median",
                                "sum_distinct", "count_distinct", "approx_count_distinct", "mode", "any_value",
                                "bool_and", "bool_or", "every"])
def test_aggregate_values_equal_the_jax_package(fn):
    """The engine's one-shot fold over the same values, NaN, nulls and
    duplicates included (booleans for the boolean folds)."""
    if fn in ("bool_and", "bool_or", "every"):
        values = [True, None, False, True, None]
    elif fn in ("collect_set", "mode", "first", "last", "any_value", "count_distinct", "approx_count_distinct"):
        values = ["b", None, "a", "b", "c", "a", "b"]
    else:
        values = [2.5, None, -1.0, 4.0, 4.0, 0.125, None, 7.0, -3.5]
    assert _norm(port_frame.aggregate_values(fn, values)) == _norm(jax_frame.aggregate_values(fn, values))
    assert _norm(port_frame.aggregate_values(fn, [])) == _norm(jax_frame.aggregate_values(fn, []))
    with_nan = [1.0, NAN, 2.0] if fn not in ("bool_and", "bool_or", "every") else [True]
    try:
        want = _norm(jax_frame.aggregate_values(fn, with_nan))
    except Exception as e:  # noqa: BLE001
        with pytest.raises(type(e)):
            port_frame.aggregate_values(fn, with_nan)
        return
    assert _norm(port_frame.aggregate_values(fn, with_nan)) == want


def test_streaming_group_agg_equals_the_jax_package(sides):
    """Groups in first-appearance order, COUNT(*) answered from metadata,
    tensor and struct keys grouped by content."""
    ours, ref = sides
    specs = [("count", None), ("avg", "v"), ("percentile:[0.5]", "n"), ("count_distinct", "s"),
             ("corr", "pair")]
    frames = []
    for side in (ours, ref):
        t = side.t.withColumn("pair", side.F.array("n", "id")).withColumn(
            "vec", lambda r: np.full(2, float((r["g"] or 0) % 2), np.float32))
        frames.append((side.cls, t))
    got = [
        cls_mod.streaming_group_agg(t, keys, specs)
        for (_, t), cls_mod in zip(frames, (port_frame, jax_frame))
        for keys in (["k"], ["vec"], [])
    ]
    half = len(got) // 2
    assert _norm(got[:half]) == _norm(got[half:])
    count_only = [mod.streaming_group_agg(side.t, [], [("count", None)]) for mod, side in
                  ((port_frame, ours), (jax_frame, ref))]
    assert count_only[0] == count_only[1] == ([()], [[12]])


#: (name, sql text, Column-surface build): the same computation on both
#: surfaces of the port; each must also equal the JAX package's SQL rows
SURFACES = [
    ("group by with the aggregates",
     "SELECT k, count(*) AS c, avg(v) AS a, stddev(n) AS sd, percentile_approx(n, 0.5) AS p, "
     "count(DISTINCT s) AS ds, count(*) FILTER (WHERE n > 2) AS big FROM t GROUP BY k",
     lambda F, t, d: t.groupBy("k").agg(
         F.count("*").alias("c"), F.avg("v").alias("a"), F.stddev("n").alias("sd"),
         F.percentile_approx("n", 0.5).alias("p"), F.countDistinct("s").alias("ds"),
         F.count(F.when(F.col("n") > 2, 1)).alias("big"))),
    ("having and order by an aggregate",
     "SELECT k, sum(n) AS s FROM t GROUP BY k HAVING count(*) > 2 ORDER BY s DESC",
     lambda F, t, d: t.groupBy("k").agg(F.sum("n").alias("s"), F.count("*").alias("c"))
     .filter(F.col("c") > 2).orderBy(F.col("s").desc()).select("k", "s")),
    ("rollup",
     "SELECT k, g, count(*) AS c FROM t GROUP BY ROLLUP(k, g)",
     lambda F, t, d: t.rollup("k", "g").agg(F.count("*").alias("c"))),
    ("inner join", "SELECT id, k, label FROM t JOIN d ON t.k = d.k",
     lambda F, t, d: t.join(d, "k").select("id", "k", "label")),
    ("left join", "SELECT id, k, label FROM t LEFT JOIN d ON t.k = d.k",
     lambda F, t, d: t.join(d, "k", "left").select("id", "k", "label")),
    ("full join", "SELECT id, k, w FROM t FULL OUTER JOIN d ON t.k = d.k",
     lambda F, t, d: t.join(d, "k", "outer").select("id", "k", "w")),
    ("semi join", "SELECT id FROM t LEFT SEMI JOIN d ON t.k = d.k",
     lambda F, t, d: t.join(d, "k", "left_semi").select("id")),
    ("union", "SELECT k FROM t UNION SELECT k FROM d",
     lambda F, t, d: t.select("k").union(d.select("k")).distinct()),
    ("intersect", "SELECT k FROM t INTERSECT SELECT k FROM d",
     lambda F, t, d: t.select("k").intersect(d.select("k"))),
    ("except", "SELECT k FROM t EXCEPT SELECT k FROM d",
     lambda F, t, d: t.select("k").subtract(d.select("k"))),
    ("distinct", "SELECT DISTINCT g, s FROM t", lambda F, t, d: t.select("g", "s").distinct()),
    ("limit offset", "SELECT id FROM t ORDER BY id DESC LIMIT 3 OFFSET 2",
     lambda F, t, d: t.orderBy(F.col("id").desc()).limit(5).offset(2).select("id")),
    ("global aggregate", "SELECT count(*) AS c, sum(n) AS s, stddev_pop(n) AS sp, percentile(n, 0.5) AS p, "
                         "bool_or(v > 0) AS b, collect_list(id) AS li FROM t",
     lambda F, t, d: t.agg(F.count("*").alias("c"), F.sum("n").alias("s"), F.stddev_pop("n").alias("sp"),
                           F.percentile("n", 0.5).alias("p"), F.bool_or(F.col("v") > 0).alias("b"),
                           F.collect_list("id").alias("li"))),
    ("expr aggregate", "SELECT g, max(n) - min(n) AS span FROM t GROUP BY g",
     lambda F, t, d: t.groupBy("g").agg(F.expr("max(n)").alias("mx"), F.expr("min(n)").alias("mn"))
     .select("g", (F.col("mx") - F.col("mn")).alias("span"))),
]


@pytest.mark.parametrize("text,build", [(q, b) for _, q, b in SURFACES], ids=[n for n, _, _ in SURFACES])
def test_sql_and_column_surfaces_agree(sides, text, build):
    ours, ref = sides
    ctx, jctx = SQLContext(), JaxSQLContext()
    for c, side in ((ctx, ours), (jctx, ref)):
        c.registerDataFrameAsTable(side.t, "t")
        c.registerDataFrameAsTable(side.d, "d")
    via_sql = rows(ctx.sql(text))
    assert via_sql == rows(jctx.sql(text))
    assert rows(build(F, ours.t, ours.d)) == via_sql


def test_what_stays_refused_on_the_frame(sides):
    """Nothing of the frame is refused any more. The pandas surfaces and
    the statistics methods, refused here until they were ported (the test
    keeps its name), and ``Column.over``, ``F.row_number``, ``F.explode``
    and ``F.rand`` now give the JAX package's rows or values (corr and cov
    within 1e-12 relative, ``toPandas`` through ``assert_frame_equal``), or
    fail as it fails."""
    import pandas as pd

    ours, ref = sides
    pd.testing.assert_frame_equal(ours.t.toPandas(), ref.t.toPandas())
    for build in (
        lambda s: s.t.groupBy("k").applyInPandas(lambda p: p.head(1)[["k"]], "k string"),
        lambda s: s.t.groupBy("k").cogroup(s.t.groupBy("k")).applyInPandas(
            lambda a, b: pd.DataFrame({"n": [len(a) + len(b)]}), "n long"),
        lambda s: s.t.select("k", s.F.pandas_udf(lambda x: x.str.upper())("k").alias("u")),
    ):
        same(sides, build)
    for build in (
        lambda s: s.t.describe(), lambda s: s.t.summary(), lambda s: s.t.crosstab("k", "s"),
        lambda s: s.t.freqItems(["k"]), lambda s: s.t.sampleBy("k", {"a": 0.5}, 3),
        lambda s: s.t.select("k", s.F.col("n").over(None)),
        lambda s: s.t.withColumn("r", s.F.row_number()),
        lambda s: s.t.select("k", s.F.explode(s.F.array("n", "n"))),
        lambda s: s.t.withColumn("u", s.F.rand()),
    ):
        same(sides, build)
    assert ours.t.approxQuantile("n", [0.5]) == ref.t.approxQuantile("n", [0.5])
    for method in ("corr", "cov"):
        for pair in (("n", "v"), ("n", "g"), ("id", "n")):
            got, want = getattr(ours.t, method)(*pair), getattr(ref.t, method)(*pair)
            assert got == pytest.approx(want, rel=1e-12, nan_ok=True), (method, pair)
