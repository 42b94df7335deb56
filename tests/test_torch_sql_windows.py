"""Windows of the port's SQL/DataFrame surface (``sparkdl_tpu_torch/sql.py``'s
window engine, ``dataframe/window.py``, ``Column.over`` and the window ``F``
functions) against the JAX package's on the CPU.

- Every window query runs through both packages and both
  ``SPARKDL_SQL_VECTORIZE`` arms over the same tables (ties, NULL keys and
  values, NaN, three partitions): the ranking functions, ``lag``/``lead``
  with offsets and defaults, ``first_value``/``last_value``/``nth_value``,
  the aggregates over a whole partition, over Spark's default running frame,
  over ROWS and RANGE frames, windows over expressions, inside CASE and
  arithmetic, over a join, in a CTE and a derived table, with scalar
  subqueries in their operands.
- Rows are compared exactly and in order. The window engine and the
  aggregate accumulators are the JAX package's, copied, so no float
  tolerance is needed.
- A query the JAX package refuses (a window in WHERE, HAVING, ORDER BY or a
  lambda, a frame on a ranking function, two RANGE keys, ...) fails in the
  port with the same error.
- The Column API (``Window.partitionBy(...).orderBy(...)``,
  ``F.*().over(w)``) gives the JAX package's rows or its error, and equals
  the SQL text's rows.
- A window over a join keeps its operands on the optimizer arm, which prunes
  the join inputs; a model UDF in a window operand runs batched.
"""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu import functions as JF
from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.dataframe import Window as JaxWindow
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.sql import SQLContext as JaxSQLContext
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame, Window, WindowSpec
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.sql import SQLContext, UnsupportedSQL
from sparkdl_tpu_torch.utils.metrics import metrics

NAN = float("nan")


def facts():
    """Fourteen rows: duplicate and NULL keys, tied and NULL values, NaN."""
    return {
        "id": list(range(14)),
        "k": ["a", "b", None, "a", "c", "b", "a", None, "d", "c", "a", "b", "a", "c"],
        "g": [1, 2, 1, None, 2, 1, 3, 2, None, 1, 3, 2, 1, 2],
        "v": [1.5, -2.0, NAN, None, 4.25, 0.5, -1.0, 3.0, None, 2.5, 7.0, -0.75, 1.5, 4.25],
        "n": [3, None, 7, 1, 1, 4, 9, None, 2, 6, 3, 5, 3, 1],
        "t": [1, 2, 4, 7, 8, 1, 10, 3, 3, 5, 12, 2, 6, 9],
        "s": ["x", "y", "x", None, "z", "y", "x", "w", "z", None, "y", "x", "x", "z"],
        "arr": [[1, 2], [3], None, [], [4, 5], [6], [7, 8], [9], [1], None, [2], [3, 4], [], [5]],
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


def unknown_as_one(result):
    """An unknown function is one outcome whichever package names it: the
    JAX package fails at execution with its catalog's KeyError, the port at
    planning with a ValueError naming the function."""
    kind, detail = result
    if kind == "error" and (
        (detail[0] == "KeyError" and "No UDF registered under" in detail[1])
        or (detail[0] == "ValueError" and detail[1].startswith("Unknown function(s) ["))
    ):
        return "error", ("unknown function", detail[1].split("'")[1])
    return result


def outcome(run):
    """``("rows", [...])`` or ``("error", (class, message))``, past a
    partition task's retry preamble (:func:`unknown_as_one` applied)."""
    try:
        return "rows", rows(run())
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return unknown_as_one(("error", (type(e).__name__, str(e).rpartition("attempts: ")[2])))


def _register(ctx, frame_cls):
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(facts(), numPartitions=3), "t")
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(dims(), numPartitions=2), "d")
    return ctx


@pytest.fixture(scope="module")
def contexts():
    return _register(SQLContext(), DataFrame), _register(JaxSQLContext(), JaxDataFrame)


def assert_same_in_both_arms(contexts, query, monkeypatch, want_rows=True):
    ours, ref = contexts
    got = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        got[arm] = (outcome(lambda: ours.sql(query)), outcome(lambda: ref.sql(query)))
    (vec_ours, vec_ref), (row_ours, row_ref) = got["1"], got["0"]
    assert vec_ref == row_ref  # the reference's own arms agree
    assert vec_ours == vec_ref
    assert row_ours == row_ref
    if want_rows:
        assert vec_ours[0] == "rows", vec_ours
    return vec_ours


#: window queries, rows compared in order (module doc)
QUERIES = {
    # ranking
    "row_number": "SELECT id, k, row_number() OVER (PARTITION BY k ORDER BY v DESC, id) AS r FROM t",
    "rank with ties": "SELECT id, n, rank() OVER (ORDER BY n) AS r, dense_rank() OVER (ORDER BY n) AS d FROM t",
    "rank per partition desc": "SELECT id, rank() OVER (PARTITION BY g ORDER BY n DESC) AS r FROM t",
    "percent_rank cume_dist": "SELECT id, percent_rank() OVER (PARTITION BY k ORDER BY n) AS p, "
                              "cume_dist() OVER (PARTITION BY k ORDER BY n) AS c FROM t",
    "ntile": "SELECT id, ntile(4) OVER (ORDER BY id) AS q4, ntile(3) OVER (PARTITION BY k ORDER BY id) AS q3 FROM t",
    "ntile more buckets than rows": "SELECT id, ntile(20) OVER (PARTITION BY k ORDER BY id) AS q FROM t",
    "nulls first ascending": "SELECT id, row_number() OVER (ORDER BY v, id) AS r FROM t",
    "nulls last": "SELECT id, row_number() OVER (ORDER BY v DESC NULLS LAST, id) AS r FROM t",
    "two order keys": "SELECT id, rank() OVER (PARTITION BY k ORDER BY g DESC, n) AS r FROM t",
    "no partition": "SELECT id, row_number() OVER (ORDER BY t DESC, id) AS r FROM t",
    # offsets
    "lag lead": "SELECT id, lag(n) OVER (ORDER BY id) AS l1, lead(n) OVER (ORDER BY id) AS f1 FROM t",
    "lag lead by two with default": "SELECT id, lag(n, 2, -1) OVER (PARTITION BY k ORDER BY id) AS l2, "
                                    "lead(s, 2, 'none') OVER (PARTITION BY k ORDER BY id) AS f2 FROM t",
    "lag of an expression": "SELECT id, lag(n * 2 + 1) OVER (PARTITION BY g ORDER BY t) AS l FROM t",
    "lead zero offset": "SELECT id, lead(n, 0) OVER (ORDER BY id) AS f FROM t",
    # value functions
    "first last nth default frame": "SELECT id, first_value(n) OVER (PARTITION BY k ORDER BY t) AS f, "
                                    "last_value(n) OVER (PARTITION BY k ORDER BY t) AS l, "
                                    "nth_value(n, 2) OVER (PARTITION BY k ORDER BY t) AS n2 FROM t",
    "first last nth whole frame":
    "SELECT id, first_value(v) OVER (PARTITION BY k ORDER BY t ROWS BETWEEN UNBOUNDED PRECEDING AND "
    "UNBOUNDED FOLLOWING) AS f, last_value(v) OVER (PARTITION BY k ORDER BY t ROWS BETWEEN UNBOUNDED "
    "PRECEDING AND UNBOUNDED FOLLOWING) AS l, nth_value(v, 2) OVER (PARTITION BY k ORDER BY t ROWS "
    "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS n2 FROM t",
    "last_value over peers": "SELECT id, last_value(id) OVER (ORDER BY n) AS l FROM t",
    "first_value of a literal": "SELECT id, first_value(1) OVER (ORDER BY id) AS f FROM t",
    # aggregates
    "whole partition aggregates": "SELECT id, k, sum(n) OVER (PARTITION BY k) AS s, avg(v) OVER (PARTITION BY k) "
                                  "AS a, count(*) OVER (PARTITION BY k) AS c, min(s) OVER (PARTITION BY k) AS mn, "
                                  "max(t) OVER (PARTITION BY k) AS mx FROM t",
    "running total": "SELECT id, sum(n) OVER (PARTITION BY k ORDER BY t) AS run, count(n) OVER (ORDER BY n) AS c "
                     "FROM t",
    "running moments": "SELECT id, stddev(n) OVER (ORDER BY id) AS sd, variance(n) OVER (PARTITION BY g ORDER BY id) "
                       "AS var FROM t",
    "collect over a window": "SELECT id, collect_list(n) OVER (PARTITION BY g ORDER BY id) AS cl, "
                             "collect_set(s) OVER (PARTITION BY g) AS cs FROM t",
    "rows frame preceding": "SELECT id, avg(n) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS m "
                            "FROM t",
    "rows frame both sides": "SELECT id, sum(n) OVER (PARTITION BY k ORDER BY t ROWS BETWEEN 1 PRECEDING AND "
                             "1 FOLLOWING) AS s FROM t",
    "rows frame following only": "SELECT id, max(v) OVER (ORDER BY id ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING) "
                                 "AS m FROM t",
    "rows frame unbounded following": "SELECT id, count(*) OVER (ORDER BY id ROWS BETWEEN CURRENT ROW AND "
                                      "UNBOUNDED FOLLOWING) AS c FROM t",
    "range frame value offsets": "SELECT id, count(*) OVER (ORDER BY id RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING) "
                                 "AS c, avg(n) OVER (ORDER BY id RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS a "
                                 "FROM t",
    "range frame per partition": "SELECT id, sum(n) OVER (PARTITION BY k ORDER BY t RANGE BETWEEN 2 PRECEDING AND "
                                 "CURRENT ROW) AS s FROM t",
    "range frame descending": "SELECT id, sum(n) OVER (ORDER BY t DESC RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING) "
                              "AS s FROM t",
    "range frame over nulls": "SELECT id, count(*) OVER (ORDER BY n RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) "
                              "AS c FROM t",
    "range unbounded equals running": "SELECT id, sum(n) OVER (ORDER BY t RANGE BETWEEN UNBOUNDED PRECEDING AND "
                                      "CURRENT ROW) AS a, sum(n) OVER (ORDER BY t) AS b FROM t",
    # expressions around and inside windows
    "expression operands": "SELECT id, sum(n * t) OVER (PARTITION BY upper(k) ORDER BY t + id) AS s FROM t",
    "arithmetic over windows": "SELECT id, n - avg(n) OVER (PARTITION BY k) AS dev, "
                               "100 * n / sum(n) OVER (PARTITION BY k) AS pct FROM t",
    "window in case": "SELECT id, CASE WHEN row_number() OVER (PARTITION BY k ORDER BY id) = 1 THEN 'first' "
                      "ELSE 'rest' END AS pos FROM t",
    "window inside a builtin": "SELECT id, coalesce(lag(s) OVER (ORDER BY id), 'start') AS prev FROM t",
    "two windows one item": "SELECT id, rank() OVER (ORDER BY n) + dense_rank() OVER (ORDER BY t) AS x FROM t",
    "star and a window": "SELECT *, row_number() OVER (ORDER BY id DESC) AS r FROM t WHERE id < 5",
    "unaliased window": "SELECT k, sum(n) OVER (PARTITION BY k ORDER BY id ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) "
                        "FROM t",
    # with the rest of the query
    "where before the window": "SELECT id, row_number() OVER (ORDER BY id) AS r FROM t WHERE n > 2",
    "order by a window alias": "SELECT id, rank() OVER (ORDER BY v) AS r FROM t ORDER BY r DESC, id",
    "limit after a window": "SELECT id, sum(n) OVER (ORDER BY id) AS s FROM t LIMIT 5",
    "distinct window values": "SELECT DISTINCT k, count(*) OVER (PARTITION BY k) AS c FROM t",
    "top n per group": "SELECT k, id, r FROM (SELECT k, id, row_number() OVER (PARTITION BY k ORDER BY v DESC, id) "
                       "AS r FROM t) s WHERE r <= 2",
    "top n in a cte": "WITH ranked AS (SELECT k, id, n, rank() OVER (PARTITION BY k ORDER BY n DESC) AS r FROM t) "
                      "SELECT k, id, n FROM ranked WHERE r = 1 ORDER BY k",
    "window over a grouped derived table": "SELECT k, c, rank() OVER (ORDER BY c DESC) AS r FROM "
                                           "(SELECT k, count(*) AS c FROM t GROUP BY k) s",
    "window over a join": "SELECT t.id, d.label, sum(t.n) OVER (PARTITION BY d.label ORDER BY t.id) AS s "
                          "FROM t JOIN d ON t.k = d.k",
    "window over a left join": "SELECT t.id, rank() OVER (PARTITION BY d.w ORDER BY t.t) AS r FROM t "
                               "LEFT JOIN d ON t.k = d.k",
    "window under an alias": "SELECT x.id, lag(x.n) OVER (PARTITION BY x.k ORDER BY x.id) AS l FROM t x",
    "scalar subquery in an operand": "SELECT id, sum(n - (SELECT min(n) FROM t)) OVER (PARTITION BY k) AS s FROM t",
    "window in an in subquery": "SELECT id FROM t WHERE id IN (SELECT lag(id) OVER (ORDER BY id) FROM t)",
    "window in a union": "SELECT id, row_number() OVER (ORDER BY id) AS r FROM t WHERE id < 3 "
                         "UNION ALL SELECT id, rank() OVER (ORDER BY n) AS r FROM t WHERE id > 10",
}


@pytest.mark.parametrize("query", list(QUERIES.values()), ids=list(QUERIES))
def test_window_queries_equal_the_jax_package(contexts, query, monkeypatch):
    assert_same_in_both_arms(contexts, query, monkeypatch)


#: window queries the JAX package refuses; the port fails the same way
REFUSED = {
    "window in where": "SELECT id FROM t WHERE row_number() OVER (ORDER BY id) > 2",
    "window in having": "SELECT k FROM t GROUP BY k HAVING rank() OVER (ORDER BY k) = 1",
    "window in order by": "SELECT id FROM t ORDER BY row_number() OVER (ORDER BY v)",
    "window in a lambda": "SELECT transform(arr, x -> row_number() OVER (ORDER BY id)) FROM t",
    "window with group by": "SELECT k, rank() OVER (ORDER BY k) FROM t GROUP BY k",
    "ranking without order": "SELECT row_number() OVER (PARTITION BY k) FROM t",
    "ranking with an argument": "SELECT rank(n) OVER (ORDER BY n) FROM t",
    "frame on a ranking function": "SELECT rank() OVER (ORDER BY n ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t",
    "frame on lag": "SELECT lag(n) OVER (ORDER BY n ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t",
    "frame without order": "SELECT sum(n) OVER (PARTITION BY k ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t",
    "range with two keys": "SELECT sum(n) OVER (ORDER BY t, id RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t",
    "inverted frame": "SELECT sum(n) OVER (ORDER BY id ROWS BETWEEN 1 FOLLOWING AND 1 PRECEDING) FROM t",
    "ntile zero": "SELECT ntile(0) OVER (ORDER BY id) FROM t",
    "ntile of a column": "SELECT ntile(n) OVER (ORDER BY id) FROM t",
    "nth_value zero": "SELECT nth_value(n, 0) OVER (ORDER BY id) FROM t",
    "lag string offset": "SELECT lag(n, 'x') OVER (ORDER BY id) FROM t",
    "lag column default": "SELECT lag(n, 1, t) OVER (ORDER BY id) FROM t",
    "distinct window aggregate": "SELECT count(DISTINCT n) OVER (PARTITION BY k) FROM t",
    "sum star": "SELECT sum(*) OVER (PARTITION BY k) FROM t",
    "unknown window function": "SELECT upper(s) OVER (PARTITION BY k) FROM t",
    "window without over": "SELECT lag(n) FROM t",
    "ranking without over": "SELECT row_number() FROM t",
    "aggregate in a window key": "SELECT k, rank() OVER (ORDER BY count(*)) FROM t GROUP BY k",
    "generator beside a window": "SELECT explode(arr) AS e, row_number() OVER (ORDER BY id) AS r FROM t",
    "unknown column": "SELECT sum(nope) OVER (PARTITION BY k) FROM t",
}


@pytest.mark.parametrize("query", list(REFUSED.values()), ids=list(REFUSED))
def test_refused_window_queries_fail_as_the_jax_package_fails(contexts, query, monkeypatch):
    got = assert_same_in_both_arms(contexts, query, monkeypatch, want_rows=False)
    assert got[0] == "error", got


def test_a_window_names_no_roadmap_item(contexts):
    """OVER no longer waits for ROADMAP Queue A item 8, and neither does
    pandas: a pandas UDF beside a window gives the JAX package's rows."""
    ours, ref = contexts
    out = ours.sql("SELECT id, row_number() OVER (ORDER BY id) AS r FROM t")
    assert [r["r"] for r in out.collect()] == list(range(1, 15))

    def windowed(ctx, fmod, window):
        plus = fmod.pandas_udf(lambda s: s.map(lambda v: None if v is None else v + 1))
        return ctx.sql("SELECT id FROM t").select(
            "id", plus("id").alias("p"), fmod.row_number().over(window.orderBy("id")).alias("r"))

    assert rows(windowed(ours, F, Window)) == rows(windowed(ref, JF, JaxWindow))
    assert issubclass(UnsupportedSQL, ValueError)


def test_window_ties_and_frames_by_hand(contexts):
    """Spark's rules, computed here without either package: ties share a
    rank and the next rank skips, nulls sort first ascending, and with an
    ORDER BY an aggregate takes the running RANGE frame (peers included)."""
    ours, _ = contexts
    out = rows(ours.sql(
        "SELECT id, n, rank() OVER (ORDER BY n) AS r, sum(n) OVER (ORDER BY n) AS s, "
        "sum(n) OVER () AS total FROM t"))
    ns = [r["n"] for r in out]
    key = [(-1 if x is None else x) for x in ns]
    for r in out:
        kx = -1 if r["n"] is None else r["n"]
        assert r["r"] == 1 + sum(1 for y in key if y < kx)
        frame = [x for x, y in zip(ns, key) if y <= kx and x is not None]
        assert r["s"] == (sum(frame) if frame else None)
        assert r["total"] == sum(x for x in ns if x is not None)


# -- the Column API ------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return DataFrame.fromColumns(facts(), numPartitions=3), JaxDataFrame.fromColumns(facts(), numPartitions=3)


#: Column-API windows: ``build(F, Window, df)``
COLUMN_CASES = {
    "row_number desc": lambda f, w, df: df.withColumn(
        "rn", f.row_number().over(w.partitionBy("k").orderBy(f.col("v").desc(), "id"))),
    "rank dense_rank": lambda f, w, df: df.select(
        "id", f.rank().over(w.orderBy("n")).alias("r"), f.dense_rank().over(w.orderBy("n")).alias("d")),
    "percent_rank cume_dist ntile": lambda f, w, df: df.select(
        "id", f.percent_rank().over(w.partitionBy("g").orderBy("t")).alias("p"),
        f.cume_dist().over(w.partitionBy("g").orderBy("t")).alias("c"),
        f.ntile(3).over(w.partitionBy("g").orderBy("t")).alias("q")),
    "lag lead defaults": lambda f, w, df: df.select(
        "id", f.lag("n").over(w.partitionBy("k").orderBy("id")).alias("l"),
        f.lead("n", 2, -1).over(w.partitionBy("k").orderBy("id")).alias("f")),
    "first last nth": lambda f, w, df: df.select(
        "id", f.first_value("n").over(w.partitionBy("k").orderBy("t")).alias("fv"),
        f.last_value("n").over(w.partitionBy("k").orderBy("t")).alias("lv"),
        f.nth_value("n", 2).over(w.partitionBy("k").orderBy("t")).alias("nv")),
    "value fns whole frame": lambda f, w, df: df.select(
        "id", f.last_value("v").over(w.partitionBy("k").orderBy("t").rowsBetween(
            w.unboundedPreceding, w.unboundedFollowing)).alias("lv")),
    "partition total and fraction": lambda f, w, df: df.select(
        "k", "n", f.sum("n").over(w.partitionBy("k")).alias("tot"),
        (f.col("n") / f.sum("n").over(w.partitionBy("k"))).alias("frac")),
    "running sum": lambda f, w, df: df.withColumn("s", f.sum("n").over(w.partitionBy("k").orderBy("t"))),
    "count star over": lambda f, w, df: df.select("k", f.count("*").over(w.partitionBy("k")).alias("c")),
    "rows moving average": lambda f, w, df: df.withColumn(
        "m", f.avg("v").over(w.partitionBy("k").orderBy("t").rowsBetween(-1, 1))),
    "range explicit equals running": lambda f, w, df: df.withColumn(
        "s", f.sum("n").over(w.partitionBy("k").orderBy("t").rangeBetween(w.unboundedPreceding, w.currentRow))),
    "range value offsets": lambda f, w, df: df.withColumn(
        "s", f.sum("n").over(w.partitionBy("k").orderBy("t").rangeBetween(-2, 0))),
    "range descending": lambda f, w, df: df.withColumn(
        "s", f.sum("n").over(w.orderBy(f.col("t").desc()).rangeBetween(-2, 0))),
    "range following count": lambda f, w, df: df.withColumn(
        "c", f.count("*").over(w.orderBy("t").rangeBetween(0, 3))),
    "range fractional offsets": lambda f, w, df: df.withColumn(
        "c", f.count("*").over(w.orderBy("v").rangeBetween(-0.5, 0))),
    "expression operand": lambda f, w, df: df.withColumn(
        "s", f.sum(f.col("n") * f.col("t")).over(w.partitionBy("k"))),
    "partition by expression": lambda f, w, df: df.withColumn(
        "c", f.count("*").over(w.partitionBy(f.upper(f.col("k"))))),
    "shared spec": lambda f, w, df: df.withColumn(
        "a", f.row_number().over(w.partitionBy("k").orderBy("id"))).withColumn(
        "b", f.row_number().over(w.partitionBy("k").orderBy(f.col("t").desc()))),
    "nulls last ordering": lambda f, w, df: df.select(
        "id", f.row_number().over(w.orderBy(f.col("v").desc_nulls_last(), "id")).alias("r")),
    "window in when": lambda f, w, df: df.select(
        "id", f.when(f.row_number().over(w.partitionBy("k").orderBy("id")) == 1, "first")
        .otherwise("rest").alias("pos")),
    "selectExpr window": lambda f, w, df: df.selectExpr(
        "k", "id", "row_number() OVER (PARTITION BY k ORDER BY id) AS rn", "sum(n) OVER (PARTITION BY k) AS t"),
    "window after a filter": lambda f, w, df: df.filter(f.col("n") > 2).withColumn(
        "r", f.rank().over(w.orderBy("n"))),
    "window then limit": lambda f, w, df: df.withColumn("r", f.row_number().over(w.orderBy("id"))).limit(4),
    # refusals, as the JAX package refuses them
    "unbound window function": lambda f, w, df: df.withColumn("x", f.row_number()),
    "ranking needs order": lambda f, w, df: f.row_number().over(w.partitionBy("k")),
    "ranking refuses a frame": lambda f, w, df: f.row_number().over(w.orderBy("n").rowsBetween(-1, 1)),
    "window in filter": lambda f, w, df: df.filter(f.row_number().over(w.orderBy("id")) == 1),
    "distinct aggregate": lambda f, w, df: f.countDistinct("n").over(w.partitionBy("k")),
    "over needs a spec": lambda f, w, df: f.row_number().over("k"),
    "over on a plain column": lambda f, w, df: f.col("n").over(w.partitionBy("k")),
    "rebinding": lambda f, w, df: f.row_number().over(w.orderBy("n")).over(w.orderBy("t")),
    "range with two keys": lambda f, w, df: f.sum("n").over(w.orderBy("t", "n").rangeBetween(-1, 0)),
    "percentile over": lambda f, w, df: f.percentile_approx("n", 0.5).over(w.partitionBy("k")),
    "generator beside a window": lambda f, w, df: df.select(
        f.sum("n").over(w.partitionBy("k")).alias("s"), f.explode("arr")),
    "window in orderBy": lambda f, w, df: df.orderBy(f.row_number().over(w.orderBy("id"))),
}


@pytest.mark.parametrize("name", list(COLUMN_CASES))
def test_column_api_windows_equal_the_jax_package(frames, name):
    ours, ref = frames
    build = COLUMN_CASES[name]

    def run(f, w, df):
        out = build(f, w, df)
        return out if hasattr(out, "collect") else DataFrame.fromColumns({"spec": [repr(type(out))]})

    got = outcome(lambda: run(F, Window, ours))
    want = outcome(lambda: run(JF, JaxWindow, ref))
    if want[0] == "rows":
        assert got == want
    else:
        assert got[0] == "error" and got[1][0] == want[1][0], (got, want)
        assert got[1][1] == want[1][1]


#: the same window through SQL text and through the Column API
SURFACES = [
    ("SELECT id, row_number() OVER (PARTITION BY k ORDER BY v DESC, id) AS r FROM t",
     lambda df: df.select("id", F.row_number().over(Window.partitionBy("k").orderBy(F.col("v").desc(), "id"))
                          .alias("r"))),
    ("SELECT id, lag(n, 2, 0) OVER (ORDER BY id) AS l FROM t",
     lambda df: df.select("id", F.lag("n", 2, 0).over(Window.orderBy("id")).alias("l"))),
    ("SELECT id, avg(n) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS m FROM t",
     lambda df: df.select("id", F.avg("n").over(Window.orderBy("id").rowsBetween(-2, 0)).alias("m"))),
    ("SELECT id, count(*) OVER (ORDER BY t RANGE BETWEEN 2 PRECEDING AND 2 FOLLOWING) AS c FROM t",
     lambda df: df.select("id", F.count("*").over(Window.orderBy("t").rangeBetween(-2, 2)).alias("c"))),
    ("SELECT id, nth_value(s, 2) OVER (PARTITION BY g ORDER BY id) AS x FROM t",
     lambda df: df.select("id", F.nth_value("s", 2).over(Window.partitionBy("g").orderBy("id")).alias("x"))),
]


@pytest.mark.parametrize("i", range(len(SURFACES)))
def test_sql_and_column_api_windows_agree(contexts, frames, i):
    query, build = SURFACES[i]
    ours, _ = contexts
    assert rows(ours.sql(query)) == rows(build(frames[0]))


def test_window_spec_builders():
    """``Window``'s constants are pyspark's, specs are immutable, and the
    spec's frame reads as the JAX package's does."""
    base = Window.partitionBy("k")
    w1 = base.orderBy("v").rowsBetween(-3, Window.currentRow)
    assert isinstance(w1, WindowSpec) and base._order_by == [] and w1._frame == (-3, 0)
    jw1 = JaxWindow.partitionBy("k").orderBy("v").rowsBetween(-3, JaxWindow.currentRow)
    assert (w1._partition_by, w1._order_by, w1._frame, w1._frame_kind) == (
        jw1._partition_by, jw1._order_by, jw1._frame, jw1._frame_kind)
    assert (Window.unboundedPreceding, Window.unboundedFollowing, Window.currentRow) == (
        JaxWindow.unboundedPreceding, JaxWindow.unboundedFollowing, JaxWindow.currentRow)
    r = Window.orderBy("t").rangeBetween(Window.unboundedPreceding, 5)
    jr = JaxWindow.orderBy("t").rangeBetween(JaxWindow.unboundedPreceding, 5)
    assert (r._frame, r._frame_kind) == (jr._frame, jr._frame_kind)
    import sparkdl_tpu_torch

    assert sparkdl_tpu_torch.Window is Window and sparkdl_tpu_torch.WindowSpec is WindowSpec


def test_no_hidden_columns_leak(frames):
    ours, ref = frames
    for df, f, w in ((ours, F, Window), (ref, JF, JaxWindow)):
        out = df.withColumn("rn", f.row_number().over(w.partitionBy("k").orderBy("id")))
        assert out.columns == list(facts()) + ["rn"]
        assert df.select(f.sum(f.col("n") * 2).over(w.partitionBy("k")).alias("s")).columns == ["s"]


def test_a_reused_window_column_resolves_again(frames):
    ours, _ = frames
    c = F.sum(F.col("n") + 0).over(Window.partitionBy("k"))
    assert rows(ours.withColumn("s", c)) == rows(ours.withColumn("s", c))


# -- pushdown and model UDFs ------------------------------------------------------------


def test_a_window_over_a_join_keeps_its_columns_on_the_pruning_arm(contexts, monkeypatch):
    """The optimizer arm prunes each join input to what the query reads,
    a window's argument, PARTITION BY and ORDER BY operands included: the
    rows equal the JAX package's (which prunes no join) and the row arm's."""
    query = ("SELECT t.id, d.label, rank() OVER (PARTITION BY t.g ORDER BY t.t DESC) AS r, "
             "sum(t.n) OVER (PARTITION BY d.label) AS s FROM t JOIN d ON t.k = d.k")
    ours, _ = contexts
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    metrics.reset()
    ours.sql(query).collect()
    assert metrics.counter("sql.pushdown.pruned_cols") > 0
    assert_same_in_both_arms(contexts, query, monkeypatch)


def _udf_table():
    n = 14
    return {
        "vec": [None if i % 5 == 0 else np.full(4, float((i * 7) % 11 - 4), dtype=np.float32) for i in range(n)],
        "k": [("a", "b", "c")[i % 3] for i in range(n)],
        "id": list(range(n)),
    }


@pytest.fixture(scope="module")
def udf_contexts():
    """``vsum``: a vector cell's sum as a 1-vector, a model UDF in both
    packages, batch 8 (a partition's rows: one dispatch per partition in
    each package)."""
    jax_udf.registerModelUDF(
        "vsum",
        ModelIngest.from_callable(lambda x: x.reshape(x.shape[0], -1).sum(axis=1, keepdims=True), input_shape=(4,)),
        batch_size=8,
    )
    mf = ModelFunction(
        lambda _m, x: x.reshape(x.shape[0], -1).sum(dim=1, keepdim=True),
        torch.nn.Module(), torch.device("cpu"), name="vsum", input_shape=(4,),
    )
    udf_catalog.registerModelUDF("vsum", mf, batch_size=8, device="cpu")
    ours, ref = SQLContext(), JaxSQLContext()
    for ctx, cls in ((ours, DataFrame), (ref, JaxDataFrame)):
        ctx.registerDataFrameAsTable(cls.fromColumns(_udf_table(), numPartitions=3), "u")
    yield ours, ref
    jax_udf.unregister("vsum")
    udf_catalog.unregister("vsum")


UDF_QUERIES = {
    "udf in a window order key": "SELECT id, rank() OVER (PARTITION BY k ORDER BY element_at(vsum(vec), 1) DESC) "
                                 "AS r FROM u",
    "udf in a window argument": "SELECT id, sum(element_at(vsum(vec), 1)) OVER (PARTITION BY k ORDER BY id) AS s "
                                "FROM u",
    "udf in a partition key": "SELECT id, count(*) OVER (PARTITION BY sign(element_at(vsum(vec), 1))) AS c FROM u",
}


@pytest.mark.parametrize("query", list(UDF_QUERIES.values()), ids=list(UDF_QUERIES))
def test_a_model_udf_inside_a_window_runs_batched(udf_contexts, query, monkeypatch):
    """Rows equal in both arms; on the optimizer arm the UDF inside the
    window's operand dispatches in as many batches as the JAX package's,
    never once per row (one feeder pipeline per partition, as
    ``tests/test_torch_sql_relational.py`` compares them)."""
    assert_same_in_both_arms(udf_contexts, query, monkeypatch)
    ours, ref = udf_contexts
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "0")
    counts = []
    for ctx, reg in ((ours, metrics), (ref, jax_metrics)):
        reg.reset()
        ctx.sql(query).collect()
        counts.append((reg.counter("sql.udf.batches"), reg.counter("sql.udf.batch_rows")))
    assert counts[0] == counts[1]
    batches, batch_rows = counts[0]
    assert 0 < batches < batch_rows


def test_the_window_engine_honours_the_collect_guard(contexts, monkeypatch):
    """A window collects its frame to the host: past
    ``SPARKDL_DRIVER_COLLECT_MAX_ROWS`` source rows it fails fast, as the
    JAX package's does; 0 turns the guard off."""
    ours, ref = contexts
    monkeypatch.setenv("SPARKDL_DRIVER_COLLECT_MAX_ROWS", "5")
    query = "SELECT id, row_number() OVER (ORDER BY id) AS r FROM t"
    for ctx in (ours, ref):
        with pytest.raises(ValueError, match="SPARKDL_DRIVER_COLLECT_MAX_ROWS"):
            ctx.sql(query).collect()
    monkeypatch.setenv("SPARKDL_DRIVER_COLLECT_MAX_ROWS", "0")
    assert outcome(lambda: ours.sql(query)) == outcome(lambda: ref.sql(query))


# -- the slice: bert-tiny scores through windows ----------------------------------------


def test_bert_tiny_scores_through_windows_equal_the_jax_package():
    """bert-tiny embeddings (the JAX weights carried across) through both
    packages' TextEmbedder, then windows over the scores on each: ranks and
    row numbers equal exactly (the scores' order agrees), window aggregates
    within 1e-5 relative (the embeddings differ by float32 rounding between
    XLA and torch)."""
    import jax

    from sparkdl_tpu.models import get_model as jax_get_model
    from sparkdl_tpu.transformers.text import TextEmbedder as JaxTextEmbedder
    from sparkdl_tpu_torch.models import get_model
    from sparkdl_tpu_torch.transformers.text import TextEmbedder

    rng = np.random.default_rng(20)
    texts = [" ".join(f"w{int(x)}" for x in rng.integers(0, 50, size=int(n))) for n in rng.integers(2, 30, 24)]
    topics = [None if i % 7 == 0 else f"t{i % 4}" for i in range(len(texts))]
    cols = {"id": list(range(len(texts))), "text": texts, "topic": topics}
    jax_mf = jax_get_model("bert-tiny").model_function()
    params = jax.tree_util.tree_map(np.asarray, jax_mf.params)
    port_mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    query = """
        WITH scored AS (SELECT id, topic, text, element_at(emb, 1) - element_at(emb, 2) AS score FROM emb)
        SELECT id, topic,
               row_number() OVER (PARTITION BY topic ORDER BY score DESC, id) AS rn,
               lag(id, 1, -1) OVER (ORDER BY id) AS prev,
               avg(score) OVER (PARTITION BY topic ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS run,
               score - avg(score) OVER (PARTITION BY topic) AS dev,
               w
        FROM scored LATERAL VIEW explode(split(text, ' ')) e AS w
        WHERE w = 'w3' OR id < 3
        ORDER BY id, w
    """
    out = []
    for ctx_cls, frame_cls, embedder, mf in (
        (SQLContext, DataFrame, TextEmbedder, port_mf), (JaxSQLContext, JaxDataFrame, JaxTextEmbedder, jax_mf),
    ):
        embedded = embedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=64).transform(
            frame_cls.fromColumns(cols, numPartitions=3))
        ctx = ctx_cls()
        ctx.registerDataFrameAsTable(embedded, "emb")
        out.append(rows(ctx.sql(query)))
    ours, ref = out
    assert len(ours) == len(ref) >= 10
    for a, b in zip(ours, ref):
        assert (a["id"], a["topic"], a["rn"], a["prev"], a["w"]) == (b["id"], b["topic"], b["rn"], b["prev"], b["w"])
        for key in ("run", "dev"):
            assert a[key] == pytest.approx(b[key], rel=1e-5, abs=1e-6), key


def test_chip_smoke_phase_25_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 25 at cut sizes on the CPU: bert-tiny over
    24 texts, every query on both surfaces and every numpy check of the
    card's run (no flash launch on the CPU)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "W_TEXT_MODEL", "bert-tiny")
    monkeypatch.setattr(chip_smoke, "W_TEXTS", 24)
    monkeypatch.setattr(chip_smoke, "W_MAX_LENGTH", 128)
    assert chip_smoke.phase_windows(0, "cpu", device="cpu") == 0
