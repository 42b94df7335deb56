"""The relational core of the port's SQL dialect (``sparkdl_tpu_torch/sql.py``)
against the JAX package's ``sql.py`` on the CPU.

- Every construct of the relational core: WITH and its CTEs, GROUP BY (by
  column, expression, alias and ordinal), ROLLUP, CUBE and GROUPING SETS,
  every aggregate with DISTINCT and FILTER, HAVING, ORDER BY an aggregate,
  INNER, LEFT, RIGHT, FULL OUTER, LEFT SEMI, LEFT ANTI, CROSS and comma
  joins, self-joins under aliases, derived tables, scalar, IN and EXISTS
  subqueries, UNION [ALL], INTERSECT, EXCEPT and MINUS, SELECT DISTINCT,
  LIMIT ... OFFSET and FROM-less SELECT. Each query runs through both
  packages and both ``SPARKDL_SQL_VECTORIZE`` arms over the same tables
  (NULL and NaN cells, duplicate and NULL keys, three partitions).
- Rows are compared exactly (NaN equal to NaN, arrays as lists) and IN
  ORDER: the JAX package fixes every order here (groups in first-appearance
  order, grouping sets in their order, join output left-major with each
  left row's matches in right order and a full join's unmatched right rows
  last, set operations and DISTINCT in first-occurrence order). No float
  tolerance: the aggregate accumulators are the JAX package's, copied, so
  avg, stddev, the moments and the percentiles are bit-equal.
- A query the JAX package refuses, the port refuses with the same error.
- A model UDF inside GROUP BY, an aggregate, a join input and an IN
  subquery runs batched, with ``sql.udf.batches`` equal in both packages.
- Pushdown keeps join keys and the columns a subquery reads, and prunes
  each join input to what the query reads.
- The slice: bert-tiny embeddings through the port and the JAX package with
  the same weights, then the same relational query on each.
"""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.sql import SQLContext as JaxSQLContext
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.sql import SQLContext
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_sql_windows import unknown_as_one

NAN = float("nan")


def facts():
    """Twelve rows over three partitions: duplicate and NULL keys, NULL and
    NaN values, negatives."""
    return {
        "id": list(range(12)),
        "k": ["a", "b", None, "a", "c", "b", "a", None, "d", "c", "a", "b"],
        "g": [1, 2, 1, None, 2, 1, 3, 2, None, 1, 3, 2],
        "v": [1.5, -2.0, NAN, None, 4.25, 0.5, -1.0, 3.0, None, 2.5, 7.0, -0.75],
        "n": [3, None, 7, 1, 1, 4, 9, None, 2, 6, 3, 5],
        "s": ["x", "y", "x", None, "z", "y", "x", "w", "z", None, "y", "x"],
        "flag": [True, False, None, True, True, False, None, False, True, True, False, True],
    }


def dims():
    """The dimension table: key "d" of ``facts`` is missing, key "e" has no
    fact, and one key is NULL."""
    return {
        "k": ["a", "b", "c", "e", None],
        "label": ["alpha", "beta", "gamma", "eps", "nil"],
        "w": [10, 20, None, 40, 50],
    }


def emps():
    return {
        "id": [1, 2, 3, 4, 5],
        "name": ["ann", "bob", "cy", "dee", "eve"],
        "mgr": [None, 1, 1, 2, None],
    }


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


def _failure(e: BaseException) -> tuple:
    """An error as both packages can be compared on it: the class name and
    the message, past a partition task's retry preamble."""
    return type(e).__name__, str(e).rpartition("attempts: ")[2]


def outcome(run):
    """``("rows", [...])`` or ``("error", (class, message))``."""
    try:
        return "rows", rows(run())
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return "error", _failure(e)


def _register(ctx, frame_cls, n_parts=3):
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(facts(), numPartitions=n_parts), "t")
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(dims(), numPartitions=2), "d")
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(emps(), numPartitions=2), "emp")
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


#: every query of the relational core; rows compared in order (module doc)
QUERIES = {
    # grouping and every aggregate
    "group by count": "SELECT k, count(*) AS c, count(v) AS cv, count(n) FROM t GROUP BY k",
    "group by avg min max": "SELECT k, avg(v), min(v), max(v), sum(n) FROM t GROUP BY k",
    "group by moments": "SELECT g, stddev(v), variance(n), stddev_pop(n), var_pop(v), stddev_samp(n), "
                        "var_samp(n), skewness(n), kurtosis(n) FROM t GROUP BY g",
    "group by distinct": "SELECT g, count(DISTINCT k) AS dk, sum(DISTINCT n) AS sn, "
                         "approx_count_distinct(s) AS ac FROM t GROUP BY g",
    "percentiles": "SELECT k, percentile_approx(n, 0.5) AS p50, percentile(n, 0.25), "
                   "percentile_approx(n, array(0.1, 0.9)) AS p19, median(n) FROM t GROUP BY k",
    "collections": "SELECT k, collect_list(n), collect_set(s), first(s), last(s), any_value(n), "
                   "mode(s) FROM t GROUP BY k",
    "co-statistics": "SELECT g, corr(n, v), covar_pop(n, id), covar_samp(id, n) FROM t GROUP BY g",
    "boolean aggregates": "SELECT k, bool_and(flag), bool_or(n > 4), every(id < 10), count_if(n > 2) "
                          "FROM t GROUP BY k",
    "filter clause": "SELECT k, count(*) FILTER (WHERE n > 2) AS big, sum(n) FILTER (WHERE s = 'x') AS sx, "
                     "count(DISTINCT s) FILTER (WHERE g = 1) AS d1 FROM t GROUP BY k",
    "global aggregate": "SELECT count(*), sum(n), avg(v), max(s) FROM t",
    "global aggregate over no rows": "SELECT count(*), sum(n), avg(v), collect_list(n) FROM t WHERE id > 99",
    "group by no rows": "SELECT k, count(*) FROM t WHERE id > 99 GROUP BY k",
    "group by two keys": "SELECT k, g, count(*) AS c FROM t GROUP BY k, g ORDER BY c DESC, k, g",
    "group by expression": "SELECT upper(k) AS uk, count(*) FROM t GROUP BY upper(k)",
    "group by alias": "SELECT n % 3 AS r, sum(id) FROM t GROUP BY r",
    "group by ordinal": "SELECT s, max(id) FROM t GROUP BY 1",
    "group key not selected": "SELECT count(*) AS c FROM t GROUP BY k ORDER BY k",
    "arithmetic over aggregates": "SELECT k, sum(n) * 10 + count(*) AS x, max(id) - min(id) AS span "
                                  "FROM t GROUP BY k",
    "case over aggregates": "SELECT k, CASE WHEN count(*) > 2 THEN 'many' ELSE 'few' END AS size "
                            "FROM t GROUP BY k",
    "aggregate of an expression": "SELECT g, sum(n * id) AS w, avg(coalesce(v, 0.0)) AS av FROM t GROUP BY g",
    "having": "SELECT k, count(*) AS c FROM t GROUP BY k HAVING count(*) > 2",
    "having on an alias": "SELECT k, sum(n) AS s FROM t GROUP BY k HAVING s > 5 ORDER BY s DESC",
    "having on a hidden aggregate": "SELECT k FROM t GROUP BY k HAVING max(v) > 2.0 OR min(n) < 2",
    "having without group by": "SELECT count(*) AS c FROM t HAVING c > 1",
    "order by an aggregate": "SELECT k, count(*) FROM t GROUP BY k ORDER BY count(*) DESC, k",
    "order by an aggregate expression": "SELECT g FROM t GROUP BY g ORDER BY sum(n) / count(*) DESC NULLS LAST",
    "distinct over groups": "SELECT DISTINCT g FROM t GROUP BY g, k",
    "rollup": "SELECT k, g, count(*) AS c, sum(n) FROM t GROUP BY ROLLUP(k, g)",
    "cube": "SELECT k, s, count(*) FROM t WHERE id < 8 GROUP BY CUBE(k, s) ORDER BY k, s",
    "grouping sets": "SELECT k, g, avg(n) FROM t GROUP BY GROUPING SETS ((k, g), (k), ())",
    "rollup with having": "SELECT g, count(*) AS c FROM t GROUP BY ROLLUP(g) HAVING c > 2",
    # joins
    "inner join": "SELECT t.id, t.k, d.label FROM t JOIN d ON t.k = d.k",
    "inner join explicit": "SELECT id, label, w FROM t INNER JOIN d ON t.k = d.k WHERE w > 10",
    "left join": "SELECT t.id, t.k, d.label FROM t LEFT JOIN d ON t.k = d.k",
    "left outer join": "SELECT id, w FROM t LEFT OUTER JOIN d ON t.k = d.k ORDER BY id DESC",
    "right join": "SELECT t.id, d.k, d.label FROM t RIGHT JOIN d ON t.k = d.k",
    "full outer join": "SELECT t.id, t.k, d.label, d.w FROM t FULL OUTER JOIN d ON t.k = d.k",
    "full join": "SELECT id, label FROM t FULL JOIN d ON t.k = d.k",
    "left semi join": "SELECT id, k FROM t LEFT SEMI JOIN d ON t.k = d.k",
    "left anti join": "SELECT id, k FROM t LEFT ANTI JOIN d ON t.k = d.k",
    "reversed on": "SELECT id, label FROM t JOIN d ON d.k = t.k",
    "cross join": "SELECT e.name, d.label FROM emp e CROSS JOIN d WHERE e.id < 3",
    "comma join": "SELECT e.name, d.k FROM emp e, d WHERE d.w > 30",
    "self join": "SELECT e.name, m.name FROM emp e JOIN emp m ON e.mgr = m.id",
    "self join star": "SELECT * FROM emp e LEFT JOIN emp m ON e.mgr = m.id",
    "join chain": "SELECT a.id, label, b.id FROM t a JOIN d ON a.k = d.k JOIN t b ON a.id = b.n",
    "join a derived table": "SELECT t.id, c.n FROM t JOIN (SELECT k, count(*) AS n FROM t GROUP BY k) c "
                            "ON t.k = c.k",
    "join then group": "SELECT d.label, count(*) AS c, sum(t.n) FROM t JOIN d ON t.k = d.k "
                       "GROUP BY d.label ORDER BY c DESC",
    "join on null keys": "SELECT a.id, b.id FROM t a JOIN t b ON a.g = b.g WHERE a.id < 3",
    # subqueries
    "scalar subquery": "SELECT id, v FROM t WHERE v > (SELECT avg(v) FROM t WHERE v = v)",
    "scalar subquery item": "SELECT id, n - (SELECT min(n) FROM t) AS above FROM t",
    "scalar subquery of no rows": "SELECT id, (SELECT max(n) FROM t WHERE id > 99) AS m FROM t LIMIT 2",
    "in subquery": "SELECT id, k FROM t WHERE k IN (SELECT k FROM d WHERE w >= 20)",
    "not in subquery with a null": "SELECT id FROM t WHERE k NOT IN (SELECT k FROM d)",
    "not in subquery": "SELECT id FROM t WHERE g NOT IN (SELECT n FROM t WHERE n > 2)",
    "exists": "SELECT id FROM t WHERE EXISTS (SELECT k FROM d WHERE label = 'eps')",
    "not exists": "SELECT id FROM t WHERE NOT EXISTS (SELECT k FROM d WHERE w > 100) AND id < 4",
    "in subquery in case": "SELECT id, CASE WHEN k IN (SELECT k FROM d) THEN 'dim' ELSE 'no' END AS m FROM t",
    "derived table": "SELECT s.k, s.c FROM (SELECT k, count(*) AS c FROM t GROUP BY k) s WHERE s.c > 1",
    "derived table of a union": "SELECT u.k FROM (SELECT k FROM t UNION SELECT k FROM d) u ORDER BY u.k",
    # CTEs
    "cte": "WITH c AS (SELECT k, count(*) AS n FROM t GROUP BY k) SELECT * FROM c WHERE n > 2",
    "chained ctes": "WITH a AS (SELECT k, n FROM t WHERE n IS NOT NULL), b AS (SELECT k, sum(n) AS s FROM a "
                    "GROUP BY k) SELECT b.k, b.s, d.label FROM b LEFT JOIN d ON b.k = d.k",
    "cte shadows a table": "WITH d AS (SELECT k, id FROM t WHERE id < 3) SELECT * FROM d",
    # set operations
    "union": "SELECT k FROM t UNION SELECT k FROM d",
    "union all": "SELECT k, n FROM t UNION ALL SELECT k, w FROM d",
    "intersect": "SELECT k FROM t INTERSECT SELECT k FROM d",
    "except": "SELECT k FROM t EXCEPT SELECT k FROM d",
    "minus": "SELECT s FROM t MINUS SELECT s FROM t WHERE g = 1",
    "set operation precedence": "SELECT k FROM t UNION SELECT k FROM d INTERSECT SELECT k FROM t WHERE n > 3",
    "set operation order and limit": "SELECT k, id FROM t WHERE n > 2 UNION ALL SELECT k, w FROM d "
                                     "ORDER BY 2 DESC LIMIT 5",
    "positional renaming": "SELECT n, k FROM t UNION ALL SELECT w, label FROM d",
    # DISTINCT, LIMIT and OFFSET
    "distinct": "SELECT DISTINCT k FROM t",
    "distinct pair ordered": "SELECT DISTINCT k, g FROM t ORDER BY g DESC, k",
    "distinct star": "SELECT DISTINCT * FROM emp",
    "distinct limit": "SELECT DISTINCT s FROM t ORDER BY s DESC LIMIT 2",
    "limit offset": "SELECT id FROM t ORDER BY id LIMIT 4 OFFSET 3",
    "offset only": "SELECT id, k FROM t ORDER BY n DESC OFFSET 9",
    "offset over a union": "SELECT k FROM t UNION ALL SELECT k FROM d LIMIT 3 OFFSET 14",
    "offset on a group": "SELECT k, count(*) FROM t GROUP BY k ORDER BY k LIMIT 2 OFFSET 1",
    # FROM-less
    "from-less select": "SELECT 1 + 2 AS x, 'y' AS y, upper('q')",
    "from-less aggregate": "SELECT count(*) AS c",
}


@pytest.mark.parametrize("query", list(QUERIES.values()), ids=list(QUERIES))
def test_relational_queries_equal_the_jax_package(contexts, query, monkeypatch):
    assert_same_in_both_arms(contexts, query, monkeypatch)


#: queries the JAX package refuses: the port refuses them with its error
ERRORS = {
    "item not grouped": "SELECT k, n FROM t GROUP BY k",
    "nested aggregate": "SELECT sum(max(n)) FROM t",
    "aggregate in where": "SELECT k FROM t WHERE sum(n) > 1",
    "having without an aggregate": "SELECT k FROM t HAVING n > 1",
    "distinct in avg": "SELECT avg(DISTINCT n) FROM t",
    "star of sum": "SELECT sum(*) FROM t",
    "ambiguous column": "SELECT id FROM t a JOIN t b ON a.id = b.n",
    "table twice": "SELECT id FROM t JOIN t ON t.k = t.k",
    "unknown join key": "SELECT id FROM t JOIN d ON t.nope = d.k",
    "union arity": "SELECT k, n FROM t UNION SELECT k FROM d",
    "scalar subquery of two rows": "SELECT (SELECT k FROM d) FROM t",
    "in subquery of two columns": "SELECT id FROM t WHERE k IN (SELECT k, w FROM d)",
    "order inside a union branch": "SELECT k FROM t ORDER BY k UNION SELECT k FROM d",
    "distinct order by a hidden column": "SELECT DISTINCT k FROM t ORDER BY n",
    "except all": "SELECT k FROM t EXCEPT ALL SELECT k FROM d",
    "derived table without alias in a join": "SELECT id FROM t JOIN (SELECT k FROM d) ON t.k = k",
    "group by an aggregate": "SELECT count(*) FROM t GROUP BY sum(n)",
    "group by ordinal out of range": "SELECT k FROM t GROUP BY 3",
    "unknown having reference": "SELECT k FROM t GROUP BY k HAVING bogus > 1",
    "duplicate cte": "WITH a AS (SELECT k FROM t), a AS (SELECT k FROM d) SELECT * FROM a",
    "qualified star in a join": "SELECT t.* FROM t JOIN d ON t.k = d.k",
}


@pytest.mark.parametrize("query", list(ERRORS.values()), ids=list(ERRORS))
def test_refused_queries_fail_as_the_jax_package_fails(contexts, query, monkeypatch):
    kind, _ = assert_same_in_both_arms(contexts, query, monkeypatch, want_rows=False)
    assert kind == "error"


#: what stays refused: windows, generators and LATERAL VIEW
#: windows and generators, refused here until they were ported: now the
#: JAX package's rows, or its failure
STILL_REFUSED = {
    "window": "SELECT k, sum(n) OVER (PARTITION BY k) FROM t",
    "ranking": "SELECT row_number() OVER (ORDER BY id) FROM t",
    "window over a group": "SELECT k, rank() OVER (ORDER BY count(*)) FROM t GROUP BY k",
    "lateral view": "SELECT id FROM t LATERAL VIEW explode(array(n)) e AS x",
    "explode": "SELECT explode(array(n, g)) FROM t",
    "generator in a cte": "WITH c AS (SELECT posexplode(array(n)) FROM t) SELECT * FROM c",
    "window in a subquery": "SELECT id FROM t WHERE n IN (SELECT lag(n) OVER (ORDER BY id) FROM t)",
}



@pytest.mark.parametrize("query", list(STILL_REFUSED.values()), ids=list(STILL_REFUSED))
def test_windows_and_generators_still_name_item_8(contexts, query, monkeypatch):
    """These raised UnsupportedSQL naming ROADMAP Queue A item 8 (the test
    keeps its name): now each gives the JAX package's rows, or fails as it
    fails, in both arms, and none waits for item 8."""
    ours, ref = contexts
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        got = unknown_as_one(outcome(lambda: ours.sql(query)))
        assert got == unknown_as_one(outcome(lambda: ref.sql(query)))
        assert "ROADMAP Queue A item 8" not in str(got)


def test_join_output_names_and_nulls(contexts):
    """FULL OUTER fills each side with NULL; colliding self-join names keep
    the alias qualifier, and the original table name is not addressable
    under an alias — all as the JAX package has it."""
    ours, ref = contexts
    q = "SELECT * FROM emp e FULL OUTER JOIN emp m ON e.mgr = m.id"
    assert ours.sql(q).columns == ref.sql(q).columns == ["id", "e.name", "e.mgr", "m.name", "m.mgr"]
    assert rows(ours.sql(q)) == rows(ref.sql(q))
    full = rows(ours.sql("SELECT t.id, d.k, d.label FROM t FULL OUTER JOIN d ON t.k = d.k"))
    assert [r for r in full if r["id"] is None] == [
        {"id": None, "k": "e", "label": "eps"}, {"id": None, "k": None, "label": "nil"}]
    assert outcome(lambda: ours.sql("SELECT emp.name FROM emp e")) == outcome(
        lambda: ref.sql("SELECT emp.name FROM emp e"))


def test_rollup_nulls_are_not_data_nulls(contexts):
    """ROLLUP's subtotal rows carry NULL keys; a NULL key in the data makes
    a group of its own, and the two stay apart."""
    ours, _ = contexts
    got = rows(ours.sql("SELECT k, count(*) AS c FROM t GROUP BY ROLLUP(k)"))
    assert got[:5] == [{"k": "a", "c": 4}, {"k": "b", "c": 3}, {"k": None, "c": 2}, {"k": "c", "c": 2},
                       {"k": "d", "c": 1}]
    assert got[5:] == [{"k": None, "c": 12}]


def test_offset_raises_the_limit_then_skips(contexts):
    ours, _ = contexts
    every = [r["id"] for r in rows(ours.sql("SELECT id FROM t ORDER BY v DESC NULLS LAST, id"))]
    got = [r["id"] for r in rows(ours.sql("SELECT id FROM t ORDER BY v DESC NULLS LAST, id LIMIT 3 OFFSET 2"))]
    assert got == every[2:5]


# -- model UDFs inside the relational constructs --------------------------------------


def _udf_table():
    n = 14
    return {
        "vec": [None if i % 5 == 0 else np.full(4, float(i - 4), dtype=np.float32) for i in range(n)],
        "k": [("a", "b", "c")[i % 3] for i in range(n)],
        "id": list(range(n)),
    }


@pytest.fixture(scope="module")
def udf_contexts():
    """``vsum``: a vector cell's sum as a 1-vector, a model UDF in both
    packages. Batch 8 holds a partition's rows, so each package dispatches
    once per partition: the JAX package's global batch spans its eight
    virtual devices, and a smaller batch would count differently there."""
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
        ctx.registerDataFrameAsTable(cls.fromColumns(dims(), numPartitions=2), "d")
    yield ours, ref
    jax_udf.unregister("vsum")
    udf_catalog.unregister("vsum")


UDF_QUERIES = {
    "udf in an aggregate": "SELECT k, count(*) AS c, avg(element_at(vsum(vec), 1)) AS a, "
                           "max(element_at(vsum(vec), 1)) AS m FROM u GROUP BY k",
    "udf in a group key": "SELECT CASE WHEN element_at(vsum(vec), 1) > 10 THEN 'big' ELSE 'small' END AS size, "
                          "count(*) FROM u GROUP BY CASE WHEN element_at(vsum(vec), 1) > 10 THEN 'big' "
                          "ELSE 'small' END",
    "udf in a join input": "SELECT s.id, s.p, d.label FROM (SELECT id, k, vsum(vec) AS p FROM u) s "
                           "JOIN d ON s.k = d.k",
    "udf in an in subquery": "SELECT id, k FROM u WHERE id IN (SELECT id FROM u WHERE element_at(vsum(vec), 1) > 8)",
    "udf after a join": "SELECT u.id, vsum(u.vec) AS p FROM u LEFT JOIN d ON u.k = d.k WHERE d.w > 10",
    "udf in a cte": "WITH s AS (SELECT k, vsum(vec) AS p FROM u WHERE id < 9) "
                    "SELECT k, collect_list(element_at(p, 1)) FROM s GROUP BY k",
}


@pytest.mark.parametrize("query", list(UDF_QUERIES.values()), ids=list(UDF_QUERIES))
def test_a_model_udf_inside_relational_queries(udf_contexts, query, monkeypatch):
    """Rows equal in both arms; on the optimizer arm the UDF dispatches in
    batches, as many as the JAX package's, never one call per row. The
    count is compared with one feeder pipeline per partition: the shared
    feeder packs concurrent partitions' rows into batches of the UDF's
    batch size here and into global batches over eight virtual devices in
    the JAX package."""
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


# -- pushdown ----------------------------------------------------------------------------


class CountingCells(list):
    """A column whose element reads (by index or by iteration) are
    counted."""

    reads = 0

    def __getitem__(self, i):
        if isinstance(i, int):
            CountingCells.reads += 1
        return list.__getitem__(self, i)

    def __iter__(self):
        CountingCells.reads += len(self)
        return list.__iter__(self)


def _probe_frame():
    parts = []
    for p in range(3):
        base = 4 * p
        parts.append({
            "id": [base + i for i in range(4)],
            "k": [("a", "b", "c", None)[i] for i in range(4)],
            "img": CountingCells(f"payload-{base + i}" for i in range(4)),
        })
    return DataFrame(parts, ["id", "k", "img"])


@pytest.mark.parametrize("query", [
    "SELECT p.id, d.label FROM p JOIN d ON p.k = d.k",
    "SELECT label, count(*) FROM p LEFT JOIN d ON p.k = d.k GROUP BY label",
    "SELECT id FROM p WHERE k IN (SELECT k FROM p WHERE id > 5)",
    "SELECT a.id, b.id FROM p a JOIN p b ON a.id = b.id",
])
def test_pushdown_keeps_join_keys_and_prunes_join_inputs(query, monkeypatch):
    """On the optimizer arm a join input and a subquery scan only what the
    query reads (the probe column is never touched); the rows equal the
    row arm's, which reads everything."""
    got = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        ctx = SQLContext()
        ctx.registerDataFrameAsTable(_probe_frame(), "p")
        ctx.registerDataFrameAsTable(DataFrame.fromColumns(dims(), numPartitions=2), "d")
        CountingCells.reads = 0
        got[arm] = (rows(ctx.sql(query)), CountingCells.reads)
    assert got["1"][0] == got["0"][0] and got["1"][0]
    assert got["1"][1] == 0 and got["0"][1] > 0


def test_pushdown_keeps_a_star_join_whole(monkeypatch):
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    ctx = SQLContext()
    ctx.registerDataFrameAsTable(_probe_frame(), "p")
    ctx.registerDataFrameAsTable(DataFrame.fromColumns(dims(), numPartitions=2), "d")
    out = ctx.sql("SELECT * FROM p JOIN d ON p.k = d.k")
    assert out.columns == ["id", "k", "img", "label", "w"]
    assert [r["img"] for r in out.collect()] == [f"payload-{i}" for i in (0, 1, 2, 4, 5, 6, 8, 9, 10)]


# -- the slice: bert-tiny scores through relational SQL -------------------------------------


def test_bert_tiny_scores_through_relational_sql_equal_the_jax_package():
    """bert-tiny embeddings (the JAX weights carried across) through both
    packages' TextEmbedder, then one relational query on each: keys and
    counts equal exactly, float cells within 1e-5 relative (the embeddings
    themselves differ by float32 rounding between XLA and torch)."""
    import jax

    from sparkdl_tpu.models import get_model as jax_get_model
    from sparkdl_tpu.transformers.text import TextEmbedder as JaxTextEmbedder
    from sparkdl_tpu_torch.models import get_model
    from sparkdl_tpu_torch.transformers.text import TextEmbedder

    rng = np.random.default_rng(19)
    texts = [" ".join(f"w{int(x)}" for x in rng.integers(0, 50, size=int(n))) for n in rng.integers(2, 30, 24)]
    topics = [None if i % 7 == 0 else f"t{i % 5}" for i in range(len(texts))]
    cols = {"id": list(range(len(texts))), "text": texts, "topic": topics}
    jax_mf = jax_get_model("bert-tiny").model_function()
    params = jax.tree_util.tree_map(np.asarray, jax_mf.params)
    port_mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    topic_dim = {"topic": ["t0", "t1", "t2", "t9"], "name": ["zero", "one", "two", "nine"]}
    query = """
        WITH scored AS (
            SELECT id, topic, element_at(emb, 1) - element_at(emb, 2) AS score FROM emb
        )
        SELECT s.topic, count(*) AS c, avg(s.score) AS mean, min(s.score) AS lo, max(s.score) AS hi,
               stddev(s.score) AS sd, count(*) FILTER (WHERE s.score > (SELECT avg(score) FROM scored)) AS above,
               d.name
        FROM scored s LEFT JOIN topics d ON s.topic = d.topic
        GROUP BY s.topic, d.name
        HAVING count(*) > 1
        ORDER BY c DESC, s.topic
    """
    out = []
    for ctx_cls, frame_cls, embedder, mf in (
        (SQLContext, DataFrame, TextEmbedder, port_mf), (JaxSQLContext, JaxDataFrame, JaxTextEmbedder, jax_mf),
    ):
        embedded = embedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=64).transform(
            frame_cls.fromColumns(cols, numPartitions=3))
        ctx = ctx_cls()
        ctx.registerDataFrameAsTable(embedded, "emb")
        ctx.registerDataFrameAsTable(frame_cls.fromColumns(topic_dim), "topics")
        out.append(rows(ctx.sql(query)))
    ours, ref = out
    assert len(ours) == len(ref) >= 3
    for a, b in zip(ours, ref):
        assert (a["topic"], a["c"], a["name"], a["above"]) == (b["topic"], b["c"], b["name"], b["above"])
        for key in ("mean", "lo", "hi", "sd"):
            assert a[key] == pytest.approx(b[key], rel=1e-5, abs=1e-7), key
