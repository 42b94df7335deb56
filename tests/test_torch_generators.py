"""The generators of the port's SQL/DataFrame surface (explode, posexplode,
stack, json_tuple, LATERAL VIEW [OUTER]) and its partition-seeded functions
(rand, randn, monotonically_increasing_id, spark_partition_id,
input_file_name) against the JAX package's on the CPU.

- Every generator query runs through both packages and both
  ``SPARKDL_SQL_VECTORIZE`` arms over the same tables (NULL and empty list
  cells, JSON strings with missing fields and bad JSON, three partitions);
  rows are compared exactly and in order.
- LATERAL VIEW: OUTER, posexplode, chained views, a later view over an
  earlier view's alias, ``alias.*``, generated columns in WHERE, GROUP BY
  and ORDER BY, under a table alias and under a join.
- The Column API's generators (``F.explode``, ``F.posexplode(...).alias(p,
  c)``, ``F.stack``, ``F.json_tuple``) give the JAX package's rows or its
  error.
- A query the JAX package refuses fails in the port with the same error.
- The partition-seeded columns are bit-equal to the JAX package's over four
  partitions, after a filter and through withColumn, select and limit.
"""

import json

import numpy as np
import pytest

from sparkdl_tpu import functions as JF
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.sql import SQLContext as JaxSQLContext
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.sql import SQLContext
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_sql_windows import assert_same_in_both_arms, outcome, rows


def table():
    """Ten rows over three partitions: list cells that are NULL or empty,
    nested lists, JSON text with missing fields, a nested object and bad
    JSON."""
    return {
        "id": list(range(10)),
        "k": ["a", "b", None, "a", "c", "b", "a", None, "c", "a"],
        "n": [3, None, 7, 1, 1, 4, 9, None, 2, 6],
        "m": [10, 20, None, 40, 50, 60, None, 80, 90, 100],
        "tags": [["x", "y"], [], None, ["z"], ["x", "x", "w"], ["y"], None, [], ["w", "z"], ["x"]],
        "pairs": [[[1, 2], [3]], None, [[4]], [], [[5, 6], []], [[7]], [[8, 9, 10]], None, [[11]], [[12], [13]]],
        "text": ["the cat sat", "a dog", None, "", "cat and dog", "the end", "sat", "dog dog", "a", "cat"],
        "js": ['{"a": 1, "b": "x"}', '{"a": 2}', None, "not json", '{"b": "y", "c": {"d": 1}}',
               '{"a": null}', '{"a": 3, "b": [1, 2]}', "{}", '{"a": 4.5, "b": "z"}', '{"c": 9}'],
    }


def dims():
    return {"k": ["a", "b", "c", None], "label": ["alpha", "beta", "gamma", "nil"], "w": [1, 2, 3, 4]}


def _register(ctx, frame_cls):
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(table(), numPartitions=3), "t")
    ctx.registerDataFrameAsTable(frame_cls.fromColumns(dims(), numPartitions=2), "d")
    return ctx


@pytest.fixture(scope="module")
def contexts():
    return _register(SQLContext(), DataFrame), _register(JaxSQLContext(), JaxDataFrame)


QUERIES = {
    # generators as select items
    "explode": "SELECT id, explode(tags) AS tag FROM t",
    "explode unaliased": "SELECT explode(tags) FROM t",
    "explode outer": "SELECT id, explode_outer(tags) AS tag FROM t",
    "explode an expression": "SELECT k, explode(split(text, ' ')) AS word FROM t",
    "explode then order and limit": "SELECT id, explode(tags) AS tag FROM t ORDER BY tag DESC, id LIMIT 5",
    "explode with a where": "SELECT id, explode(tags) AS tag FROM t WHERE n > 2",
    "explode of an array builtin": "SELECT id, explode(array(n, m)) AS v FROM t",
    "explode in a derived table": "SELECT word, count(*) AS c FROM (SELECT explode(split(text, ' ')) AS word "
                                  "FROM t) s GROUP BY word ORDER BY c DESC, word",
    "explode in a cte": "WITH w AS (SELECT k, explode(tags) AS tag FROM t) SELECT k, tag FROM w WHERE tag <> 'x'",
    "words per key top": "WITH w AS (SELECT k, explode(split(text, ' ')) AS word FROM t) "
                         "SELECT k, word, count(*) AS c FROM w GROUP BY k, word ORDER BY c DESC, k, word LIMIT 6",
    "stack": "SELECT id, stack(2, n, m) AS v FROM t",
    "stack two columns": "SELECT stack(2, id, n, k, m) FROM t",
    "stack uneven": "SELECT id, stack(2, n, m, k) FROM t",
    "json_tuple": "SELECT id, json_tuple(js, 'a', 'b') FROM t",
    "json_tuple nested": "SELECT json_tuple(js, 'c', 'b', 'missing') FROM t",
    "json_tuple built": "SELECT json_tuple(to_json(named_struct('id', id, 'k', k, 'n', n)), 'id', 'k', 'n') FROM t",
    # LATERAL VIEW
    "lateral view": "SELECT id, x FROM t LATERAL VIEW explode(tags) e AS x",
    "lateral view outer": "SELECT id, e.x FROM t LATERAL VIEW OUTER explode(tags) e AS x",
    "lateral posexplode": "SELECT id, p, x FROM t LATERAL VIEW posexplode(tags) e AS p, x",
    "lateral posexplode outer": "SELECT id, p, x FROM t LATERAL VIEW OUTER posexplode(tags) e AS p, x",
    "lateral explode_outer": "SELECT id, x FROM t LATERAL VIEW explode_outer(tags) e AS x",
    "lateral default names": "SELECT id, col FROM t LATERAL VIEW explode(tags) e",
    "lateral posexplode default names": "SELECT pos, col FROM t LATERAL VIEW posexplode(tags) e",
    "chained views": "SELECT id, v FROM t LATERAL VIEW explode(pairs) a AS pr LATERAL VIEW explode(pr) b AS v",
    "chained view over an alias": "SELECT id, v FROM t LATERAL VIEW explode(pairs) a AS pr "
                                  "LATERAL VIEW OUTER explode(a.pr) b AS v",
    "chained outer posexplode and star": "SELECT id, e.*, f.* FROM t LATERAL VIEW OUTER posexplode(pairs) e AS p, pr "
                                         "LATERAL VIEW OUTER posexplode(pr) f AS q, v",
    "alias star": "SELECT id, e.* FROM t LATERAL VIEW posexplode(tags) e AS p, x",
    "generated columns downstream": "SELECT x, count(*) AS c FROM t LATERAL VIEW explode(tags) e AS x "
                                    "WHERE x <> 'w' GROUP BY x ORDER BY c DESC, x",
    "lateral under a table alias": "SELECT s.id, x FROM t s LATERAL VIEW explode(s.tags) e AS x",
    "lateral under a join": "SELECT t.id, d.label, x FROM t JOIN d ON t.k = d.k LATERAL VIEW explode(t.tags) e AS x",
    "lateral then a window": "SELECT id, x, row_number() OVER (PARTITION BY x ORDER BY id) AS r "
                             "FROM t LATERAL VIEW explode(tags) e AS x",
    "lateral then an aggregate": "SELECT k, count(x) AS c, collect_list(x) AS xs FROM t "
                                 "LATERAL VIEW OUTER explode(tags) e AS x GROUP BY k",
    "lateral over split": "SELECT id, w FROM t LATERAL VIEW explode(split(text, ' ')) e AS w WHERE w = 'dog'",
    "lateral star": "SELECT * FROM t LATERAL VIEW explode(tags) e AS x WHERE id < 2",
}


@pytest.mark.parametrize("query", list(QUERIES.values()), ids=list(QUERIES))
def test_generator_queries_equal_the_jax_package(contexts, query, monkeypatch):
    assert_same_in_both_arms(contexts, query, monkeypatch)


REFUSED = {
    "two generators": "SELECT explode(tags), explode(pairs) FROM t",
    "nested generator": "SELECT upper(explode(tags)) FROM t",
    "generator in where": "SELECT id FROM t WHERE explode(tags) = 'x'",
    "generator and a window": "SELECT explode(tags) AS x, rank() OVER (ORDER BY id) AS r FROM t",
    "generator with group by": "SELECT k, explode(tags) FROM t GROUP BY k",
    "generator beside a star": "SELECT *, explode(tags) FROM t",
    "stack row count not literal": "SELECT stack(n, id) FROM t",
    "lateral view of a builtin": "SELECT id FROM t LATERAL VIEW upper(k) e AS x",
    "posexplode with one name": "SELECT id FROM t LATERAL VIEW posexplode(tags) e AS x",
    "explode with two names": "SELECT id FROM t LATERAL VIEW explode(tags) e AS x, y",
    "unknown star qualifier": "SELECT z.* FROM t LATERAL VIEW explode(tags) e AS x",
    "posexplode as a select item": "SELECT posexplode(tags) FROM t",
    "posexplode in a cte": "WITH c AS (SELECT posexplode(array(n)) FROM t) SELECT * FROM c",
    "explode of a string": "SELECT explode(k) FROM t",
}


@pytest.mark.parametrize("query", list(REFUSED.values()), ids=list(REFUSED))
def test_refused_generator_queries_fail_as_the_jax_package_fails(contexts, query, monkeypatch):
    got = assert_same_in_both_arms(contexts, query, monkeypatch, want_rows=False)
    assert got[0] == "error", got


def test_exploded_row_counts_by_hand(contexts):
    """Counted without either package: explode keeps one row per element
    and drops NULL and empty cells; OUTER keeps them with a NULL element."""
    ours, _ = contexts
    tags = table()["tags"]
    inner = sum(len(x) for x in tags if x)
    outer = inner + sum(1 for x in tags if not x)
    assert len(ours.sql("SELECT explode(tags) FROM t").collect()) == inner
    assert len(ours.sql("SELECT id FROM t LATERAL VIEW OUTER explode(tags) e AS x").collect()) == outer
    pos = [(r["id"], r["p"], r["x"]) for r in ours.sql(
        "SELECT id, p, x FROM t LATERAL VIEW posexplode(tags) e AS p, x").collect()]
    assert pos == [(i, j, x) for i, xs in enumerate(tags) if xs for j, x in enumerate(xs)]


def test_lateral_stays_usable_as_a_name():
    for ctx, cls in ((SQLContext(), DataFrame), (JaxSQLContext(), JaxDataFrame)):
        ctx.registerDataFrameAsTable(cls.fromColumns({"lateral": [5], "view": [6]}), "lt")
        assert rows(ctx.sql("SELECT lateral, view FROM lt")) == [{"lateral": 5, "view": 6}]


def test_a_lateral_view_over_a_join_keeps_its_columns_on_the_pruning_arm(contexts, monkeypatch):
    """The optimizer arm prunes each join input to what the query reads,
    the LATERAL VIEW's argument included: rows equal the JAX package's
    (which prunes no join) and the row arm's."""
    query = ("SELECT t.id, d.label, x, rank() OVER (PARTITION BY d.label ORDER BY t.id DESC) AS r "
             "FROM t JOIN d ON t.k = d.k LATERAL VIEW OUTER explode(t.tags) e AS x")
    ours, _ = contexts
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    metrics.reset()
    ours.sql(query).collect()
    assert metrics.counter("sql.pushdown.pruned_cols") > 0
    assert_same_in_both_arms(contexts, query, monkeypatch)


# -- the Column API ------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return DataFrame.fromColumns(table(), numPartitions=3), JaxDataFrame.fromColumns(table(), numPartitions=3)


#: Column-API generators: ``build(F, df)``
COLUMN_CASES = {
    "explode": lambda f, df: df.select("id", f.explode("tags").alias("tag")),
    "explode default name": lambda f, df: df.select(f.explode("tags")),
    "explode outer": lambda f, df: df.select("id", f.explode_outer("tags")),
    "explode an expression": lambda f, df: df.select("k", f.explode(f.split(f.col("text"), " ")).alias("w")),
    "explode with a computed item": lambda f, df: df.select(
        (f.col("id") * 10).alias("x"), f.explode("tags").alias("tag")),
    "posexplode": lambda f, df: df.select("id", f.posexplode("tags")),
    "posexplode aliased": lambda f, df: df.select("id", f.posexplode("tags").alias("p", "c")),
    "posexplode outer": lambda f, df: df.select("id", f.posexplode_outer("tags").alias("p", "c")),
    "stack": lambda f, df: df.select("id", f.stack(f.lit(2), "n", "m")),
    "stack aliased": lambda f, df: df.select(f.stack(2, "id", "n", "k", "m").alias("a", "b")),
    "stack uneven": lambda f, df: df.select(f.stack(2, "n", "m", "k")),
    "json_tuple": lambda f, df: df.select("id", f.json_tuple("js", "a", "b")),
    "json_tuple aliased": lambda f, df: df.select(f.json_tuple(f.col("js"), "a", "c").alias("x", "y")),
    "explode after a filter": lambda f, df: df.filter(f.col("n") > 2).select("id", f.explode("tags")),
    "explode then group": lambda f, df: df.select("k", f.explode("tags").alias("t")).groupBy("t").agg(
        f.count("*").alias("c")),
    # refusals, as the JAX package refuses them
    "two generators": lambda f, df: df.select(f.explode("tags"), f.explode("pairs")),
    "generator in withColumn": lambda f, df: df.withColumn("x", f.explode("tags")),
    "nested generator": lambda f, df: df.select(f.upper(f.explode("tags"))),
    "generator in filter": lambda f, df: df.filter(f.explode("tags") == "x"),
    "posexplode one alias": lambda f, df: df.select(f.posexplode("tags").alias("p")),
    "stack wrong alias count": lambda f, df: df.select(f.stack(2, "n", "m", "k", "id").alias("a")),
    "stack zero rows": lambda f, df: f.stack(0, "n"),
    "stack column count": lambda f, df: f.stack(f.col("n"), "m"),
    "json_tuple no fields": lambda f, df: f.json_tuple("js"),
    "explode a string cell": lambda f, df: df.select(f.explode("k")),
    "duplicate output": lambda f, df: df.select("id", f.explode("tags").alias("id")),
}


@pytest.mark.parametrize("name", list(COLUMN_CASES))
def test_column_api_generators_equal_the_jax_package(frames, name):
    ours, ref = frames
    build = COLUMN_CASES[name]

    def run(f, df):
        out = build(f, df)
        return out if hasattr(out, "collect") else DataFrame.fromColumns({"built": [type(out).__name__]})

    got = outcome(lambda: run(F, ours))
    want = outcome(lambda: run(JF, ref))
    assert got == want


#: the same generator through SQL text and through the Column API
SURFACES = [
    ("SELECT id, explode(tags) AS tag FROM t", lambda df: df.select("id", F.explode("tags").alias("tag"))),
    ("SELECT id, p, x FROM t LATERAL VIEW OUTER posexplode(tags) e AS p, x",
     lambda df: df.select("id", F.posexplode_outer("tags").alias("p", "x"))),
    ("SELECT stack(2, id, n, k, m) FROM t", lambda df: df.select(F.stack(2, "id", "n", "k", "m"))),
    ("SELECT json_tuple(js, 'a', 'b') FROM t", lambda df: df.select(F.json_tuple("js", "a", "b"))),
]


@pytest.mark.parametrize("i", range(len(SURFACES)))
def test_sql_and_column_api_generators_agree(contexts, frames, i):
    query, build = SURFACES[i]
    ours, _ = contexts
    assert rows(ours.sql(query)) == rows(build(frames[0]))


def test_json_tuple_reads_what_json_reads(frames):
    """json_tuple's cells, by hand: scalars as strings, containers as JSON
    text, a missing field, JSON null and bad JSON as NULL."""
    ours, _ = frames
    got = [(r["c0"], r["c1"]) for r in ours.select(F.json_tuple("js", "a", "b")).collect()]
    want = []
    for js in table()["js"]:
        try:
            obj = json.loads(js) if js is not None else None
        except ValueError:
            obj = None
        cells = []
        for key in ("a", "b"):
            v = obj.get(key) if isinstance(obj, dict) else None
            cells.append(None if v is None else (json.dumps(v) if isinstance(v, (list, dict)) else str(v)))
        want.append(tuple(cells))
    assert got == want


# -- partition-seeded functions ------------------------------------------------------


def _seeded(frame_cls):
    return frame_cls.fromColumns({"id": list(range(23)), "x": [float(i % 5) for i in range(23)]}, numPartitions=4)


SEEDED = {
    "withColumn": lambda f, df: df.withColumn("u", f.rand(7)).withColumn("z", f.randn(7)).withColumn(
        "mid", f.monotonically_increasing_id()).withColumn("pid", f.spark_partition_id()),
    "select": lambda f, df: df.select("id", f.rand(7).alias("u"), f.randn(11).alias("z"),
                                      f.monotonically_increasing_id().alias("mid"),
                                      f.spark_partition_id().alias("pid")),
    "after a filter": lambda f, df: df.filter(f.col("x") > 1).withColumn("u", f.rand(7)).withColumn(
        "mid", f.monotonically_increasing_id()).withColumn("pid", f.spark_partition_id()),
    "then a limit": lambda f, df: df.withColumn("u", f.rand(7)).withColumn("z", f.randn()).limit(9),
    "after a limit": lambda f, df: df.limit(9).withColumn("u", f.rand(7)).withColumn("pid", f.spark_partition_id()),
    "default and negative seeds": lambda f, df: df.select("id", f.rand().alias("a"), f.rand(-3).alias("b"),
                                                          f.randn(2 ** 70).alias("c")),
    "input_file_name": lambda f, df: df.select("id", f.input_file_name().alias("src")),
    "head": lambda f, df: DataFrame.fromColumns(
        {"head": [sorted(r.items()) for r in df.withColumn("u", f.rand(5)).head(6)]}),
    "nondet inside an expression": lambda f, df: df.select((f.rand(7) * 2).alias("u")),
    "after a union": lambda f, df: df.union(df).withColumn("u", f.rand(7)).withColumn("pid", f.spark_partition_id()),
    "after a sort": lambda f, df: df.orderBy(f.col("x").desc()).withColumn("u", f.rand(7)),
    "after an offset": lambda f, df: df.offset(3).withColumn("mid", f.monotonically_increasing_id()),
    "after a join": lambda f, df: df.join(df.select("id", f.col("x").alias("y")), "id").withColumn(
        "pid", f.spark_partition_id()),
    "after a group": lambda f, df: df.groupBy("x").agg(f.count("*").alias("c")).withColumn(
        "mid", f.monotonically_increasing_id()),
}


@pytest.mark.parametrize("name", list(SEEDED))
def test_partition_seeded_columns_are_bit_equal_to_the_jax_package(name):
    build = SEEDED[name]
    got = outcome(lambda: build(F, _seeded(DataFrame)))
    want = outcome(lambda: build(JF, _seeded(JaxDataFrame)))
    assert got == want


def test_rand_is_numpy_per_partition_and_repeats():
    """rand/randn draw from ``default_rng(SeedSequence([seed, index]))``
    for each partition, by hand, and the same plan gives the same draws
    again; ids are ``index << 33`` plus the row's offset."""
    df = _seeded(DataFrame)
    out = df.withColumn("u", F.rand(7)).withColumn("z", F.randn(7)).withColumn(
        "mid", F.monotonically_increasing_id()).withColumn("pid", F.spark_partition_id())
    first = out.collect()
    assert first == out.collect()
    counts = df.partitionRowCounts()
    u, z, mid, pid = [], [], [], []
    for index, n in enumerate(counts):
        u += np.random.default_rng(np.random.SeedSequence([7, index])).random(n).tolist()
        z += np.random.default_rng(np.random.SeedSequence([7, index])).standard_normal(n).tolist()
        mid += [(index << 33) + j for j in range(n)]
        pid += [index] * n
    assert [r["u"] for r in first] == u and [r["z"] for r in first] == z
    assert [r["mid"] for r in first] == mid and [r["pid"] for r in first] == pid


def test_the_batch_worker_keeps_the_global_partition_index(tmp_path):
    """The batch worker hands a stage one partition at a time; a
    partition-seeded column there equals the single-process frame's."""
    from sparkdl_tpu_torch import worker

    path = str(tmp_path / "in.parquet")
    src = _seeded(DataFrame)
    src.writeParquet(path)
    whole = src.withColumn("mid", F.monotonically_increasing_id()).withColumn("u", F.rand(3)).collect()
    parts = []
    for gi, part_df in worker._read_owned_partitions(path, 4, [0, 1, 2, 3]):
        parts.append((gi, part_df.withColumn("mid", F.monotonically_increasing_id()).withColumn(
            "u", F.rand(3)).collect()))
    assert [gi for gi, _ in parts] == [0, 1, 2, 3]
    assert [r for _, rs in parts for r in rs] == whole
