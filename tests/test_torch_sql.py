"""The port's SQL subset (``sparkdl_tpu_torch/sql.py``) against the JAX
package's ``sql.py`` on the CPU.

- Parity: each query runs through both packages and both
  ``SPARKDL_SQL_VECTORIZE`` arms over the same table (NULL cells,
  negative numbers, three partitions) and the same model UDF; the four
  row lists must be identical (arrays compared as lists, exactly).
- Pushdown is real: a probe column counts its element reads, the stand-in
  for decoding an image, so a pruned column and a pre-filtered row are
  shown never to be touched (the JAX package's own proofs, with its
  counters), and a probe UDF shows that WHERE's metadata conjuncts and
  LIMIT run before any UDF scores a row.
- The row-expression constructs this subset once refused (builtins,
  CASE, CAST, ``||``, UDF calls inside them) and the relational ones
  (joins, GROUP BY and aggregates, WITH, set operations, DISTINCT,
  subqueries, OFFSET, HAVING) equal the JAX package's, and so do the
  windows, generators and LATERAL VIEW it refused after them.
"""

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

PARITY_QUERIES = [
    # the JAX package's tests/test_sql_pushdown.py PARITY_QUERIES
    "SELECT sum_vec(vec) AS s, label FROM t",
    "SELECT label FROM t WHERE sum_vec(vec) IS NOT NULL AND label = 'l1'",
    "SELECT label FROM t WHERE label <> 'l2' LIMIT 4",
    "SELECT label FROM t WHERE label = 'l0' ORDER BY label",
    # OR / IN / LIKE / BETWEEN / IS NULL over NULL cells
    "SELECT label, n FROM t WHERE n > 2 OR label = 'l1'",
    "SELECT n FROM t WHERE n IN (1, 3, -2, NULL) OR label NOT IN ('l0', 'l1')",
    "SELECT label, n FROM t WHERE label LIKE 'l_' AND n NOT BETWEEN -3 AND 3",
    "SELECT n, label FROM t WHERE n IS NULL OR NOT (n % 2 = 0)",
    "SELECT n FROM t WHERE n BETWEEN -1 AND 4 ORDER BY n",
    "SELECT label FROM t WHERE sum_vec(vec) IS NULL",
    # arithmetic, naming, ORDER BY DESC, ordinals, expression keys
    "SELECT n * 2 + 1 AS m, n / 4, -n, n % 3 FROM t ORDER BY n DESC, label",
    "SELECT label, n FROM t ORDER BY 2 DESC LIMIT 5",
    "SELECT label, n FROM t ORDER BY n * -1 LIMIT 4",
    # nested UDFs, SELECT *, qualified columns
    "SELECT sum_vec(sum_vec(vec)) AS ss FROM t WHERE n >= 0",
    "SELECT * FROM t WHERE label = 'l2'",
    "SELECT * FROM t ORDER BY n DESC LIMIT 3",
    "SELECT *, sum_vec(vec) AS s FROM t LIMIT 3",
    "SELECT x.label, sum_vec(x.vec) AS s FROM t x WHERE x.n < 4 ORDER BY x.label DESC LIMIT 6",
]

#: windows and generators, refused here until they were ported: now the
#: JAX package's rows, or its failure
UNSUPPORTED = {
    "window": "SELECT sum_vec(vec) OVER (PARTITION BY label) FROM t",
    "lateral view": "SELECT label FROM t LATERAL VIEW explode(vec) e AS x",
    "window function without over": "SELECT row_number() FROM t",
    "generator": "SELECT explode(vec) FROM t",
}

#: constructs this table once refused, which now run as the JAX package
#: runs them (the relational core), or fail as it fails
RELATIONAL = {
    "join": "SELECT a.label FROM t a JOIN t b ON a.label = b.label",
    "comma join": "SELECT label FROM t, t",
    "group by": "SELECT label FROM t GROUP BY label",
    "aggregate": "SELECT count(*) FROM t",
    "named aggregate": "SELECT max(n) FROM t",
    "with": "WITH u AS (SELECT label FROM t) SELECT label FROM u",
    "union": "SELECT label FROM t UNION SELECT label FROM t",
    "distinct": "SELECT DISTINCT label FROM t",
    "derived table": "SELECT label FROM (SELECT label FROM t) s",
    "in subquery": "SELECT label FROM t WHERE label IN (SELECT label FROM t)",
    "scalar subquery": "SELECT (SELECT 1) FROM t",
    "exists": "SELECT label FROM t WHERE EXISTS (SELECT label FROM t)",
    "offset": "SELECT label FROM t LIMIT 2 OFFSET 1",
    "having": "SELECT label FROM t HAVING n > 1",
    "count distinct": "SELECT count(DISTINCT label) FROM t",
}

#: constructs this table once refused, which now run as the JAX package
#: runs them (the row-expression half of the dialect)
EXPRESSIONS = {
    "row builtin": "SELECT upper(label) FROM t",
    "builtin in where": "SELECT label FROM t WHERE length(label) > 1",
    "case": "SELECT CASE WHEN n > 0 THEN 1 END FROM t",
    "cast": "SELECT CAST(n AS double) FROM t",
    "concat": "SELECT label || 'x' FROM t",
    "udf in case": "SELECT CASE WHEN n > 0 THEN sum_vec(vec) ELSE sum_vec(sum_vec(vec)) END AS s FROM t",
    "udf in coalesce": "SELECT coalesce(sum_vec(vec), array(-1.0)) AS s, n FROM t WHERE n IS NOT NULL",
    "udf over builtin": "SELECT sum_vec(transform(vec, x -> x * 2)) AS s FROM t WHERE label RLIKE '[12]$'",
}


class CountingCells(list):
    """A column whose element reads are counted: a pruned scan and a
    pre-filtered row must never touch these elements."""

    reads = 0

    def __getitem__(self, i):
        if isinstance(i, int):
            CountingCells.reads += 1
        return list.__getitem__(self, i)


def _probe_parts(n_parts=4, rows_per=8):
    parts = []
    k = 0
    for _ in range(n_parts):
        parts.append(
            {
                "vec": [np.full(4, float(k + i), dtype=np.float32) for i in range(rows_per)],
                "label": ["even" if (k + i) % 2 == 0 else "odd" for i in range(rows_per)],
                "img": CountingCells(f"payload-{k + i}" for i in range(rows_per)),
            }
        )
        k += rows_per
    return parts


def _probe_frame(**kw):
    return DataFrame(_probe_parts(**kw), ["vec", "label", "img"])


def _table():
    n = 14
    return {
        "vec": [None if i % 5 == 0 else np.full(4, float(i), dtype=np.float32) for i in range(n)],
        "label": [f"l{i % 3}" for i in range(n)],
        "n": [None if i % 4 == 3 else i - 5 for i in range(n)],
    }


def _rows_as_data(rows):
    return [
        {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v) for k, v in r.items()}
        for r in rows
    ]


@pytest.fixture(autouse=True)
def _reset_probe():
    CountingCells.reads = 0
    yield


@pytest.fixture
def ctx():
    return SQLContext()


@pytest.fixture(scope="module")
def sum_vec():
    """``sum_vec``: a vector cell's sum, as a 1-vector, registered as a
    model UDF in both packages (batch 3, so partitions span batches)."""
    jax_udf.registerModelUDF(
        "sum_vec",
        ModelIngest.from_callable(
            lambda x: x.reshape(x.shape[0], -1).sum(axis=1, keepdims=True), input_shape=(4,)
        ),
        batch_size=3,
    )
    mf = ModelFunction(
        lambda _m, x: x.reshape(x.shape[0], -1).sum(dim=1, keepdim=True),
        torch.nn.Module(), torch.device("cpu"), name="sum_vec", input_shape=(4,),
    )
    udf_catalog.registerModelUDF("sum_vec", mf, batch_size=3, device="cpu")
    yield
    jax_udf.unregister("sum_vec")
    udf_catalog.unregister("sum_vec")


@pytest.fixture(scope="module")
def contexts(sum_vec):
    ours, ref = SQLContext(), JaxSQLContext()
    ours.registerDataFrameAsTable(DataFrame.fromColumns(_table(), numPartitions=3), "t")
    ref.registerDataFrameAsTable(JaxDataFrame.fromColumns(_table(), numPartitions=3), "t")
    return ours, ref


# -- parity ------------------------------------------------------------------


@pytest.mark.parametrize("query", PARITY_QUERIES)
def test_rows_equal_the_jax_package_in_both_arms(contexts, query, monkeypatch):
    ours, ref = contexts
    got = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        got[arm] = (_rows_as_data(ours.sql(query).collect()), _rows_as_data(ref.sql(query).collect()))
    (vec_ours, vec_ref), (row_ours, row_ref) = got["1"], got["0"]
    assert vec_ref == row_ref  # the reference's own arms agree
    assert vec_ours == vec_ref
    assert row_ours == row_ref
    assert vec_ours, "every parity query returns rows"


def test_output_columns_and_names_match(contexts):
    ours, ref = contexts
    q = "SELECT n * 2 + 1 AS m, n / 4, -n, sum_vec(vec), label lab FROM t"
    assert ours.sql(q).columns == ref.sql(q).columns == ["m", "(n / 4)", "(- n)", "sum_vec(vec)", "lab"]


# -- pushdown ------------------------------------------------------------------


def _counters(names, reg):
    return {n: reg.counter(n) for n in names}


PUSHDOWN = ("sql.pushdown.pruned_cols", "sql.pushdown.skipped_rows")


def test_metadata_where_never_decodes_pruned_column(ctx):
    """SELECT label ... WHERE label = 'even': the pruned img and vec
    columns are never read, and the counters move as the JAX package's."""
    ctx.registerDataFrameAsTable(_probe_frame(), "t")
    ref = JaxSQLContext()
    ref.registerDataFrameAsTable(JaxDataFrame(_probe_parts(), ["vec", "label", "img"]), "t")
    before = (_counters(PUSHDOWN, metrics), _counters(PUSHDOWN, jax_metrics))
    rows = ctx.sql("SELECT label FROM t WHERE label = 'even'").collect()
    assert [r.label for r in rows] == ["even"] * 16
    assert CountingCells.reads == 0
    moved = {n: metrics.counter(n) - before[0][n] for n in PUSHDOWN}
    assert moved == {"sql.pushdown.pruned_cols": 2, "sql.pushdown.skipped_rows": 16}
    ref_rows = ref.sql("SELECT label FROM t WHERE label = 'even'").collect()
    assert [r.label for r in ref_rows] == [r.label for r in rows]
    assert moved == {n: jax_metrics.counter(n) - before[1][n] for n in PUSHDOWN}


def test_predicate_filters_before_udf_column_materializes(ctx):
    """WHERE label = ... AND udf(vec) > ...: the UDF sees only the rows
    the metadata conjunct keeps."""
    seen = {"cells": 0}

    def partition_fn(cells):
        seen["cells"] += len(cells)
        return [None if c is None else float(np.asarray(c).sum()) for c in cells]

    udf_catalog.register("vsum_probe", partition_fn, batch_fn=partition_fn)
    try:
        ctx.registerDataFrameAsTable(_probe_frame(), "t")
        rows = ctx.sql("SELECT label FROM t WHERE label = 'even' AND vsum_probe(vec) > 20").collect()
        assert rows and all(r.label == "even" for r in rows)
        assert len(rows) == 13  # the even rows 6..30: their vec sums 4 k past 20
        assert seen["cells"] == 16
        assert CountingCells.reads == 0
    finally:
        udf_catalog.unregister("vsum_probe")


def test_limit_without_order_runs_before_the_udf(ctx):
    seen = {"cells": 0}

    def partition_fn(cells):
        seen["cells"] += len(cells)
        return [float(np.asarray(c).sum()) for c in cells]

    udf_catalog.register("vsum_probe", partition_fn, batch_fn=partition_fn)
    try:
        ctx.registerDataFrameAsTable(_probe_frame(), "t")
        rows = ctx.sql("SELECT vsum_probe(vec) AS s FROM t LIMIT 3").collect()
        assert [r.s for r in rows] == [0.0, 4.0, 8.0]
        assert seen["cells"] == 3
    finally:
        udf_catalog.unregister("vsum_probe")


def test_select_star_is_not_pruned(ctx):
    ctx.registerDataFrameAsTable(_probe_frame(n_parts=1, rows_per=4), "t")
    rows = ctx.sql("SELECT * FROM t WHERE label = 'even'").collect()
    assert len(rows) == 2 and rows[0].img == "payload-0"
    assert CountingCells.reads > 0


def test_knob_off_skips_pushdown_entirely(ctx, monkeypatch):
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "0")
    ctx.registerDataFrameAsTable(_probe_frame(n_parts=1, rows_per=4), "t")
    before = _counters(PUSHDOWN, metrics)
    rows = ctx.sql("SELECT label FROM t WHERE label = 'even'").collect()
    assert [r.label for r in rows] == ["even", "even"]
    assert _counters(PUSHDOWN, metrics) == before
    assert CountingCells.reads > 0  # the row filter reads every column


def test_model_udf_dispatches_batched(contexts, monkeypatch):
    """A model UDF in SQL reaches the device in batches on the optimizer
    arm (``sql.udf.*`` move, the gauge reads 1); the row arm leaves the
    batch counters flat and the gauge at 0."""
    ours, _ = contexts
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    b0, r0 = metrics.counter("sql.udf.batches"), metrics.counter("sql.udf.batch_rows")
    rows = ours.sql("SELECT sum_vec(vec) AS s FROM t").collect()
    assert len(rows) == 14
    assert metrics.counter("sql.udf.batches") - b0 >= 3  # one partition at least per batch
    assert metrics.counter("sql.udf.batch_rows") - r0 == 11  # the non-null cells
    assert metrics.snapshot()["gauges"]["sql.udf.vectorized"] == 1.0
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "0")
    b1 = metrics.counter("sql.udf.batches")
    ours.sql("SELECT sum_vec(vec) AS s FROM t").collect()
    assert metrics.counter("sql.udf.batches") == b1
    assert metrics.snapshot()["gauges"]["sql.udf.vectorized"] == 0.0


def test_partition_order_is_kept(ctx):
    """Partitions run at once; rows come back partition by partition, as
    the source holds them, with and without LIMIT."""
    ctx.registerDataFrameAsTable(_probe_frame(), "t")
    labels = ["even" if i % 2 == 0 else "odd" for i in range(32)]
    q = "SELECT label, vec FROM t"
    assert [r.label for r in ctx.sql(q).collect()] == labels
    assert [float(r.vec[0]) for r in ctx.sql(q).collect()] == [float(i) for i in range(32)]
    assert [float(r.vec[0]) for r in ctx.sql(q + " LIMIT 11").collect()] == [float(i) for i in range(11)]


# -- the context and what it refuses ---------------------------------------------


def test_context_tables_and_module_default():
    from sparkdl_tpu_torch import sql as sqlmod

    ctx = SQLContext()
    df = DataFrame.fromColumns({"a": [1, 2]})
    ctx.registerDataFrameAsTable(df, "x")
    assert ctx.tables() == ["x"] and ctx.table("x") is df
    with pytest.raises(KeyError, match="registered: \\['x'\\]"):
        ctx.table("y")
    assert ctx.dropTempTable("x") and not ctx.dropTempTable("x")
    df.createOrReplaceTempView("torch_sql_view")
    try:
        assert [r.a for r in sqlmod.sql("SELECT a FROM torch_sql_view WHERE a > 1").collect()] == [2]
    finally:
        sqlmod.dropTempTable("torch_sql_view")
    with pytest.raises(KeyError):
        sqlmod.sql("SELECT a FROM torch_sql_view")


@pytest.mark.parametrize("query", list(EXPRESSIONS.values()), ids=list(EXPRESSIONS))
def test_expression_constructs_equal_the_jax_package(contexts, query, monkeypatch):
    test_rows_equal_the_jax_package_in_both_arms(contexts, query, monkeypatch)


def test_a_udf_takes_one_argument(contexts):
    ours, ref = contexts
    for ctx in (ours, ref):
        with pytest.raises(ValueError, match="takes exactly one argument"):
            ctx.sql("SELECT sum_vec(vec, n) FROM t").collect()


def _outcome(run):
    """``("rows", [...])``, or ``("error", (class, message))``."""
    try:
        return "rows", _rows_as_data(run().collect())
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return "error", (type(e).__name__, str(e))



@pytest.mark.parametrize("query", list(RELATIONAL.values()), ids=list(RELATIONAL))
def test_relational_constructs_equal_the_jax_package(contexts, query, monkeypatch):
    """Rows equal in both arms, or the same error as the JAX package's."""
    ours, ref = contexts
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        assert _outcome(lambda: ours.sql(query)) == _outcome(lambda: ref.sql(query))


@pytest.mark.parametrize("query", list(UNSUPPORTED.values()), ids=list(UNSUPPORTED))
def test_constructs_outside_the_subset_raise(contexts, query, monkeypatch):
    """These raised UnsupportedSQL naming ROADMAP Queue A item 8 (the test
    keeps its name): now each gives the JAX package's rows, or fails as it
    fails, in both arms, and none waits for item 8."""
    ours, ref = contexts
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        got = unknown_as_one(_outcome(lambda: ours.sql(query)))
        assert got == unknown_as_one(_outcome(lambda: ref.sql(query)))
        assert "ROADMAP Queue A item 8" not in str(got)
