"""The port's ``Column`` and the DataFrame methods that take Columns
(``sparkdl_tpu_torch/dataframe/column.py``, ``dataframe/frame.py``,
``dataframe/types.py``) against the JAX package's on the CPU.

Each case builds the same expression with each package's ``functions``
module over the same table (NULL and NaN cells, three partitions) and
the rows must be equal: operators and their null semantics, three-valued
``filter`` under ``~``, ``when``/``otherwise``, ``cast``, ``isin`` over
literals and Columns, the LIKE family, ``eqNullSafe``, struct and array
access, sort markers with NULLS FIRST/LAST; ``select``, ``withColumn``,
``withColumns``, ``filter``/``where``, ``orderBy``/``sort``,
``selectExpr``, the renames, ``toDF``, ``schema``/``dtypes``/
``printSchema``, ``show``, ``head``/``take``/``first``/``tail``,
``isEmpty`` and ``transform``. A model UDF inside a Column dispatches
batched, as in the JAX package. ``F.pandas_udf`` raises ``UnsupportedSQL``
naming ROADMAP Queue A item 8; the windows and generators are
``tests/test_torch_sql_windows.py`` and ``tests/test_torch_generators.py``.
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu import functions as JF
from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.dataframe.column import Column
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.sql import UnsupportedSQL
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_sql_expressions import assert_same_outcome, rows, table


@pytest.fixture(scope="module")
def frames():
    t = table()
    t["st"] = [{"a": i, "b": None if i % 3 else f"s{i}"} for i in range(9)]
    t["st"][4] = None
    return DataFrame.fromColumns(t, numPartitions=3), JaxDataFrame.fromColumns(t, numPartitions=3)


#: (name, f(F) -> Column): one select item each
VALUES = {
    "add": lambda F: F.col("n") + F.col("m"),
    "radd": lambda F: 10 + F.col("n"),
    "sub": lambda F: F.col("n") - 2.5,
    "rsub": lambda F: 1 - F.col("x"),
    "mul": lambda F: F.col("x") * F.col("y"),
    "div": lambda F: F.col("n") / F.col("m"),
    "rdiv": lambda F: 1 / F.col("m"),
    "mod": lambda F: F.col("n") % F.col("m"),
    "rmod": lambda F: 17 % F.col("m"),
    "neg": lambda F: -F.col("n"),
    "cmp": lambda F: F.col("n") > F.col("m"),
    "eq": lambda F: F.col("tag") == "t0",
    "ne": lambda F: F.col("x") != 1.5,
    "le_ge": lambda F: (F.col("n") <= 3) & (F.col("m") >= 0),
    "or": lambda F: (F.col("n") < 0) | F.col("s").isNull(),
    "not": lambda F: ~(F.col("n") > 2),
    "is_not_null": lambda F: F.col("x").isNotNull(),
    "between": lambda F: F.col("n").between(-1, 5),
    "between_cols": lambda F: F.col("x").between(F.col("y"), 3),
    "isin": lambda F: F.col("n").isin(3, 5, 7),
    "isin_list": lambda F: F.col("tag").isin(["t0", "t3"]),
    "isin_cols": lambda F: F.col("n").isin(F.col("m") + 1, 7),
    "like": lambda F: F.col("s").like("%o%"),
    "rlike": lambda F: F.col("s").rlike("[0-9]{2}"),
    "ilike": lambda F: F.col("s").ilike("HELLO%"),
    "contains": lambda F: F.col("s").contains("%"),
    "startswith": lambda F: F.col("s").startswith("sp"),
    "endswith": lambda F: F.col("s").endswith("d"),
    "eq_null_safe": lambda F: F.col("n").eqNullSafe(F.col("m")),
    "eq_null_safe_lit": lambda F: F.col("tag").eqNullSafe(None),
    "cast_string": lambda F: F.col("x").cast("string"),
    "cast_int": lambda F: F.col("s").cast("int"),
    "astype": lambda F: F.col("n").astype("double"),
    "try_cast": lambda F: F.col("d").try_cast("int"),
    "when": lambda F: F.when(F.col("n") > 2, "big").when(F.col("n") < 0, "neg").otherwise("small"),
    "when_no_else": lambda F: F.when(F.col("flag") == True, F.col("x")),  # noqa: E712
    "when_boolean_builtin": lambda F: F.when(F.isnan(F.col("x")), 1).otherwise(0),
    "coalesce": lambda F: F.coalesce(F.col("n"), F.col("m"), F.lit(-1)),
    "lit_none": lambda F: F.lit(None),
    "substr": lambda F: F.col("s").substr(2, 3),
    "slice_sugar": lambda F: F.col("s")[1:2],
    "get_item": lambda F: F.col("arr").getItem(0),
    "index_sugar": lambda F: F.col("arr")[1],
    "map_key": lambda F: F.col("mp").getItem("a"),
    "get_field": lambda F: F.col("st").getField("b"),
    "attr_field": lambda F: F.col("st").a,
    "with_field": lambda F: F.col("st").withField("c", F.col("id") * 2),
    "drop_fields": lambda F: F.col("st").dropFields("a"),
    "bitwise": lambda F: F.col("m").bitwiseAND(6) + F.col("m").bitwiseOR(1) + F.col("m").bitwiseXOR(3),
    "nested": lambda F: F.round(F.sqrt(F.abs(F.col("x")) + 1), 3) * F.signum(F.col("n")),
}


@pytest.mark.parametrize("name", list(VALUES))
def test_select_item_equals_the_jax_package(frames, name):
    ours, ref = frames
    build = VALUES[name]
    assert_same_outcome(lambda: rows(ours.select("id", build(F).alias("v"))),
                        lambda: rows(ref.select("id", build(JF).alias("v"))))


@pytest.mark.parametrize("name", list(VALUES))
def test_unaliased_output_names_equal_the_jax_package(frames, name):
    ours, ref = frames
    assert ours.select(VALUES[name](F)).columns == ref.select(VALUES[name](JF)).columns


CONDITIONS = {
    "gt": lambda F: F.col("n") > 2,
    "not_gt": lambda F: ~(F.col("n") > 2),
    "and_or": lambda F: ((F.col("n") > 0) & (F.col("m") > 0)) | (F.col("tag") == "t3"),
    "isnull": lambda F: F.col("tag").isNull(),
    "not_isin_null": lambda F: ~F.col("n").isin(3, None),
    "bare_boolean": lambda F: F.col("flag"),
    "boolean_builtin": lambda F: F.array_contains(F.col("arr"), 2),
    "not_boolean_builtin": lambda F: ~F.isnan(F.col("x")),
    "between": lambda F: F.col("x").between(-1, 2),
    "expr": lambda F: F.expr("n > 1 AND s LIKE '%l%'"),
    "hof": lambda F: F.exists(F.col("arr"), lambda v: v > 2),
}


@pytest.mark.parametrize("name", list(CONDITIONS))
def test_filter_and_where_equal_the_jax_package(frames, name):
    """Three-valued: an unknown condition never keeps a row."""
    ours, ref = frames
    cond = CONDITIONS[name]
    assert rows(ours.filter(cond(F)).select("id")) == rows(ref.filter(cond(JF)).select("id"))
    assert rows(ours.where(cond(F)).select("id")) == rows(ref.where(cond(JF)).select("id"))
    assert rows(ours.withColumn("c", cond(F)).select("id", "c")) == rows(ref.withColumn("c", cond(JF)).select("id", "c"))


SORTS = {
    "asc": lambda F: [F.col("n").asc()],
    "desc": lambda F: [F.col("n").desc(), "id"],
    "asc_nulls_last": lambda F: [F.col("x").asc_nulls_last()],
    "desc_nulls_first": lambda F: [F.col("y").desc_nulls_first()],
    "desc_nulls_last": lambda F: [F.col("tag").desc_nulls_last(), F.col("id").desc()],
    "asc_nulls_first": lambda F: [F.col("m").asc_nulls_first(), "id"],
    "expression": lambda F: [(F.col("n") % 4).desc(), F.length(F.col("s"))],
    "function_markers": lambda F: [F.desc("tag"), F.asc("id")],
}


@pytest.mark.parametrize("name", list(SORTS))
def test_order_by_columns_equals_the_jax_package(frames, name):
    ours, ref = frames
    keys = SORTS[name]
    assert rows(ours.orderBy(*keys(F)).select("id")) == rows(ref.orderBy(*keys(JF)).select("id"))
    assert rows(ours.sort(*keys(F)).select("id")) == rows(ref.sort(*keys(JF)).select("id"))
    assert ours.orderBy(*keys(F)).columns == ours.columns


def test_order_by_names_with_a_direction_list(frames):
    ours, ref = frames
    assert rows(ours.orderBy("tag", "n", ascending=[False, True]).select("id")) == \
        rows(ref.orderBy("tag", "n", ascending=[False, True]).select("id"))


def test_select_reads_the_frame_as_it_was(frames):
    """An alias that shadows an input column changes no later item."""
    ours, ref = frames
    build = lambda F: ["id", (F.col("n") * 2).alias("n"), (F.col("n") + 1).alias("n1"), F.col("m").alias("mm")]  # noqa: E731
    assert rows(ours.select(*build(F))) == rows(ref.select(*build(JF)))
    assert ours.select(build(F)).columns == ["id", "n", "n1", "mm"]


def test_with_columns_and_renames_equal_the_jax_package(frames):
    ours, ref = frames

    def chain(df, F):
        return (df.withColumns({"n": F.col("n") * 10, "z": F.col("n") + F.col("m"), "k": lambda r: r["id"] * 3})
                .withColumnRenamed("z", "zz").withColumnRenamed("missing", "q")
                .withColumnsRenamed({"zz": "n2", "k": "kk"})
                .select("id", "n", "n2", "kk"))

    assert rows(chain(ours, F)) == rows(chain(ref, JF))
    assert chain(ours, F).columns == chain(ref, JF).columns
    with pytest.raises(ValueError, match="already exists"):
        ours.withColumnRenamed("n", "m")
    with pytest.raises(ValueError, match="duplicate"):
        ours.withColumnsRenamed({"n": "m"})


def test_select_expr_equals_the_jax_package(frames):
    ours, ref = frames
    exprs = ("id", "n * 2 AS n", "upper(s) u", "CASE WHEN x > 0 THEN 'p' END AS sign", "transform(arr, v -> v + n)")
    assert rows(ours.selectExpr(*exprs)) == rows(ref.selectExpr(*exprs))
    assert ours.selectExpr(*exprs).columns == ref.selectExpr(*exprs).columns
    assert rows(ours.selectExpr("*", "id + 1 AS j")) == rows(ref.selectExpr("*", "id + 1 AS j"))
    with pytest.raises(ValueError, match="Duplicate"):
        ours.selectExpr("n", "m AS n")


def test_to_df_transform_and_attribute_access(frames):
    ours, ref = frames
    names = [f"c{i}" for i in range(len(ours.columns))]
    assert rows(ours.toDF(*names)) == rows(ref.toDF(*names))
    with pytest.raises(ValueError):
        ours.toDF("a")
    assert rows(ours.transform(lambda d, k: d.filter(d.n > k), 2).select(ours["id"])) == \
        rows(ref.transform(lambda d, k: d.filter(d.n > k), 2).select(ref["id"]))
    with pytest.raises(TypeError, match="must return a DataFrame"):
        ours.transform(lambda d: 3)
    assert isinstance(ours.n, Column) and isinstance(ours["n"], Column)
    with pytest.raises(AttributeError):
        ours.no_such_column
    with pytest.raises(KeyError):
        ours["no_such_column"]
    assert rows(ours[["id", "s"]]) == rows(ref[["id", "s"]])


def test_schema_dtypes_and_print_schema_equal_the_jax_package(frames, capsys):
    ours, ref = frames
    ours = ours.withColumn("vec", lambda r: np.zeros(3, np.float32))
    ref = ref.withColumn("vec", lambda r: np.zeros(3, np.float32))
    assert ours.dtypes == ref.dtypes
    assert [(f.name, f.dataType, f.nullable) for f in ours.schema] == \
        [(f.name, f.dataType, f.nullable) for f in ref.schema]
    assert ours.schema.names == ref.schema.names and ours.schema["n"].dataType == "bigint"
    ours.printSchema()
    mine = capsys.readouterr().out
    ref.printSchema()
    assert mine == capsys.readouterr().out


@pytest.mark.parametrize("n, truncate", [(3, 20), (20, 0), (2, 3)])
def test_show_prints_what_the_jax_package_prints(frames, capsys, n, truncate):
    ours, ref = frames
    ours.drop("st").show(n, truncate)
    mine = capsys.readouterr().out
    ref.drop("st").show(n, truncate)
    assert mine == capsys.readouterr().out


def test_row_access_equals_the_jax_package(frames):
    ours, ref = frames

    def norm(rs):
        return [{k: v for k, v in r.items() if k in ("id", "s", "n")} for r in rs]

    for n in (0, 1, 4, 20):
        assert norm(ours.head(n)) == norm(ref.head(n))
        assert norm(ours.take(n)) == norm(ref.take(n))
        assert norm(ours.tail(n)) == norm(ref.tail(n))
    assert norm([ours.first()]) == norm([ref.first()])
    empty = ours.filter(F.col("id") > 100)
    assert empty.first() is None and empty.isEmpty() and not ours.isEmpty()
    assert ref.filter(JF.col("id") > 100).isEmpty()


def test_a_udf_inside_a_column_dispatches_batched(frames):
    """A model UDF inside CASE and arithmetic materializes batched
    (``sql.udf.batch_rows`` counts every row once), and the rows equal
    the JAX package's."""
    ours, ref = frames
    mf = ModelFunction(lambda _m, x: x * 2.0, torch.nn.Module(), torch.device("cpu"), name="dbl", input_shape=(1,))
    udf_catalog.registerModelUDF("dbl_col", mf, batch_size=4, device="cpu")
    jax_udf.registerModelUDF("dbl_col", ModelIngest.from_callable(lambda x: x * 2.0, input_shape=(1,)),
                             batch_size=4)
    try:
        def build(F):
            arg = F.array(F.coalesce(F.col("x"), F.lit(0.0)))
            call = F.expr("dbl_col(array(coalesce(x, 0.0)))")
            return F.when(F.col("n") > 0, call).otherwise(arg).alias("v")

        metrics.reset()
        got = rows(ours.select("id", build(F)))
        assert metrics.counter("sql.udf.batch_rows") == 9
        assert got == rows(ref.select("id", build(JF)))
        cond = F.expr("element_at(dbl_col(array(coalesce(x, 0.0))), 1) > 2")
        jcond = JF.expr("element_at(dbl_col(array(coalesce(x, 0.0))), 1) > 2")
        assert rows(ours.filter(cond).select("id")) == rows(ref.filter(jcond).select("id"))
    finally:
        udf_catalog.unregister("dbl_col")
        jax_udf.unregister("dbl_col")


def test_python_udf_equals_the_jax_package(frames):
    ours, ref = frames

    def build(F):
        plus = F.udf(lambda a, b: None if a is None or b is None else a + b)
        upper = F.udf(lambda s: None if s is None else s.upper() + "!")
        return [plus(F.col("n"), F.col("m")).alias("p"), upper("s").alias("u")]

    assert rows(ours.select("id", *build(F))) == rows(ref.select("id", *build(JF)))


def test_what_stays_refused(frames):
    """Nothing of the Column API is refused any more. ``F.pandas_udf``,
    ``Column.over`` and the window, generator and partition-seeded
    functions it refused until they were ported (the test
    keeps its name) now build what the JAX package's build, or fail as
    they fail."""
    ours, _ = frames

    def built(call):
        try:
            return type(call()).__name__
        except Exception as e:  # noqa: BLE001 — compared below
            return type(e).__name__, str(e)

    assert built(lambda: F.col("n").over(None)) == built(lambda: JF.col("n").over(None))
    for name in ("row_number", "lag", "explode", "stack", "json_tuple", "rand",
                 "monotonically_increasing_id"):
        assert built(lambda: getattr(F, name)("n")) == built(lambda: getattr(JF, name)("n")), name
    # F.pandas_udf, refused here until it was ported: a non-callable first
    # argument makes the decorator form in both packages, and the UDF over
    # the frame gives the JAX package's rows
    assert built(lambda: F.pandas_udf("n")) == built(lambda: JF.pandas_udf("n"))
    _, ref = frames
    twice = lambda pd_mod: pd_mod.pandas_udf(lambda s: s.map(lambda v: None if v is None else 2 * v))  # noqa: E731
    assert rows(ours.select("id", twice(F)("n").alias("d"))) == rows(ref.select("id", twice(JF)("n").alias("d")))
    assert issubclass(UnsupportedSQL, ValueError)  # still exported for code that catches it
    with pytest.raises(AttributeError):
        F.no_such_function
    with pytest.raises(TypeError, match="Cannot convert a Column to bool"):
        bool(F.col("n") > 1)
    with pytest.raises(TypeError, match="not a condition"):
        ours.filter(F.col("n") + 1)
    with pytest.raises(TypeError, match="Column is not iterable"):
        list(F.col("arr"))


#: names ``test_what_stays_refused`` once refused: now the JAX package's
MOVED = {
    "sum": lambda f, df: df.groupBy("tag").agg(f.sum("n").alias("s")),
    "count": lambda f, df: df.groupBy("tag").agg(f.count("x").alias("c"), f.count("*").alias("rows")),
    "collect_list": lambda f, df: df.agg(f.collect_list("s").alias("ss")),
    "broadcast": lambda f, df: df.join(f.broadcast(df.select("id", f.col("n").alias("n2"))), "id"),
    "window": lambda f, df: df.withColumn("t", f.to_timestamp("ts")).groupBy(
        f.window("t", "1 day")).agg(f.count("*").alias("c")),
}


@pytest.mark.parametrize("name", list(MOVED))
def test_aggregates_broadcast_and_window_equal_the_jax_package(frames, name):
    ours, ref = frames
    assert_same_outcome(lambda: rows(MOVED[name](F, ours)), lambda: rows(MOVED[name](JF, ref)))
