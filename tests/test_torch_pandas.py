"""The port's pandas surfaces (``F.pandas_udf``, ``DataFrame.toPandas``,
``mapInPandas``, ``GroupedData.applyInPandas``, ``cogroup(...)
.applyInPandas`` and ``SparkSession.createDataFrame`` from a pandas frame)
against the JAX package's, on the CPU.

The same seeded columns go through both packages: the rows (or the error
raised) agree, and ``toPandas`` agrees through ``assert_frame_equal``, so
the port's own conversion gives the dtypes the JAX package gets from
``pyarrow``'s ``to_pandas``. The cases follow the JAX package's own tests
(``test_cogroup.py``, ``test_parity_round5b.py::TestPandasInterop``,
``test_functions_round5g.py::test_pandas_udf``,
``test_pandas_oracle_diff.py``).
"""

import datetime
import math
import re
import sys

import numpy as np
import pandas as pd
import pytest

from sparkdl_tpu import functions as JF
from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.session import SparkSession as JaxSparkSession
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.session import SparkSession


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


def _root(e):
    """The error itself: the cause of a wrapping error, and without the
    executor's "Partition task <i> failed after <n> attempts: " prefix
    (which partition fails first is a race)."""
    while e.__cause__ is not None:
        e = e.__cause__
    return type(e).__name__, re.sub(r"^Partition task \d+ failed after \d+ attempts: \w+: ", "", str(e))


def outcome(call):
    """Columns, partition count and rows, or the root error's type and
    message (an action may wrap it in a partition-task error)."""
    try:
        got = call()
        if hasattr(got, "collect"):
            return ("rows", got.columns, got.numPartitions, [{k: _norm(v) for k, v in r.items()}
                                                               for r in got.collect()])
        return ("value", _norm(got))
    except Exception as e:  # noqa: BLE001 — compared below
        return ("raises", *_root(e))


class Side:
    def __init__(self, frame_cls, fmod):
        self.DataFrame = frame_cls
        self.F = fmod

    def df(self, cols, parts=2):
        return self.DataFrame.fromColumns(cols, numPartitions=parts)


SIDES = (Side(DataFrame, F), Side(JaxDataFrame, JF))


def same(build):
    got, want = (outcome(lambda: build(side)) for side in SIDES)
    assert got == want
    return got


def table(seed: int = 0, n: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "id": list(range(n)),
        "k": [None if rng.random() < 0.1 else "abcd"[int(v)] for v in rng.integers(0, 4, n)],
        "g": [int(v) for v in rng.integers(0, 3, n)],
        "v": [None if rng.random() < 0.15 else float(rng.integers(-50, 50)) for _ in range(n)],
        "n": [None if rng.random() < 0.15 else int(v) for v in rng.integers(-9, 9, n)],
        "x": [float("nan") if rng.random() < 0.1 else float(v) for v in rng.normal(size=n)],
    }


# -- F.pandas_udf -------------------------------------------------------------------


UDFS = {
    "plus-one": lambda s: s.df(table()).dropna(subset=["v"]).select(
        "id", s.F.pandas_udf(lambda c: c + 1)("v").alias("r")),
    "decorator": lambda s: s.df(table()).select("id", s.F.pandas_udf()(lambda c: c.astype(str))("g").alias("r")),
    "return-type": lambda s: s.df(table()).select("id", s.F.pandas_udf(lambda c: c * 2, "long")("g").alias("r")),
    "two-args": lambda s: s.df(table()).dropna(subset=["v"]).select(
        "id", s.F.pandas_udf(lambda a, b: a + b, "double")(s.F.col("v"), s.F.col("id")).alias("r")),
    "three-args": lambda s: s.df(table()).select(
        "id", s.F.pandas_udf(lambda a, b, c: a * b - c)("g", "id", s.F.lit(3)).alias("r")),
    "nulls-as-objects": lambda s: s.df(table()).select(
        "id", s.F.pandas_udf(lambda c: c.isna())("n").alias("r"), s.F.pandas_udf(lambda c: c.isna())("x").alias("q")),
    "nan-through": lambda s: s.df(table()).select("id", s.F.pandas_udf(lambda c: c.map(
        lambda v: None if v is None else (-1.0 if v != v else v)))("x").alias("r")),
    "strings": lambda s: s.df(table()).select("id", s.F.pandas_udf(lambda c: c.map(
        lambda v: None if v is None else v.upper() * 2))("k").alias("r")),
    "empty-partition-one-arg": lambda s: s.df(table(), parts=4).filter(s.F.col("id") >= 20).select(
        s.F.pandas_udf(lambda c: c * 10)("g").alias("r")),
    "empty-partition-two-args": lambda s: s.df({"a": list(range(8)), "b": list(range(8))}, parts=4).filter(
        s.F.col("a") >= 6).select(s.F.pandas_udf(lambda a, b: a + b)(s.F.col("a"), s.F.col("b")).alias("r")),
    "filtered-to-nothing": lambda s: s.df(table()).filter(s.F.col("id") < 0).select(
        s.F.pandas_udf(lambda a, b: a + b)("g", "id").alias("r")),
    "with-where": lambda s: s.df(table()).withColumn("r", s.F.pandas_udf(lambda c: c - 1)("g")).filter(
        s.F.col("r") > 0),
    "wrong-length": lambda s: s.df(table()).select(s.F.pandas_udf(lambda c: c.head(1))("g").alias("r")),
    "no-argument": lambda s: s.F.pandas_udf(lambda c: c)(),
}


@pytest.mark.parametrize("name", list(UDFS))
def test_pandas_udf_matches_jax(name):
    same(UDFS[name])


def test_pandas_udf_sees_object_series_of_the_partition():
    """Each call receives the whole partition batch as a pandas Series of
    dtype object, in both packages."""
    seen = {}
    for side in SIDES:
        calls = []

        def probe(c, calls=calls):
            calls.append((type(c), str(c.dtype), len(c)))
            return c

        side.df(table(), parts=3).select(side.F.pandas_udf(probe)("v").alias("r")).collect()
        seen[side.DataFrame.__module__] = sorted(calls, key=str)
    got, want = seen.values()
    assert got == want and all(t is pd.Series and dt == "object" for t, dt, _ in got)
    assert sorted(n for _, _, n in got) == [8, 8, 8]


def test_pandas_udf_over_a_bert_tiny_catalog_udf():
    """A pandas UDF that scores its Series of token-id rows through a
    bert-tiny model registered in each package's UDF catalog: the JAX
    weights carried across, embeddings within 1e-4."""
    import jax

    from sparkdl_tpu.models import get_model as jax_get_model
    from sparkdl_tpu_torch.models import get_model

    jax_mf = jax_get_model("bert-tiny").model_function()
    params = jax.tree_util.tree_map(np.asarray, jax_mf.params)
    port_mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    to_batch = lambda chunk: (np.stack([np.asarray(c, np.int32) for c in chunk]), np.ones(len(chunk), bool))  # noqa: E731
    udf_catalog.registerModelUDF("pd_bert_tiny", port_mf, to_batch=to_batch, batch_size=4, device="cpu")
    jax_udf.registerModelUDF("pd_bert_tiny", jax_mf, to_batch=to_batch, batch_size=4)
    rng = np.random.default_rng(4)
    ids = [np.concatenate([rng.integers(5, 1000, n), np.zeros(16 - n, np.int64)]).astype(np.int32)
           for n in rng.integers(3, 16, 10)]
    out = {}
    for side, catalog in zip(SIDES, (udf_catalog, jax_udf)):
        score = side.F.pandas_udf(
            lambda s, catalog=catalog: pd.Series(catalog.get("pd_bert_tiny").partition_fn(list(s))))
        rows = side.df({"ids": ids}, parts=3).select(score("ids").alias("e")).collect()
        out[side.DataFrame.__module__] = np.stack([r["e"] for r in rows])
    got, want = out.values()
    assert got.shape == (10, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    udf_catalog.unregister("pd_bert_tiny")
    jax_udf.unregister("pd_bert_tiny")


# -- mapInPandas ---------------------------------------------------------------------


def _keep_big(it):
    for pdf in it:
        out = pdf[pdf.g > 0].copy()
        out["d"] = out.g * 2
        yield out[["k", "d"]]


def _ident(it):
    yield from it


def _second_frame_short(it):
    next(it)
    yield pd.DataFrame({"k": ["a"], "v": [1]})
    yield pd.DataFrame({"k": ["b"]})


MAPS = {
    "row-count-changes": lambda s: s.df(table()).mapInPandas(_keep_big, "k string, d long"),
    "schema-list": lambda s: s.df(table()).mapInPandas(_ident, ["id", "k", "g", "v", "n", "x"]),
    "schema-ddl-nested": lambda s: s.df(table()).mapInPandas(_ident, "id long, k map<string,int>, g decimal(10,2)"),
    "explode-rows": lambda s: s.df(table()).mapInPandas(
        lambda it: (pd.concat([p, p], ignore_index=True) for p in it), "id, g"),
    "nothing-yielded": lambda s: s.df(table()).mapInPandas(lambda it: iter(()), "id"),
    "missing-column": lambda s: s.df(table()).mapInPandas(_ident, ["nope"]),
    "not-a-frame": lambda s: s.df(table()).mapInPandas(lambda it: ([1, 2] for _ in it), "id"),
    "each-frame-checked": lambda s: s.df(table()).mapInPandas(_second_frame_short, "k, v"),
    "nulls-survive": lambda s: s.df({"x": [1, None, 3]}).mapInPandas(_ident, ["x"]).filter(
        s.F.col("x").isNull()),
    "arrays-through": lambda s: s.df({"a": [np.arange(3, dtype=np.float32) + i for i in range(5)]}).mapInPandas(
        _ident, "a"),
}


@pytest.mark.parametrize("name", list(MAPS))
def test_map_in_pandas_matches_jax(name):
    same(MAPS[name])


def test_map_in_pandas_is_lazy_and_partition_local():
    for side in SIDES:
        seen = []

        def count(it, seen=seen):
            for pdf in it:
                seen.append(len(pdf))
                yield pdf

        out = side.df(table(), parts=3).mapInPandas(count, "id")
        assert seen == [] and out.numPartitions == 3
        assert out.count() == 24 and sorted(seen) == [8, 8, 8]


# -- applyInPandas --------------------------------------------------------------------


def _center(pdf):
    pdf = pdf.copy()
    pdf["cv"] = pdf.g - pdf.g.mean()
    return pdf[["k", "cv"]]


APPLIES = {
    "center": lambda s: s.df(table()).groupBy("k").applyInPandas(_center, ["k", "cv"]),
    "key-aware": lambda s: s.df(table()).groupBy("k", "g").applyInPandas(
        lambda key, pdf: pd.DataFrame({"key": [repr(key)], "n": [len(pdf)]}), "key string, n long"),
    "first-row": lambda s: s.df(table(), parts=3).groupBy("g").applyInPandas(
        lambda pdf: pdf.head(1), "id, k, g, v"),
    "null-key-group": lambda s: s.df(table()).groupBy("k").applyInPandas(
        lambda pdf: pd.DataFrame({"k": [pdf.k.iloc[0]], "s": [pdf.v.sum()]}), "k, s"),
    "rollup": lambda s: s.df(table()).rollup("k").applyInPandas(lambda p: p, ["k"]),
    "cube": lambda s: s.df(table()).cube("k").applyInPandas(lambda p: p, ["k"]),
    "no-keys": lambda s: s.df(table()).groupBy().applyInPandas(lambda p: p, ["k"]),
    "not-a-frame": lambda s: s.df(table()).groupBy("k").applyInPandas(lambda p: len(p), ["k"]),
    "missing-column": lambda s: s.df(table()).groupBy("k").applyInPandas(lambda p: p, ["k", "zz"]),
    "empty-frame": lambda s: s.df(table()).filter(s.F.col("id") < 0).groupBy("k").applyInPandas(
        lambda p: p, ["k"]),
}


@pytest.mark.parametrize("name", list(APPLIES))
def test_apply_in_pandas_matches_jax(name):
    same(APPLIES[name])


def test_apply_in_pandas_guards_the_collect(monkeypatch):
    monkeypatch.setenv("SPARKDL_DRIVER_COLLECT_MAX_ROWS", "10")
    for side in SIDES:
        with pytest.raises(ValueError, match="SPARKDL_DRIVER_COLLECT_MAX_ROWS"):
            side.df(table()).groupBy("k").applyInPandas(lambda p: p, ["k"])


# -- cogroup ----------------------------------------------------------------------------


def _ab(side):
    a = side.DataFrame.fromRows([{"k": "x", "v": 1}, {"k": "x", "v": 2}, {"k": "y", "v": 10}])
    b = side.DataFrame.fromRows([{"k": "x", "w": 100}, {"k": "z", "w": 7}])
    return a, b


def _merge(left, right):
    return pd.DataFrame({
        "k": [left["k"].iloc[0] if len(left) else right["k"].iloc[0]],
        "sum_v": [int(left["v"].sum()) if len(left) else 0],
        "sum_w": [int(right["w"].sum()) if len(right) else 0],
    })


def _columns_seen(left, right):
    k = left["k"].iloc[0] if len(left) else right["k"].iloc[0]
    return pd.DataFrame({"k": [k], "lc": [",".join(left.columns)], "rc": [",".join(right.columns)],
                         "ln": [len(left)], "rn": [len(right)]})


COGROUPS = {
    "pair": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1].groupBy("k")).applyInPandas(
        _merge, "k string, sum_v long, sum_w long"),
    "key-aware": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1].groupBy("k")).applyInPandas(
        lambda key, left, right: pd.DataFrame({"k": [key[0]], "n": [len(left) + len(right)]}), "k string, n long"),
    "one-sided-keys-keep-columns": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1].groupBy("k")).applyInPandas(
        _columns_seen, "k, lc, rc, ln, rn"),
    "two-keys-by-position": lambda s: s.df(table()).groupBy("k", "g").cogroup(
        s.df(table(seed=1)).withColumnRenamed("k", "kk").groupBy("kk", "g")).applyInPandas(
        lambda key, left, right: pd.DataFrame({"key": [repr(key)], "l": [len(left)], "r": [len(right)]}),
        "key, l, r"),
    "not-grouped": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1]),
    "unequal-keys": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1].groupBy("k", "w")),
    "no-keys": lambda s: _ab(s)[0].groupBy().cogroup(_ab(s)[1].groupBy()),
    "rollup": lambda s: _ab(s)[0].rollup("k").cogroup(_ab(s)[1].groupBy("k")),
    "missing-column": lambda s: _ab(s)[0].groupBy("k").cogroup(_ab(s)[1].groupBy("k")).applyInPandas(
        lambda left, right: left, "k, w"),
}


@pytest.mark.parametrize("name", list(COGROUPS))
def test_cogroup_matches_jax(name):
    same(COGROUPS[name])


# -- toPandas -------------------------------------------------------------------------------


COLUMNS = {
    "ints": [1, 2, 3, 4],
    "nullable-ints": [1, 2, None, 4],
    "floats": [1.0, None, 3.5, float("nan")],
    "ints-and-floats": [1, 2.5, None, 3],
    "numpy-float32": [np.float32(1.5), np.float32(2), None, np.float32(3)],
    "numpy-int32": [np.int32(1), np.int32(5), np.int32(-2), np.int32(0)],
    "bools": [True, False, True, True],
    "nullable-bools": [True, False, None, True],
    "strings": ["a", "b", "c", "d"],
    "nullable-strings": ["a", None, "c", ""],
    "bytes": [b"ab", None, b"c", b""],
    "all-null": [None, None, None, None],
    "int-lists": [[1, 2], [3], None, []],
    "float-lists-with-null": [[1.0, None], [3.0], None, []],
    "string-lists": [["x", None], ["y"], [], None],
    "nested-lists": [[[1, 2], [3]], None, [[4]], []],
    "tensor-1d": [np.arange(3, dtype=np.float32) + k for k in range(4)],
    "tensor-2d": [np.full((2, 2), k, np.float32) for k in range(4)],
    "tensor-int64": [np.arange(2, dtype=np.int64) * k for k in range(4)],
    "ragged-arrays": [np.arange(k + 1, dtype=np.float32) for k in range(4)],
    "arrays-with-null": [np.ones(2, np.float32), None, np.zeros(2, np.float32), np.ones(2, np.float32)],
    "structs": [{"a": 1, "b": "x"}, None, {"a": 2, "b": "y"}, {"a": 3, "b": None}],
    "structs-uneven-keys": [{"a": [1, 2]}, {"c": 2.5}, None, {"a": None, "c": 1.0}],
    "timestamps": [datetime.datetime(2020, 1, 1), None, datetime.datetime(2021, 1, 1, 5), datetime.datetime(2022, 1, 1)],
    "dates": [datetime.date(2020, 1, 1), None, datetime.date(2021, 1, 1), datetime.date(2022, 1, 1)],
}


@pytest.mark.parametrize("name", list(COLUMNS))
def test_to_pandas_matches_jax(name):
    cols = {"id": [0, 1, 2, 3], name: COLUMNS[name]}
    got = DataFrame.fromColumns(cols, numPartitions=2).toPandas()
    want = JaxDataFrame.fromColumns(cols, numPartitions=2).toPandas()
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("parts", [1, 3])
def test_to_pandas_of_a_planned_frame_matches_jax(parts):
    build = lambda s: s.df(table(), parts=parts).filter(s.F.col("g") > 0).select(  # noqa: E731
        "id", "k", "v", "n", "x", (s.F.col("g") * 2).alias("g2"))
    got, want = (build(side).toPandas() for side in SIDES)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == sum(1 for g in table()["g"] if g > 0)


def test_to_pandas_of_an_empty_frame_matches_jax():
    for cols in ({"a": [], "b": []}, {"a": [1, 2], "b": ["x", None]}):
        build = lambda s, cols=cols: s.df(cols).filter(s.F.col("a") > 5)  # noqa: E731
        got, want = (build(side).toPandas() for side in SIDES)
        pd.testing.assert_frame_equal(got, want)


def test_to_pandas_of_a_file_tensor_column_matches_jax(tmp_path):
    """A tensor column read back from Parquet (a numpy block in its
    partition) converts as the JAX package's fixed-shape tensor column."""
    block = np.arange(24, dtype=np.float32).reshape(6, 4)
    cols = {"id": list(range(6)), "emb": list(block)}
    DataFrame.fromColumns(cols, numPartitions=2).writeParquet(str(tmp_path / "t.parquet"))
    got = DataFrame.readParquet(str(tmp_path / "t.parquet"), numPartitions=2).toPandas()
    want = JaxDataFrame.fromColumns(cols, numPartitions=2).toPandas()
    pd.testing.assert_frame_equal(got, want)


# -- createDataFrame ------------------------------------------------------------------------


PANDAS_FRAMES = {
    "ints": lambda: pd.DataFrame({"x": [1, 2, 3]}),
    "mixed-nulls": lambda: pd.DataFrame({"x": [1, 2], "s": ["a", None], "f": [0.5, None]}),
    "bools-and-objects": lambda: pd.DataFrame({"b": [True, False], "o": [[1, 2], None]}),
    "empty": lambda: pd.DataFrame({"x": pd.Series([], dtype="int64")}),
}


@pytest.mark.parametrize("name", list(PANDAS_FRAMES))
def test_create_data_frame_from_pandas_matches_jax(name):
    ours = SparkSession.builder.getOrCreate()
    ref = JaxSparkSession.builder.getOrCreate()
    got = outcome(lambda: ours.createDataFrame(PANDAS_FRAMES[name]()))
    want = outcome(lambda: ref.createDataFrame(PANDAS_FRAMES[name]()))
    assert got == want


def test_pandas_round_trip_matches_jax():
    """toPandas, then createDataFrame, then toPandas gives the same frame
    in both packages."""
    frames = []
    cols = {c: v for c, v in table().items() if c != "k"}  # a str column with a null comes back as NaN
    for side, session in zip(SIDES, (SparkSession, JaxSparkSession)):
        pdf = side.df(cols).toPandas()
        frames.append(session.builder.getOrCreate().createDataFrame(pdf).toPandas())
    pd.testing.assert_frame_equal(*frames)


# -- without pandas ----------------------------------------------------------------------


def test_without_pandas_the_rest_runs(monkeypatch):
    """Where pandas is not installed (the card's machine), building a
    pandas UDF works, applying it raises ModuleNotFoundError naming pandas,
    and the frame and session paths that need no pandas run."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    udf = F.pandas_udf(lambda s: s)
    with pytest.raises(ModuleNotFoundError, match="pandas"):
        udf("x")
    with pytest.raises(ModuleNotFoundError, match="pandas"):
        DataFrame.fromColumns({"x": [1]}).toPandas()
    spark = SparkSession.builder.getOrCreate()
    df = spark.createDataFrame([(1, "a"), (2, None)], ["id", "s"]).toDF("i", "t")
    assert [r["i"] for r in df.collect()] == [1, 2]
