"""The frame's NA handling, partitioning, actions, plan metadata, views and
line files (``sparkdl_tpu_torch/dataframe/frame.py``) against the JAX
package's on the CPU.

Both packages get the same seeded numpy columns on three partitions (ints,
floats and strings with NULLs, booleans, tensor cells). Rows compare
exactly and in order; a call the JAX package refuses, the port refuses
with the same error type and message. Files cross both ways: what the
port writes, the JAX package reads, and the reverse, with the rows equal.
Cases are drawn from the JAX package's ``test_dataframe.py``,
``test_parity_round5b.py``, ``test_functions_round5g.py`` and
``test_functions_round5h.py``.
"""

import math
import os

import numpy as np
import pytest

from sparkdl_tpu import functions as JF
from sparkdl_tpu import sql as jax_sql
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch import sql as port_sql
from sparkdl_tpu_torch.dataframe import DataFrame


def columns(seed: int = 5, n: int = 30) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "id": list(range(n)),
        "i": [None if rng.random() < 0.15 else int(v) for v in rng.integers(-9, 9, n)],
        "f": [None if rng.random() < 0.15 else round(float(v), 3) for v in rng.normal(0.0, 3.0, n)],
        "s": [None if rng.random() < 0.15 else "pqr"[int(v)] for v in rng.integers(0, 3, n)],
        "flag": [None if rng.random() < 0.1 else bool(v) for v in rng.integers(0, 2, n)],
        "vec": [rng.normal(size=2).astype(np.float32) for _ in range(n)],
    }


class Side:
    def __init__(self, frame_cls, fn):
        self.df = frame_cls.fromColumns(columns(), numPartitions=3)
        self.DataFrame = frame_cls
        self.F = fn


@pytest.fixture(scope="module")
def sides():
    return Side(DataFrame, F), Side(JaxDataFrame, JF)


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


def outcome(call):
    try:
        got = call()
    except Exception as e:  # noqa: BLE001 — compared below
        return ("raises", type(e).__name__, str(e))
    if hasattr(got, "collect"):
        return ("rows", got.columns, got.numPartitions, rows(got))
    return ("value", _norm(got))


def same(sides, build):
    ours, ref = sides
    got, want = outcome(lambda: build(ours)), outcome(lambda: build(ref))
    assert got == want
    return got


NA = {
    "dropna": lambda s: s.df.dropna(),
    "dropna-all": lambda s: s.df.dropna("all", subset=["i", "f"]),
    "dropna-thresh": lambda s: s.df.dropna(thresh=5),
    "dropna-thresh-subset": lambda s: s.df.dropna(thresh=1, subset=["i", "s"]),
    "dropna-subset-str": lambda s: s.df.dropna(subset="s"),
    "dropna-legacy-list": lambda s: s.df.dropna(["i", "f"]),
    "dropna-legacy-col": lambda s: s.df.dropna("f"),
    "dropna-bad-how": lambda s: s.df.dropna("some"),
    "dropna-missing": lambda s: s.df.dropna(subset=["nope"]),
    "fillna-scalar": lambda s: s.df.fillna(0),
    "fillna-subset": lambda s: s.df.fillna(-1, subset=["i", "f"]),
    "fillna-subset-str": lambda s: s.df.fillna("?", subset="s"),
    "fillna-dict": lambda s: s.df.fillna({"i": 7, "s": "none", "flag": False}),
    "fillna-missing": lambda s: s.df.fillna({"nope": 1}),
    "na.drop": lambda s: s.df.na.drop(how="any", subset=["flag"]),
    "na.fill": lambda s: s.df.na.fill(2.5, ["f"]),
    "na.replace": lambda s: s.df.na.replace("p", "P", ["s"]),
    "replace-scalar": lambda s: s.df.replace(1, 100),
    "replace-list": lambda s: s.df.replace(["p", "q"], ["P", "Q"]),
    "replace-dict": lambda s: s.df.replace({0: -100, "r": "R"}, subset=["i", "s"]),
    "replace-bool-zero": lambda s: s.df.replace(0, 5, subset=["flag", "i"]),
    "replace-bool": lambda s: s.df.replace(True, False),
    "replace-tensors": lambda s: s.df.replace(1.0, 2.0, subset=["vec", "f"]),
    "replace-str-subset": lambda s: s.df.replace("p", "P", "s"),
    "replace-dict-and-value": lambda s: s.df.replace({1: 2}, 3),
    "replace-list-mismatch": lambda s: s.df.replace([1, 2], [3]),
    "replace-no-value": lambda s: s.df.replace(1),
    "replace-missing": lambda s: s.df.replace(1, 2, subset=["nope"]),
}


@pytest.mark.parametrize("name", list(NA))
def test_na_handling_equals_the_jax_package(sides, name):
    same(sides, NA[name])


def test_dropna_keeps_what_python_keeps(sides):
    ours, _ = sides
    cols = columns()
    want = [i for i in cols["id"] if all(cols[c][i] is not None for c in ("i", "f"))]
    assert [r["id"] for r in ours.df.dropna(subset=["i", "f"]).collect()] == want


PARTITIONING = {
    "repartition-1": lambda s: s.df.repartition(1),
    "repartition-2": lambda s: s.df.repartition(2),
    "repartition-7": lambda s: s.df.repartition(7),
    "byRange": lambda s: s.df.repartitionByRange(2, "i"),
    "byRange-keep-count": lambda s: s.df.repartitionByRange("f"),
    "byRange-desc": lambda s: s.df.repartitionByRange(4, s.F.col("f").desc()),
    "byRange-two-keys": lambda s: s.df.repartitionByRange(3, "s", "i"),
    "byRange-zero": lambda s: s.df.repartitionByRange(0, "i"),
    "byRange-no-key": lambda s: s.df.repartitionByRange(2),
    "coalesce-1": lambda s: s.df.coalesce(1),
    "coalesce-2": lambda s: s.df.coalesce(2),
    "coalesce-more": lambda s: s.df.coalesce(5),
    "coalesce-zero": lambda s: s.df.coalesce(0),
    "coalesce-planned": lambda s: s.df.filter(lambda r: r["i"] is not None).select("id", "i").coalesce(2),
    "coalesce-seeded": lambda s: s.df.withColumn("u", s.F.rand(3)).withColumn(
        "m", s.F.monotonically_increasing_id()).coalesce(2),
    "sortWithin": lambda s: s.df.sortWithinPartitions("i"),
    "sortWithin-two": lambda s: s.df.sortWithinPartitions("s", "f", ascending=[False, True]),
    "sortWithin-desc": lambda s: s.df.sortWithinPartitions(s.F.col("f").desc()),
    "sortWithin-nulls-last": lambda s: s.df.sortWithinPartitions(s.F.col("i").asc_nulls_last(), "id"),
    "sortWithin-nulls-first": lambda s: s.df.sortWithinPartitions(s.F.col("i").desc_nulls_first()),
    "sortWithin-expression": lambda s: s.df.sortWithinPartitions(s.F.col("i") + 1),
    "sortWithin-none": lambda s: s.df.sortWithinPartitions(),
    "sortWithin-mismatch": lambda s: s.df.sortWithinPartitions("i", "f", ascending=[True]),
    "sortWithin-missing": lambda s: s.df.sortWithinPartitions("nope"),
    "melt": lambda s: s.df.melt("id", ["i", "s"]),
    "melt-default-values": lambda s: s.df.select("id", "i", "f").melt(["id"], None, "var", "val"),
    "melt-str-values": lambda s: s.df.unpivot("id", "flag"),
    "melt-collision": lambda s: s.df.melt("id", ["i"], "id"),
    "melt-no-values": lambda s: s.df.select("id").melt("id"),
    "melt-missing-id": lambda s: s.df.melt("nope", ["i"]),
    "melt-missing-value": lambda s: s.df.melt("id", ["nope"]),
}


@pytest.mark.parametrize("name", list(PARTITIONING))
def test_partitioning_equals_the_jax_package(sides, name):
    same(sides, PARTITIONING[name])


def test_coalesce_stays_lazy_and_runs_each_child_once(sides):
    """The parent's plan runs at the first access of a merged partition,
    once per child, with the child's own index (the JAX package's
    ``_CoalescedPartition``)."""
    ours, _ = sides
    calls = []

    def tagged(part, index):
        calls.append(index)
        return dict(part, where=[index] * len(part["id"]))

    tagged._indexed = True
    planned = ours.df.mapPartitions(tagged, ours.df.columns + ["where"])
    merged = planned.coalesce(2)
    assert calls == [] and merged.numPartitions == 2
    got = [r["where"] for r in merged.collect()]
    assert sorted(calls) == [0, 1, 2]
    assert got == [r["where"] for r in planned.collect()]


def test_repartition_by_range_cuts_ordered_ranges(sides):
    ours, _ = sides
    ranged = ours.df.dropna(subset=["f"]).repartitionByRange(3, "f")
    spans = [[r["f"] for r in DataFrame([p], ranged.columns).collect()] for p in ranged._source]
    assert [len(s) for s in spans] == [len(x) for x in np.array_split(np.zeros(sum(map(len, spans))), 3)]
    assert all(max(a) <= min(b) for a, b in zip(spans, spans[1:]))


ACTIONS = {
    "toJSON": lambda s: s.df.toJSON(),
    "toJSON-planned": lambda s: s.df.select("id", "s").filter(lambda r: r["s"] is None).toJSON(),
    "toLocalIterator": lambda s: list(s.df.toLocalIterator()),
    "tail": lambda s: s.df.tail(4),
    "hint": lambda s: s.df.hint("broadcast", 1),
    "persist": lambda s: s.df.select("id", "f").persist("MEMORY_ONLY"),
    "unpersist": lambda s: s.df.unpersist(True),
    "checkpoint": lambda s: s.df.filter(lambda r: r["i"] is not None).checkpoint(False),
    "localCheckpoint": lambda s: s.df.select("id").localCheckpoint(),
    "colRegex": lambda s: s.df.select(*s.df.colRegex("`^[if].*`")),
    "colRegex-plain": lambda s: s.df.select("id", *s.df.colRegex("s|flag")),
    "to": lambda s: s.df.to("f double, zz string, id long"),
    "to-list": lambda s: s.df.to(["s", "id"]),
    "to-bad": lambda s: s.df.to(3),
    "withMetadata": lambda s: s.df.withMetadata("i", {"comment": "x"}),
    "withMetadata-missing": lambda s: s.df.withMetadata("nope", {}),
    "withMetadata-not-dict": lambda s: s.df.withMetadata("i", [1]),
    "fromRows": lambda s: s.DataFrame.fromRows([{"a": 1, "b": None}, {"a": 2, "b": "x"}], numPartitions=2),
    "fromRows-empty": lambda s: s.DataFrame.fromRows([]),
    "isLocal": lambda s: s.df.isLocal(),
    "isStreaming": lambda s: s.df.isStreaming,
    "inputFiles-memory": lambda s: s.df.inputFiles(),
}


@pytest.mark.parametrize("name", list(ACTIONS))
def test_actions_and_plan_metadata_equal_the_jax_package(sides, name):
    same(sides, ACTIONS[name])


def test_foreach_and_foreach_partition_see_every_row(sides):
    seen = []
    for side in sides:
        side_rows, parts = [], []
        side.df.foreach(lambda r: side_rows.append(r["id"]))
        side.df.foreachPartition(lambda p: parts.append(len(p["id"])))
        seen.append((sorted(side_rows), parts))
    assert seen[0] == seen[1] == (list(range(30)), [10, 10, 10])


def test_explain_prints_the_same_header(sides, capsys):
    out = []
    for side in sides:
        side.df.select("id", "i").filter(lambda r: True).explain()
        out.append(capsys.readouterr().out.splitlines())
    ours, ref = out
    assert ours[:3] == ref[:3] == ["DataFrame[id, i]", "  partitions: 3", f"  pending ops: {len(ours) - 3}"]
    assert len(ours) == len(ref)


def test_same_semantics_semantic_hash_and_session(sides):
    from sparkdl_tpu_torch.session import SparkSession

    for side in sides:
        df = side.df
        clone = side.DataFrame(df._source, df.columns, list(df._ops))
        assert df.sameSemantics(df) and df.sameSemantics(clone) and df.semanticHash() == clone.semanticHash()
        assert not df.sameSemantics(df.select("id")) and not df.sameSemantics("x")
    ours, _ = sides
    session = ours.df.sparkSession
    try:
        assert session is SparkSession.getActiveSession() and ours.df.sparkSession is session
    finally:
        session.stop()


def test_input_files_of_a_lazy_scan(sides, tmp_path):
    ours, ref = sides
    path = str(tmp_path / "t.parquet")
    ours.df.select("id", "i", "s").writeParquet(path)
    scans = [ours.DataFrame.scanParquet(path, numPartitions=2), ref.DataFrame.scanParquet(path, numPartitions=2)]
    assert scans[0].inputFiles() == scans[1].inputFiles() == [path, path]
    assert rows(scans[0]) == rows(scans[1]) == rows(ours.df.select("id", "i", "s"))


def test_views_and_global_temp_resolve_in_sql(sides):
    query = "SELECT s, count(*) AS n, sum(i) AS t FROM global_temp.port_g21 GROUP BY s ORDER BY s"
    outcomes = []
    for side, mod in zip(sides, (port_sql, jax_sql)):
        df = side.df
        try:
            df.createTempView("port_v21")
            with pytest.raises(ValueError, match="already exists"):
                df.createTempView("port_v21")
            df.createGlobalTempView("port_g21")
            with pytest.raises(ValueError, match="Global temp view 'port_g21' already exists"):
                df.createGlobalTempView("port_g21")
            first = rows(mod.sql(query))
            df.filter(lambda r: r["s"] == "p").createOrReplaceGlobalTempView("port_g21")
            outcomes.append((first, rows(mod.sql(query)), rows(mod.sql("SELECT count(*) AS c FROM port_v21"))))
        finally:
            mod.dropTempTable("port_v21")
            mod.dropTempTable("global_temp.port_g21")
    assert outcomes[0] == outcomes[1]
    assert len(outcomes[0][0]) == 4 and outcomes[0][1][0]["s"] == "p"


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt", ["csv", "csv-no-header", "json"])
def test_line_files_cross_between_the_packages(sides, tmp_path, writer, fmt):
    """What one package writes, both read to the same rows."""
    ours, ref = sides
    src = (ours if writer == "port" else ref).df.select("id", "i", "f", "s", "flag")
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "json":
        src.writeJSON(path)
        back = [ours.DataFrame.readJSON(path, 2), ref.DataFrame.readJSON(path, 2)]
    else:
        header = fmt == "csv"
        src.writeCSV(path, header=header)
        back = [ours.DataFrame.readCSV(path, header=header, numPartitions=2),
                ref.DataFrame.readCSV(path, header=header, numPartitions=2)]
    assert outcome(lambda: back[0]) == outcome(lambda: back[1])
    if fmt == "json":
        assert rows(back[0]) == rows(src)


def test_json_lines_carry_numpy_and_nested_cells(sides, tmp_path):
    ours, ref = sides
    data = {"id": [1, 2], "v": [np.arange(3, dtype=np.float32), np.array([0.5, 1.5])],
            "n": [np.int64(4), None], "d": [{"a": np.float64(2.0), "b": [np.int32(1)]}, None]}
    out = []
    for side in (ours, ref):
        path = str(tmp_path / f"{side.DataFrame.__module__.split('.')[0]}.json")
        side.DataFrame.fromColumns(data).writeJSON(path)
        with open(path) as f:
            out.append(f.read())
    assert out[0] == out[1]
    assert rows(ours.DataFrame.readJSON(os.path.join(tmp_path, "sparkdl_tpu_torch.json"))) == [
        {"id": 1, "v": [0.0, 1.0, 2.0], "n": 4, "d": {"a": 2.0, "b": [1]}},
        {"id": 2, "v": [0.5, 1.5], "n": None, "d": None}]


CSV_TEXTS = {
    "strict-numbers": "a,b,c,d\n1,2.5,12_34, 5\n-3,1e3,nan,x\n",
    "ragged": "a,b\n1\n2,3,4\n\n5,\n",
    "quoted": 'a,b\n"x,y",1\n"say ""hi""",2\n',
    "duplicate-header": "a,a\n1,2\n",
    "empty": "",
}


@pytest.mark.parametrize("name", list(CSV_TEXTS))
@pytest.mark.parametrize("header,infer", [(True, True), (False, True), (True, False)])
def test_read_csv_infers_as_the_jax_package(sides, tmp_path, name, header, infer):
    path = tmp_path / "t.csv"
    path.write_text(CSV_TEXTS[name])
    same(sides, lambda s: s.DataFrame.readCSV(str(path), header=header, inferSchema=infer))


def test_read_json_unions_the_keys(sides, tmp_path):
    path = tmp_path / "t.json"
    path.write_text('{"a": 1}\n\n{"b": [1, 2], "a": null}\n{"c": {"x": 1}}\n')
    same(sides, lambda s: s.DataFrame.readJSON(str(path), numPartitions=2))
    (tmp_path / "e.json").write_text("\n")
    same(sides, lambda s: s.DataFrame.readJSON(str(tmp_path / "e.json")))


def test_the_pandas_surfaces_stay_refused(sides):
    """Refused until they were ported (the test keeps its name): ``toPandas``
    and ``mapInPandas`` now give the JAX package's frame and rows, nullable
    ints, bools, strings and a tensor column included."""
    import pandas as pd

    ours, ref = sides
    pd.testing.assert_frame_equal(ours.df.toPandas(), ref.df.toPandas())
    same(sides, lambda s: s.df.mapInPandas(lambda it: it, "id long, i long, f double, s string, flag boolean, vec"))
    same(sides, lambda s: s.df.mapInPandas(lambda it: (p[p["id"] % 2 == 0][["id", "s"]] for p in it), "id, s"))
