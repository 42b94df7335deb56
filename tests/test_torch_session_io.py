"""The session's readers, writers, catalog and conf
(``sparkdl_tpu_torch/session.py``: ``spark.read``, ``df.write``,
``spark.range``, ``spark.catalog``, ``spark.conf``, ``newSession``,
``sparkContext``, ``version``, ``enableHiveSupport`` and DDL-string
schemas in ``createDataFrame``) against the JAX package's on the CPU.

Rows compare exactly; a call the JAX package refuses, the port refuses
with the same error type and message. Parquet crosses both ways: the port
writes with its own writer and the JAX package reads with pyarrow, and the
reverse, float32 embeddings bit-equal. Cases are drawn from the JAX
package's ``test_session.py``, ``test_parity_round5b.py`` and
``test_functions_round5h.py``. Last, ``chip_smoke.py``'s phase 26 runs
here at a cut size.
"""

import math
import os

import numpy as np
import pytest

from sparkdl_tpu import sql as jax_sql
from sparkdl_tpu.session import AnalysisException as JaxAnalysisException
from sparkdl_tpu.session import SparkSession as JaxSparkSession
from sparkdl_tpu_torch import sql as port_sql
from sparkdl_tpu_torch.session import AnalysisException, SparkSession
from sparkdl_tpu_torch.sql import UnsupportedSQL

ROWS = [(1, "a", 0.5), (2, None, 1.25), (3, "c", None), (4, "d", -2.0)]


@pytest.fixture
def sessions():
    ours = SparkSession.builder.appName("io").getOrCreate()
    ref = JaxSparkSession.builder.appName("io").getOrCreate()
    yield ours, ref
    ours.stop()
    ref.stop()


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


def same(sessions, build):
    ours, ref = sessions
    got, want = outcome(lambda: build(ours)), outcome(lambda: build(ref))
    assert got == want
    return got


SCHEMAS = {
    "names": ["id", "s", "v"],
    "tuple": ("id", "s", "v"),
    "ddl": "id long, s string, v double",
    "ddl-colons": "id: long, s:string,v double",
    "ddl-nested": "id map<string,int>, s decimal(10,2), v array<struct<x:int,y:int>>",
    "ddl-spaces": "  id long ,  s string,v  double  ",
    "ddl-duplicate": "id long, id string, v double",
    "ddl-empty": " , ",
    "not-a-schema": 3,
    "duplicate-names": ["a", "a", "b"],
}


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_create_data_frame_takes_ddl_schemas(sessions, name):
    got = same(sessions, lambda s: s.createDataFrame(ROWS, SCHEMAS[name]))
    if name.startswith(("names", "tuple", "ddl-")) and name not in ("ddl-duplicate", "ddl-empty"):
        assert got[1] == ["id", "s", "v"]


def test_a_pandas_frame_stays_refused(sessions):
    """Refused until it was ported (the test keeps its name): a pandas frame
    in ``createDataFrame`` gives the JAX package's rows, and a pandas
    Series still fails as it fails there."""
    import pandas as pd

    same(sessions, lambda s: s.createDataFrame(pd.DataFrame({"x": [1, 2], "s": ["a", None], "f": [0.5, None]})))
    same(sessions, lambda s: s.createDataFrame(pd.Series([1, 2])))
    assert issubclass(UnsupportedSQL, ValueError)


RANGES = [(4,), (2, 9, 3), (10,), (5, 0, -2), (0,), (3, 3)]


@pytest.mark.parametrize("args", RANGES, ids=[str(a) for a in RANGES])
@pytest.mark.parametrize("parts", [None, 3])
def test_range_equals_the_jax_package(sessions, args, parts):
    got = same(sessions, lambda s: s.range(*args, numPartitions=parts))
    ours, _ = sessions
    df = ours.range(*args, numPartitions=parts)
    assert all(type(v) is np.int64 for v in df.collectColumns()["id"])
    assert got[0] == "rows"


READS = {
    "csv": lambda r, p: r.csv(p["csv"]),
    "csv-header-option": lambda r, p: r.option("header", "true").csv(p["csv"]),
    "csv-header-arg": lambda r, p: r.csv(p["csv"], header=True),
    "csv-header-true": lambda r, p: r.option("header", True).csv(p["csv"]),
    "csv-partitions": lambda r, p: r.options(header="1", numPartitions=3).csv(p["csv"]),
    "json": lambda r, p: r.json(p["json"]),
    "json-partitions": lambda r, p: r.option("num_partitions", 2).json(p["json"]),
    "text": lambda r, p: r.text(p["text"]),
    "format-csv": lambda r, p: r.format("CSV").option("header", "true").load(p["csv"]),
    "format-json": lambda r, p: r.format("json").load(p["json"]),
    "format-text": lambda r, p: r.format("text").load(p["text"]),
    "format-option-inert": lambda r, p: r.option("format", "text").format("json").load(p["json"]),
    "format-avro": lambda r, p: r.format("avro"),
}


@pytest.mark.parametrize("name", list(READS))
def test_the_readers_equal_the_jax_package(sessions, tmp_path, name):
    ours, _ = sessions
    df = ours.createDataFrame(ROWS, "id long, s string, v double")
    paths = {"csv": str(tmp_path / "t.csv"), "json": str(tmp_path / "t.json"), "text": str(tmp_path / "t.txt")}
    df.writeCSV(paths["csv"])
    df.writeJSON(paths["json"])
    (tmp_path / "t.txt").write_bytes("a b\nc d\r\n\ne\n".encode("utf-8"))
    same(sessions, lambda s: READS[name](s.read, paths))


WRITES = {
    "parquet": lambda w, p: w.parquet(p),
    "csv": lambda w, p: w.csv(p),
    "csv-header": lambda w, p: w.csv(p, header=True),
    "json": lambda w, p: w.json(p),
    "format-json": lambda w, p: w.format("json").save(p),
    "format-avro": lambda w, p: w.format("avro"),
    "mode-append": lambda w, p: w.mode("append"),
}


@pytest.mark.parametrize("name", list(WRITES))
def test_the_writers_and_their_modes_equal_the_jax_package(sessions, tmp_path, name):
    """errorifexists is the default; ``mode`` changes the writer it returns;
    each package reads back what the other wrote."""
    outcomes = []
    for session, other in (sessions, sessions[::-1]):
        df = session.createDataFrame(ROWS, ["id", "s", "v"])
        path = str(tmp_path / name)  # one path, so that the messages compare
        if os.path.exists(path):
            os.remove(path)
        first = outcome(lambda: WRITES[name](df.write, path))
        again = outcome(lambda: WRITES[name](df.write, path))
        w = df.write
        w.mode("Overwrite")
        forced = outcome(lambda: WRITES[name](w, path))
        fmt = "parquet" if name == "parquet" else ("json" if "json" in name else "csv")
        back = [outcome(lambda s=s: getattr(s.read.option("header", name == "csv-header"), fmt)(path))
                for s in (session, other)] if first == ("value", None) else []
        outcomes.append((first, again, forced, back))
    assert outcomes[0][:3] == outcomes[1][:3]
    if outcomes[0][3]:
        assert outcomes[0][3][0] == outcomes[0][3][1] == outcomes[1][3][0] == outcomes[1][3][1]
        assert outcomes[0][1][1] == "FileExistsError"


def test_write_text_takes_one_column(sessions, tmp_path):
    got = []
    for session in sessions:
        df = session.createDataFrame(ROWS, ["id", "s", "v"])
        path = tmp_path / "s.txt"
        if path.exists():
            path.unlink()
        df.select("s").write.text(str(path))
        got.append((path.read_text(), outcome(lambda: df.write.text(str(path) + "x")),
                    outcome(lambda: df.select("s").write.text(str(path)))))
    assert got[0] == got[1]
    assert got[0][0] == "a\n\nc\nd\n"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parquet_crosses_with_float32_embeddings_bit_equal(sessions, tmp_path, writer):
    rng = np.random.default_rng(21)
    data = {"id": list(range(12)), "s": [None if i % 5 == 0 else f"r{i}" for i in range(12)],
            "emb": [rng.normal(size=8).astype(np.float32) for _ in range(12)],
            "score": [float(v) for v in rng.normal(size=12)]}
    ours, ref = sessions
    src = (ours if writer == "port" else ref).createDataFrame(data)
    path = str(tmp_path / "emb.parquet")
    src.write.parquet(path)
    backs = [ours.read.option("numPartitions", 3).parquet(path), ref.read.option("numPartitions", 3).parquet(path)]
    assert rows(backs[0]) == rows(backs[1])
    for back in backs:
        cols = back.collectColumns()
        assert [int(i) for i in cols["id"]] == data["id"] and list(cols["s"]) == data["s"]
        assert all(np.asarray(a).dtype == np.float32 and np.asarray(a).tobytes() == b.tobytes()
                   for a, b in zip(cols["emb"], data["emb"]))


def test_the_json_writer_keeps_float32_embeddings(sessions, tmp_path):
    ours, ref = sessions
    embs = [np.random.default_rng(i).normal(size=5).astype(np.float32) for i in range(4)]
    df = ours.createDataFrame({"id": [0, 1, 2, 3], "emb": embs})
    path = str(tmp_path / "emb.json")
    df.write.json(path)
    for back in (ours.read.json(path), ref.read.json(path)):
        got = back.collectColumns()["emb"]
        assert all(np.asarray(a, np.float32).tobytes() == b.tobytes() for a, b in zip(got, embs))


CATALOG = {
    "tableExists": lambda c: c.tableExists("io_t"),
    "tableExists-db": lambda c: c.tableExists("io_t", "default"),
    "tableExists-qualified": lambda c: c.tableExists("default.io_t"),
    "tableExists-other-db": lambda c: c.tableExists("io_t", "global_temp"),
    "tableExists-global": lambda c: c.tableExists("io_g", "global_temp"),
    "tableExists-global-qualified": lambda c: c.tableExists("global_temp.io_g"),
    "tableExists-missing": lambda c: c.tableExists("io_missing"),
    "listTables-global": lambda c: c.listTables("global_temp"),
    "listTables-default": lambda c: [t for t in c.listTables("default") if t.name.startswith("io_")],
    "listTables": lambda c: [t for t in c.listTables() if t.name.startswith("io_")],
    "listColumns": lambda c: c.listColumns("io_t"),
    "listColumns-db": lambda c: c.listColumns("io_g", "global_temp"),
    "listColumns-qualified": lambda c: [x.name for x in c.listColumns("default.io_t")],
    "listColumns-missing": lambda c: c.listColumns("io_missing", "default"),
    "currentDatabase": lambda c: c.currentDatabase(),
    "listDatabases": lambda c: c.listDatabases(),
    "dropTempView": lambda c: (c.dropTempView("io_t"), c.tableExists("io_t"), c.dropTempView("io_t")),
    "dropGlobalTempView": lambda c: (c.dropGlobalTempView("io_g"), c.tableExists("io_g", "global_temp"),
                                     c.listTables("global_temp")),
}


@pytest.mark.parametrize("name", list(CATALOG))
def test_the_catalog_equals_the_jax_package(sessions, name):
    got = []
    for session, mod in zip(sessions, (port_sql, jax_sql)):
        df = session.createDataFrame(ROWS, ["id", "s", "v"])
        df.createOrReplaceTempView("io_t")
        df.select("id").createGlobalTempView("io_g")
        try:
            got.append(outcome(lambda: CATALOG[name](session.catalog)))
        finally:
            mod.dropTempTable("io_t")
            mod.dropTempTable("global_temp.io_g")
    if name == "listColumns-missing":
        assert got[0][:2] == ("raises", "AnalysisException") and got[0] == got[1]
        with pytest.raises(AnalysisException, match="Table or view not found: io_missing"):
            sessions[0].catalog.listColumns("io_missing")
        assert not issubclass(AnalysisException, JaxAnalysisException)
    assert got[0] == got[1]


def test_the_runtime_conf_equals_the_jax_package(sessions):
    got = []
    for session in sessions:
        conf = session.conf
        conf.set("spark.sql.shuffle.partitions", "4")
        steps = [conf.get("spark.sql.shuffle.partitions"), conf.get("missing.key", "dflt"),
                 outcome(lambda: conf.get("missing.key")), conf.isModifiable("anything")]
        conf.unset("spark.sql.shuffle.partitions")
        conf.unset("never.set")
        conf["k"] = "v"
        steps += [conf.get("spark.sql.shuffle.partitions", None), dict(conf)]
        del conf["k"]
        again = type(session).builder.config("k2", "v2").getOrCreate()
        steps += [again is session, dict(session.conf)]
        got.append(steps)
    assert got[0] == got[1]
    assert got[0][2][:2] == ("raises", "KeyError")


def test_builder_sessions_context_and_version(sessions):
    got = []
    for session in sessions:
        builder = type(session).builder.master("local[8]").enableHiveSupport()
        again = builder.getOrCreate()
        fresh = session.newSession()
        got.append((again is session, dict(session.conf), fresh is not session, dict(fresh.conf),
                    type(fresh.conf).__name__, outcome(lambda: session.sparkContext)[:2], session.version))
    assert got[0][:5] == got[1][:5]
    assert got[0][5] == got[1][5] == ("raises", "AttributeError")
    assert got[0][6] == got[1][6] == "0.1.0"
    with pytest.raises(AttributeError, match="RDD"):
        sessions[0].sparkContext


def test_a_range_joins_a_read_frame(sessions, tmp_path):
    """``spark.range(n)`` (int64 ids) joined to a frame read back from
    Parquet keeps every row, in both packages."""
    got = []
    for session in sessions:
        path = str(tmp_path / f"{type(session).__module__}.parquet")
        session.createDataFrame({"id": list(range(9)), "x": [i * 0.5 for i in range(9)]}).write.parquet(path)
        joined = session.range(9).join(session.read.parquet(path), "id")
        got.append(sorted((int(r["id"]), r["x"]) for r in joined.collect()))
    assert got[0] == got[1] == [(i, i * 0.5) for i in range(9)]


def test_chip_smoke_phase_26_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s phase 26 at cut sizes on the CPU: bert-tiny over
    24 texts, every check of the card's run (no flash launch on the CPU)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "F_TEXT_MODEL", "bert-tiny")
    monkeypatch.setattr(chip_smoke, "F_TEXTS", 24)
    monkeypatch.setattr(chip_smoke, "F_MAX_LENGTH", 128)
    try:
        assert chip_smoke.phase_frame_io(0, "cpu", str(tmp_path), device="cpu") == 0
    finally:
        SparkSession.builder.getOrCreate().stop()
