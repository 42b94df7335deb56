"""The port's ``SparkSession`` (``sparkdl_tpu_torch/session.py``) against
the JAX package's ``session.py`` on the CPU: the builder and the active
session, ``createDataFrame`` in each of its forms, ``sql``/``table`` over
``createOrReplaceTempView`` and ``spark.udf.register``; rows compared
exactly."""

import pytest

from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.session import SparkSession as JaxSparkSession
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.session import SparkSession

ROWS = [(1, "a", 0.5), (2, "b", None), (3, None, 2.0)]
DICT_ROWS = [{"id": 1, "s": "a"}, {"id": 2, "x": 7.5}, {"s": "c"}]
COLUMNS = {"id": [1, 2, 3], "s": ["a", "b", None]}


@pytest.fixture
def sessions():
    ours = SparkSession.builder.appName("port").config("k", 1).getOrCreate()
    ref = JaxSparkSession.builder.appName("port").config("k", 1).getOrCreate()
    yield ours, ref
    ours.stop()
    ref.stop()


def _data(rows):
    return [dict(r) for r in rows]


def test_builder_and_active_session(sessions):
    ours, ref = sessions
    assert SparkSession.getActiveSession() is ours
    again = SparkSession.builder.master("local[4]").config(extra="v").getOrCreate()
    assert again is ours
    assert ours.conf == {"spark.app.name": "port", "k": 1, "spark.master": "local[4]", "extra": "v"}
    JaxSparkSession.builder.master("local[4]").config(extra="v").getOrCreate()
    assert dict(ref.conf) == ours.conf
    ours.stop()
    assert SparkSession.getActiveSession() is None
    fresh = SparkSession.builder.getOrCreate()
    assert fresh is not ours and fresh.conf == {}


@pytest.mark.parametrize(
    "args",
    [(ROWS, ["id", "s", "v"]), (DICT_ROWS, None), (COLUMNS, None)],
    ids=["tuples", "dicts", "columns"],
)
def test_create_data_frame_matches_jax(sessions, args):
    ours, ref = sessions
    got, want = ours.createDataFrame(*args), ref.createDataFrame(*args)
    assert got.columns == want.columns
    assert _data(got.collect()) == _data(want.collect())


def test_create_data_frame_refusals(sessions):
    ours, ref = sessions
    for session in (ours, ref):
        with pytest.raises(ValueError, match="at least one row"):
            session.createDataFrame([])
        with pytest.raises(ValueError, match="column names"):
            session.createDataFrame(ROWS)
        with pytest.raises(ValueError, match="Duplicate"):
            session.createDataFrame(ROWS, ["a", "a", "b"])


def test_sql_and_table_over_a_temp_view(sessions):
    ours, ref = sessions
    query = "SELECT id, v * 2 AS w FROM port_session_t WHERE v IS NOT NULL ORDER BY id DESC"
    ours.createDataFrame(ROWS, ["id", "s", "v"]).createOrReplaceTempView("port_session_t")
    ref.createDataFrame(ROWS, ["id", "s", "v"]).createOrReplaceTempView("port_session_t")
    try:
        assert _data(ours.sql(query).collect()) == _data(ref.sql(query).collect()) == [
            {"id": 3, "w": 4.0}, {"id": 1, "w": 1.0}
        ]
        assert _data(ours.table("port_session_t").collect()) == _data(ref.table("port_session_t").collect())
    finally:
        from sparkdl_tpu import sql as jax_sql
        from sparkdl_tpu_torch import sql as torch_sql

        torch_sql.dropTempTable("port_session_t")
        jax_sql.dropTempTable("port_session_t")
    with pytest.raises(KeyError):
        ours.table("port_session_t")


def test_udf_register_is_callable_from_sql(sessions):
    ours, ref = sessions
    query = "SELECT port_twice(id) AS t FROM port_session_u WHERE port_twice(id) > 2"
    for session in (ours, ref):
        session.udf.register("port_twice", lambda v: None if v is None else 2 * v)
        session.createDataFrame(COLUMNS).createOrReplaceTempView("port_session_u")
    try:
        assert _data(ours.sql(query).collect()) == _data(ref.sql(query).collect()) == [{"t": 4}, {"t": 6}]
        assert not udf_catalog.get("port_twice").vectorized
    finally:
        from sparkdl_tpu import sql as jax_sql
        from sparkdl_tpu_torch import sql as torch_sql

        udf_catalog.unregister("port_twice")
        jax_udf.unregister("port_twice")
        torch_sql.dropTempTable("port_session_u")
        jax_sql.dropTempTable("port_session_u")


def test_udf_register_takes_one_positional_argument(sessions):
    ours, ref = sessions
    for session in (ours, ref):
        with pytest.raises(ValueError, match="one column per UDF"):
            session.udf.register("port_two", lambda a, b: a)
        fn = lambda a, b=1: a  # noqa: E731
        assert session.udf.register("port_default", fn) is fn
    udf_catalog.unregister("port_default")
    jax_udf.unregister("port_default")
    assert "port_two" not in udf_catalog.list_udfs()
