"""The port's SQL row-expression dialect (``sparkdl_tpu_torch/sql.py`` and
``sql_builtins.py``) against the JAX package's ``sql.py`` on the CPU.

- Every row builtin family (strings, math, trigonometry, codecs and
  digests, dates, arrays, maps, JSON, higher-order functions over lambdas,
  casts, the null-consuming and null-skipping forms), CASE, CAST,
  EXTRACT, ``||``, IS [NOT] DISTINCT FROM, ``<=>``, ILIKE/RLIKE, IN over
  expressions and literals of every kind: the same query over the same
  table (NULL and NaN cells, negative numbers, three partitions) through
  both packages; the rows must be equal (NaN equal to NaN, arrays as
  lists, exactly).
- The same expressions as Columns (``F.expr``) on both packages' frames.
- ORDER BY with NULLS FIRST/LAST and NaN keys.
- Pushdown with expressions, against the semantics of the JAX package's
  ``tests/test_sql_pushdown.py``: a column read only inside a CASE
  branch, a lambda body or a builtin's argument is kept by the pruned
  scan, and a conjunct with a builtin filters before a UDF scores a row.
- The relational constructs this file once listed as refused equal the
  JAX package's, and so do the windows, generators and LATERAL VIEW it
  refused after them.
"""

import math

import numpy as np
import pytest
import torch

from sparkdl_tpu import functions as JF
from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.sql import SQLContext as JaxSQLContext
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.sql import SQLContext
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_sql_windows import unknown_as_one

NAN = float("nan")


def table():
    """Nine rows over three partitions: NULL and NaN cells, negatives,
    empty strings and arrays, maps, JSON text, dates that cross month
    ends and a leap day."""
    return {
        "id": list(range(9)),
        "s": ["Hello World", "spark SQL", None, "", "  pad  ", "a,b,,c", "ÄÖü", "x1y22z333", "hello%_"],
        "n": [3, -7, None, 0, 12, 5, -1, 2 ** 40, 7],
        "m": [2, 3, 0, None, -5, 4, 7, 3, -2],
        "x": [1.5, -2.25, NAN, None, 0.0, 3.14159, -0.5, 1e10, 2.5],
        "y": [0.5, 4.0, 1.0, 2.0, None, -1.5, NAN, 0.1, -3.0],
        "flag": [True, False, None, True, False, True, None, False, True],
        "arr": [[1, 2, 3], [], None, [3, None, 1], [5], [2, 2, 4], [7, 8], [0], [-1, -2]],
        "words": [["b", "a"], ["x"], [], None, ["c", "c", "d"], ["a", None], ["z", "y", "x"], ["q"], ["m", "n"]],
        "mp": [{"a": 1, "b": 2}, {}, None, {"c": 3}, {"a": None}, {"x": 9, "y": 8}, {"k": 0}, {"a": 5}, {"b": 1}],
        "d": ["2024-01-31", "2023-02-28", None, "2024-02-29", "2020-12-31", "1999-07-04", "2024-03-31",
              "bad", "2000-01-01"],
        "ts": ["2024-01-31 13:45:10", "2023-02-28 00:00:00", None, "2024-02-29 23:59:59", "2020-12-31 12:00:00",
               "1999-07-04 06:30:15", "2024-03-31 01:02:03", "nope", "2000-01-01 00:00:01"],
        "js": ['{"a": 1, "b": {"c": [1, 2]}}', "[1, 2]", None, "not json", '{"a": "x"}', '{"b": null}',
               '{"a": 2.5}', "{}", '{"a": [3]}'],
        "tag": ["t0", None, "t1", "t3", None, "t0", "t2", "t3", "t1"],
    }


def _norm(v):
    """Exact comparison form: NaN as a marker, arrays as lists."""
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
    """An error as both packages can be compared on it: the class name
    and the message, past a partition task's retry preamble."""
    return type(e).__name__, str(e).rpartition("attempts: ")[2]


def assert_same_outcome(ours, ref):
    """``ours()`` returns what ``ref()`` returns, or fails as it fails (a
    builtin over a NaN cell can raise in the JAX package: the port
    raises the same)."""
    try:
        want = ref()
    except Exception as e:  # noqa: BLE001 — compared below
        with pytest.raises(Exception) as info:
            ours()
        assert _failure(info.value) == _failure(e)
        return
    assert ours() == want


@pytest.fixture(scope="module")
def contexts():
    ours, ref = SQLContext(), JaxSQLContext()
    ours.registerDataFrameAsTable(DataFrame.fromColumns(table(), numPartitions=3), "t")
    ref.registerDataFrameAsTable(JaxDataFrame.fromColumns(table(), numPartitions=3), "t")
    return ours, ref


@pytest.fixture(scope="module")
def frames():
    return DataFrame.fromColumns(table(), numPartitions=3), JaxDataFrame.fromColumns(table(), numPartitions=3)


#: (family, expression): each runs as ``SELECT id, <expr> AS v FROM t``
EXPRESSIONS = [
    # strings
    ("string", "upper(s)"), ("string", "lower(s)"), ("string", "length(s)"), ("string", "trim(s)"),
    ("string", "ltrim(s)"), ("string", "rtrim(s)"), ("string", "initcap(s)"), ("string", "reverse(s)"),
    ("string", "repeat(s, 2)"), ("string", "replace(s, 'l', 'L')"), ("string", "instr(s, 'o')"),
    ("string", "lpad(s, 8, '*')"), ("string", "rpad(s, 3, 'xy')"), ("string", "split(s, ',')"),
    ("string", "regexp_extract(s, '([a-z]+)([0-9]+)', 2)"), ("string", "regexp_replace(s, '[0-9]+', '#')"),
    ("string", "concat(s, '-', tag)"), ("string", "substring(s, 2, 3)"), ("string", "substring(s, -3, 2)"),
    ("string", "translate(s, 'lo', 'LO')"), ("string", "left(s, 2)"), ("string", "right(s, 2)"),
    ("string", "format_string('%s=%d', tag, id)"), ("string", "locate('l', s)"), ("string", "levenshtein(s, 'hello')"),
    ("string", "soundex(s)"), ("string", "ascii(s)"), ("string", "char_length(s)"), ("string", "bit_length(s)"),
    ("string", "octet_length(s)"), ("string", "btrim(s)"), ("string", "elt(2, s, tag)"),
    ("string", "find_in_set('b', s)"), ("string", "substring_index(s, ',', 2)"), ("string", "overlay(s, 'ZZ', 2, 1)"),
    ("string", "split_part(s, ',', 2)"), ("string", "regexp_count(s, '[a-z]')"), ("string", "regexp_instr(s, '[0-9]')"),
    ("string", "regexp_substr(s, '[0-9]+')"), ("string", "startswith(s, 'he')"), ("string", "endswith(s, 'L')"),
    ("string", "contains(s, 'a')"), ("string", "s || '|' || tag"), ("string", "concat_ws('/', s, tag, 'z')"),
    ("string", "format_number(x, 2)"), ("string", "chr(65 + id)"), ("string", "url_encode(s)"),
    # math
    ("math", "abs(n)"), ("math", "sqrt(x)"), ("math", "exp(y)"), ("math", "log(x)"), ("math", "log10(x)"),
    ("math", "log2(y)"), ("math", "pow(y, 2)"), ("math", "power(m, 3)"), ("math", "sign(x)"), ("math", "signum(n)"),
    ("math", "floor(x)"), ("math", "ceil(x)"), ("math", "round(x, 1)"), ("math", "round(n / 3, 2)"),
    ("math", "bround(y, 0)"), ("math", "greatest(n, m, id)"), ("math", "least(x, y)"), ("math", "n % m"),
    ("math", "n / m"), ("math", "-n % 3"), ("math", "n * 2 + m"), ("math", "x * y"), ("math", "isnan(x)"),
    ("math", "nanvl(x, y)"), ("math", "cbrt(m)"), ("math", "rint(x)"), ("math", "hypot(x, y)"),
    ("math", "factorial(m)"), ("math", "expm1(y)"), ("math", "log1p(y)"), ("math", "shiftleft(m, 2)"),
    ("math", "shiftright(n, 1)"), ("math", "shiftrightunsigned(n, 60)"), ("math", "try_add(n, m)"),
    ("math", "try_divide(n, m)"), ("math", "try_multiply(n, n)"), ("math", "negative(m)"), ("math", "positive(x)"),
    ("math", "ln(y)"), ("math", "e() + pi()"), ("math", "bin(m)"), ("math", "conv('ff', 16, 10)"),
    ("math", "hex(n)"),
    # trigonometry
    ("trig", "sin(x)"), ("trig", "cos(y)"), ("trig", "tan(x)"), ("trig", "asin(y)"), ("trig", "acos(y)"),
    ("trig", "atan(x)"), ("trig", "atan2(y, x)"), ("trig", "sinh(y)"), ("trig", "cosh(y)"), ("trig", "tanh(x)"),
    ("trig", "degrees(y)"), ("trig", "radians(x)"), ("trig", "sec(y)"), ("trig", "csc(y)"), ("trig", "cot(y)"),
    # codecs and digests
    ("codec", "md5(s)"), ("codec", "sha1(s)"), ("codec", "sha2(s, 256)"), ("codec", "crc32(s)"),
    ("codec", "hex(s)"), ("codec", "unhex(hex(s))"), ("codec", "base64(s)"), ("codec", "unbase64(base64(s))"),
    ("codec", "hash(s, n)"), ("codec", "url_decode(url_encode(s))"),
    # dates
    ("date", "to_date(d)"), ("date", "to_timestamp(ts)"), ("date", "year(to_date(d))"),
    ("date", "month(to_date(d))"), ("date", "dayofmonth(to_date(d))"), ("date", "dayofweek(to_date(d))"),
    ("date", "hour(to_timestamp(ts))"), ("date", "minute(to_timestamp(ts))"), ("date", "second(to_timestamp(ts))"),
    ("date", "date_add(to_date(d), 30)"), ("date", "date_sub(to_date(d), 1)"),
    ("date", "datediff(to_date(d), to_date('2024-01-01'))"), ("date", "date_format(to_timestamp(ts), 'yyyy/MM/dd HH')"),
    ("date", "add_months(to_date(d), 1)"), ("date", "months_between(to_date(d), to_date('2020-02-29'))"),
    ("date", "trunc(to_date(d), 'MM')"), ("date", "last_day(to_date(d))"), ("date", "next_day(to_date(d), 'Mon')"),
    ("date", "quarter(to_date(d))"), ("date", "weekofyear(to_date(d))"), ("date", "dayofyear(to_date(d))"),
    ("date", "unix_timestamp(ts)"), ("date", "from_unixtime(id * 86400)"), ("date", "timestamp_seconds(id * 3600)"),
    ("date", "date_trunc('HOUR', to_timestamp(ts))"), ("date", "make_date(2024, m, 29)"),
    ("date", "EXTRACT(month FROM to_date(d))"), ("date", "EXTRACT(doy FROM to_date(d))"),
    ("date", "timestampadd(HOUR, 3, to_timestamp(ts))"), ("date", "timestampdiff(DAY, to_date('2000-01-01'), to_date(d))"),
    ("date", "weekday(to_date(d))"), ("date", "unix_date(to_date(d))"), ("date", "date_part('year', to_date(d))"),
    # arrays
    ("array", "size(arr)"), ("array", "array(n, m, NULL)"), ("array", "sort_array(arr)"),
    ("array", "sort_array(arr, false)"), ("array", "array_distinct(arr)"), ("array", "array_max(arr)"),
    ("array", "array_min(arr)"), ("array", "array_contains(arr, 2)"), ("array", "element_at(arr, 1)"),
    ("array", "element_at(arr, -1)"), ("array", "get(arr, 0)"), ("array", "slice(arr, 1, 2)"),
    ("array", "flatten(array(arr, array(9)))"), ("array", "sequence(1, m)"), ("array", "arrays_zip(arr, words)"),
    ("array", "array_union(arr, array(1, 9))"), ("array", "array_intersect(arr, array(2, 3))"),
    ("array", "array_except(arr, array(2))"), ("array", "array_position(arr, 2)"), ("array", "array_remove(arr, 2)"),
    ("array", "array_repeat(tag, 2)"), ("array", "array_join(words, '+', '?')"), ("array", "array_append(arr, 0)"),
    ("array", "array_prepend(arr, 0)"), ("array", "array_insert(arr, 2, 99)"), ("array", "array_compact(arr)"),
    ("array", "array_size(words)"), ("array", "concat_ws(',', words)"),
    # maps
    ("map", "map_keys(mp)"), ("map", "map_values(mp)"), ("map", "element_at(mp, 'a')"),
    ("map", "map_contains_key(mp, 'a')"), ("map", "map_entries(mp)"), ("map", "create_map('k', id, 'v', n)"),
    ("map", "map_from_arrays(array('p', 'q'), array(n, m))"), ("map", "map_concat(mp, map('z', id))"),
    ("map", "map_from_entries(array(named_struct('key', 'a', 'value', id)))"),
    ("map", "named_struct('a', n, 'b', s)"),
    # JSON
    ("json", "get_json_object(js, '$.a')"), ("json", "get_json_object(js, '$.b.c[1]')"),
    ("json", "from_json(js)"), ("json", "to_json(mp)"), ("json", "to_json(arr)"),
    # higher-order
    ("hof", "transform(arr, v -> v * 2)"), ("hof", "transform(arr, (v, i) -> v + i)"),
    ("hof", "filter(arr, v -> v > 1)"), ("hof", "exists(arr, v -> v = 2)"), ("hof", "forall(arr, v -> v > 0)"),
    ("hof", "aggregate(arr, 0, (acc, v) -> acc + v)"), ("hof", "aggregate(arr, 0, (acc, v) -> acc + v, acc -> acc * 10)"),
    ("hof", "reduce(arr, 1, (acc, v) -> acc * v)"), ("hof", "zip_with(arr, arr, (a, b) -> a * b)"),
    ("hof", "map_filter(mp, (k, v) -> v > 1)"), ("hof", "transform_keys(mp, (k, v) -> upper(k))"),
    ("hof", "transform_values(mp, (k, v) -> v * 10)"), ("hof", "map_zip_with(mp, mp, (k, a, b) -> a + b)"),
    ("hof", "transform(arr, v -> v + n)"), ("hof", "filter(words, w -> w RLIKE '^[a-c]')"),
    ("hof", "transform(arr, v -> CASE WHEN v > 2 THEN 'big' ELSE 'small' END)"),
    # casts
    ("cast", "CAST(x AS STRING)"), ("cast", "CAST(n AS DOUBLE)"), ("cast", "CAST(x AS INT)"),
    ("cast", "CAST(s AS INT)"), ("cast", "CAST('3.7' AS BIGINT)"), ("cast", "CAST(flag AS STRING)"),
    ("cast", "CAST(n AS BOOLEAN)"), ("cast", "CAST('yes' AS BOOLEAN)"), ("cast", "TRY_CAST(s AS DOUBLE)"),
    ("cast", "CAST(y / 3 AS STRING)"), ("cast", "CAST(n AS FLOAT)"), ("cast", "typeof(x)"),
    # nulls
    ("null", "coalesce(n, m, -1)"), ("null", "ifnull(s, 'none')"), ("null", "nvl(x, 0.0)"),
    ("null", "nvl2(s, 'has', 'none')"), ("null", "nullif(n, 3)"), ("null", "equal_null(n, m)"),
    ("null", "greatest(x, y, NULL)"), ("null", "NULL"), ("null", "n + NULL"), ("null", "nvl(NULL, n)"),
    # CASE and literals
    ("case", "CASE WHEN n > 2 THEN 'big' WHEN n IS NULL THEN 'none' ELSE 'small' END"),
    ("case", "CASE m WHEN 3 THEN 'three' WHEN 0 THEN 'zero' END"),
    ("case", "CASE WHEN flag = FALSE THEN x ELSE y END"),
    ("case", "CASE WHEN x > y OR s LIKE 'h%' THEN 1 ELSE 0 END"),
    ("case", "CASE WHEN NOT (n BETWEEN 0 AND 5) THEN n END"),
    ("literal", "TRUE"), ("literal", "-2.5"), ("literal", "'it\\'s'"), ("literal", "1 - -1"),
    ("literal", "`id` * 1.5"),
]


def _select(expr):
    return f"SELECT id, {expr} AS v FROM t"


@pytest.mark.parametrize("expr", [e for _, e in EXPRESSIONS], ids=[f"{f}:{e}" for f, e in EXPRESSIONS])
def test_sql_rows_equal_the_jax_package(contexts, expr):
    ours, ref = contexts
    q = _select(expr)
    assert_same_outcome(lambda: rows(ours.sql(q)), lambda: rows(ref.sql(q)))


@pytest.mark.parametrize("family", sorted({f for f, _ in EXPRESSIONS}))
def test_column_surface_equals_the_jax_package(frames, family):
    ours, ref = frames
    for e in (e for f, e in EXPRESSIONS if f == family):
        assert_same_outcome(lambda: rows(ours.select("id", F.expr(e).alias("v"))),
                            lambda: rows(ref.select("id", JF.expr(e).alias("v"))))


PREDICATES = [
    "n > 2", "n = m", "n <> 3", "x < y", "s IS NULL", "s IS NOT NULL", "n IS DISTINCT FROM m",
    "n IS NOT DISTINCT FROM m", "n <=> NULL", "tag IS DISTINCT FROM 't3'", "s ILIKE 'HELLO%'",
    "s NOT ILIKE '%sql'", "s RLIKE '[0-9]{2}'", "s NOT RLIKE '^h'", "s REGEXP 'o'", "n IN (3, m, id * 2)",
    "n NOT IN (3, NULL)", "n IN (SELECT_ROW, 7)".replace("SELECT_ROW", "-7"), "id IN (0, 1) OR flag = TRUE",
    "array_contains(arr, 2)", "exists(arr, v -> v > 4)", "NOT exists(arr, v -> v > 4)",
    "isnan(x) OR x > 1", "x BETWEEN y AND 3", "n NOT BETWEEN -1 AND m", "length(s) > 5 AND upper(s) LIKE 'H%'",
    "coalesce(n, 0) + m > 4", "CASE WHEN flag = TRUE THEN n ELSE m END > 2", "NOT (n > 2 AND m > 2)",
    "s LIKE 'hello\\%\\_'", "x = x", "y > 0.3",
]


@pytest.mark.parametrize("pred", PREDICATES)
def test_where_rows_equal_the_jax_package(contexts, pred, monkeypatch):
    ours, ref = contexts
    q = f"SELECT id, s, n FROM t WHERE {pred}"
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        assert rows(ours.sql(q)) == rows(ref.sql(q))


ORDERINGS = [
    "n NULLS LAST", "n DESC NULLS FIRST", "x", "x DESC", "x NULLS LAST", "y DESC NULLS LAST, id",
    "tag, n DESC", "length(s) DESC NULLS FIRST, id", "3 DESC", "abs(n) % 5, id DESC",
]


@pytest.mark.parametrize("order", ORDERINGS)
def test_order_by_with_nulls_and_nan_equals_the_jax_package(contexts, order):
    ours, ref = contexts
    q = f"SELECT id, tag, n, x, y FROM t ORDER BY {order}"
    assert rows(ours.sql(q)) == rows(ref.sql(q))
    q = f"SELECT * FROM t ORDER BY {order.replace('3 DESC', 'm DESC')} LIMIT 5"
    assert rows(ours.sql(q)) == rows(ref.sql(q))


def test_qualified_names_and_star_equal_the_jax_package(contexts):
    ours, ref = contexts
    for q in ("SELECT q.*, upper(q.s) AS u FROM t q WHERE q.n > 0",
              "SELECT t.id, CASE WHEN t.n > 0 THEN t.s END AS c FROM t ORDER BY t.id DESC LIMIT 4",
              "SELECT *, transform(arr, v -> v * id) AS w FROM t"):
        assert rows(ours.sql(q)) == rows(ref.sql(q))


@pytest.mark.parametrize("expr", ["round(x)", "x / 0", "n % 0", "-7 % 3", "7 / 2", "CAST(1e10 AS INT)",
                                  "2147483647 + 1", "CAST(-2.7 AS INT)", "CAST(x AS STRING)", "1.0 / 3"])
def test_arithmetic_traps_equal_the_jax_package(contexts, expr):
    """Integer division, overflow, % with negatives and float strings."""
    ours, ref = contexts
    q = _select(expr)
    assert_same_outcome(lambda: rows(ours.sql(q)), lambda: rows(ref.sql(q)))


# -- pushdown with expressions ------------------------------------------------


class CountingCells(list):
    """A column whose element reads are counted."""

    reads = 0

    def __getitem__(self, i):
        if isinstance(i, int):
            CountingCells.reads += 1
        return list.__getitem__(self, i)


def _probe(frame_cls):
    parts = []
    k = 0
    for _ in range(3):
        parts.append({
            "vec": [np.full(4, float(k + i), dtype=np.float32) for i in range(6)],
            "label": ["even" if (k + i) % 2 == 0 else "odd" for i in range(6)],
            "n": [k + i for i in range(6)],
            "img": CountingCells(f"payload-{k + i}" for i in range(6)),
        })
        k += 6
    return frame_cls(parts, ["vec", "label", "n", "img"])


@pytest.fixture(scope="module")
def sum_vec():
    jax_udf.registerModelUDF(
        "sum_vec_x",
        ModelIngest.from_callable(lambda x: x.reshape(x.shape[0], -1).sum(axis=1, keepdims=True), input_shape=(4,)),
        batch_size=4,
    )
    mf = ModelFunction(
        lambda _m, x: x.reshape(x.shape[0], -1).sum(dim=1, keepdim=True),
        torch.nn.Module(), torch.device("cpu"), name="sum_vec_x", input_shape=(4,),
    )
    udf_catalog.registerModelUDF("sum_vec_x", mf, batch_size=4, device="cpu")
    yield
    jax_udf.unregister("sum_vec_x")
    udf_catalog.unregister("sum_vec_x")


PUSHDOWN_QUERIES = [
    # columns read only inside a CASE branch, a lambda body, a builtin's argument
    "SELECT CASE WHEN n > 4 THEN upper(label) ELSE 'x' END AS c FROM p",
    "SELECT transform(array(1, 2), v -> v + n) AS t FROM p WHERE length(label) = 4",
    "SELECT coalesce(sum_vec_x(vec), array(0.0)) AS s FROM p WHERE n % 3 = 0",
    "SELECT CASE WHEN label = 'odd' THEN sum_vec_x(vec) END AS s, n FROM p WHERE n IN (1, 2, n) AND n < 12",
    "SELECT label || '-' || CAST(n AS STRING) AS k FROM p WHERE upper(label) RLIKE 'EV' ORDER BY n DESC LIMIT 4",
]


@pytest.mark.parametrize("query", PUSHDOWN_QUERIES)
def test_pushdown_with_expressions_matches_the_jax_package(sum_vec, query, monkeypatch):
    """Rows equal the JAX package's in both arms; the pruned scan never
    reads the untouched ``img`` column, and the counters agree."""
    names = ("sql.pushdown.pruned_cols", "sql.pushdown.skipped_rows", "sql.udf.batch_rows")
    out = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
        got = []
        for ctx_cls, frame_cls, reg in ((SQLContext, DataFrame, metrics), (JaxSQLContext, JaxDataFrame, jax_metrics)):
            ctx = ctx_cls()
            ctx.registerDataFrameAsTable(_probe(frame_cls), "p")
            reg.reset()
            CountingCells.reads = 0
            r = rows(ctx.sql(query))
            got.append((r, {n: reg.counter(n) for n in names}, CountingCells.reads))
        (ours, ours_counts, ours_reads), (ref, ref_counts, ref_reads) = got
        assert ours == ref
        assert ours_counts == ref_counts
        out[arm] = (ours_reads, ours_counts)
        if arm == "1":
            assert ours_reads == 0, "the pruned scan read the img column"
    assert out["1"][1]["sql.pushdown.pruned_cols"] >= 1


def test_a_builtin_conjunct_filters_before_the_udf_scores(sum_vec):
    """WHERE's builtin-only conjunct drops rows before the model UDF runs,
    as the JAX package's pushdown does (a builtin is cheap, a UDF is not)."""
    q = "SELECT sum_vec_x(vec) AS s FROM p WHERE upper(label) = 'EVEN' AND sum_vec_x(vec) IS NOT NULL"
    seen = []
    for ctx_cls, frame_cls, reg in ((SQLContext, DataFrame, metrics), (JaxSQLContext, JaxDataFrame, jax_metrics)):
        ctx = ctx_cls()
        ctx.registerDataFrameAsTable(_probe(frame_cls), "p")
        reg.reset()
        r = rows(ctx.sql(q))
        seen.append((r, reg.counter("sql.pushdown.skipped_rows")))
    assert seen[0] == seen[1]
    assert seen[0][1] == 9 and len(seen[0][0]) == 9


# -- what stays refused ---------------------------------------------------------

RELATIONAL = {
    "join": "SELECT a.id FROM t a JOIN t b ON a.id = b.id",
    "left join": "SELECT id FROM t LEFT JOIN t b ON t.id = b.id",
    "cross join": "SELECT id FROM t CROSS JOIN t",
    "comma join": "SELECT id FROM t, t",
    "group by": "SELECT tag FROM t GROUP BY tag",
    "having": "SELECT tag FROM t HAVING n > 1",
    "count star": "SELECT count(*) FROM t",
    "aggregate": "SELECT sum(n) FROM t",
    "aggregate in case": "SELECT CASE WHEN max(n) > 1 THEN 1 END FROM t",
    "count distinct": "SELECT count(DISTINCT tag) FROM t",
    "count_if": "SELECT count_if(n > 1) FROM t",
    "with": "WITH u AS (SELECT id FROM t) SELECT id FROM u",
    "union": "SELECT id FROM t UNION SELECT id FROM t",
    "intersect": "SELECT id FROM t INTERSECT SELECT id FROM t",
    "except": "SELECT id FROM t EXCEPT SELECT id FROM t",
    "distinct": "SELECT DISTINCT tag FROM t",
    "from-less": "SELECT 1",
    "derived table": "SELECT id FROM (SELECT id FROM t) s",
    "in subquery": "SELECT id FROM t WHERE n IN (SELECT m FROM t)",
    "scalar subquery": "SELECT (SELECT 1) FROM t",
    "exists": "SELECT id FROM t WHERE EXISTS (SELECT id FROM t)",
    "not exists": "SELECT id FROM t WHERE NOT EXISTS (SELECT id FROM t)",
    "offset": "SELECT id FROM t LIMIT 2 OFFSET 1",
}

#: windows, generators and LATERAL VIEW: still refused
#: windows and generators, refused here until they were ported: now the
#: JAX package's rows, or its failure
STILL_REFUSED = {
    "window": "SELECT upper(s) OVER (PARTITION BY tag) FROM t",
    "ranking": "SELECT row_number() OVER (ORDER BY id) FROM t",
    "lag": "SELECT lag(n) FROM t",
    "lateral view": "SELECT id FROM t LATERAL VIEW explode(arr) e AS v",
    "explode": "SELECT explode(arr) FROM t",
    "stack": "SELECT stack(2, n, m) FROM t",
    "json_tuple": "SELECT json_tuple(js, 'a') FROM t",
}


@pytest.mark.parametrize("query", list(RELATIONAL.values()), ids=list(RELATIONAL))
def test_relational_constructs_equal_the_jax_package(contexts, query):
    """Once refused here, now the relational core: the JAX package's rows,
    or its error."""
    ours, ref = contexts
    assert_same_outcome(lambda: rows(ours.sql(query)), lambda: rows(ref.sql(query)))


@pytest.mark.parametrize("query", list(STILL_REFUSED.values()), ids=list(STILL_REFUSED))
def test_relational_constructs_still_name_item_8(contexts, query):
    """These raised UnsupportedSQL naming ROADMAP Queue A item 8 (the test
    keeps its name): now each gives the JAX package's rows, or fails as it
    fails, and none waits for item 8."""
    ours, ref = contexts

    def run(ctx):
        try:
            return "rows", rows(ctx.sql(query))
        except Exception as e:  # noqa: BLE001 — compared below
            return unknown_as_one(("error", _failure(e)))

    got = run(ours)
    assert got == run(ref)
    assert "ROADMAP Queue A item 8" not in str(got)


def test_unknown_functions_and_bad_arity_raise(contexts):
    ours, ref = contexts
    with pytest.raises(ValueError, match="Unknown function"):
        ours.sql("SELECT no_such_fn(s) FROM t").collect()
    for q in ("SELECT upper(s, s) FROM t", "SELECT coalesce(s) FROM t", "SELECT CAST(s AS blob) FROM t",
              "SELECT transform(arr) FROM t", "SELECT s FROM t WHERE s RLIKE '('"):
        for ctx in (ours, ref):
            with pytest.raises(ValueError):
                ctx.sql(q).collect()
