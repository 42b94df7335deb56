"""The port's ``functions`` module (``sparkdl_tpu_torch/functions.py``)
against the JAX package's on the CPU: every exported row function is
called the same way through each package's module over the same table
(NULL and NaN cells, three partitions), and the rows must be equal, or
both packages must fail the same way.

The families: strings, math, trigonometry, codecs and digests, dates,
arrays, maps, JSON, the higher-order functions over Python lambdas, the
null forms and the sort markers; ``udf`` registers a Python function in
the port's catalog. The builtins whose value reads the clock, the time
zone or the login name are checked for their type only. A test holds
the case list to the module's ``__all__``, so a new export needs a case.
"""

import datetime
import pathlib

import pytest

from sparkdl_tpu import functions as JF
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu_torch import functions as F
from sparkdl_tpu_torch.dataframe import DataFrame
from test_torch_sql_expressions import assert_same_outcome, rows, table


@pytest.fixture(scope="module")
def frames():
    return DataFrame.fromColumns(table(), numPartitions=3), JaxDataFrame.fromColumns(table(), numPartitions=3)


def _date(F):
    return F.to_date(F.col("d"))


def _ts(F):
    return F.to_timestamp(F.col("ts"))


#: one-argument functions, by the column they read
UNARY = {
    "s": ["upper", "lower", "length", "trim", "ltrim", "rtrim", "initcap", "reverse", "soundex", "ascii",
          "bit_length", "octet_length", "char_length", "character_length", "btrim", "md5", "sha1", "crc32",
          "base64", "url_encode", "isnull"],
    "x": ["abs", "sqrt", "exp", "log", "log10", "log2", "signum", "isnan", "floor", "ceil", "round", "bround",
          "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "degrees", "radians", "expm1", "log1p", "cbrt",
          "rint", "ln", "negative", "positive", "sign", "sec", "csc", "cot"],
    "y": ["asin", "acos"],
    "m": ["factorial", "bin", "chr", "char", "hex"],
    "arr": ["size", "sort_array", "array_distinct", "array_max", "array_min", "flatten_wrapped", "array_compact",
            "array_size"],
    "mp": ["map_keys", "map_values", "map_entries", "to_json"],
    "js": ["from_json"],
    "date": ["year", "month", "dayofmonth", "dayofweek", "quarter", "weekofyear", "dayofyear", "last_day",
             "weekday", "unix_date"],
    "ts": ["hour", "minute", "second", "unix_seconds"],
    "id": ["timestamp_seconds", "date_from_unix_date"],
}


def _unary(name, source):
    def build(F):
        if source == "date":
            arg = _date(F)
        elif source == "ts":
            arg = _ts(F)
        else:
            arg = F.col(source)
        if name == "flatten_wrapped":
            return F.flatten(F.array(arg, F.array(F.lit(9))))
        return getattr(F, name)(arg)

    return build


CASES = {f"{name}({src})": _unary(name, src) for src, names in UNARY.items() for name in names}
CASES.update({
    # strings
    "repeat": lambda F: F.repeat(F.col("s"), 2),
    "instr": lambda F: F.instr(F.col("s"), "o"),
    "lpad": lambda F: F.lpad(F.col("s"), 8, "*"),
    "rpad": lambda F: F.rpad(F.col("s"), 3, "xy"),
    "split": lambda F: F.split(F.col("s"), ",", 2),
    "regexp_extract": lambda F: F.regexp_extract(F.col("s"), "([a-z]+)([0-9]+)", 2),
    "regexp_replace": lambda F: F.regexp_replace(F.col("s"), "[0-9]+", "#"),
    "concat": lambda F: F.concat(F.col("s"), F.lit("-"), F.col("tag")),
    "concat_ws": lambda F: F.concat_ws("/", F.col("s"), F.col("tag"), F.col("words")),
    "substring": lambda F: F.substring(F.col("s"), -3, 2),
    "translate": lambda F: F.translate(F.col("s"), "lo", "LO"),
    "format_string": lambda F: F.format_string("%s:%d", F.col("tag"), F.col("id")),
    "printf": lambda F: F.printf("%05d", F.col("id")),
    "locate": lambda F: F.locate("l", F.col("s"), 2),
    "levenshtein": lambda F: F.levenshtein(F.col("s"), F.lit("hello")),
    "sha2": lambda F: F.sha2(F.col("s"), 512),
    "unhex": lambda F: F.unhex(F.hex(F.col("s"))),
    "unbase64": lambda F: F.unbase64(F.base64(F.col("s"))),
    "url_decode": lambda F: F.url_decode(F.url_encode(F.col("s"))),
    "hash": lambda F: F.hash(F.col("s"), F.col("n")),
    "format_number": lambda F: F.format_number(F.col("y"), 3),
    "substring_index": lambda F: F.substring_index(F.col("s"), ",", -2),
    "overlay": lambda F: F.overlay(F.col("s"), F.lit("ZZ"), 2, 1),
    "left": lambda F: F.left(F.col("s"), F.lit(3)),
    "right": lambda F: F.right(F.col("s"), F.lit(3)),
    "btrim_chars": lambda F: F.btrim(F.col("s"), "h_"),
    "elt": lambda F: F.elt(F.lit(2), F.col("s"), F.col("tag")),
    "find_in_set": lambda F: F.find_in_set(F.col("s"), "x,spark SQL,y"),
    "startswith": lambda F: F.startswith(F.col("s"), F.lit("he")),
    "endswith": lambda F: F.endswith(F.col("s"), F.lit("L")),
    "contains": lambda F: F.contains(F.col("s"), F.lit("a")),
    "ilike": lambda F: F.ilike(F.col("s"), "%WORLD"),
    "regexp_count": lambda F: F.regexp_count(F.col("s"), F.lit("[a-z]")),
    "regexp_instr": lambda F: F.regexp_instr(F.col("s"), F.lit("[0-9]")),
    "regexp_like": lambda F: F.regexp_like(F.col("s"), F.lit("^[a-z]")),
    "regexp": lambda F: F.regexp(F.col("s"), F.lit("o")),
    "regexp_substr": lambda F: F.regexp_substr(F.col("s"), F.lit("[0-9]+")),
    "split_part": lambda F: F.split_part(F.col("s"), F.lit(","), F.lit(2)),
    "to_char": lambda F: F.to_char(F.col("m"), F.lit("999")),
    "to_varchar": lambda F: F.to_varchar(F.col("m"), F.lit("000")),
    "to_number": lambda F: F.to_number(F.lit("12.5")),
    "try_to_number": lambda F: F.try_to_number(F.col("s")),
    # math
    "pow": lambda F: F.pow(F.col("y"), 2),
    "power": lambda F: F.power(F.col("m"), F.lit(3)),
    "round_scale": lambda F: F.round(F.col("x"), 2),
    "bround_scale": lambda F: F.bround(F.col("y"), 1),
    "greatest": lambda F: F.greatest(F.col("n"), F.col("m"), F.col("id")),
    "least": lambda F: F.least(F.col("x"), F.col("y")),
    "nanvl": lambda F: F.nanvl(F.col("x"), F.col("y")),
    "atan2": lambda F: F.atan2(F.col("y"), F.col("x")),
    "hypot": lambda F: F.hypot(F.col("x"), F.col("y")),
    "conv": lambda F: F.conv(F.col("s"), 36, 10),
    "shiftleft": lambda F: F.shiftleft(F.col("m"), 3),
    "shiftright": lambda F: F.shiftright(F.col("n"), 2),
    "shiftrightunsigned": lambda F: F.shiftrightunsigned(F.col("n"), 60),
    "shiftLeft": lambda F: F.shiftLeft(F.col("m"), 1),
    "shiftRight": lambda F: F.shiftRight(F.col("m"), 1),
    "shiftRightUnsigned": lambda F: F.shiftRightUnsigned(F.col("m"), 1),
    "try_add": lambda F: F.try_add(F.col("n"), F.col("m")),
    "try_subtract": lambda F: F.try_subtract(F.col("n"), F.col("m")),
    "try_multiply": lambda F: F.try_multiply(F.col("n"), F.col("n")),
    "try_divide": lambda F: F.try_divide(F.col("n"), F.col("m")),
    "e": lambda F: F.e() * F.col("x"),
    "pi": lambda F: F.pi() + F.col("n"),
    # dates
    "to_date": lambda F: _date(F),
    "to_date_fmt": lambda F: F.to_date(F.col("d"), "yyyy-dd-MM"),
    "to_timestamp": lambda F: _ts(F),
    "date_add": lambda F: F.date_add(_date(F), 30),
    "date_sub": lambda F: F.date_sub(_date(F), 1),
    "datediff": lambda F: F.datediff(_date(F), F.to_date(F.lit("2024-01-01"))),
    "date_diff": lambda F: F.date_diff(_date(F), F.to_date(F.lit("2024-01-01"))),
    "dateadd": lambda F: F.dateadd(_date(F), 3),
    "date_format": lambda F: F.date_format(_ts(F), "yyyy/MM/dd HH:mm"),
    "add_months": lambda F: F.add_months(_date(F), 1),
    "months_between": lambda F: F.months_between(_date(F), F.to_date(F.lit("2020-02-29"))),
    "months_between_raw": lambda F: F.months_between(_date(F), F.to_date(F.lit("2020-02-29")), False),
    "trunc": lambda F: F.trunc(_date(F), "MM"),
    "trunc_year": lambda F: F.trunc(_date(F), "year"),
    "next_day": lambda F: F.next_day(_date(F), "Mon"),
    "unix_timestamp": lambda F: F.unix_timestamp(F.col("ts")),
    "to_unix_timestamp": lambda F: F.to_unix_timestamp(F.col("ts")),
    "from_unixtime": lambda F: F.from_unixtime(F.col("id") * 86400),
    "date_trunc": lambda F: F.date_trunc("HOUR", _ts(F)),
    "make_date": lambda F: F.make_date(F.lit(2024), F.col("m"), F.lit(29)),
    "make_timestamp": lambda F: F.make_timestamp(F.lit(2024), F.lit(2), F.lit(29), F.col("id"), F.lit(5), F.lit(1.5)),
    "extract": lambda F: F.extract(F.lit("doy"), _date(F)),
    "date_part": lambda F: F.date_part(F.lit("month"), _date(F)),
    "datepart": lambda F: F.datepart(F.lit("year"), _date(F)),
    "timestampadd": lambda F: F.timestampadd("HOUR", F.lit(3), _ts(F)),
    "timestampdiff": lambda F: F.timestampdiff("DAY", F.to_date(F.lit("2000-01-01")), _date(F)),
    # arrays
    "array": lambda F: F.array(F.col("n"), F.col("m"), F.lit(None)),
    "sort_array_desc": lambda F: F.sort_array(F.col("arr"), asc=False),
    "array_contains": lambda F: F.array_contains(F.col("arr"), 2),
    "element_at": lambda F: F.element_at(F.col("arr"), -1),
    "element_at_map": lambda F: F.element_at(F.col("mp"), "a"),
    "try_element_at": lambda F: F.try_element_at(F.col("arr"), F.lit(5)),
    "get": lambda F: F.get(F.col("arr"), F.lit(0)),
    "slice": lambda F: F.slice(F.col("arr"), 1, 2),
    "sequence": lambda F: F.sequence(F.lit(1), F.col("m")),
    "sequence_step": lambda F: F.sequence(F.lit(10), F.lit(1), F.lit(-3)),
    "arrays_zip": lambda F: F.arrays_zip(F.col("arr"), F.col("words")),
    "array_union": lambda F: F.array_union(F.col("arr"), F.array(F.lit(1), F.lit(9))),
    "array_intersect": lambda F: F.array_intersect(F.col("arr"), F.array(F.lit(2), F.lit(3))),
    "array_except": lambda F: F.array_except(F.col("arr"), F.array(F.lit(2))),
    "array_position": lambda F: F.array_position(F.col("arr"), 2),
    "array_remove": lambda F: F.array_remove(F.col("arr"), 2),
    "array_repeat": lambda F: F.array_repeat(F.col("tag"), 2),
    "array_join": lambda F: F.array_join(F.col("words"), "+", "?"),
    "array_append": lambda F: F.array_append(F.col("arr"), F.lit(0)),
    "array_prepend": lambda F: F.array_prepend(F.col("arr"), F.lit(0)),
    "array_insert": lambda F: F.array_insert(F.col("arr"), F.lit(-1), F.lit(99)),
    "struct": lambda F: F.struct(F.col("id"), F.col("tag")),
    "named_struct": lambda F: F.named_struct(F.lit("a"), F.col("n"), F.lit("b"), F.col("s")),
    # maps and JSON
    "create_map": lambda F: F.create_map(F.lit("k"), F.col("id"), F.lit("v"), F.col("n")),
    "map_from_arrays": lambda F: F.map_from_arrays(F.array(F.lit("p"), F.lit("q")), F.array(F.col("n"), F.col("m"))),
    "map_concat": lambda F: F.map_concat(F.col("mp"), F.create_map(F.lit("z"), F.col("id"))),
    "map_contains_key": lambda F: F.map_contains_key(F.col("mp"), "a"),
    "map_from_entries": lambda F: F.map_from_entries(
        F.array(F.named_struct(F.lit("key"), F.lit("a"), F.lit("value"), F.col("id")))),
    "get_json_object": lambda F: F.get_json_object(F.col("js"), "$.b.c[0]"),
    "to_json_array": lambda F: F.to_json(F.col("arr")),
    # higher-order
    "transform": lambda F: F.transform("arr", lambda v: v * 2),
    "transform_index": lambda F: F.transform(F.col("arr"), lambda v, i: v + i),
    "filter": lambda F: F.filter("arr", lambda v: v > 1),
    "exists": lambda F: F.exists("arr", lambda v: v == 2),
    "forall": lambda F: F.forall("arr", lambda v: v > 0),
    "aggregate": lambda F: F.aggregate("arr", F.lit(0), lambda acc, v: acc + v),
    "aggregate_finish": lambda F: F.aggregate("arr", F.lit(0), lambda acc, v: acc + v, lambda acc: acc * 10),
    "reduce": lambda F: F.reduce("arr", F.lit(1), lambda acc, v: acc * v),
    "zip_with": lambda F: F.zip_with("arr", "arr", lambda a, b: a * b),
    "map_filter": lambda F: F.map_filter("mp", lambda k, v: v > 1),
    "transform_keys": lambda F: F.transform_keys("mp", lambda k, v: F.upper(k)),
    "transform_values": lambda F: F.transform_values("mp", lambda k, v: v * 10),
    "map_zip_with": lambda F: F.map_zip_with("mp", "mp", lambda k, a, b: a + b),
    "transform_outer_column": lambda F: F.transform("arr", lambda v: v + F.col("n")),
    "filter_condition": lambda F: F.filter("words", lambda w: w.rlike("^[a-c]")),
    "transform_when": lambda F: F.transform("arr", lambda v: F.when(v > 2, "big").otherwise("small")),
    # nulls
    "coalesce": lambda F: F.coalesce(F.col("n"), F.col("m"), F.lit(-1)),
    "ifnull": lambda F: F.ifnull(F.col("s"), F.lit("none")),
    "nvl": lambda F: F.nvl(F.col("x"), F.lit(0.0)),
    "nullif": lambda F: F.nullif(F.col("n"), F.lit(3)),
    "nvl2": lambda F: F.nvl2(F.col("s"), F.lit("has"), F.lit("none")),
    "equal_null": lambda F: F.equal_null(F.col("n"), F.col("m")),
    "typeof": lambda F: F.typeof(F.col("x")),
})


@pytest.mark.parametrize("name", list(CASES))
def test_function_rows_equal_the_jax_package(frames, name):
    ours, ref = frames
    build = CASES[name]
    assert_same_outcome(lambda: rows(ours.select("id", build(F).alias("v"))),
                        lambda: rows(ref.select("id", build(JF).alias("v"))))


SORT_MARKERS = ["asc", "desc", "asc_nulls_first", "asc_nulls_last", "desc_nulls_first", "desc_nulls_last"]


@pytest.mark.parametrize("name", SORT_MARKERS)
def test_sort_markers_equal_the_jax_package(frames, name):
    ours, ref = frames
    assert rows(ours.orderBy(getattr(F, name)("x"), "id").select("id")) == \
        rows(ref.orderBy(getattr(JF, name)("x"), "id").select("id"))


@pytest.mark.parametrize("name", ["col", "column", "lit", "expr", "when"])
def test_constructors_equal_the_jax_package(frames, name):
    ours, ref = frames
    builders = {
        "col": lambda F: F.col("n") * 2,
        "column": lambda F: F.column("s"),
        "lit": lambda F: F.lit("k") + F.lit(None),
        "expr": lambda F: F.expr("upper(s) || tag"),
        "when": lambda F: F.when(F.col("x") > 0, F.col("x")).otherwise(F.lit(0.0)),
    }
    assert rows(ours.select("id", builders[name](F).alias("v"))) == rows(ref.select("id", builders[name](JF).alias("v")))
    assert rows(ours.filter(F.expr("n > 1 AND s LIKE '%l%'"))) == rows(ref.filter(JF.expr("n > 1 AND s LIKE '%l%'")))


def test_the_host_reading_builtins_have_their_types(frames):
    """current_date/current_timestamp/current_timezone read the clock and
    the time zone, version the package: only their types are compared."""
    ours, _ = frames
    row = ours.select(F.current_date().alias("d"), F.current_timestamp().alias("t"),
                      F.current_timezone().alias("z"), F.version().alias("v")).first()
    assert isinstance(row["d"], datetime.date) and isinstance(row["t"], datetime.datetime)
    assert isinstance(row["z"], str)
    import sparkdl_tpu_torch

    assert row["v"] == sparkdl_tpu_torch.__version__


#: the aggregates, ``broadcast`` and ``window``: their cases are in
#: tests/test_torch_dataframe_relational.py
RELATIONAL_EXPORTS = {
    "count", "countDistinct", "count_distinct", "sum", "avg", "mean", "min", "max",
    "collect_list", "array_agg", "collect_set", "first", "last", "median",
    "stddev", "variance", "stddev_samp", "var_samp", "stddev_pop", "var_pop",
    "skewness", "kurtosis", "sumDistinct", "sum_distinct", "approx_count_distinct",
    "approxCountDistinct", "percentile_approx", "percentile", "corr", "covar_pop",
    "covar_samp", "bool_and", "every", "bool_or", "count_if", "any_value", "mode",
    "broadcast", "window",
}

#: the window functions and the generators: their cases are in
#: tests/test_torch_sql_windows.py and tests/test_torch_generators.py
WINDOW_AND_GENERATOR_EXPORTS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
    "lag", "lead", "first_value", "last_value", "nth_value",
    "explode", "explode_outer", "posexplode", "posexplode_outer", "stack",
    "json_tuple", "monotonically_increasing_id", "rand", "randn",
    "spark_partition_id", "input_file_name",
}


def test_every_export_has_a_case():
    covered = {c.split("(")[0] for c in CASES} | set(SORT_MARKERS) | RELATIONAL_EXPORTS | WINDOW_AND_GENERATOR_EXPORTS | {
        "col", "column", "lit", "expr", "when", "udf", "current_date", "current_timestamp",
        "current_timezone", "version", "current_user", "user", "flatten", "pandas_udf",
    }
    assert set(F.__all__) - covered == set()
    relational = (pathlib.Path(__file__).parent / "test_torch_dataframe_relational.py").read_text()
    assert {n for n in RELATIONAL_EXPORTS if f"F.{n}(" not in relational} == set()
    here = pathlib.Path(__file__).parent
    windows = (here / "test_torch_sql_windows.py").read_text() + (here / "test_torch_generators.py").read_text()
    assert {n for n in WINDOW_AND_GENERATOR_EXPORTS if f"f.{n}(" not in windows} == set()
    # the pandas UDF's cases live in test_torch_pandas.py
    assert "pandas_udf" in F.__all__ and "s.F.pandas_udf(" in (here / "test_torch_pandas.py").read_text()
    # and the export list is the JAX module's: nothing is refused any more
    assert set(F.__all__) == set(JF.__all__)
