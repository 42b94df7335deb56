"""Column construction functions, the ``pyspark.sql.functions``
analogue: the port's copy of the JAX package's ``functions.py``.

    from sparkdl_tpu_torch import functions as F
    df.filter(F.col("x") > 3).select((F.col("v") * 2).alias("d"))

Every function returns a :class:`~sparkdl_tpu_torch.dataframe.column.Column`
over the SQL layer's expression nodes, so the builtins here are exactly
the SQL dialect's (same names, same null semantics, one evaluator):
``col``/``lit``/``when``/``expr``, the string, math, trigonometry, codec,
date, array, map and JSON builtins, the higher-order ``transform``,
``filter``, ``exists``, ``forall``, ``aggregate``, ``zip_with`` and the
map forms over Python lambdas, and :func:`udf`, a Python function in the
process-global UDF catalog.

The aggregates (``F.count``, ``F.sum``, ``F.avg``, ``F.stddev``,
``F.percentile_approx``, ``F.countDistinct``, ``F.collect_list``, ``F.corr``,
``F.count_if``, ``F.mode``, ...) build the aggregate Columns that
``groupBy(...).agg(...)`` and ``df.agg(...)`` take; ``F.window`` is the
time-window group key and ``F.broadcast`` a join hint, accepted and
ignored.

The window functions (``F.row_number``, ``F.rank``, ``F.lag``,
``F.nth_value``, ...) build unbound Window nodes that ``Column.over`` binds
to a :class:`~sparkdl_tpu_torch.dataframe.window.WindowSpec`; the
generators (``F.explode``, ``F.posexplode``, ``F.stack``,
``F.json_tuple``) are top-level select items; ``F.rand``/``F.randn``/
``F.monotonically_increasing_id``/``F.spark_partition_id`` are seeded by the
partition index, as in the JAX package.

``F.pandas_udf`` is the SCALAR vectorized UDF: its function receives one
pandas Series per argument. pandas is imported when the UDF is applied,
never at import, so the rest of this module runs where pandas is not
installed; there, applying a pandas UDF raises ModuleNotFoundError.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

from sparkdl_tpu_torch import sql as _sql
from sparkdl_tpu_torch.dataframe.column import Column, _operand, _pred_of

__all__ = [
    "expr", "size", "array", "sort_array", "array_distinct",
    "array_max", "array_min", "array_contains", "element_at", "concat_ws",
    "col", "column", "lit", "when", "coalesce",
    "upper", "lower", "length", "trim", "ltrim",
    "rtrim", "initcap", "reverse", "repeat", "instr",
    "lpad", "rpad", "split", "regexp_extract", "regexp_replace",
    "abs", "sqrt", "exp", "log", "log10",
    "log2", "pow", "signum", "isnan", "floor",
    "ceil", "round", "concat", "substring", "greatest",
    "least", "to_date", "to_timestamp", "year", "month",
    "dayofmonth", "dayofweek", "hour", "minute", "second",
    "date_add", "date_sub", "datediff", "date_format", "current_date",
    "current_timestamp", "add_months", "months_between", "trunc", "last_day",
    "next_day", "quarter", "weekofyear", "dayofyear", "unix_timestamp",
    "from_unixtime", "timestamp_seconds", "udf", "pandas_udf", "struct", "translate",
    "format_string", "printf", "bround", "hash", "asc",
    "desc", "nanvl", "to_json", "from_json", "get_json_object",
    "map_keys", "map_values", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "tanh", "degrees", "radians", "expm1",
    "log1p", "cbrt", "rint", "hypot", "factorial",
    "bin", "conv", "shiftleft", "shiftright", "shiftrightunsigned",
    "shiftLeft", "shiftRight", "shiftRightUnsigned", "md5", "sha1",
    "sha2", "crc32", "hex", "unhex", "base64",
    "unbase64", "locate", "levenshtein", "soundex", "isnull",
    "slice", "flatten", "sequence", "arrays_zip", "array_union",
    "array_intersect", "array_except", "array_position", "array_remove", "array_repeat",
    "array_join", "create_map", "map_from_arrays", "map_concat", "map_entries",
    "map_contains_key", "date_trunc", "transform", "filter", "exists",
    "forall", "aggregate", "reduce", "zip_with", "map_filter",
    "transform_keys", "transform_values", "map_zip_with", "format_number", "substring_index",
    "overlay", "left", "right", "bit_length", "octet_length",
    "char_length", "character_length", "ascii", "chr", "char",
    "btrim", "elt", "find_in_set", "make_date", "startswith",
    "endswith", "contains", "ilike", "try_add", "try_subtract",
    "try_multiply", "try_divide", "ifnull", "nvl", "nullif",
    "nvl2", "asc_nulls_first", "asc_nulls_last", "desc_nulls_first", "desc_nulls_last",
    "regexp_count", "regexp_instr", "regexp_like", "regexp", "regexp_substr",
    "split_part", "to_char", "to_varchar", "to_number", "try_to_number",
    "array_append", "array_prepend", "array_insert", "array_compact", "array_size",
    "get", "map_from_entries", "named_struct", "url_encode", "url_decode",
    "equal_null", "ln", "negative", "positive", "power",
    "sign", "sec", "csc", "cot", "e",
    "pi", "typeof", "weekday", "unix_date", "date_from_unix_date",
    "unix_seconds", "extract", "current_timezone", "current_user", "user",
    "version", "date_diff", "dateadd", "to_unix_timestamp", "try_element_at",
    "timestampadd", "timestampdiff", "make_timestamp", "date_part", "datepart",
    "count", "countDistinct", "count_distinct", "sum", "avg", "mean", "min", "max",
    "collect_list", "array_agg", "collect_set", "first", "last", "median",
    "stddev", "variance", "stddev_samp", "var_samp", "stddev_pop", "var_pop",
    "skewness", "kurtosis", "sumDistinct", "sum_distinct", "approx_count_distinct",
    "approxCountDistinct", "percentile_approx", "percentile", "corr", "covar_pop",
    "covar_samp", "bool_and", "every", "bool_or", "count_if", "any_value", "mode",
    "broadcast", "window",
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
    "lag", "lead", "first_value", "last_value", "nth_value",
    "explode", "explode_outer", "posexplode", "posexplode_outer", "stack",
    "json_tuple", "monotonically_increasing_id", "rand", "randn",
    "spark_partition_id", "input_file_name",
]


def expr(text: str) -> Column:
    """Parse a SQL-dialect expression string into a Column
    (pyspark F.expr): ``F.expr("price * qty")``,
    ``F.expr("upper(s) AS u")``
    (the alias is honored), and PREDICATES for filter position —
    ``df.filter(F.expr("v > 1 AND s LIKE 'a%'"))``."""
    item = None
    try:
        parser = _sql._Parser(_sql._tokenize(text))
        candidate = parser.select_item()
        if parser.peek()[0] == "eof":
            item = candidate
    except ValueError:
        pass
    if item is not None:
        if item.expr == "*" or isinstance(item.expr, _sql.QualifiedStar):
            raise ValueError(
                "F.expr('*') is not an expression; use select"
            )
        return Column(item.expr, item.alias)
    # not a value expression — parse as a predicate (the common
    # pyspark filter idiom); errors here are the authoritative ones
    parser = _sql._Parser(_sql._tokenize(text))
    pred = parser.or_pred()
    if parser.peek()[0] != "eof":
        raise ValueError(f"Trailing tokens in expression {text!r}")
    return Column(pred)


def col(name: str) -> Column:
    """A reference to a column by name (resolved against the frame the
    expression is eventually applied to)."""
    if not isinstance(name, str):
        raise TypeError(f"col() takes a column name, got {type(name).__name__}")
    return Column(_sql.Col(name))


column = col  # pyspark alias


def lit(value: Any) -> Column:
    """A literal value (None is SQL NULL)."""
    if isinstance(value, Column):
        return value
    return Column(_sql.Lit(value))


def when(condition: Column, value: Any) -> Column:
    """Start a CASE WHEN chain: F.when(c, v).when(c2, v2).otherwise(d).
    Without .otherwise(), unmatched rows are null (Spark)."""
    return Column(
        _sql.Case([(_pred_of(condition), _operand(value))], None)
    )


def _builtin(fn_name: str, *args: Any) -> Column:
    # pyspark's ColumnOrName convention: a bare string names a COLUMN
    # (F.upper("name") reads column name); true string literals are
    # wrapped with lit() by the wrappers whose parameters are literal-
    # typed in pyspark's own signatures (patterns, formats, pads)
    ops = [
        _sql.Col(a) if isinstance(a, str) else _operand(a) for a in args
    ]
    return Column(_sql.Call(fn_name, ops[0], False, ops))


def coalesce(*cols: Any) -> Column:
    if len(cols) < 2:
        raise ValueError("coalesce needs at least two arguments")
    return _builtin("coalesce", *cols)


def upper(c: Any) -> Column:
    return _builtin("upper", c)


def lower(c: Any) -> Column:
    return _builtin("lower", c)


def length(c: Any) -> Column:
    return _builtin("length", c)


def trim(c: Any) -> Column:
    return _builtin("trim", c)


def abs(c: Any) -> Column:  # noqa: A001 — mirrors pyspark's name
    return _builtin("abs", c)


def sqrt(c: Any) -> Column:
    return _builtin("sqrt", c)


def floor(c: Any) -> Column:
    return _builtin("floor", c)


def ceil(c: Any) -> Column:
    return _builtin("ceil", c)


def round(c: Any, scale: int = 0) -> Column:  # noqa: A001
    return _builtin("round", c, scale)


def concat(*cols: Any) -> Column:
    if not cols:
        raise ValueError("concat needs at least one argument")
    return _builtin("concat", *cols)


def substring(c: Any, pos: int, length_: int) -> Column:
    """1-based start position, Spark's substring semantics."""
    return _builtin("substring", c, pos, length_)


def ltrim(c: Any) -> Column:
    return _builtin("ltrim", c)


def rtrim(c: Any) -> Column:
    return _builtin("rtrim", c)


def initcap(c: Any) -> Column:
    return _builtin("initcap", c)


def reverse(c: Any) -> Column:
    return _builtin("reverse", c)


def repeat(c: Any, n: int) -> Column:
    return _builtin("repeat", c, n)


def instr(c: Any, substr: str) -> Column:
    """1-based position of the first occurrence; 0 when absent."""
    return _builtin("instr", c, lit(str(substr)))


def lpad(c: Any, length_: int, pad: str) -> Column:
    return _builtin("lpad", c, length_, lit(str(pad)))


def rpad(c: Any, length_: int, pad: str) -> Column:
    return _builtin("rpad", c, length_, lit(str(pad)))


def split(c: Any, pattern: str, limit: int = -1) -> Column:
    """Regex split to a list cell (Spark split)."""
    return _builtin("split", c, lit(str(pattern)), limit)


def regexp_extract(c: Any, pattern: str, idx: int) -> Column:
    """'' when the pattern does not match (Spark)."""
    return _builtin("regexp_extract", c, lit(str(pattern)), idx)


def regexp_replace(c: Any, pattern: str, replacement: str) -> Column:
    return _builtin("regexp_replace", c, lit(str(pattern)), lit(str(replacement)))


def exp(c: Any) -> Column:
    return _builtin("exp", c)


def log(c: Any) -> Column:
    """Natural log; null on non-positive input (Spark)."""
    return _builtin("log", c)


def log10(c: Any) -> Column:
    return _builtin("log10", c)


def log2(c: Any) -> Column:
    return _builtin("log2", c)


def pow(c: Any, p: Any) -> Column:  # noqa: A001
    return _builtin("pow", c, p)


def isnan(c: Any) -> Column:
    """True for float NaN cells; FALSE (not null) for null (Spark)."""
    return _builtin("isnan", c)


def signum(c: Any) -> Column:
    return _builtin("signum", c)


def concat_ws(sep: str, *cols: Any) -> Column:
    """Join with a separator, SKIPPING nulls (Spark); list cells
    flatten into the joined pieces."""
    if not cols:
        raise ValueError("concat_ws needs at least one column")
    return _builtin("concat_ws", lit(sep), *cols)


def array(*cols: Any) -> Column:
    """Build a list cell from columns/literals; nulls stay elements."""
    if not cols:
        raise ValueError("array needs at least one argument")
    return _builtin("array", *cols)


def sort_array(c: Any, asc: bool = True) -> Column:
    """Sort a list cell (nulls first asc, last desc — Spark)."""
    return _builtin("sort_array", c, asc)


def array_distinct(c: Any) -> Column:
    return _builtin("array_distinct", c)


def array_max(c: Any) -> Column:
    return _builtin("array_max", c)


def array_min(c: Any) -> Column:
    return _builtin("array_min", c)


def size(c: Any) -> Column:
    """Element count of a list/dict cell; null cell -> null."""
    return _builtin("size", c)


def array_contains(c: Any, value: Any) -> Column:
    return _builtin("array_contains", c, value if isinstance(value, Column) else lit(value))


def element_at(c: Any, key: Any) -> Column:
    """1-based list access (negative from the end) / dict key lookup;
    out of bounds -> null (Spark non-ANSI)."""
    return _builtin("element_at", c, key if isinstance(key, Column) else lit(key))


def to_date(c: Any, fmt: str = "yyyy-MM-dd") -> Column:
    """Parse to a date (Java-pattern subset); unparseable -> null."""
    return _builtin("to_date", c, lit(str(fmt)))


def to_timestamp(c: Any, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    return _builtin("to_timestamp", c, lit(str(fmt)))


def year(c: Any) -> Column:
    return _builtin("year", c)


def month(c: Any) -> Column:
    return _builtin("month", c)


def dayofmonth(c: Any) -> Column:
    return _builtin("dayofmonth", c)


def dayofweek(c: Any) -> Column:
    """1 = Sunday .. 7 = Saturday (Spark)."""
    return _builtin("dayofweek", c)


def hour(c: Any) -> Column:
    return _builtin("hour", c)


def minute(c: Any) -> Column:
    return _builtin("minute", c)


def second(c: Any) -> Column:
    return _builtin("second", c)


def date_add(c: Any, days: int) -> Column:
    return _builtin("date_add", c, days)


def date_sub(c: Any, days: int) -> Column:
    return _builtin("date_sub", c, days)


def datediff(end: Any, start: Any) -> Column:
    """Days from start to end (Spark argument order)."""
    return _builtin("datediff", end, start)


def date_format(c: Any, fmt: str) -> Column:
    return _builtin("date_format", c, lit(str(fmt)))


def add_months(c: Any, months: Any) -> Column:
    """Month arithmetic with end-of-month clamping (Spark); ``months``
    may be an int or a Column."""
    if not isinstance(months, Column):
        months = int(months)
    return _builtin("add_months", c, months)


def months_between(end: Any, start: Any, roundOff: bool = True) -> Column:
    """Whole months plus a 31-day-month day fraction (Spark)."""
    return _builtin("months_between", end, start, bool(roundOff))


def trunc(c: Any, format: str) -> Column:  # noqa: A002 — pyspark name
    """Floor a date to year/quarter/month/week; unsupported unit ->
    null (Spark)."""
    return _builtin("trunc", c, lit(str(format)))


def last_day(c: Any) -> Column:
    return _builtin("last_day", c)


def next_day(c: Any, dayOfWeek: str) -> Column:
    """First date after the value falling on the named weekday
    ('Mon'..'Sun'); invalid name -> null (Spark)."""
    return _builtin("next_day", c, lit(str(dayOfWeek)))


def quarter(c: Any) -> Column:
    return _builtin("quarter", c)


def weekofyear(c: Any) -> Column:
    """ISO week number (Spark)."""
    return _builtin("weekofyear", c)


def dayofyear(c: Any) -> Column:
    return _builtin("dayofyear", c)


def unix_timestamp(
    c: Any = None, format: str = "yyyy-MM-dd HH:mm:ss"  # noqa: A002
) -> Column:
    """Seconds since the epoch; no argument means 'now' at row
    evaluation time."""
    if c is None:
        return Column(_sql.Call("unix_timestamp", None, False, []))
    return _builtin("unix_timestamp", c, lit(str(format)))


def from_unixtime(c: Any, format: str = "yyyy-MM-dd HH:mm:ss") -> Column:  # noqa: A002
    return _builtin("from_unixtime", c, lit(str(format)))


def timestamp_seconds(c: Any) -> Column:
    """Epoch seconds -> timestamp cell."""
    return _builtin("timestamp_seconds", c)


def current_date() -> Column:
    """Today's date, evaluated at EXECUTION time (a cached plan must
    not pin the day it was built)."""
    return Column(_sql.Call("current_date", None, False, []))


def current_timestamp() -> Column:
    return Column(_sql.Call("current_timestamp", None, False, []))


def greatest(*cols: Any) -> Column:
    """Row-wise maximum, SKIPPING nulls (null only when all are)."""
    if len(cols) < 2:
        raise ValueError("greatest needs at least two arguments")
    return _builtin("greatest", *cols)


def least(*cols: Any) -> Column:
    """Row-wise minimum, SKIPPING nulls (null only when all are)."""
    if len(cols) < 2:
        raise ValueError("least needs at least two arguments")
    return _builtin("least", *cols)


# -- misc builtins ------------------------------------------------------


def translate(c: Any, matching: str, replace: str) -> Column:
    """Per-character mapping (Spark ``translate``): chars of
    ``matching`` beyond ``len(replace)`` are deleted."""
    return _builtin("translate", c, _lit_arg(matching), _lit_arg(replace))


def format_string(fmt: str, *cols: Any) -> Column:
    """printf-style formatting (Spark ``format_string``). A null
    argument nulls the result (Spark renders 'null' — documented
    divergence of this engine's central null propagation)."""
    return _builtin("format_string", _lit_arg(fmt), *cols)


printf = format_string  # Spark's alias


def bround(c: Any, scale: int = 0) -> Column:
    """HALF_EVEN (banker's) rounding; ``round`` is HALF_UP."""
    return _builtin("bround", c, _lit_arg(int(scale)))


def hash(c: Any, *cols: Any) -> Column:  # noqa: A001 — pyspark name
    """Deterministic signed-int32 hash of the argument tuple. Stable
    across processes and runs; NOT Spark's murmur3 constants (use it
    for bucketing/partitioning, not for cross-engine comparison)."""
    return _builtin("hash", c, *cols)


def struct(*cols: Any) -> Column:
    """Combine columns into one dict cell (Spark ``struct``): field
    names come from plain column references / aliases, else colN."""
    if not cols:
        raise ValueError("struct needs at least one column")
    parts: list = []
    for i, c in enumerate(cols):
        if isinstance(c, str):
            name, expr = c, _sql.Col(c)
        elif isinstance(c, Column):
            plain = c._plain_name()
            name = c._alias or plain or f"col{i + 1}"
            expr = _operand(c)
        else:
            name, expr = f"col{i + 1}", _sql.Lit(c)
        parts.extend([_sql.Lit(name), expr])
    return Column(_sql.Call("named_struct", parts[0], False, parts))


def _lit_arg(v: Any):
    return v if isinstance(v, Column) else Column(_sql.Lit(v))


def asc(c: Any) -> Column:
    """Ascending sort key (pyspark F.asc): ``df.orderBy(F.asc("v"))``;
    nulls first, like every ascending sort here."""
    return (col(c) if isinstance(c, str) else c).asc()


def desc(c: Any) -> Column:
    """Descending sort key (nulls last)."""
    return (col(c) if isinstance(c, str) else c).desc()


def asc_nulls_first(c: Any) -> Column:
    return (col(c) if isinstance(c, str) else c).asc_nulls_first()


def asc_nulls_last(c: Any) -> Column:
    """Ascending with nulls LAST (overrides Spark's asc default)."""
    return (col(c) if isinstance(c, str) else c).asc_nulls_last()


def desc_nulls_first(c: Any) -> Column:
    """Descending with nulls FIRST (overrides Spark's desc default)."""
    return (col(c) if isinstance(c, str) else c).desc_nulls_first()


def desc_nulls_last(c: Any) -> Column:
    return (col(c) if isinstance(c, str) else c).desc_nulls_last()


def nanvl(a: Any, b: Any) -> Column:
    """``b`` where ``a`` is float NaN, else ``a`` (Spark nanvl);
    null propagates as usual."""
    return _builtin("nanvl", a, b)


def to_json(c: Any) -> Column:
    """Serialize a struct/array cell to a JSON string."""
    return _builtin("to_json", c)


def from_json(c: Any, schema: Any = None) -> Column:
    """Parse a JSON string cell (unparseable -> null, Spark's
    PERMISSIVE mode); ``schema`` is accepted for source compatibility
    and ignored — cells are dynamically typed."""
    del schema
    return _builtin("from_json", c)


def get_json_object(c: Any, path: str) -> Column:
    """Extract from a JSON string by a ``$.a.b[0]`` path; scalars come
    back as strings, containers as JSON text, misses as null."""
    return _builtin("get_json_object", c, lit(str(path)))


def map_keys(c: Any) -> Column:
    """Keys of a dict cell as a list."""
    return _builtin("map_keys", c)


def map_values(c: Any) -> Column:
    """Values of a dict cell as a list."""
    return _builtin("map_values", c)


# -- trigonometry / numeric (round-5 batch; Java Math semantics:
# domain misses are NaN, overflow is Infinity) --------------------------


def sin(c: Any) -> Column:
    return _builtin("sin", c)


def cos(c: Any) -> Column:
    return _builtin("cos", c)


def tan(c: Any) -> Column:
    return _builtin("tan", c)


def asin(c: Any) -> Column:
    """NaN outside [-1, 1] (Java Math)."""
    return _builtin("asin", c)


def acos(c: Any) -> Column:
    return _builtin("acos", c)


def atan(c: Any) -> Column:
    return _builtin("atan", c)


def atan2(y: Any, x: Any) -> Column:
    return _builtin("atan2", y, x)


def sinh(c: Any) -> Column:
    return _builtin("sinh", c)


def cosh(c: Any) -> Column:
    return _builtin("cosh", c)


def tanh(c: Any) -> Column:
    return _builtin("tanh", c)


def degrees(c: Any) -> Column:
    return _builtin("degrees", c)


def radians(c: Any) -> Column:
    return _builtin("radians", c)


def expm1(c: Any) -> Column:
    return _builtin("expm1", c)


def log1p(c: Any) -> Column:
    """null at or below -1, matching F.log's null on non-positive."""
    return _builtin("log1p", c)


def cbrt(c: Any) -> Column:
    """Signed cube root (cbrt(-8) = -2)."""
    return _builtin("cbrt", c)


def rint(c: Any) -> Column:
    """Round half to EVEN, as a float (Java Math.rint)."""
    return _builtin("rint", c)


def hypot(a: Any, b: Any) -> Column:
    return _builtin("hypot", a, b)


def factorial(c: Any) -> Column:
    """n! for 0 <= n <= 20; null outside (Spark's long-safe range)."""
    return _builtin("factorial", c)


def bin(c: Any) -> Column:  # noqa: A001 — pyspark name
    """Binary text of a long; negatives as 64-bit two's complement."""
    return _builtin("bin", c)


def conv(c: Any, fromBase: int, toBase: int) -> Column:
    """Re-base an integer string (Spark conv); bases 2..36."""
    return _builtin("conv", c, _lit_arg(int(fromBase)), _lit_arg(int(toBase)))


def shiftleft(c: Any, n: int) -> Column:
    """64-bit (Java long) left shift with two's-complement wrap."""
    return _builtin("shiftleft", c, _lit_arg(int(n)))


shiftLeft = shiftleft  # pyspark's pre-3.2 spelling


def shiftright(c: Any, n: int) -> Column:
    """Arithmetic (sign-extending) 64-bit right shift."""
    return _builtin("shiftright", c, _lit_arg(int(n)))


shiftRight = shiftright


def shiftrightunsigned(c: Any, n: int) -> Column:
    """Logical (zero-filling) 64-bit right shift."""
    return _builtin("shiftrightunsigned", c, _lit_arg(int(n)))


shiftRightUnsigned = shiftrightunsigned


# -- digests / codecs ---------------------------------------------------


def md5(c: Any) -> Column:
    """Hex MD5 of the cell's bytes (strings hash their utf-8)."""
    return _builtin("md5", c)


def sha1(c: Any) -> Column:
    return _builtin("sha1", c)


def sha2(c: Any, numBits: int = 256) -> Column:
    """sha2(c, 224/256/384/512); 0 means 256; other widths -> null."""
    return _builtin("sha2", c, _lit_arg(int(numBits)))


def crc32(c: Any) -> Column:
    return _builtin("crc32", c)


def hex(c: Any) -> Column:  # noqa: A001 — pyspark name
    """Ints as unsigned 64-bit uppercase hex; strings as byte hex."""
    return _builtin("hex", c)


def unhex(c: Any) -> Column:
    """Hex text -> bytes cell; odd length gets a leading zero."""
    return _builtin("unhex", c)


def base64(c: Any) -> Column:
    return _builtin("base64", c)


def unbase64(c: Any) -> Column:
    return _builtin("unbase64", c)


# -- string search / distance -------------------------------------------


def locate(substr: str, c: Any, pos: int = 1) -> Column:
    """1-based position of substr at or after pos; 0 when absent.
    NOTE pyspark's argument order: the needle comes FIRST."""
    return _builtin("locate", lit(str(substr)), c, _lit_arg(int(pos)))


def levenshtein(l: Any, r: Any) -> Column:  # noqa: E741 — pyspark names
    return _builtin("levenshtein", l, r)


def soundex(c: Any) -> Column:
    """American Soundex code (letter + 3 digits)."""
    return _builtin("soundex", c)


def isnull(c: Any) -> Column:
    """Boolean null test usable in select position (pyspark F.isnull);
    equivalent to Column.isNull()."""
    return (col(c) if isinstance(c, str) else c).isNull()


# -- array surgery (round-5 batch 2) ------------------------------------


def slice(c: Any, start: Any, length: Any) -> Column:  # noqa: A001
    """1-based subarray of ``length`` elements; negative start counts
    from the end (Spark slice)."""
    return _builtin("slice", c, start, length)


def flatten(c: Any) -> Column:
    """Remove ONE level of array nesting; a null nested array nulls
    the result (Spark)."""
    return _builtin("flatten", c)


def sequence(start: Any, stop: Any, step: Any = None) -> Column:
    """Inclusive integer range cell; default step walks toward stop."""
    if step is None:
        return _builtin("sequence", start, stop)
    return _builtin("sequence", start, stop, step)


def arrays_zip(*cols: Any) -> Column:
    """Element-wise zip to struct cells keyed '0', '1', ... (Spark
    keys by source column name — value-level divergence, documented);
    shorter arrays pad with null."""
    if not cols:
        raise ValueError("arrays_zip needs at least one column")
    return _builtin("arrays_zip", *cols)


def array_union(a: Any, b: Any) -> Column:
    """Deduplicated concatenation, first-occurrence order."""
    return _builtin("array_union", a, b)


def array_intersect(a: Any, b: Any) -> Column:
    return _builtin("array_intersect", a, b)


def array_except(a: Any, b: Any) -> Column:
    """Elements of a not in b, deduplicated, order preserved."""
    return _builtin("array_except", a, b)


def array_position(c: Any, value: Any) -> Column:
    """1-based first index of value; 0 when absent (Spark)."""
    return _builtin("array_position", c, _lit_arg(value))


def array_remove(c: Any, value: Any) -> Column:
    return _builtin("array_remove", c, _lit_arg(value))


def array_repeat(value: Any, count: Any) -> Column:
    """count copies of value as a list cell (value may be null)."""
    return _builtin("array_repeat", _lit_arg(value), count)


def array_join(c: Any, delimiter: str, null_replacement: str = None) -> Column:
    """Join elements with the delimiter, SKIPPING nulls unless a
    replacement is given (Spark)."""
    if null_replacement is None:
        return _builtin("array_join", c, lit(str(delimiter)))
    return _builtin(
        "array_join", c, lit(str(delimiter)), lit(str(null_replacement))
    )


# -- map constructors / surgery -----------------------------------------


def create_map(*cols: Any) -> Column:
    """Alternating key/value arguments -> dict cell (Spark create_map);
    null keys null the map, null values are data."""
    if not cols or len(cols) % 2:
        raise ValueError(
            "create_map needs an even, non-zero number of arguments "
            "(alternating keys and values)"
        )
    return _builtin("create_map", *cols)


def map_from_arrays(keys: Any, values: Any) -> Column:
    """Two equal-length list cells -> dict cell."""
    return _builtin("map_from_arrays", keys, values)


def map_concat(*cols: Any) -> Column:
    """Merge dict cells; later maps win duplicate keys (Spark)."""
    if not cols:
        raise ValueError("map_concat needs at least one column")
    return _builtin("map_concat", *cols)


def map_entries(c: Any) -> Column:
    """Dict cell -> list of {'key': k, 'value': v} structs."""
    return _builtin("map_entries", c)


def map_contains_key(c: Any, key: Any) -> Column:
    return _builtin("map_contains_key", c, _lit_arg(key))


def date_trunc(format: str, timestamp: Any) -> Column:  # noqa: A002
    """Floor a timestamp to the named unit — note the argument order
    is reversed vs trunc(date, unit), exactly as in pyspark."""
    return _builtin("date_trunc", lit(str(format)), timestamp)


# -- round-5 batch 5: string/misc scalars -------------------------------


def format_number(c: Any, d: int) -> Column:
    """Comma-grouped text with d decimals (HALF_UP)."""
    return _builtin("format_number", c, _lit_arg(int(d)))


def substring_index(c: Any, delim: str, count: int) -> Column:
    """Text before the count-th delimiter (negative: from the right)."""
    return _builtin(
        "substring_index", c, lit(str(delim)), _lit_arg(int(count))
    )


def overlay(src: Any, replace: Any, pos: Any, len: Any = -1) -> Column:  # noqa: A002
    """Replace ``len`` chars at 1-based pos with ``replace`` (pyspark
    overlay); len defaults to the replacement's length."""
    return _builtin("overlay", src, replace, pos, len)


def left(c: Any, n: Any) -> Column:
    """Leftmost n characters ('' when n <= 0, Spark)."""
    return _builtin("left", c, n)


def right(c: Any, n: Any) -> Column:
    return _builtin("right", c, n)


def bit_length(c: Any) -> Column:
    """Bits of the utf-8 encoding (8x octet_length)."""
    return _builtin("bit_length", c)


def octet_length(c: Any) -> Column:
    return _builtin("octet_length", c)


def char_length(c: Any) -> Column:
    return _builtin("char_length", c)


character_length = char_length


def ascii(c: Any) -> Column:  # noqa: A001 — pyspark name
    """Codepoint of the first character; 0 for ''."""
    return _builtin("ascii", c)


def chr(n: Any) -> Column:  # noqa: A001 — pyspark name
    """Character for codepoint n % 256; '' for negative (Spark)."""
    return _builtin("chr", n)


char = chr  # Spark alias


def btrim(c: Any, trim: str = None) -> Column:  # noqa: A002
    """Strip the given characters from both ends (default whitespace)."""
    if trim is None:
        return _builtin("btrim", c)
    return _builtin("btrim", c, lit(str(trim)))


def elt(n: Any, *cols: Any) -> Column:
    """1-based pick among the arguments; out of range -> null."""
    if not cols:
        raise ValueError("elt needs at least one choice argument")
    return _builtin("elt", n, *cols)


def find_in_set(c: Any, str_array: str) -> Column:
    """1-based index of the value in a comma-separated list; 0 when
    absent or when the value contains a comma (Spark)."""
    return _builtin("find_in_set", c, _lit_arg(str_array))


def make_date(year: Any, month: Any, day: Any) -> Column:
    """Date from components; invalid -> null (Spark non-ANSI)."""
    return _builtin("make_date", year, month, day)


def startswith(c: Any, prefix: Any) -> Column:
    """Boolean prefix test (usable bare in filter position)."""
    return _builtin("startswith", c, prefix)


def endswith(c: Any, suffix: Any) -> Column:
    return _builtin("endswith", c, suffix)


def contains(c: Any, other: Any) -> Column:
    return _builtin("contains", c, other)


def ilike(c: Any, pattern: str) -> Column:
    """Case-insensitive LIKE as a function (Column.ilike exists too)."""
    return (col(c) if isinstance(c, str) else c).ilike(pattern)


def try_element_at(c: Any, extraction: Any) -> Column:
    """element_at's try_ spelling — identical here (out-of-bounds is
    already null in this non-ANSI dialect)."""
    return element_at(c, extraction)


def try_add(a: Any, b: Any) -> Column:
    """Addition that yields null instead of any error (Spark try_add)."""
    return _builtin("try_add", a, b)


def try_subtract(a: Any, b: Any) -> Column:
    return _builtin("try_subtract", a, b)


def try_multiply(a: Any, b: Any) -> Column:
    return _builtin("try_multiply", a, b)


def try_divide(a: Any, b: Any) -> Column:
    """Division with null on divide-by-zero (Spark try_divide)."""
    return _builtin("try_divide", a, b)


def ifnull(a: Any, b: Any) -> Column:
    """b when a is null (two-argument coalesce)."""
    return _builtin("ifnull", a, b)


nvl = ifnull  # Spark alias


def nullif(a: Any, b: Any) -> Column:
    """null when a equals b, else a."""
    return _builtin("nullif", a, b)


def nvl2(a: Any, b: Any, c: Any) -> Column:
    """b when a is NOT null, else c."""
    return _builtin("nvl2", a, b, c)


# -- Spark 3.4/3.5 names (round-5 batch 6) ------------------------------


def regexp_count(c: Any, pattern: Any) -> Column:
    """Number of regex matches in the string (0 when none)."""
    return _builtin("regexp_count", c, _lit_arg(pattern))


def regexp_instr(c: Any, pattern: Any) -> Column:
    """1-based position of the first regex match; 0 when absent."""
    return _builtin("regexp_instr", c, _lit_arg(pattern))


def regexp_like(c: Any, pattern: Any) -> Column:
    """Boolean partial regex match (RLIKE as a function; bare-usable
    in filter position)."""
    return _builtin("regexp_like", c, _lit_arg(pattern))


regexp = regexp_like  # Spark alias


def regexp_substr(c: Any, pattern: Any) -> Column:
    """First regex match text, or null."""
    return _builtin("regexp_substr", c, _lit_arg(pattern))


def split_part(c: Any, delimiter: Any, partNum: Any) -> Column:
    """1-based literal-delimiter part; negative from the end; out of
    range -> '' (Spark split_part)."""
    return _builtin("split_part", c, _lit_arg(delimiter), partNum)


def to_char(c: Any, format: Any) -> Column:  # noqa: A002
    """Approximate Spark to_char numeric formatting (decimals from
    the D/. tail, grouping when G/, appears)."""
    return _builtin("to_char", c, _lit_arg(format))


to_varchar = to_char


def to_number(c: Any, format: Any = None) -> Column:  # noqa: A002
    """Parse formatted number text (grouping/currency stripped);
    unparseable -> null."""
    if format is None:
        return _builtin("to_number", c)
    return _builtin("to_number", c, _lit_arg(format))


try_to_number = to_number


def array_append(c: Any, value: Any) -> Column:
    return _builtin("array_append", c, _lit_arg(value))


def array_prepend(c: Any, value: Any) -> Column:
    return _builtin("array_prepend", c, _lit_arg(value))


def array_insert(c: Any, pos: Any, value: Any) -> Column:
    """1-based insert (negative from the end); past-the-end pads with
    nulls (Spark 3.4)."""
    return _builtin("array_insert", c, pos, _lit_arg(value))


def array_compact(c: Any) -> Column:
    """Drop null elements."""
    return _builtin("array_compact", c)


def array_size(c: Any) -> Column:
    return _builtin("array_size", c)


def get(c: Any, index: Any) -> Column:
    """0-based list access; out of bounds -> null (Spark get)."""
    return _builtin("get", c, index)


def map_from_entries(c: Any) -> Column:
    """List of {'key','value'} structs (or [k, v] pairs) -> dict."""
    return _builtin("map_from_entries", c)


def named_struct(*cols: Any) -> Column:
    """Alternating name/value arguments -> struct cell (the SQL
    builtin's F spelling; F.struct infers names instead)."""
    if not cols or len(cols) % 2:
        raise ValueError(
            "named_struct needs alternating name, value arguments"
        )
    return _builtin("named_struct", *cols)


def url_encode(c: Any) -> Column:
    return _builtin("url_encode", c)


def url_decode(c: Any) -> Column:
    return _builtin("url_decode", c)


def equal_null(a: Any, b: Any) -> Column:
    """Null-safe equality as a function (the <=> operator): never
    null — null vs null is True."""
    return _builtin("equal_null", a, b)


def ln(c: Any) -> Column:
    """Natural log (alias of F.log); null on non-positive."""
    return _builtin("ln", c)


def negative(c: Any) -> Column:
    return _builtin("negative", c)


def positive(c: Any) -> Column:
    return _builtin("positive", c)


def power(c: Any, p: Any) -> Column:
    return _builtin("power", c, p)


def sign(c: Any) -> Column:
    return _builtin("sign", c)


def sec(c: Any) -> Column:
    return _builtin("sec", c)


def csc(c: Any) -> Column:
    return _builtin("csc", c)


def cot(c: Any) -> Column:
    return _builtin("cot", c)


def e() -> Column:
    return Column(_sql.Call("e", None, False, []))


def pi() -> Column:
    return Column(_sql.Call("pi", None, False, []))


def typeof(c: Any) -> Column:
    """Spark-vocabulary type name of each cell ('void' for null)."""
    return _builtin("typeof", c)


def weekday(c: Any) -> Column:
    """0 = Monday .. 6 = Sunday (vs dayofweek's 1 = Sunday)."""
    return _builtin("weekday", c)


def unix_date(c: Any) -> Column:
    """Days since 1970-01-01."""
    return _builtin("unix_date", c)


def date_from_unix_date(c: Any) -> Column:
    return _builtin("date_from_unix_date", c)


def unix_seconds(c: Any) -> Column:
    return _builtin("unix_seconds", c)


def extract(field: str, source: Any) -> Column:
    """EXTRACT(field FROM source)'s function form: F.extract('year',
    d) — same field vocabulary as the SQL grammar."""
    fn = _sql._EXTRACT_FIELDS.get(str(field).lower())
    if fn is None:
        raise ValueError(
            f"Unsupported extract field {field!r}; supported: "
            f"{sorted(_sql._EXTRACT_FIELDS)}"
        )
    return _builtin(fn, source)


def current_timezone() -> Column:
    return Column(_sql.Call("current_timezone", None, False, []))


def current_user() -> Column:
    return Column(_sql.Call("current_user", None, False, []))


user = current_user


def version() -> Column:
    return Column(_sql.Call("version", None, False, []))


# pyspark 3.4+ date aliases
def date_diff(end: Any, start: Any) -> Column:
    return _builtin("datediff", end, start)


def dateadd(c: Any, days: Any) -> Column:
    return _builtin("date_add", c, days)


def to_unix_timestamp(
    c: Any, format: str = "yyyy-MM-dd HH:mm:ss"  # noqa: A002
) -> Column:
    return _builtin("unix_timestamp", c, lit(str(format)))


def timestampadd(unit: str, quantity: Any, ts: Any) -> Column:
    """ts + quantity units (calendar-aware for YEAR/QUARTER/MONTH)."""
    return _builtin("timestampadd", lit(str(unit)), quantity, ts)


def timestampdiff(unit: str, start: Any, end: Any) -> Column:
    """WHOLE units from start to end (Spark timestampdiff)."""
    return _builtin("timestampdiff", lit(str(unit)), start, end)


def make_timestamp(years: Any, months: Any, days: Any, hours: Any,
                   mins: Any, secs: Any) -> Column:
    """Timestamp from components; invalid -> null (non-ANSI)."""
    return _builtin(
        "make_timestamp", years, months, days, hours, mins, secs
    )


def date_part(field: Any, source: Any) -> Column:
    """EXTRACT's function form: F.date_part('year', d); unknown
    fields yield null (the SQL grammar form raises instead)."""
    return _builtin("date_part", _lit_arg(field), source)


datepart = date_part


# -- higher-order collection functions ----------------------------------
# pyspark idiom: the lambda receives Column placeholders and returns a
# Column; the resulting expression tree becomes the SQL layer's Lambda
# node, so F.transform(c, f) and SQL transform(c, x -> ...) are the
# same engine. Lambda bodies are builtin-only (no catalog UDFs inside).


def _lambda_node(f: Callable) -> "_sql.Lambda":
    import inspect

    names = list(inspect.signature(f).parameters)
    if not 1 <= len(names) <= 3:
        raise ValueError(
            "higher-order lambdas take 1..3 parameters, got "
            f"{len(names)}"
        )
    # reserved placeholder names cannot collide with frame columns;
    # nested lambdas shadow outward like Spark's scoping
    params = [f"__hof_{n}" for n in names]
    out = f(*[Column(_sql.Col(p)) for p in params])
    body = out._expr if isinstance(out, Column) else _sql.Lit(out)
    # builtin-only bodies fail HERE with a named error, not as a
    # partition-task crash at collect (catalog UDFs can't run
    # per-element)
    _sql._validate_lambda_body(body)
    return _sql.Lambda(params, body)


def _hof(fn: str, *args: Any) -> Column:
    ops = [
        a
        if isinstance(a, _sql.Lambda)
        else (_sql.Col(a) if isinstance(a, str) else _operand(a))
        for a in args
    ]
    return Column(_sql.Call(fn, ops[0], False, ops))


def transform(c: Any, f: Callable) -> Column:
    """Map a lambda over a list cell (pyspark F.transform); a
    two-parameter lambda also receives the 0-based index."""
    return _hof("transform", c, _lambda_node(f))


def filter(c: Any, f: Callable) -> Column:  # noqa: A001 — pyspark name
    """Keep list elements where the lambda is true; unknown (null)
    drops the element, like WHERE."""
    return _hof("filter", c, _lambda_node(f))


def exists(c: Any, f: Callable) -> Column:
    """True if any element satisfies the lambda; three-valued over
    null elements (Spark)."""
    return _hof("exists", c, _lambda_node(f))


def forall(c: Any, f: Callable) -> Column:
    """True if every element satisfies the lambda."""
    return _hof("forall", c, _lambda_node(f))


def aggregate(
    c: Any, initialValue: Any, merge: Callable, finish: Callable = None
) -> Column:
    """Fold a list cell: acc = merge(acc, x) over elements, then
    optionally finish(acc) (pyspark F.aggregate)."""
    init = (
        initialValue
        if isinstance(initialValue, Column)
        else lit(initialValue)
    )
    args = [c, init, _lambda_node(merge)]
    if finish is not None:
        args.append(_lambda_node(finish))
    return _hof("aggregate", *args)


reduce = aggregate  # pyspark 3.4 alias


def zip_with(left: Any, right: Any, f: Callable) -> Column:
    """Element-wise combine two list cells; the shorter side pads
    with null (Spark)."""
    return _hof("zip_with", left, right, _lambda_node(f))


def map_filter(c: Any, f: Callable) -> Column:
    """Keep dict entries where f(key, value) is true."""
    return _hof("map_filter", c, _lambda_node(f))


def transform_keys(c: Any, f: Callable) -> Column:
    """Rewrite dict keys via f(key, value); a null new key nulls the
    map (Spark raises — this dialect's non-ANSI posture)."""
    return _hof("transform_keys", c, _lambda_node(f))


def transform_values(c: Any, f: Callable) -> Column:
    """Rewrite dict values via f(key, value)."""
    return _hof("transform_values", c, _lambda_node(f))


def map_zip_with(m1: Any, m2: Any, f: Callable) -> Column:
    """Merge two dict cells by key via f(key, v1, v2); missing keys
    see null."""
    return _hof("map_zip_with", m1, m2, _lambda_node(f))


# -- general-purpose Python UDFs ----------------------------------------

_udf_seq = itertools.count()


def _register_callable_udf(fn, prefix, doc, single, multi):
    """The plumbing of F.udf: register per-batch
    implementations in the process-global catalog, return a Column-
    producing call wrapper whose lifetime governs the entries."""
    import weakref

    from sparkdl_tpu_torch import udf as _catalog

    base = f"{prefix}_{next(_udf_seq)}_{getattr(fn, '__name__', 'fn')}"
    _catalog.register(base, single, doc)
    multi_name = base + "__multi"
    _catalog.register(multi_name, multi, doc)

    def call(*cols: Any) -> Column:
        if not cols:
            raise TypeError(
                f"UDF {getattr(fn, '__name__', 'fn')!r} needs at "
                "least one Column argument"
            )
        ops = [
            _operand(col(c) if isinstance(c, str) else c) for c in cols
        ]
        if len(ops) == 1:
            node = _sql.Call(base, ops[0], False, [ops[0]])
        else:
            # pack args into one list cell; the __multi entry unpacks
            # per row (nulls stay elements, as pyspark passes None
            # into the Python function)
            arr = _sql.Call("array", ops[0], False, ops)
            node = _sql.Call(multi_name, arr, False, [arr])
        # the expression holds the wrapper alive (inline idiom:
        # df.select(F.udf(f)(c)) drops the wrapper immediately, but
        # the Call node must keep resolving in the catalog)
        node._udf_ref = call
        return Column(node)

    call.__name__ = getattr(fn, "__name__", "udf")
    # the catalog entries live as long as the wrapper OR any
    # expression built from it: a per-batch `F.udf(lambda ...)`
    # pattern must not grow the process-global catalog without bound
    weakref.finalize(call, _catalog.unregister, base)
    weakref.finalize(call, _catalog.unregister, multi_name)
    return call


def pandas_udf(f: Callable = None, returnType: Any = None, functionType: Any = None):
    """A vectorized UDF (pyspark ``pandas_udf``, the SCALAR flavor): the
    function receives pandas Series, one per argument column, a whole
    partition batch at a time, and returns a Series (or any list-like) of
    the same length. ``returnType`` and ``functionType`` are accepted for
    pyspark source compatibility and ignored. Works as a decorator too.
    pandas is imported where the UDF is applied to a column: without it
    that raises ModuleNotFoundError."""
    del returnType, functionType

    def build(fn: Callable[..., Any]):
        def single(cells):
            import pandas as pd

            return list(fn(pd.Series(list(cells), dtype=object)))

        def multi(cells):
            if not cells:  # an emptied partition must not call fn()
                return []
            import pandas as pd

            series = [pd.Series(list(s), dtype=object) for s in zip(*cells)]
            return list(fn(*series))

        udf_call = _register_callable_udf(
            fn,
            prefix="__pdudf",
            doc=f"F.pandas_udf({getattr(fn, '__name__', 'fn')})",
            single=single,
            multi=multi,
        )

        def call(*cols: Any) -> Column:
            import pandas  # noqa: F401 -- fail where the expression is built, not mid-query

            return udf_call(*cols)

        call.__name__ = udf_call.__name__
        return call

    if f is None or not callable(f):
        return build
    return build(f)


def udf(f: Callable[[Any], Any] = None, returnType: Any = None):
    """Wrap a Python function as a Column-producing UDF (pyspark
    ``F.udf``): ``plus_one = F.udf(lambda x: x + 1); df.select(
    plus_one(F.col("v")))``. Works as a decorator too. The function is
    registered in the process-global catalog and runs batched per
    partition like every catalog UDF; cells pass through as-is
    (``None`` included — guard in the function, as in vanilla Python
    pyspark UDFs).

    ``returnType`` is accepted for pyspark source compatibility and
    ignored: this engine's columns are dynamically typed.

    Multi-argument UDFs pack their inputs through the array builtin
    (null arguments pass through as None, like pyspark), so
    ``F.udf(lambda a, b: a + b)(df.x, df.y)`` works directly."""

    def build(fn: Callable[..., Any]):
        return _register_callable_udf(
            fn,
            prefix="__pyudf",
            doc=f"F.udf({getattr(fn, '__name__', 'fn')})",
            single=lambda cells: [fn(v) for v in cells],
            multi=lambda cells: [fn(*c) for c in cells],
        )

    # @udf, @udf("string"), @udf(returnType=IntegerType()), udf(fn, T):
    # any non-callable first argument is a return type (ignored — the
    # engine's columns are dynamically typed), not the function
    if f is None or not callable(f):
        return build
    return build(f)


# -- aggregate constructors (groupBy().agg(...) / df.agg(...)) ----------
# Like pyspark, sum/min/max/abs/round deliberately shadow Python
# builtins inside this module — import it as `F`, not star-import.


def _agg(fn: str, c: Any, distinct: bool = False) -> Column:
    if isinstance(c, str):
        if c == "*":
            if fn != "count":
                raise ValueError(f"{fn}('*') is not valid; only count")
            return Column(_sql.Call("count", "*"))
        arg = _sql.Col(c)
    else:
        arg = _operand(c)
    return Column(_sql.Call(fn, arg, distinct, [arg]))


def count(c: Any = "*") -> Column:
    return _agg("count", c)


def countDistinct(c: Any) -> Column:
    return _agg("count", c, distinct=True)


def sum(c: Any) -> Column:  # noqa: A001
    return _agg("sum", c)


def avg(c: Any) -> Column:
    return _agg("avg", c)


mean = avg  # pyspark alias


def min(c: Any) -> Column:  # noqa: A001
    return _agg("min", c)


def max(c: Any) -> Column:  # noqa: A001
    return _agg("max", c)


def collect_list(c: Any) -> Column:
    """All non-null values of the group as a list cell (explode's
    inverse); memory O(values) per group."""
    return _agg("collect_list", c)


def collect_set(c: Any) -> Column:
    """Distinct non-null values of the group, first-occurrence order
    (Spark leaves the order undefined)."""
    return _agg("collect_set", c)


def first(c: Any, ignorenulls: bool = True) -> Column:
    """First non-null value in stream order (Spark's first is equally
    order-nondeterministic). Only ignore-nulls semantics exist here —
    the streaming engine skips nulls by design."""
    if not ignorenulls:
        raise ValueError(
            "first(ignorenulls=False) is not supported: the streaming "
            "aggregate engine skips nulls; sort + limit(1) instead"
        )
    return _agg("first", c)


def last(c: Any, ignorenulls: bool = True) -> Column:
    """Last non-null value in stream order."""
    if not ignorenulls:
        raise ValueError(
            "last(ignorenulls=False) is not supported: the streaming "
            "aggregate engine skips nulls"
        )
    return _agg("last", c)


def median(c: Any) -> Column:
    """Exact median (Spark 3.4 median = percentile(0.5), midpoint
    interpolation for even counts); holds the group's values in memory
    like collect_list."""
    return _agg("median", c)


def stddev(c: Any) -> Column:
    return _agg("stddev", c)


def variance(c: Any) -> Column:
    return _agg("variance", c)


stddev_samp = stddev  # Spark's default IS the sample statistic
var_samp = variance


def stddev_pop(c: Any) -> Column:
    """Population standard deviation (divide by n)."""
    return _agg("stddev_pop", c)


def var_pop(c: Any) -> Column:
    return _agg("var_pop", c)


def skewness(c: Any) -> Column:
    """Population skewness g1 (NaN on zero variance, Spark)."""
    return _agg("skewness", c)


def kurtosis(c: Any) -> Column:
    """Excess kurtosis g2 (normal = 0.0, Spark)."""
    return _agg("kurtosis", c)


def sumDistinct(c: Any) -> Column:
    """Sum over distinct non-null values (pyspark sumDistinct /
    sum_distinct)."""
    return _agg("sum", c, distinct=True)


sum_distinct = sumDistinct  # pyspark 3.2+ spelling


def approx_count_distinct(c: Any, rsd: float = None) -> Column:
    """Distinct count. Computed EXACTLY here (``rsd`` accepted and
    ignored) — the host-scale engine has no need for HyperLogLog."""
    del rsd
    return _agg("approx_count_distinct", c)


approxCountDistinct = approx_count_distinct  # pre-3.1 spelling


def percentile_approx(c: Any, percentage: Any, accuracy: int = None) -> Column:
    """Group percentile(s): a float in [0, 1] or a list of them (list
    in, list out). Returns an actual group element (Spark's discrete
    percentile_approx), computed exactly; ``accuracy`` is accepted and
    ignored."""
    del accuracy
    return _percentile_col("percentile_approx", c, percentage)


def percentile(c: Any, percentage: Any) -> Column:
    """Continuous (interpolating) percentile, Spark's percentile()."""
    return _percentile_col("percentile", c, percentage)


def _percentile_col(fn: str, c: Any, percentage: Any) -> Column:
    if isinstance(percentage, (list, tuple)):
        pct = [float(p) for p in percentage]
        bad = [p for p in pct if not 0 <= p <= 1]
    else:
        pct = float(percentage)
        bad = [] if 0 <= pct <= 1 else [pct]
    if bad:
        raise ValueError(
            f"{fn} percentage must be in [0, 1], got {bad[0]}"
        )
    col_ = _sql.Col(c) if isinstance(c, str) else _operand(c)
    node = _sql.Call(fn, col_, False, [col_])
    node._params = [pct]
    return Column(node)


def _pair_agg(fn: str, a: Any, b: Any) -> Column:
    # two-column aggregates pack their pair into one array(x, y) cell;
    # the accumulator drops observations with a null in either slot
    ops = [
        _sql.Col(x) if isinstance(x, str) else _operand(x) for x in (a, b)
    ]
    packed = _sql.Call("array", ops[0], False, ops)
    return Column(_sql.Call(fn, packed, False, [packed]))


def corr(a: Any, b: Any) -> Column:
    """Pearson correlation as a GROUP aggregate (pyspark F.corr);
    NaN when either side has zero variance."""
    return _pair_agg("corr", a, b)


def covar_pop(a: Any, b: Any) -> Column:
    return _pair_agg("covar_pop", a, b)


def covar_samp(a: Any, b: Any) -> Column:
    return _pair_agg("covar_samp", a, b)


def _bool_agg_arg(c: Any) -> Any:
    """bool_and/bool_or accept predicate Columns (F.col('v') > 1):
    wrap as CASE so the engine sees True/False/null cells."""
    c2 = col(c) if isinstance(c, str) else c
    if isinstance(c2, Column) and c2._is_pred():
        p = c2._expr
        return Column(_sql.Case(
            [(p, _sql.Lit(True)), (_sql.NotOp(p), _sql.Lit(False))], None
        ))
    return c2


def bool_and(c: Any) -> Column:
    """True when every non-null value/condition is true; null on no
    inputs. Takes a boolean column or a predicate Column."""
    return _agg("bool_and", _bool_agg_arg(c))


every = bool_and  # Spark alias


def bool_or(c: Any) -> Column:
    return _agg("bool_or", _bool_agg_arg(c))


def count_if(c: Any) -> Column:
    """Count rows where the condition is true (Spark count_if)."""
    c2 = col(c) if isinstance(c, str) else c
    p = (
        c2._expr
        if isinstance(c2, Column) and c2._is_pred()
        else _sql.Predicate(_operand(c2), "=", True)
    )
    arg = _sql.Case([(p, _sql.Lit(1))], None)
    return Column(_sql.Call("count", arg, False, [arg]))


def any_value(c: Any, ignoreNulls: bool = True) -> Column:
    """An arbitrary non-null value of the group (first seen here)."""
    if not ignoreNulls:
        raise ValueError(
            "any_value(ignoreNulls=False) is not supported: the "
            "streaming aggregate engine skips nulls"
        )
    return _agg("any_value", c)


def mode(c: Any) -> Column:
    """Most frequent non-null value; ties break on first occurrence
    (Spark leaves tie order undefined)."""
    return _agg("mode", c)


# -- window functions (bind with .over(Window.partitionBy(...))) --------
# Each returns an UNBOUND window node; Column.over fills the spec in.
# Aggregates (sum/avg/...) need no constructor here — any aggregate
# Column takes .over directly, like pyspark.

count_distinct = countDistinct
array_agg = collect_list


def broadcast(df):
    """pyspark's broadcast-join hint: accepted and ignored (one join
    strategy here); returns the frame unchanged."""
    return df


def window(timeColumn: Any, windowDuration: str,
           slideDuration: str = None, startTime: str = None) -> Column:
    """Tumbling time-window bucketing (pyspark F.window):
    ``df.groupBy(F.window("ts", "10 minutes")).agg(...)``: each row's
    timestamp floors into a {'start', 'end'} struct key. Sliding windows
    (slideDuration != windowDuration) refuse: each row would belong to
    several windows. Durations parse '<n> <seconds|minutes|hours|days|
    weeks|milliseconds>' and are validated here, not inside a partition
    task."""
    from sparkdl_tpu_torch.sql_builtins import _parse_duration_s

    if _parse_duration_s(windowDuration) <= 0:
        raise ValueError(f"window duration must be positive: {windowDuration!r}")
    args = [timeColumn, lit(str(windowDuration))]
    if slideDuration is not None:
        if _parse_duration_s(slideDuration) != _parse_duration_s(windowDuration):
            raise ValueError(
                "sliding windows (slideDuration != windowDuration) are "
                "not supported: each row would belong to several "
                "windows; use a tumbling window"
            )
        args.append(lit(str(slideDuration)))
        if startTime is not None:
            _parse_duration_s(startTime)
            args.append(lit(str(startTime)))
    elif startTime is not None:
        # the builtin's 3rd positional is the slide; pass it equal to the
        # duration so startTime lands in the 4th slot
        _parse_duration_s(startTime)
        args.extend([lit(str(windowDuration)), lit(str(startTime))])
    return _builtin("window", *args).alias("window")


# -- window functions ----------------------------------------------------
# Each returns an UNBOUND window node; Column.over fills the spec in.
# Aggregates (sum/avg/...) need no constructor here — any aggregate
# Column takes .over directly, like pyspark.


def _winarg(c: Any):
    """A window function's argument: name string or expression tree
    (the engine materializes expressions to hidden columns)."""
    if isinstance(c, str):
        return c
    if isinstance(c, Column):
        plain = c._plain_name()
        return plain if plain is not None else _operand(c)
    return _sql.Lit(c)


def _ranking(fn: str) -> Column:
    return Column(_sql.Window(fn, None, [], []))


def row_number() -> Column:
    """1-based row position within the ordered window partition."""
    return _ranking("row_number")


def rank() -> Column:
    """Rank with gaps (ties share a rank; the next rank skips)."""
    return _ranking("rank")


def dense_rank() -> Column:
    """Rank without gaps."""
    return _ranking("dense_rank")


def percent_rank() -> Column:
    """(rank - 1) / (partition rows - 1); 0.0 for a single row."""
    return _ranking("percent_rank")


def cume_dist() -> Column:
    """Fraction of partition rows at or before the current row's peers."""
    return _ranking("cume_dist")


def ntile(n: int) -> Column:
    """Bucket number 1..n over the ordered partition (larger buckets
    first when uneven, SQL semantics)."""
    if int(n) < 1:
        raise ValueError(f"ntile bucket count must be >= 1, got {n}")
    return Column(_sql.Window("ntile", None, [], [], offset=int(n)))


def lag(c: Any, offset: int = 1, default: Any = None) -> Column:
    """Value ``offset`` rows BEFORE the current row in the ordered
    partition; ``default`` past the partition edge."""
    return Column(
        _sql.Window("lag", _winarg(c), [], [], offset=int(offset),
                    default=default)
    )


def lead(c: Any, offset: int = 1, default: Any = None) -> Column:
    """Value ``offset`` rows AFTER the current row."""
    return Column(
        _sql.Window("lead", _winarg(c), [], [], offset=int(offset),
                    default=default)
    )


def first_value(c: Any) -> Column:
    """First value of the window frame."""
    return Column(_sql.Window("first_value", _winarg(c), [], []))


def last_value(c: Any) -> Column:
    """Last value of the window frame (default frame: the current
    row's last PEER, Spark semantics)."""
    return Column(_sql.Window("last_value", _winarg(c), [], []))


def nth_value(c: Any, n: int) -> Column:
    """The frame's n-th value (1-based); null while the frame spans
    fewer than n rows."""
    if int(n) < 1:
        raise ValueError(f"nth_value position must be >= 1, got {n}")
    return Column(_sql.Window("nth_value", _winarg(c), [], [], offset=int(n)))

# -- generators ----------------------------------------------------------


def explode(c: Any) -> Column:
    """One output row per element of a list cell (pyspark F.explode):
    rows whose cell is null or empty are DROPPED. Select-item position
    only, at most one generator per select; default output name 'col'.
    A plain string names a COLUMN (pyspark's idiom) — a string literal
    could never be valid generator input."""
    from sparkdl_tpu_torch.dataframe.column import ExplodeNode

    if isinstance(c, str):
        c = col(c)
    return Column(ExplodeNode(_operand(c), outer=False), None)


def explode_outer(c: Any) -> Column:
    """Like :func:`explode` but null/empty cells KEEP their row with a
    null element."""
    from sparkdl_tpu_torch.dataframe.column import ExplodeNode

    if isinstance(c, str):
        c = col(c)
    return Column(ExplodeNode(_operand(c), outer=True), None)


def posexplode(c: Any) -> Column:
    """explode with the element's 0-based position: two output columns,
    default names (pos, col); rename with .alias('p', 'c')."""
    from sparkdl_tpu_torch.dataframe.column import ExplodeNode

    if isinstance(c, str):
        c = col(c)
    return Column(ExplodeNode(_operand(c), outer=False, with_pos=True), None)


def posexplode_outer(c: Any) -> Column:
    from sparkdl_tpu_torch.dataframe.column import ExplodeNode

    if isinstance(c, str):
        c = col(c)
    return Column(ExplodeNode(_operand(c), outer=True, with_pos=True), None)


def stack(n: Any, *cols: Any) -> Column:
    """Spark's stack generator: n output ROWS per input row, the
    arguments laid out row-major into ceil(k/n) columns (col0..colW;
    rename with .alias(...)); the last row pads with nulls. Top-level
    select item only. The row count must be a literal."""
    from sparkdl_tpu_torch.dataframe.column import StackNode

    if isinstance(n, Column):
        if not isinstance(n._expr, _sql.Lit):
            raise ValueError(
                "stack's row count must be a literal (F.lit(2))"
            )
        n = n._expr.value
    args = [
        _sql.Col(c) if isinstance(c, str) else _operand(c) for c in cols
    ]
    return Column(StackNode(int(n), args), None)


def json_tuple(c: Any, *fields: str) -> Column:
    """Extract TOP-LEVEL fields from a JSON string into one column per
    field (c0..c{k-1}; rename with .alias(...)) — row count unchanged.
    Rendering matches get_json_object: scalars as strings, containers
    as JSON text, misses/bad JSON as null (Spark json_tuple)."""
    from sparkdl_tpu_torch.dataframe.column import JsonTupleNode

    src = _sql.Col(c) if isinstance(c, str) else _operand(c)
    return Column(JsonTupleNode(src, list(fields)), None)

# -- partition-seeded generators ----------------------------------------


def monotonically_increasing_id() -> Column:
    """Unique, monotonically increasing int64 per row (pyspark layout:
    partition index << 33 + row position — unique and increasing, not
    consecutive). Top-level select/withColumn item only."""
    from sparkdl_tpu_torch.dataframe.column import NondetNode

    return Column(NondetNode("mono_id"))


def rand(seed: Any = None) -> Column:
    """Uniform [0, 1) draw per row, deterministic for a given seed and
    partitioning (seed defaults to 0 here — pass one explicitly for
    clarity). Top-level select/withColumn item only."""
    from sparkdl_tpu_torch.dataframe.column import NondetNode

    return Column(NondetNode("rand", seed))


def randn(seed: Any = None) -> Column:
    """Standard-normal draw per row; see :func:`rand`."""
    from sparkdl_tpu_torch.dataframe.column import NondetNode

    return Column(NondetNode("randn", seed))


def spark_partition_id() -> Column:
    """The 0-based partition index of each row (pyspark
    spark_partition_id). Top-level select/withColumn item only."""
    from sparkdl_tpu_torch.dataframe.column import NondetNode

    return Column(NondetNode("spark_partition_id"))


def input_file_name() -> Column:
    """pyspark input_file_name. This engine's frames carry no
    file-source lineage, so this is always '' — exactly what pyspark
    returns whenever the source is not a file scan. Frames built by
    readImages/filesToDF keep the path in their 'filePath'/'origin'
    column instead."""
    return Column(_sql.Lit(""))
