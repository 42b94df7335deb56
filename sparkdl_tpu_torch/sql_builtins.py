"""The SQL dialect's row builtins: the cast tables, the helpers of the
scalar builtins, ``_BUILTIN_FNS`` (name -> (least, most arguments, fn)),
the higher-order functions' arities and the null tables that
``sql._eval_expr_row`` reads.

The port's own copy of the JAX package's ``sql.py`` builtin layer,
unchanged in meaning: Spark's non-ANSI semantics (an unconvertible CAST is
null, ``round`` is HALF_UP, Java's ``%`` and regex dialect, the Java date
patterns of ``_JAVA_TOKENS``), null in -> null out except for the
null-safe, null-tolerant and null-skipping tables. Pure Python over host
values: nothing here touches torch or the device.

A few builtins read the host: ``current_date``, ``current_timestamp``,
``now`` and ``current_timezone`` the clock and time zone,
``current_user``/``user`` the login name.
"""

from __future__ import annotations

import datetime as _dtm
import functools
import getpass
import math
import re
import time as _time
import urllib.parse as _urlparse
from typing import Callable, Dict, Optional, Tuple

import numpy as _np


def _substring_sql(s, pos, n):
    """Spark's substringSQL: 1-based; pos 0 acts like 1; NEGATIVE pos
    counts from the end, with the end index computed before clamping
    (so substring('ADA', -5, 2) = '' like Spark, not 'AD')."""
    s = str(s)
    pos, n = int(pos), int(n)
    if pos > 0:
        start = pos - 1
    elif pos < 0:
        start = len(s) + pos
    else:
        start = 0
    end = start + n
    return s[max(start, 0): max(end, 0)] if n >= 0 else ""


def _round_half_up(x, n=0):
    """Spark's ROUND: HALF_UP (2.5 -> 3), not Python's banker's."""
    f = 10.0 ** int(n)
    r = math.floor(abs(x) * f + 0.5) / f
    r = math.copysign(r, x)
    return int(r) if isinstance(x, int) and int(n) <= 0 else r


_CAST_INT_TYPES = {"int", "integer", "bigint", "long", "smallint", "tinyint"}
_CAST_FLOAT_TYPES = {"float", "double", "real"}
_CAST_STR_TYPES = {"string", "varchar", "text"}
_CAST_BOOL_TYPES = {"boolean", "bool"}
_CAST_TYPES = (
    _CAST_INT_TYPES | _CAST_FLOAT_TYPES | _CAST_STR_TYPES | _CAST_BOOL_TYPES
)


def _cast_sql(v, ty):
    """Spark's non-ANSI CAST: unconvertible values yield null, never an
    error; numeric->int truncates toward zero (CAST(3.7 AS INT) = 3);
    booleans render as 'true'/'false' in strings."""
    try:
        if ty in _CAST_INT_TYPES:
            if isinstance(v, bool):
                return int(v)
            if isinstance(v, str):
                return int(float(v.strip()))
            return int(v)
        if ty in _CAST_FLOAT_TYPES:
            if isinstance(v, bool):
                return float(v)
            return float(v.strip() if isinstance(v, str) else v)
        if ty in _CAST_STR_TYPES:
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        # boolean
        if isinstance(v, str):
            s = v.strip().lower()
            if s in ("true", "t", "yes", "y", "1"):
                return True
            if s in ("false", "f", "no", "n", "0"):
                return False
            return None
        return bool(v)
    except (ValueError, TypeError, OverflowError):
        return None


def _instr_sql(s, sub):
    """Spark instr: 1-based position of the first occurrence, 0 when
    absent."""
    return str(s).find(str(sub)) + 1


def _pad_sql(s, n, pad, left: bool):
    """Spark lpad/rpad: truncate when n < len(s); empty pad -> s cut."""
    s, n, pad = str(s), int(n), str(pad)
    if n <= len(s):
        return s[:n]
    if not pad:
        return s
    fill = (pad * ((n - len(s)) // len(pad) + 1))[: n - len(s)]
    return fill + s if left else s + fill


def _regexp_extract_sql(s, pattern, idx):
    """Spark regexp_extract: '' when the pattern does not match."""
    m = re.search(pattern, str(s))
    if m is None:
        return ""
    return m.group(int(idx)) or ""


def _sort_array_sql(a, asc=True):
    """Spark sort_array: nulls FIRST ascending, LAST descending."""
    if not isinstance(a, (list, tuple)):
        return None
    nulls = [x for x in a if x is None]
    rest = sorted((x for x in a if x is not None), reverse=not asc)
    return nulls + rest if asc else rest + nulls


def _array_distinct_sql(a):
    if not isinstance(a, (list, tuple)):
        return None
    out, seen = [], set()
    for x in a:
        k = _cell_key_sql(x)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


def _cell_key_sql(v):
    if isinstance(v, (list, tuple)):
        return ("l",) + tuple(_cell_key_sql(x) for x in v)
    if isinstance(v, dict):
        return ("d",) + tuple(
            sorted(
                ((k, _cell_key_sql(x)) for k, x in v.items()),
                key=lambda kv: repr(kv[0]),
            )
        )
    return v


def _element_at_sql(a, i):
    """Spark element_at: 1-based, negative counts from the end, null
    out of bounds; dict cells look up the key."""
    if isinstance(a, dict):
        return a.get(i)
    if not isinstance(a, (list, tuple)):
        return None
    i = int(i)
    if i == 0:
        raise ValueError("element_at index cannot be 0 (1-based)")
    idx = i - 1 if i > 0 else len(a) + i
    return a[idx] if 0 <= idx < len(a) else None


_JAVA_TOKENS = {
    "yyyy": "%Y", "yy": "%y", "MM": "%m", "dd": "%d",
    "HH": "%H", "mm": "%M", "ss": "%S",
}


@functools.lru_cache(maxsize=256)
def _strftime_pattern(fmt: str) -> str:
    """The common subset of Spark/Java datetime patterns -> strftime.
    Tokenized by letter runs: an UNSUPPORTED token (MMM, single M, ...)
    raises rather than silently emitting corrupted output; callers
    degrade that to null per their non-ANSI contract. Cached — the
    translation is per-format constant but evaluation is per-row."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch.isalpha():
            j = i
            while j < len(fmt) and fmt[j] == ch:
                j += 1
            run = fmt[i:j]
            if run not in _JAVA_TOKENS:
                raise ValueError(
                    f"Unsupported datetime pattern token {run!r}; "
                    f"supported: {sorted(_JAVA_TOKENS)}"
                )
            out.append(_JAVA_TOKENS[run])
            i = j
        else:
            out.append("%%" if ch == "%" else ch)
            i += 1
    return "".join(out)


def _to_date_sql(s, fmt="yyyy-MM-dd"):
    """Spark to_date: unparseable -> null (non-ANSI)."""
    import datetime as _dt

    if isinstance(s, _dt.datetime):
        return s.date()
    if isinstance(s, _dt.date):
        return s
    try:
        return _dt.datetime.strptime(
            str(s), _strftime_pattern(fmt)
        ).date()
    except (ValueError, TypeError):
        return None


def _to_timestamp_sql(s, fmt="yyyy-MM-dd HH:mm:ss"):
    import datetime as _dt

    if isinstance(s, _dt.datetime):
        return s
    if isinstance(s, _dt.date):
        return _dt.datetime(s.year, s.month, s.day)
    try:
        return _dt.datetime.strptime(str(s), _strftime_pattern(fmt))
    except (ValueError, TypeError):
        return None


def _date_part_sql(v, part: str):
    """year/month/... over a date, datetime, or parseable string."""
    d = _to_timestamp_sql(v) or _to_date_sql(v)
    if d is None:
        return None
    if part in ("hour", "minute", "second"):
        import datetime as _dt

        if not isinstance(d, _dt.datetime):
            return 0
        return getattr(d, part)
    if part == "dayofweek":
        # Spark: 1 = Sunday .. 7 = Saturday
        return (d.weekday() + 1) % 7 + 1
    if part == "weekday":
        return d.weekday()  # Spark weekday(): 0 = Monday .. 6 = Sunday
    if part == "quarter":
        return (d.month - 1) // 3 + 1
    if part == "weekofyear":
        return d.isocalendar()[1]  # ISO week, like Spark
    if part == "dayofyear":
        return d.timetuple().tm_yday
    return getattr(d, part)


def _coerce_date(v):
    """A date from a date, datetime, date string, OR timestamp string
    (Spark casts timestamps down to dates for the date arithmetic fns)."""
    d = _to_date_sql(v)
    if d is not None:
        return d
    ts = _to_timestamp_sql(v)
    return None if ts is None else ts.date()


def _shift_months(year: int, month: int, day: int, n: int):
    """(year, month, day) + n months with end-of-month clamping — the
    ONE month-arithmetic rule (add_months, timestampadd share it)."""
    import calendar

    month0 = month - 1 + n
    y = year + month0 // 12
    m = month0 % 12 + 1
    return y, m, min(day, calendar.monthrange(y, m)[1])


def _add_months_sql(v, n):
    """Month arithmetic with end-of-month clamping (Spark add_months:
    2024-01-31 + 1 month -> 2024-02-29)."""
    d = _coerce_date(v)
    if d is None:
        return None
    y, m, day = _shift_months(d.year, d.month, d.day, int(n))
    return d.replace(year=y, month=m, day=day)


def _months_between_sql(end, start, round_off=True):
    """Spark months_between: whole-month difference plus a day
    fraction over a 31-day month; both ends at month-end count as
    whole months. ``round_off`` keeps Spark's 8-decimal rounding."""
    import calendar

    e, s = _coerce_date(end), _coerce_date(start)
    if e is None or s is None:
        return None
    e_last = calendar.monthrange(e.year, e.month)[1]
    s_last = calendar.monthrange(s.year, s.month)[1]
    months = (e.year - s.year) * 12 + (e.month - s.month)
    if e.day == e_last and s.day == s_last:
        return float(months)
    frac = months + (e.day - s.day) / 31.0
    return round(frac, 8) if round_off else frac


def _trunc_sql(v, unit):
    """Spark trunc(date, unit): floor to year/quarter/month/week."""
    import datetime as _dt

    d = _coerce_date(v)
    if d is None:
        return None
    unit = str(unit).lower()
    if unit in ("year", "yyyy", "yy"):
        return d.replace(month=1, day=1)
    if unit in ("quarter",):
        return d.replace(month=((d.month - 1) // 3) * 3 + 1, day=1)
    if unit in ("month", "mon", "mm"):
        return d.replace(day=1)
    if unit in ("week",):
        return d - _dt.timedelta(days=d.weekday())  # Monday (Spark)
    return None  # Spark: unsupported unit -> null


_DURATION_RE = re.compile(
    r"\s*(\d+)\s*(microsecond|millisecond|second|minute|hour|day|week)s?\s*",
    re.I,
)
_DURATION_S = {
    "microsecond": 1e-6, "millisecond": 1e-3, "second": 1.0,
    "minute": 60.0, "hour": 3600.0, "day": 86400.0, "week": 604800.0,
}


@functools.lru_cache(maxsize=64)
def _parse_duration_s(text) -> float:
    """'10 minutes' / '1 hour' -> seconds; raises on anything else
    (a malformed interval is a query bug, not row data). Cached: the
    interval strings are per-query constants evaluated per row."""
    m = _DURATION_RE.fullmatch(str(text))
    if not m:
        raise ValueError(
            f"Cannot parse interval {text!r}; expected '<n> "
            "<microseconds|milliseconds|seconds|minutes|hours|days|weeks>'"
        )
    return int(m.group(1)) * _DURATION_S[m.group(2).lower()]


def _window_sql(v, duration, slide=None, start=None):
    """Spark's time-window bucketing (TUMBLING form): floor the
    timestamp into [start, start + duration) buckets, returned as a
    {'start', 'end'} struct cell — group keys hash by content, so
    ``groupBy(window(ts, '10 minutes'))`` works like Spark. Sliding
    windows (slide != duration) would emit multiple rows per input
    row and are refused loudly."""
    import datetime as _dt

    ts = _to_timestamp_sql(v)
    if ts is None:
        d = _coerce_date(v)
        if d is None:
            return None
        ts = _dt.datetime(d.year, d.month, d.day)
    dur_s = _parse_duration_s(duration)
    if dur_s <= 0:
        raise ValueError(f"window duration must be positive: {duration!r}")
    if slide is not None and _parse_duration_s(slide) != dur_s:
        raise ValueError(
            "sliding windows (slide != duration) are not supported: "
            "each row would belong to several windows; use a tumbling "
            "window or explode precomputed buckets"
        )
    off_s = _parse_duration_s(start) if start is not None else 0.0
    epoch = ts.timestamp()
    lo = math.floor((epoch - off_s) / dur_s) * dur_s + off_s
    return {
        "start": _dt.datetime.fromtimestamp(lo),
        "end": _dt.datetime.fromtimestamp(lo + dur_s),
    }


_TS_UNIT_SECONDS = {
    "microsecond": 1e-6, "millisecond": 1e-3, "second": 1.0,
    "minute": 60.0, "hour": 3600.0, "day": 86400.0, "week": 604800.0,
}


def _timestampadd_sql(unit, n, v):
    """Spark timestampadd(unit, n, ts): calendar arithmetic for
    YEAR/QUARTER/MONTH, exact seconds for the fixed-width units;
    unsupported unit -> null (non-ANSI posture)."""
    ts = _to_timestamp_sql(v)
    if ts is None:
        d = _coerce_date(v)
        if d is None:
            return None
        ts = _dtm.datetime(d.year, d.month, d.day)
    unit = str(unit).lower()
    n = int(n)
    if unit in ("year", "quarter", "month"):
        months = n * {"year": 12, "quarter": 3, "month": 1}[unit]
        y, m, day = _shift_months(ts.year, ts.month, ts.day, months)
        return ts.replace(year=y, month=m, day=day)
    sec = _TS_UNIT_SECONDS.get(unit)
    if sec is None:
        return None
    return ts + _dtm.timedelta(seconds=n * sec)


def _timestampdiff_sql(unit, start, end):
    """Spark timestampdiff(unit, start, end): WHOLE units from start
    to end (calendar months for YEAR/QUARTER/MONTH, truncating
    division for the fixed-width units)."""
    a = _to_timestamp_sql(start)
    b = _to_timestamp_sql(end)
    if a is None or b is None:
        da, db = _coerce_date(start), _coerce_date(end)
        if da is None or db is None:
            return None
        a = a or _dtm.datetime(da.year, da.month, da.day)
        b = b or _dtm.datetime(db.year, db.month, db.day)
    unit = str(unit).lower()
    if unit in ("year", "quarter", "month"):
        months = (b.year - a.year) * 12 + (b.month - a.month)
        # incomplete trailing month doesn't count (java.time's rule:
        # compare the sub-month components directly — constructing
        # b.replace(month=a.month) could be an invalid date)
        a_sub = (a.day, a.hour, a.minute, a.second, a.microsecond)
        b_sub = (b.day, b.hour, b.minute, b.second, b.microsecond)
        if months > 0 and b_sub < a_sub:
            months -= 1
        elif months < 0 and b_sub > a_sub:
            months += 1
        div = {"year": 12, "quarter": 3, "month": 1}[unit]
        q = abs(months) // div  # truncate toward ZERO (Spark), not floor
        return -q if months < 0 else q
    sec = _TS_UNIT_SECONDS.get(unit)
    if sec is None:
        return None
    td = b - a
    # exact integer microseconds (float total_seconds() loses precision
    # at long ranges, and float division floors milliseconds wrong)
    total_us = (td.days * 86400 + td.seconds) * 10**6 + td.microseconds
    unit_us = int(sec * 10**6)
    q = abs(total_us) // unit_us  # truncate toward zero (Spark)
    return -q if total_us < 0 else q


def _make_timestamp_sql(y, mo, d, h, mi, s):
    try:
        sec = float(s)
        if not 0 <= sec <= 60:
            return None
        # seconds add as a timedelta so 60 (and 59.999999x rounding)
        # roll over to the next minute, like Spark
        base = _dtm.datetime(int(y), int(mo), int(d), int(h), int(mi))
        return base + _dtm.timedelta(seconds=sec)
    except (ValueError, OverflowError):
        return None  # non-ANSI: invalid components -> null


def _date_part_fn_sql(field, v):
    """date_part('year', d) — EXTRACT's two-argument function form
    (the string field routes to the same per-part builtins)."""
    fn = _EXTRACT_FIELDS.get(str(field).lower())
    if fn is None:
        return None
    impl = _BUILTIN_FNS[fn][2]
    return impl(v)


def _date_trunc_sql(unit, v):
    """Spark date_trunc(unit, ts): floor a TIMESTAMP (argument order
    reversed vs trunc, both as in Spark); unsupported unit -> null."""
    import datetime as _dt

    ts = _to_timestamp_sql(v)
    if ts is None:
        d = _coerce_date(v)
        if d is None:
            return None
        ts = _dt.datetime(d.year, d.month, d.day)
    unit = str(unit).lower()
    if unit in ("year", "yyyy", "yy"):
        return ts.replace(month=1, day=1, hour=0, minute=0, second=0,
                          microsecond=0)
    if unit == "quarter":
        return ts.replace(month=((ts.month - 1) // 3) * 3 + 1, day=1,
                          hour=0, minute=0, second=0, microsecond=0)
    if unit in ("month", "mon", "mm"):
        return ts.replace(day=1, hour=0, minute=0, second=0,
                          microsecond=0)
    if unit == "week":
        monday = ts - _dt.timedelta(days=ts.weekday())
        return monday.replace(hour=0, minute=0, second=0, microsecond=0)
    if unit in ("day", "dd"):
        return ts.replace(hour=0, minute=0, second=0, microsecond=0)
    if unit == "hour":
        return ts.replace(minute=0, second=0, microsecond=0)
    if unit == "minute":
        return ts.replace(second=0, microsecond=0)
    if unit == "second":
        return ts.replace(microsecond=0)
    return None


def _last_day_sql(v):
    import calendar

    d = _coerce_date(v)
    if d is None:
        return None
    return d.replace(day=calendar.monthrange(d.year, d.month)[1])


def _next_day_sql(v, dow):
    """First date AFTER v that falls on the named weekday (Spark
    next_day; invalid day name -> null)."""
    import datetime as _dt

    d = _coerce_date(v)
    if d is None:
        return None
    names = {
        "mon": 0, "monday": 0, "tue": 1, "tuesday": 1,
        "wed": 2, "wednesday": 2, "thu": 3, "thursday": 3,
        "fri": 4, "friday": 4, "sat": 5, "saturday": 5,
        "sun": 6, "sunday": 6,
    }
    key = str(dow).lower()
    if key not in names:  # EXACT name/abbreviation, like Spark
        return None
    ahead = (names[key] - d.weekday() - 1) % 7 + 1
    return d + _dt.timedelta(days=ahead)


def _unix_timestamp_sql(v=None, fmt="yyyy-MM-dd HH:mm:ss"):
    """Seconds since the epoch (UTC-naive like the rest of the date
    layer) from a timestamp/date/string."""
    import datetime as _dt

    if v is None:
        v = _dt.datetime.now()
    t = _to_timestamp_sql(v, fmt) if isinstance(v, str) else v
    if t is None:
        return None
    if isinstance(t, _dt.datetime):
        return int(t.timestamp())
    if isinstance(t, _dt.date):
        return int(
            _dt.datetime(t.year, t.month, t.day).timestamp()
        )
    return None


def _from_unixtime_sql(sec, fmt="yyyy-MM-dd HH:mm:ss"):
    t = _timestamp_seconds_sql(sec)
    return None if t is None else _date_format_sql(t, fmt)


def _timestamp_seconds_sql(sec):
    """Epoch seconds -> timestamp; non-numeric / out-of-range -> null
    (matching the rest of the date layer's null-not-crash contract)."""
    import datetime as _dt

    try:
        return _dt.datetime.fromtimestamp(int(sec))
    except (ValueError, TypeError, OverflowError, OSError):
        return None


def _date_add_sql(v, n):
    import datetime as _dt

    d = _coerce_date(v)
    return None if d is None else d + _dt.timedelta(days=int(n))


def _datediff_sql(end, start):
    a, b = _coerce_date(end), _coerce_date(start)
    if a is None or b is None:
        return None
    return (a - b).days


def _date_format_sql(v, fmt):
    d = _to_timestamp_sql(v) or _to_date_sql(v)
    if d is None:
        return None
    try:
        return d.strftime(_strftime_pattern(fmt))
    except ValueError:
        return None  # unsupported pattern token -> null, not corruption


def _split_sql(s, pattern, limit=-1):
    """Spark split: regex delimiter; limit>0 caps the piece count
    (limit=1 means no split at all — Python's maxsplit=0 would mean
    UNLIMITED, hence the explicit case)."""
    limit = int(limit)
    if limit == 1:
        return [str(s)]
    return re.split(pattern, str(s), maxsplit=limit - 1 if limit > 1 else 0)


def _initcap_sql(s):
    """Spark initcap: capitalize the first letter of SPACE-separated
    words only, lowercasing the rest ('a-b' -> 'A-b', not str.title's
    'A-B')."""
    return " ".join(
        w[:1].upper() + w[1:].lower() for w in str(s).split(" ")
    )


def _pow_sql(a, b):
    """Spark/Java Math.pow: 0^negative and overflow -> Infinity,
    negative^fractional -> NaN (never a Python complex or a crash)."""
    a, b = float(a), float(b)
    try:
        r = a ** b
    except ZeroDivisionError:
        return float("inf")
    except OverflowError:
        return float("inf")
    if isinstance(r, complex):
        return float("nan")
    return r


def _exp_sql(a):
    try:
        return math.exp(a)
    except OverflowError:
        return float("inf")  # Spark returns Infinity, not a crash


# Builtin scalar functions, evaluated row-wise on the host like
def _from_json_sql(s):
    """Parse a JSON string cell to a dict/list cell; unparseable ->
    null (Spark's PERMISSIVE mode). The optional schema argument is
    accepted for source compatibility and ignored — columns are
    dynamically typed here."""
    import json

    try:
        return json.loads(str(s))
    except (ValueError, TypeError):
        return None


def _json_value_text(cur):
    """Spark's JSON-extraction rendering, shared by get_json_object and
    json_tuple: null stays null, containers re-serialize as JSON,
    booleans as true/false, scalars as strings."""
    import json

    if cur is None:
        return None
    if isinstance(cur, (dict, list)):
        return json.dumps(cur)
    if isinstance(cur, bool):
        return "true" if cur else "false"
    return str(cur)


def _json_tuple_row(js, fields) -> tuple:
    """One json.loads, k LITERAL top-level key lookups (Spark
    json_tuple: 'a.b' is the literal key \"a.b\", never a path)."""
    import json

    try:
        obj = json.loads(str(js))
    except (ValueError, TypeError):
        obj = None
    if not isinstance(obj, dict):
        return (None,) * len(fields)
    return tuple(_json_value_text(obj.get(f)) for f in fields)


def _get_json_object_sql(s, path):
    """Spark get_json_object: extract by a $.a.b[0] path from a JSON
    string; scalars come back as strings, containers re-serialized as
    JSON, misses and bad input as null."""
    import json
    import re as _re

    try:
        cur = json.loads(str(s))
    except (ValueError, TypeError):
        return None
    path = str(path)
    if not path.startswith("$"):
        return None
    # the WHOLE path must be dot-key / [index] steps: anything else
    # (bracket-quoted keys, wildcards, dashes) yields null, never a
    # silently wrong fragment match
    step_re = r"\.[A-Za-z_][A-Za-z_0-9]*|\[\d+\]"
    if not _re.fullmatch(f"(?:{step_re})*", path[1:]):
        return None
    for step in _re.findall(r"\.([A-Za-z_][A-Za-z_0-9]*)|\[(\d+)\]",
                            path[1:]):
        key, idx = step
        if key:
            if not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
        else:
            i = int(idx)
            if not isinstance(cur, list) or i >= len(cur):
                return None
            cur = cur[i]
    return _json_value_text(cur)


_I64_MASK = (1 << 64) - 1


def _wrap_i64(n: int) -> int:
    """Two's-complement wrap to a signed 64-bit long (Java long
    arithmetic — Spark's shiftleft/shiftright operate on longs)."""
    n = int(n) & _I64_MASK
    return n - (1 << 64) if n >= (1 << 63) else n


def _bin_sql(n):
    """Spark bin: binary text of a long; negatives render as 64-bit
    two's complement (bin(-1) = 64 ones)."""
    return format(int(n) & _I64_MASK, "b")


_CONV_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _conv_sql(num, from_base, to_base):
    """Spark/Hive conv: re-base an integer string. Parses the longest
    valid digit prefix (none -> null); negative inputs render as
    unsigned 64-bit two's complement unless to_base is negative, which
    asks for signed output. Bases 2..36."""
    fb, tb = int(from_base), int(to_base)
    if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
        return None
    s = str(num).strip().upper()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    digits = ""
    for ch in s:
        if ch in _CONV_DIGITS[:fb]:
            digits += ch
        else:
            break
    if not digits:
        return None
    val = int(digits, fb)
    if val > _I64_MASK:
        val = _I64_MASK  # Hive/Spark saturate overflow at unsigned max
    if neg:
        val = -val
    if tb > 0:
        val &= _I64_MASK  # unsigned two's-complement view
        sign = ""
    else:
        sign = "-" if val < 0 else ""
        val, tb = abs(val), -tb
    if val == 0:
        return "0"
    out = []
    while val:
        val, r = divmod(val, tb)
        out.append(_CONV_DIGITS[r])
    return sign + "".join(reversed(out))


def _as_bytes(v) -> bytes:
    return v if isinstance(v, (bytes, bytearray)) else str(v).encode("utf-8")


def _hex_sql(v):
    """Spark hex: ints as unsigned 64-bit uppercase hex; strings/bytes
    as the hex of their bytes."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, _np.integer)):
        return format(int(v) & _I64_MASK, "X")
    return _as_bytes(v).hex().upper()


def _unhex_sql(s):
    """Inverse of hex on strings: hex text -> bytes cell; odd length
    gets a leading zero (hex(unhex('F')) == '0F', Spark); invalid
    digits -> null."""
    s = str(s)
    if len(s) % 2:
        s = "0" + s
    try:
        return bytes.fromhex(s)
    except ValueError:
        return None


def _unbase64_sql(s):
    """Lenient base64 decode (Spark tolerates missing padding and
    MIME line breaks); undecodable input -> null, never a crash."""
    import base64 as _b64
    import binascii

    raw = s.decode("ascii", "ignore") if isinstance(
        s, (bytes, bytearray)) else str(s)
    raw = "".join(raw.split())  # MIME-style wrapped input
    raw += "=" * (-len(raw) % 4)  # repair missing padding
    try:
        return _b64.b64decode(raw)
    except (binascii.Error, ValueError):
        return None


def _sha2_sql(v, bits):
    """sha2(expr, 224/256/384/512); 0 means 256 (Spark); any other
    width -> null."""
    import hashlib

    bits = int(bits)
    algo = {0: "sha256", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}.get(bits)
    if algo is None:
        return None
    return getattr(hashlib, algo)(_as_bytes(v)).hexdigest()


def _levenshtein_sql(a, b):
    """Edit distance (insert/delete/substitute), classic rolling-row DP."""
    s, t = str(a), str(b)
    if not s:
        return len(t)
    if not t:
        return len(s)
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s, 1):
        cur = [i]
        for j, ct in enumerate(t, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (cs != ct)))
        prev = cur
    return prev[-1]


_SOUNDEX_CODE = {}
for _chars, _code in (("BFPV", "1"), ("CGJKQSXZ", "2"), ("DT", "3"),
                      ("L", "4"), ("MN", "5"), ("R", "6")):
    for _ch in _chars:
        _SOUNDEX_CODE[_ch] = _code


def _soundex_sql(s):
    """American Soundex (Spark soundex): letter + 3 digits; H/W are
    transparent between same-coded consonants; non-alphabetic first
    char returns the input unchanged (Spark)."""
    s = str(s)
    if not s or not s[0].isalpha():
        return s
    up = [c for c in s.upper() if c.isalpha()]
    first = up[0]
    out = [first]
    prev = _SOUNDEX_CODE.get(first, "")
    for ch in up[1:]:
        code = _SOUNDEX_CODE.get(ch, "")
        if code and code != prev:
            out.append(code)
            if len(out) == 4:
                break
        if ch not in "HW":  # vowels reset the run; H/W don't
            prev = code
    return "".join(out) + "0" * (4 - len(out))


def _is_arr(a) -> bool:
    return isinstance(a, (list, tuple))


def _slice_sql(a, start, length):
    """Spark slice: 1-based start (negative counts from the end),
    ``length`` elements; start=0 is an error in Spark -> null here
    (non-ANSI posture of this dialect); non-array -> null."""
    if not _is_arr(a):
        return None
    start, length = int(start), int(length)
    if start == 0 or length < 0:
        return None
    i = start - 1 if start > 0 else len(a) + start
    if i < 0:
        return []
    return list(a[i:i + length])


def _flatten_sql(a):
    """One level of nesting removed; a null nested array nulls the
    result (Spark)."""
    if not _is_arr(a):
        return None
    out = []
    for el in a:
        if el is None:
            return None
        if not _is_arr(el):
            return None
        out.extend(el)
    return out


def _sequence_sql(start, stop, step=None):
    """Inclusive integer range; default step is +/-1 toward stop;
    a step of 0 or pointing away from stop -> null (Spark errors —
    null keeps this dialect's non-ANSI posture)."""
    start, stop = int(start), int(stop)
    if step is None:
        step = 1 if stop >= start else -1
    step = int(step)
    if step == 0 or (stop > start and step < 0) or (stop < start and step > 0):
        return None
    out = []
    v = start
    if step > 0:
        while v <= stop:
            out.append(v)
            v += step
    else:
        while v >= stop:
            out.append(v)
            v += step
    return out


def _arrays_zip_sql(*arrs):
    """Element-wise zip to struct cells keyed "0", "1", ... (Spark
    keys by source column name, which a value-level builtin cannot
    see — documented divergence); shorter arrays pad with null."""
    if any(not _is_arr(a) for a in arrs):
        return None
    n = max((len(a) for a in arrs), default=0)
    return [
        {str(j): (a[i] if i < len(a) else None)
         for j, a in enumerate(arrs)}
        for i in range(n)
    ]


def _dedup_keep_order(vals):
    seen, out = [], []
    for v in vals:
        if v not in seen:
            seen.append(v)
            out.append(v)
    return out


def _array_union_sql(a, b):
    if not _is_arr(a) or not _is_arr(b):
        return None
    return _dedup_keep_order(list(a) + list(b))


def _array_intersect_sql(a, b):
    if not _is_arr(a) or not _is_arr(b):
        return None
    bl = list(b)
    return _dedup_keep_order([v for v in a if v in bl])


def _array_except_sql(a, b):
    if not _is_arr(a) or not _is_arr(b):
        return None
    bl = list(b)
    return _dedup_keep_order([v for v in a if v not in bl])


def _array_position_sql(a, v):
    """1-based first index of v; 0 when absent (Spark)."""
    if not _is_arr(a) or v is None:
        return None
    for i, el in enumerate(a):
        if el == v and el is not None:
            return i + 1
    return 0


def _array_remove_sql(a, v):
    if not _is_arr(a) or v is None:
        return None
    return [el for el in a if el != v or el is None]


def _array_repeat_sql(v, n):
    """n copies of v — v may legitimately be null (the fn is in the
    null-TOLERANT set, so a null count must null the result here)."""
    if n is None:
        return None
    n = int(n)
    return [v] * n if n > 0 else []


def _array_join_sql(a, sep, null_repl=None):
    """Join elements with sep; nulls are SKIPPED unless a replacement
    is given (Spark)."""
    if not _is_arr(a):
        return None
    parts = []
    for el in a:
        if el is None:
            if null_repl is not None:
                parts.append(str(null_repl))
        else:
            parts.append(str(el))
    return str(sep).join(parts)


def _create_map_sql(*kv):
    """map(k1, v1, k2, v2, ...) -> dict cell; null VALUES are data
    (null-tolerant), a null KEY is an error in Spark -> null here."""
    if len(kv) % 2:
        return None
    keys, vals = kv[0::2], kv[1::2]
    if any(k is None for k in keys):
        return None
    return dict(zip(keys, vals))


def _map_from_arrays_sql(ks, vs):
    if not _is_arr(ks) or not _is_arr(vs) or len(ks) != len(vs):
        return None
    if any(k is None for k in ks):
        return None
    return dict(zip(ks, vs))


def _map_concat_sql(*ms):
    """Later maps win duplicate keys (Spark's LAST_WIN policy)."""
    out = {}
    for m in ms:
        if not isinstance(m, dict):
            return None
        out.update(m)
    return out


def _split_part_sql(s, delim, n):
    """Spark split_part: 1-based LITERAL-delimiter part; negative
    counts from the end; out of range -> ''; n = 0 -> null (Spark
    errors; null keeps this dialect's non-ANSI posture)."""
    n = int(n)
    if n == 0:
        return None
    parts = str(s).split(str(delim))
    idx = n - 1 if n > 0 else len(parts) + n
    if not 0 <= idx < len(parts):
        return ""
    return parts[idx]


def _array_insert_sql(a, pos, v):
    """Spark array_insert: 1-based (negative from the end, -1 appends
    BEFORE the last position per Spark 3.4); inserting past the end
    pads with nulls; pos = 0 -> null."""
    if not _is_arr(a):
        return None
    pos = int(pos)
    if pos == 0:
        return None
    out = list(a)
    if pos > 0:
        idx = pos - 1
        if idx > len(out):
            out.extend([None] * (idx - len(out)))
        out.insert(idx, v)
    else:
        idx = len(out) + pos + 1
        if idx < 0:
            out[0:0] = [v] + [None] * (-idx)
        else:
            out.insert(idx, v)
    return out


def _map_from_entries_sql(entries):
    """[{'key': k, 'value': v}, ...] or [[k, v], ...] -> dict cell;
    null keys null the map (matching map_from_arrays)."""
    if not _is_arr(entries):
        return None
    out = {}
    for e in entries:
        if isinstance(e, dict):
            if set(e.keys()) >= {"key", "value"}:
                k, v = e["key"], e["value"]
            elif len(e) == 2:
                k, v = list(e.values())
            else:
                return None
        elif _is_arr(e) and len(e) == 2:
            k, v = e
        else:
            return None
        if k is None:
            return None
        out[k] = v
    return out


def _typeof_sql(v):
    """Spark-vocabulary type name of a cell (dynamically typed engine:
    the PYTHON cell type maps onto Spark's names)."""
    import datetime as _dt

    if v is None:
        return "void"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, _np.integer)):
        return "bigint"
    if isinstance(v, (float, _np.floating)):
        return "double"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (bytes, bytearray)):
        return "binary"
    if isinstance(v, _dt.datetime):
        return "timestamp"
    if isinstance(v, _dt.date):
        return "date"
    if isinstance(v, dict):
        return "map<...>" if v and not all(
            isinstance(k, str) for k in v
        ) else "struct<...>"
    if isinstance(v, (list, tuple, _np.ndarray)):
        return "array<...>"
    return type(v).__name__


def _to_number_sql(s, fmt=None):
    """Approximate Spark to_number: strip grouping separators and
    currency signs per the format, parse; unparseable -> null."""
    del fmt  # the '9G999D99' patterns only guide parsing in Spark
    raw = str(s).strip().replace(",", "").replace("$", "")
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return None


def _to_char_sql(v, fmt):
    """Approximate Spark to_char for numeric formats: decimals from
    the digits after D/., grouping when G/, appears."""
    fmt = str(fmt).upper().replace("G", ",").replace("D", ".")
    dec = len(fmt.split(".")[1]) if "." in fmt else 0
    q = _round_half_up(float(v), dec)
    return f"{q:,.{dec}f}" if "," in fmt else f"{q:.{dec}f}"


def _format_number_sql(v, d):
    """Spark format_number: comma-grouped with d decimals (HALF_UP,
    matching this dialect's round); d < 0 -> null."""
    d = int(d)
    if d < 0:
        return None
    q = _round_half_up(float(v), d)
    return f"{q:,.{d}f}"


def _substring_index_sql(s, delim, count):
    """Spark substring_index: text before the count-th delimiter
    (count > 0, from the left) or after the |count|-th from the right
    (count < 0); count = 0 -> ''."""
    s, delim, count = str(s), str(delim), int(count)
    if count == 0 or not delim:
        return ""
    parts = s.split(delim)
    if count > 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


def _overlay_sql(s, repl, pos, n=-1):
    """Spark overlay: replace ``n`` chars at 1-based pos with repl
    (n defaults to len(repl)); pos < 1 -> null (Spark errors)."""
    s, repl, pos, n = str(s), str(repl), int(pos), int(n)
    if pos < 1:
        return None
    if n < 0:
        n = len(repl)
    return s[: pos - 1] + repl + s[pos - 1 + n:]


def _elt_sql(n, *xs):
    """1-based argument pick; out of range -> null (Spark non-ANSI)."""
    n = int(n)
    if not 1 <= n <= len(xs):
        return None
    return xs[n - 1]


def _find_in_set_sql(s, csv):
    """1-based index of s in a comma-separated list; 0 when absent or
    when s itself contains a comma (Spark)."""
    s = str(s)
    if "," in s:
        return 0
    items = str(csv).split(",")
    return items.index(s) + 1 if s in items else 0


def _make_date_sql(y, m, d):
    import datetime as _dt

    try:
        return _dt.date(int(y), int(m), int(d))
    except (ValueError, OverflowError):
        return None  # Spark non-ANSI: invalid date -> null


def _try_arith(op, a, b):
    """try_add/subtract/multiply/divide: null instead of any error."""
    try:
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        return a / b if b != 0 else None
    except (TypeError, OverflowError, ZeroDivisionError):
        return None


def _locate_sql(sub, s, pos=1):
    """Spark locate(substr, str, pos): 1-based position of the first
    occurrence at or after pos; 0 when absent or pos < 1."""
    pos = int(pos)
    if pos < 1:
        return 0
    return str(s).find(str(sub), pos - 1) + 1


def _inf_on_overflow(fn, a, signed=True):
    """Java Math maps double overflow to Infinity; Python raises.
    ``signed=False`` for even functions (cosh overflows to +Infinity
    on BOTH ends)."""
    try:
        return fn(float(a))
    except OverflowError:
        return math.copysign(float("inf"), a) if signed else float("inf")


def _rint_sql(a):
    """Java Math.rint: round half to EVEN, returned as float; non-
    finite values pass through."""
    a = float(a)
    if math.isnan(a) or math.isinf(a):
        return a
    return float(round(a))


def _factorial_sql(n):
    n = int(n)
    if not 0 <= n <= 20:  # Spark: null outside the long-safe range
        return None
    return math.factorial(n)


def _hash_sql(*xs) -> int:
    """Stable 32-bit row hash over the argument tuple (md5-keyed;
    signed int32 like Spark's hash, but not murmur3-compatible).
    ndarray cells hash their FULL buffer + dtype + shape — repr would
    elide the interior of arrays >1000 elements and collapse nearly
    all large tensors into the same bucket."""
    import hashlib

    h = hashlib.md5()
    for x in xs:
        if isinstance(x, _np.ndarray):
            h.update(b"nd|")
            h.update(str(x.dtype).encode())
            h.update(repr(x.shape).encode())
            h.update(_np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(x).encode())
        h.update(b"\x1f")  # field separator: ('ab',) != ('a','b')
    return int.from_bytes(h.digest()[:4], "little", signed=True)


# arithmetic (Spark's builtins win over same-named registered UDFs).
# (min_args, max_args, fn); null in any argument -> null result, except
# coalesce/ifnull which exist to consume nulls and greatest/least which
# skip nulls (Spark).
_BUILTIN_FNS: Dict[str, Tuple[int, Optional[int], Callable]] = {
    "upper": (1, 1, lambda a: str(a).upper()),
    "lower": (1, 1, lambda a: str(a).lower()),
    "length": (1, 1, lambda a: len(str(a))),
    "trim": (1, 1, lambda a: str(a).strip()),
    "ltrim": (1, 1, lambda a: str(a).lstrip()),
    "rtrim": (1, 1, lambda a: str(a).rstrip()),
    "initcap": (1, 1, _initcap_sql),
    "reverse": (1, 1, lambda a: str(a)[::-1]),
    "repeat": (2, 2, lambda a, n: str(a) * int(n)),
    "replace": (2, 3, lambda s, find, repl="": str(s).replace(
        str(find), str(repl)
    )),
    "instr": (2, 2, _instr_sql),
    "lpad": (3, 3, lambda s, n, p: _pad_sql(s, n, p, True)),
    "rpad": (3, 3, lambda s, n, p: _pad_sql(s, n, p, False)),
    "split": (2, 3, _split_sql),
    "regexp_extract": (3, 3, _regexp_extract_sql),
    "regexp_replace": (3, 3, lambda s, pat, repl: re.sub(
        pat, repl, str(s)
    )),
    "abs": (1, 1, abs),
    "sqrt": (1, 1, lambda a: math.sqrt(a) if a >= 0 else float("nan")),
    "exp": (1, 1, _exp_sql),
    "log": (1, 1, lambda a: math.log(a) if a > 0 else None),  # ln, Spark
    "log10": (1, 1, lambda a: math.log10(a) if a > 0 else None),
    "log2": (1, 1, lambda a: math.log2(a) if a > 0 else None),
    "pow": (2, 2, _pow_sql),
    "power": (2, 2, _pow_sql),
    "sign": (1, 1, lambda a: float((a > 0) - (a < 0))),
    "signum": (1, 1, lambda a: float((a > 0) - (a < 0))),
    "floor": (1, 1, lambda a: math.floor(a)),
    "ceil": (1, 1, lambda a: math.ceil(a)),
    "round": (1, 2, _round_half_up),
    "concat": (1, None, lambda *xs: "".join(str(x) for x in xs)),
    # concat_ws(sep, ...) SKIPS null args (unlike concat, Spark); list
    # args flatten; evaluated via a dedicated branch in _eval_expr_row
    "concat_ws": (2, None, None),
    "substring": (3, 3, lambda s, pos, n: _substring_sql(s, pos, n)),
    # array cells (split() produces them): size, 0-based get (null out
    # of bounds, Spark's get()), 1-based element_at (negative counts
    # from the end), membership
    "isnan": (1, 1, None),  # dedicated branch: isnan(NULL) is FALSE
    "array": (1, None, None),  # dedicated branch: nulls stay ELEMENTS
    "sort_array": (1, 2, lambda a, asc=True: _sort_array_sql(a, asc)),
    "array_distinct": (1, 1, lambda a: _array_distinct_sql(a)),
    "array_max": (1, 1, lambda a: max(
        (x for x in a if x is not None), default=None
    ) if isinstance(a, (list, tuple)) else None),
    "array_min": (1, 1, lambda a: min(
        (x for x in a if x is not None), default=None
    ) if isinstance(a, (list, tuple)) else None),
    "size": (1, 1, lambda a: len(a) if isinstance(a, (list, tuple, dict))
             else None),
    "get": (2, 2, lambda a, i: a[int(i)]
            if isinstance(a, (list, tuple)) and 0 <= int(i) < len(a)
            else None),
    "element_at": (2, 2, lambda a, i: _element_at_sql(a, i)),
    # non-ANSI dialect: element_at already nulls out-of-bounds, so the
    # try_ spelling is the same operation (Spark 3.5 names)
    "try_element_at": (2, 2, lambda a, i: _element_at_sql(a, i)),
    "array_contains": (2, 2, lambda a, v: v in a
                       if isinstance(a, (list, tuple)) else None),
    # dates/timestamps: Java-pattern subset (yyyy MM dd HH mm ss);
    # unparseable values -> null (Spark non-ANSI)
    "to_date": (1, 2, _to_date_sql),
    "to_timestamp": (1, 2, _to_timestamp_sql),
    "year": (1, 1, lambda v: _date_part_sql(v, "year")),
    "month": (1, 1, lambda v: _date_part_sql(v, "month")),
    "dayofmonth": (1, 1, lambda v: _date_part_sql(v, "day")),
    "day": (1, 1, lambda v: _date_part_sql(v, "day")),
    "dayofweek": (1, 1, lambda v: _date_part_sql(v, "dayofweek")),
    "hour": (1, 1, lambda v: _date_part_sql(v, "hour")),
    "minute": (1, 1, lambda v: _date_part_sql(v, "minute")),
    "second": (1, 1, lambda v: _date_part_sql(v, "second")),
    "date_add": (2, 2, _date_add_sql),
    "date_sub": (2, 2, lambda v, n: _date_add_sql(v, -int(n))),
    "datediff": (2, 2, _datediff_sql),
    "date_format": (2, 2, _date_format_sql),
    "add_months": (2, 2, _add_months_sql),
    "months_between": (2, 3, _months_between_sql),
    "trunc": (2, 2, _trunc_sql),
    "last_day": (1, 1, _last_day_sql),
    "next_day": (2, 2, _next_day_sql),
    "quarter": (1, 1, lambda v: _date_part_sql(v, "quarter")),
    "weekofyear": (1, 1, lambda v: _date_part_sql(v, "weekofyear")),
    "dayofyear": (1, 1, lambda v: _date_part_sql(v, "dayofyear")),
    "unix_timestamp": (0, 2, _unix_timestamp_sql),
    "from_unixtime": (1, 2, _from_unixtime_sql),
    "timestamp_seconds": (1, 1, _timestamp_seconds_sql),
    # deferred to EXECUTION time (a cached plan must not pin the day it
    # was built); evaluated per row — negligible intra-query drift vs
    # Spark's per-query constant
    "current_date": (0, 0, lambda: __import__("datetime").date.today()),
    "current_timestamp": (
        0, 0, lambda: __import__("datetime").datetime.now(),
    ),
    # CAST(expr AS type) parses through a dedicated grammar rule but
    # evaluates as a two-argument builtin (arg, type-name literal)
    "cast": (2, 2, _cast_sql),
    # translate(s, from, to): per-char map; from-chars beyond len(to)
    # are DELETED (Spark)
    "translate": (3, 3, lambda s, frm, to: str(s).translate({
        ord(ch): (str(to)[i] if i < len(str(to)) else None)
        for i, ch in enumerate(str(frm))
    })),
    # printf-style formatting (Spark format_string/printf); any null
    # argument nulls the result via the central null propagation (Spark
    # prints 'null' — documented divergence)
    "format_string": (1, None, lambda fmt, *xs: str(fmt) % tuple(xs)),
    "printf": (1, None, lambda fmt, *xs: str(fmt) % tuple(xs)),
    # bround = HALF_EVEN (banker's) rounding, vs round's HALF_UP
    "bround": (1, 2, lambda a, s=0: round(a, int(s))),
    # deterministic row hash -> int32. NOT Spark's murmur3 values (the
    # exact constants are engine-specific everywhere); stable across
    # processes/runs, which is what partitioning/bucketing idioms need
    "hash": (1, None, _hash_sql),
    # named_struct('a', x, 'b', y) -> dict cell; F.struct compiles onto
    # it with field names derived from its Column arguments
    "named_struct": (2, None, lambda *xs: (
        dict(zip(xs[0::2], xs[1::2]))
    )),
    # struct-cell surgery (Column.withField / dropFields); null struct
    # -> null, null VALUES are legitimate fields (null-tolerant)
    "with_field": (3, 3, lambda d, n, v: (
        {**d, n: v} if isinstance(d, dict) else None
    )),
    "drop_fields": (2, None, lambda d, *ns: (
        {k: v for k, v in d.items() if k not in ns}
        if isinstance(d, dict)
        else None
    )),
    "map_keys": (1, 1, lambda d: (
        list(d.keys()) if isinstance(d, dict) else None
    )),
    "map_values": (1, 1, lambda d: (
        list(d.values()) if isinstance(d, dict) else None
    )),
    # nanvl(a, b): b when a is NaN (null propagation stays central)
    "nanvl": (2, 2, lambda a, b: (
        b if isinstance(a, float) and math.isnan(a) else a
    )),
    # JSON bridge: Spark's string-in/string-out semantics
    "to_json": (1, 1, lambda d: __import__("json").dumps(d, default=str)),
    "from_json": (1, 2, lambda s, _schema=None: _from_json_sql(s)),
    "get_json_object": (2, 2, lambda s, path: _get_json_object_sql(
        s, path
    )),
    # trigonometry / hyperbolics: Java Math semantics — domain misses
    # are NaN (asin(2) -> NaN), never exceptions
    "sin": (1, 1, lambda a: math.sin(a)),
    "cos": (1, 1, lambda a: math.cos(a)),
    "tan": (1, 1, lambda a: math.tan(a)),
    "asin": (1, 1, lambda a: math.asin(a) if -1 <= a <= 1
             else float("nan")),
    "acos": (1, 1, lambda a: math.acos(a) if -1 <= a <= 1
             else float("nan")),
    "atan": (1, 1, lambda a: math.atan(a)),
    "atan2": (2, 2, lambda y, x: math.atan2(y, x)),
    "sinh": (1, 1, lambda a: _inf_on_overflow(math.sinh, a)),
    "cosh": (1, 1, lambda a: _inf_on_overflow(math.cosh, a, signed=False)),
    "tanh": (1, 1, lambda a: math.tanh(a)),
    "degrees": (1, 1, lambda a: math.degrees(a)),
    "radians": (1, 1, lambda a: math.radians(a)),
    "expm1": (1, 1, lambda a: _inf_on_overflow(math.expm1, a)),
    # log-family misses -> null, matching this table's log/log10/log2
    "log1p": (1, 1, lambda a: math.log1p(a) if a > -1 else None),
    "cbrt": (1, 1, lambda a: math.copysign(
        abs(float(a)) ** (1.0 / 3.0), a
    )),
    "rint": (1, 1, _rint_sql),
    "hypot": (2, 2, lambda a, b: math.hypot(a, b)),
    "factorial": (1, 1, _factorial_sql),
    # long (64-bit two's-complement) bit arithmetic, Java semantics
    "bin": (1, 1, _bin_sql),
    "conv": (3, 3, _conv_sql),
    "shiftleft": (2, 2, lambda v, n: _wrap_i64(int(v) << (int(n) & 63))),
    "shiftright": (2, 2, lambda v, n: _wrap_i64(int(v)) >> (int(n) & 63)),
    "shiftrightunsigned": (2, 2, lambda v, n: _wrap_i64(
        (int(v) & _I64_MASK) >> (int(n) & 63)
    )),
    # digests / codecs: strings hash their utf-8 bytes, bytes cells
    # hash as-is
    "hex": (1, 1, _hex_sql),
    "unhex": (1, 1, _unhex_sql),
    "base64": (1, 1, lambda v: __import__("base64").b64encode(
        _as_bytes(v)).decode("ascii")),
    "unbase64": (1, 1, lambda s: _unbase64_sql(s)),
    "md5": (1, 1, lambda v: __import__("hashlib").md5(
        _as_bytes(v)).hexdigest()),
    "sha1": (1, 1, lambda v: __import__("hashlib").sha1(
        _as_bytes(v)).hexdigest()),
    "sha": (1, 1, lambda v: __import__("hashlib").sha1(
        _as_bytes(v)).hexdigest()),
    "sha2": (1, 2, lambda v, bits=256: _sha2_sql(v, bits)),
    "crc32": (1, 1, lambda v: __import__("zlib").crc32(_as_bytes(v))),
    # string search / distance
    "locate": (2, 3, _locate_sql),
    "position": (2, 3, _locate_sql),
    "levenshtein": (2, 2, _levenshtein_sql),
    "soundex": (1, 1, _soundex_sql),
    # array surgery (round-5 batch 2); non-array input -> null
    "slice": (3, 3, _slice_sql),
    "flatten": (1, 1, _flatten_sql),
    "sequence": (2, 3, _sequence_sql),
    "arrays_zip": (1, None, _arrays_zip_sql),
    "array_union": (2, 2, _array_union_sql),
    "array_intersect": (2, 2, _array_intersect_sql),
    "array_except": (2, 2, _array_except_sql),
    "array_position": (2, 2, _array_position_sql),
    "array_remove": (2, 2, _array_remove_sql),
    "array_repeat": (2, 2, _array_repeat_sql),
    "array_join": (2, 3, _array_join_sql),
    # map constructors / surgery; null VALUES are data, null KEYS null
    # the map (Spark errors; null keeps this dialect's non-ANSI posture)
    "map": (2, None, _create_map_sql),
    "create_map": (2, None, _create_map_sql),
    "map_from_arrays": (2, 2, _map_from_arrays_sql),
    "map_concat": (1, None, _map_concat_sql),
    "map_entries": (1, 1, lambda d: (
        [{"key": k, "value": v} for k, v in d.items()]
        if isinstance(d, dict) else None
    )),
    "map_contains_key": (2, 2, lambda d, k: (
        k in d if isinstance(d, dict) else None
    )),
    # date_trunc(unit, ts) — TIMESTAMP-level floor; note the argument
    # order is reversed vs trunc(date, unit) (Spark keeps both)
    "date_trunc": (2, 2, lambda unit, v: _date_trunc_sql(unit, v)),
    # round-5 batch 5: string/misc scalars
    "format_number": (2, 2, _format_number_sql),
    "substring_index": (3, 3, _substring_index_sql),
    "overlay": (3, 4, _overlay_sql),
    "left": (2, 2, lambda s, n: str(s)[:int(n)] if int(n) > 0 else ""),
    "right": (2, 2, lambda s, n: str(s)[-int(n):] if int(n) > 0 else ""),
    "bit_length": (1, 1, lambda v: len(_as_bytes(v)) * 8),
    "octet_length": (1, 1, lambda v: len(_as_bytes(v))),
    "char_length": (1, 1, lambda v: len(str(v))),
    "character_length": (1, 1, lambda v: len(str(v))),
    "ascii": (1, 1, lambda s: ord(str(s)[0]) if str(s) else 0),
    "chr": (1, 1, lambda n: "" if int(n) < 0 else chr(int(n) % 256)),
    "char": (1, 1, lambda n: "" if int(n) < 0 else chr(int(n) % 256)),
    "btrim": (1, 2, lambda s, ch=None: (
        str(s).strip() if ch is None else str(s).strip(str(ch))
    )),
    "elt": (2, None, _elt_sql),
    "find_in_set": (2, 2, _find_in_set_sql),
    "make_date": (3, 3, _make_date_sql),
    # boolean string tests (also usable BARE in WHERE via _BOOLEAN_FNS)
    "startswith": (2, 2, lambda s, p: str(s).startswith(str(p))),
    "endswith": (2, 2, lambda s, p: str(s).endswith(str(p))),
    "contains": (2, 2, lambda s, p: str(p) in str(s)),
    # try_* arithmetic: null instead of any error (Spark's try family)
    "try_add": (2, 2, lambda a, b: _try_arith("+", a, b)),
    "try_subtract": (2, 2, lambda a, b: _try_arith("-", a, b)),
    "try_multiply": (2, 2, lambda a, b: _try_arith("*", a, b)),
    "try_divide": (2, 2, lambda a, b: _try_arith("/", a, b)),
    # null plumbing beyond coalesce/ifnull/nvl. nullif = CASE WHEN
    # a = b THEN NULL ELSE a: a null b makes the comparison UNKNOWN,
    # so a passes through (null-TOLERANT, not null-propagating)
    "nullif": (2, 2, lambda a, b: (
        None if (a is not None and b is not None and a == b) else a
    )),
    # 64-bit bitwise scalars (Column.bitwiseAND/OR/XOR compile here)
    "bitand": (2, 2, lambda a, b: _wrap_i64(int(a) & int(b))),
    "bitor": (2, 2, lambda a, b: _wrap_i64(int(a) | int(b))),
    "bitxor": (2, 2, lambda a, b: _wrap_i64(int(a) ^ int(b))),
    "bit_count": (1, 1, lambda a: bin(int(a) & _I64_MASK).count("1")),
    "getbit": (2, 2, lambda a, i: ((int(a) & _I64_MASK) >> (int(i) & 63)) & 1),
    # nvl2(a, b, c): b when a is NOT null else c — a's null is the
    # whole point, so the fn is null-TOLERANT
    "nvl2": (3, 3, lambda a, b, c: b if a is not None else c),
    # time-window bucketing (tumbling); {'start','end'} struct cells
    "window": (2, 4, _window_sql),
    # timestamp arithmetic (Spark timestampadd/timestampdiff; the
    # 2-arg dateadd/datediff spellings remain day-based aliases above)
    "timestampadd": (3, 3, _timestampadd_sql),
    "timestampdiff": (3, 3, _timestampdiff_sql),
    "make_timestamp": (6, 6, _make_timestamp_sql),
    "date_part": (2, 2, _date_part_fn_sql),
    "datepart": (2, 2, _date_part_fn_sql),
    # Spark 3.4/3.5 batch: regex functions
    "regexp_count": (2, 2, lambda s, p: len(re.findall(p, str(s)))),
    "regexp_instr": (2, 2, lambda s, p: (
        (lambda m: m.start() + 1 if m else 0)(re.search(p, str(s)))
    )),
    "regexp_like": (2, 2, lambda s, p: re.search(p, str(s)) is not None),
    "regexp": (2, 2, lambda s, p: re.search(p, str(s)) is not None),
    "regexp_substr": (2, 2, lambda s, p: (
        (lambda m: m.group(0) if m else None)(re.search(p, str(s)))
    )),
    "split_part": (3, 3, _split_part_sql),
    # number <-> text formats (approximate Spark to_char/to_number)
    "to_char": (2, 2, _to_char_sql),
    "to_varchar": (2, 2, _to_char_sql),
    "to_number": (1, 2, _to_number_sql),
    "try_to_number": (1, 2, _to_number_sql),
    # array editing
    "array_append": (2, 2, lambda a, v: (
        list(a) + [v] if _is_arr(a) else None
    )),
    "array_prepend": (2, 2, lambda a, v: (
        [v] + list(a) if _is_arr(a) else None
    )),
    "array_insert": (3, 3, _array_insert_sql),
    "array_compact": (1, 1, lambda a: (
        [x for x in a if x is not None] if _is_arr(a) else None
    )),
    "array_size": (1, 1, lambda a: len(a) if _is_arr(a) else None),
    "map_from_entries": (1, 1, _map_from_entries_sql),
    # URL codecs
    "url_encode": (1, 1, lambda s: _urlparse.quote_plus(str(s))),
    "url_decode": (1, 1, lambda s: _urlparse.unquote_plus(str(s))),
    # misc numerics / trig complements
    "ln": (1, 1, lambda a: math.log(a) if a > 0 else None),
    "negative": (1, 1, lambda a: -a),
    "positive": (1, 1, lambda a: a),
    # zero denominators yield Infinity (Java double division), never
    # a ZeroDivisionError partition crash
    "sec": (1, 1, lambda a: (
        1.0 / math.cos(a) if math.cos(a) != 0 else float("inf")
    )),
    "csc": (1, 1, lambda a: (
        1.0 / math.sin(a) if math.sin(a) != 0 else float("inf")
    )),
    "cot": (1, 1, lambda a: (
        math.cos(a) / math.sin(a) if math.sin(a) != 0 else float("inf")
    )),
    "e": (0, 0, lambda: math.e),
    "pi": (0, 0, lambda: math.pi),
    "typeof": (1, 1, None),  # dedicated branch: typeof(NULL) = 'void'
    # date/epoch complements
    "weekday": (1, 1, lambda v: _date_part_sql(v, "weekday")),
    "unix_date": (1, 1, lambda v: (
        (lambda d: (d - _EPOCH_DATE).days if d is not None else None)(
            _coerce_date(v)
        )
    )),
    "date_from_unix_date": (1, 1, lambda n: (
        _EPOCH_DATE + _dtm.timedelta(days=int(n))
    )),
    "unix_seconds": (1, 1, lambda v: (
        (lambda t: int(t.timestamp()) if t is not None else None)(
            _to_timestamp_sql(v)
        )
    )),
    # environment probes
    "current_timezone": (0, 0, lambda: _time.tzname[0]),
    "current_user": (0, 0, getpass.getuser),
    "user": (0, 0, getpass.getuser),
    "version": (0, 0, lambda: __import__("sparkdl_tpu_torch").__version__),
    # null-safe equality as a function (the <=> operator's fn form);
    # null-TOLERANT: nulls are the point; array cells compare by
    # content (bool(a == b) on an ndarray is ambiguous)
    "equal_null": (2, 2, lambda a, b: (
        (a is None and b is None)
        or (a is not None and b is not None and _cells_equal(a, b))
    )),
}
_EPOCH_DATE = _dtm.date(1970, 1, 1)


def _cells_equal(a, b) -> bool:
    if isinstance(a, _np.ndarray) or isinstance(b, _np.ndarray):
        return bool(_np.array_equal(a, b))
    return bool(a == b)
# higher-order builtins taking lambda arguments (name -> (min, max)
# argument count); parsed via lambda_or_expr, evaluated in _eval_hof
_HIGHER_ORDER_FNS: Dict[str, Tuple[int, int]] = {
    "transform": (2, 2),
    "filter": (2, 2),
    "exists": (2, 2),
    "forall": (2, 2),
    "aggregate": (3, 4),
    "reduce": (3, 4),  # Spark 3.4 alias of aggregate
    "zip_with": (3, 3),
    "map_filter": (2, 2),
    "transform_keys": (2, 2),
    "transform_values": (2, 2),
    "map_zip_with": (3, 3),
}
# array-consuming builtins: tensor-column rows arrive as numpy arrays
# (the featurizer's own output type!) and must behave as list cells —
# normalized to lists at the eval boundary, not per-lambda
_ARRAY_INPUT_FNS = {
    "size", "get", "element_at", "try_element_at", "array_contains",
    "sort_array", "array_distinct", "array_max", "array_min", "slice",
    "flatten", "arrays_zip", "array_union", "array_intersect",
    "array_except", "array_position", "array_remove", "array_join",
    "array_append", "array_prepend", "array_insert", "array_compact",
    "array_size", "map_from_entries", "map_from_arrays",
}
# boolean-valued builtins usable BARE in condition position
# (WHERE exists(a, x -> ...), df.filter(F.array_contains(...)))
_BOOLEAN_FNS = {
    "isnan", "array_contains", "map_contains_key", "exists", "forall",
    "startswith", "endswith", "contains", "regexp_like", "regexp",
    "equal_null",
}
# null-consuming builtins: evaluated with short-circuit, not null-propagation
_NULL_SAFE_FNS = {"coalesce", "ifnull", "nvl"}
# builtins whose null ARGUMENTS are legitimate data (struct fields stay
# null inside the struct; a hash of nulls is still a hash — Spark).
# with_field's VALUE may be null (the struct-null case is handled in
# the lambda); nanvl passes NaN logic its own way but null args null
# centrally, so it is NOT here. map/create_map/map_from_arrays carry
# null VALUES as data (the lambdas null on null KEYS themselves);
# array_repeat's repeated value may be null.
_NULL_TOLERANT_FNS = {
    "named_struct", "hash", "with_field",
    "map", "create_map", "map_from_arrays", "array_repeat", "nvl2",
    "nullif", "equal_null",
}
# variadic comparisons that SKIP nulls (null only when all args null)
_NULL_SKIP_FNS = {"greatest", "least"}

# EXTRACT(FIELD FROM expr) -> the equivalent date-part builtin
_EXTRACT_FIELDS = {
    "year": "year", "yearofweek": "year", "quarter": "quarter",
    "month": "month", "mon": "month", "week": "weekofyear",
    "day": "dayofmonth", "dd": "dayofmonth",
    "dayofweek": "dayofweek", "dow": "dayofweek",
    "doy": "dayofyear", "hour": "hour", "minute": "minute",
    "second": "second",
}
