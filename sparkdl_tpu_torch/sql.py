"""SQL over registered DataFrames: model UDFs inside the row-expression
dialect of the JAX package's ``sql.py``.

Port of the JAX package's ``sql.py`` (upstream: ``registerKerasImageUDF(
"my_udf", model)``, then ``spark.sql("SELECT my_udf(image) FROM
images")``), its row-expression half. The semantics are the JAX
package's; the grammar is:

    SELECT item, ... FROM table [[AS] alias] [WHERE pred]
        [ORDER BY key [ASC|DESC] [NULLS FIRST|LAST], ...] [LIMIT n]
    item := * | alias.* | expr [[AS] alias]
    key  := column | select-item ordinal | expr
    expr := column | `quoted column` | literal (number, 'string', NULL,
            TRUE/FALSE) | fn(expr, ...) | CAST(expr AS type)
          | TRY_CAST(expr AS type) | EXTRACT(field FROM expr)
          | expr (+ - * / %) expr | expr || expr | - expr | (expr)
          | CASE WHEN pred THEN expr ... [ELSE expr] END
          | CASE expr WHEN expr THEN expr ... [ELSE expr] END
          | hof(expr, x -> body | (x, y) -> body, ...)
    pred := expr (= != <> < <= > >= <=>) expr | expr IS [NOT] NULL
          | expr IS [NOT] DISTINCT FROM expr
          | expr [NOT] IN (expr, ...) | expr [NOT] BETWEEN expr AND expr
          | expr [NOT] LIKE|ILIKE|RLIKE|REGEXP 'pattern'
          | boolean builtin | pred AND|OR pred | NOT pred | (pred)

``fn`` is a row builtin (``sql_builtins._BUILTIN_FNS``: strings, math and
trigonometry, codecs and digests, dates, arrays, maps, JSON; the
null-consuming ``coalesce``/``ifnull``/``nvl`` and the null-skipping
``greatest``/``least``), a higher-order builtin over lambdas
(``transform``, ``filter``, ``exists``, ``forall``, ``aggregate``, ...),
or a UDF of the process-global catalog (``sparkdl_tpu_torch.udf``), which
takes one argument. Builtins evaluate row by row on the host; a UDF call
anywhere in an expression (inside CASE, COALESCE, arithmetic or WHERE)
is materialized first, a partition at a time through the catalog, and
the rest of the tree then evaluates over its column. Lambda bodies are
builtin-only. NULL and NaN follow Spark's semantics exactly as the JAX
package has them: comparisons with NULL are unknown and WHERE keeps only
true rows, arithmetic over NULL is NULL, ``x / 0`` and ``x % 0`` are
NULL, ``%`` takes the dividend's sign, CAST is non-ANSI (null when
unconvertible).

The relational half of the JAX dialect (joins, GROUP BY and aggregates,
windows, WITH, set operations, DISTINCT, subqueries, FROM-less SELECT,
derived tables, OFFSET, LATERAL VIEW and the generators) raises
:class:`UnsupportedSQL`, a ValueError naming the construct and ROADMAP
Queue A item 8, where it waits.

The optimizer arm (``SPARKDL_SQL_VECTORIZE``, default on): the scan is
pruned to the columns the query reads, lambda bodies and CASE branches
included (``sql.pushdown.pruned_cols``); WHERE's top-level conjuncts
without a UDF call filter first, over only the columns they read
(``sql.pushdown.skipped_rows``), so no UDF scores a row they drop; model
UDFs dispatch batched through the shared feeder (``sql.udf.batches``,
``sql.udf.batch_rows``); without ORDER BY, LIMIT applies before the
projection, so no UDF scores a row the limit drops. 0/off is the
row-path planner, the A/B arm. No predicate skips rows on file
statistics: the port's scans keep none.
"""

from __future__ import annotations

import functools
import math
import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as _np

from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.sql_builtins import (
    _ARRAY_INPUT_FNS,
    _BOOLEAN_FNS,
    _BUILTIN_FNS,
    _CAST_TYPES,
    _EXTRACT_FIELDS,
    _HIGHER_ORDER_FNS,
    _NULL_SAFE_FNS,
    _NULL_SKIP_FNS,
    _NULL_TOLERANT_FNS,
    _is_arr,
    _typeof_sql,
)
from sparkdl_tpu_torch.utils.metrics import metrics

__all__ = [
    "SQLContext", "UnsupportedSQL", "registerDataFrameAsTable",
    "dropTempTable", "sql",
]

_ITEM8 = "ROADMAP Queue A item 8"


class UnsupportedSQL(ValueError):
    """A construct of the JAX package's dialect that the port lacks."""

    def __init__(self, construct: str):
        super().__init__(
            f"{construct}: not in the port's SQL dialect (SELECT over one "
            f"table with row expressions, UDFs, WHERE, ORDER BY and "
            f"LIMIT); it waits for {_ITEM8}"
        )


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<comment>--[^\n]*|/\*(?s:.*?)\*/)
      | (?P<num>\d+\.\d+|\d+)
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<qident>`[^`]+`)
      | (?P<arrow>->)
      | (?P<op><=>|<=|>=|!=|<>|=|<|>)
      | (?P<concat>\|\|)
      | (?P<arith>[+\-/%])
      | (?P<punct>[(),*])
      | (?P<ident>[A-Za-z_][A-Za-z_0-9.]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "limit", "as", "is", "not", "null",
    "and", "or", "order", "by", "asc", "desc", "group", "having",
    "distinct", "in", "between", "like",
    "join", "on", "inner", "left", "right", "full", "outer",
    "case", "when", "then", "else", "end",
    "union", "all", "except", "intersect", "minus",
    "over", "partition",
    "rows", "range", "unbounded", "preceding", "following", "current",
    "row", "exists", "with",
}

# the relational half's function names: refused where they are called
_AGGREGATES = {
    "count", "sum", "avg", "min", "max", "stddev", "variance",
    "collect_list", "collect_set", "first", "last", "median",
    "stddev_pop", "stddev_samp", "var_pop", "var_samp", "skewness",
    "kurtosis", "sum_distinct", "approx_count_distinct", "percentile",
    "percentile_approx", "corr", "covar_pop", "covar_samp", "bool_and",
    "bool_or", "every", "any_value", "mode", "count_if",
}
_WINDOW_FNS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "first_value", "last_value", "nth_value", "lag", "lead", "ntile",
}
_GENERATOR_FNS = {
    "explode", "explode_outer", "posexplode", "posexplode_outer",
    "stack", "json_tuple", "inline", "inline_outer",
}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise ValueError(
                    f"SQL syntax error near: {text[pos:pos + 20]!r}"
                )
            break
        pos = m.end()
        kind = m.lastgroup
        val = m.group(kind)
        if kind == "arith" and val == "/" and text[pos:pos + 1] == "*":
            # a `/*` that the comment alternative did NOT swallow has no
            # closing `*/` — without this check it silently tokenizes
            # as divide-then-star and fails parsing somewhere far away
            raise ValueError(
                "unterminated block comment: '/*' without a closing "
                f"'*/' near: {text[m.start(kind):m.start(kind) + 20]!r}"
            )
        if kind == "comment":
            # `-- ...` line and `/* ... */` block comments are dropped,
            # which also swallows optimizer hints (/*+ BROADCAST(t) */)
            # — this engine has no optimizer to hint, and Spark treats
            # unknown hints as no-ops too
            continue
        if kind == "qident":
            # backtick-quoted identifier (Spark's escape for columns
            # named like keywords: SELECT `end` FROM t). Quoted
            # true/false keep a distinct kind so the contextual
            # boolean-literal rule cannot capture them — `true` is the
            # COLUMN, bare true is the literal.
            name = val[1:-1]
            if name.lower() in ("true", "false"):
                out.append(("bident", name))
            else:
                out.append(("ident", name))
        elif kind == "ident" and val.lower() in _KEYWORDS:
            out.append(("kw", val.lower()))
        else:
            out.append((kind, val))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


@dataclass
class Call:
    fn: str
    arg: "Expr"  # first argument (None for a zero-argument builtin)
    distinct: bool = False  # the JAX node's aggregate flag, always False here
    args: Optional[List["Expr"]] = None  # full list (builtins take >1)

    def all_args(self) -> List["Expr"]:
        return self.args if self.args is not None else [self.arg]


@dataclass
class Col:
    name: str


class SortDir:
    """Direction + explicit nulls placement for one ORDER BY key
    (``ORDER BY x DESC NULLS FIRST`` / ``Column.asc_nulls_last()``).
    Truthiness equals "ascending", so every ``(key, asc)`` consumer
    that only cares about direction keeps working unchanged; the frame's sort loop
    reads ``nulls_first`` to place nulls. ``nulls_first=None`` means
    Spark's default (first when ascending, last when descending)."""

    __slots__ = ("asc", "nulls_first")

    def __init__(self, asc: bool, nulls_first=None):
        self.asc = bool(asc)
        self.nulls_first = nulls_first

    def __bool__(self) -> bool:
        return self.asc

    def __repr__(self) -> str:
        tail = (
            ""
            if self.nulls_first is None
            else f", nulls_first={self.nulls_first}"
        )
        return f"SortDir({self.asc}{tail})"


@dataclass
class Lambda:
    """Lambda argument of a higher-order builtin — ``x -> x * 2`` /
    ``(x, i) -> ...`` (Spark's HOF syntax; F.transform builds the same
    node from a Python lambda over Columns). The body is a value
    expression OR a predicate tree; parameters shadow frame columns at
    evaluation (Spark scoping). Alias qualification deliberately does
    not descend into bodies: lambda bodies reference columns by bare name
    and builtins only."""

    params: List[str]
    body: Any  # Expr | Predicate | BoolOp | NotOp


@dataclass
class Lit:
    """Literal appearing in expression position (SELECT price * 2)."""

    value: Any


@dataclass
class Arith:
    """Arithmetic over expressions: + - * / % and unary 'neg'.

    Null semantics follow Spark: any null operand -> null result, and
    division/modulo by zero -> null (not an error)."""

    op: str
    left: "Expr"
    right: Optional["Expr"] = None


@dataclass
class Case:
    """Searched CASE: WHEN <pred> THEN <expr> ... [ELSE <expr>] END.
    First true branch wins; no ELSE -> null (Spark semantics)."""

    branches: List[Tuple[Any, "Expr"]]  # (Predicate|BoolOp, Expr)
    default: Optional["Expr"] = None


Expr = Any  # Col | Call | Lit | Arith | Case


@dataclass
class QualifiedStar:
    """``SELECT t.*``, resolved against the FROM table's alias (or its
    name) at planning."""

    qualifier: str


@dataclass
class SelectItem:
    expr: Expr  # or "*" or QualifiedStar
    alias: Optional[str]


@dataclass
class Predicate:
    col: Any  # column name | Expr
    op: str  # comparison op, 'isnull', 'notnull'
    value: Any = None


@dataclass
class BoolOp:
    """AND/OR over sub-predicates (Predicate | BoolOp)."""

    op: str  # 'and' | 'or'
    parts: List[Any]


class DynItems(list):
    """An IN-list carrying expression elements (Column API's
    isin(F.col("a"), 2)); marks the per-row evaluation path so plain
    literal lists keep O(1) dispatch."""


@dataclass
class NotOp:
    """Logical NOT over a predicate tree: the Column API's ~cond, and
    the SQL grammar's IS DISTINCT FROM (NOT over <=>; its other NOTs
    stay fused into NOT IN/BETWEEN/LIKE ops). Three-valued: NOT over
    NULL stays NULL, so ~(x > 3) drops null x rows under filter, like
    Spark."""

    part: Any  # Predicate | BoolOp | NotOp


@dataclass
class Query:
    items: List[SelectItem]
    table: str
    table_alias: Optional[str]
    where: Optional[Any]  # Predicate | BoolOp | NotOp
    order: List[Tuple[Any, Any]]  # (column name | ordinal Lit | Expr, bool | SortDir)
    limit: Optional[int]


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        k, v = self.toks[self.i]
        # backtick-quoted true/false are ordinary idents to the whole
        # grammar; only the boolean-literal rule tells them apart
        return ("ident", v) if k == "bident" else (k, v)

    def _raw_quoted(self) -> bool:
        return self.toks[self.i][0] == "bident"

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind, val=None):
        k, v = self.next()
        if k != kind or (val is not None and v.lower() != val):
            raise ValueError(f"Expected {val or kind}, got {v!r}")
        return v

    def _at_ident_pair(self, first: str, second) -> bool:
        k, v = self.peek()
        return k == "ident" and v.lower() == first and (
            self.toks[self.i + 1] == second
            if isinstance(second, tuple)
            else self.toks[self.i + 1][0] == "ident"
            and self.toks[self.i + 1][1].lower() == second
        )

    def _at_offset_clause(self) -> bool:
        k, v = self.peek()
        return k == "ident" and v.lower() == "offset" and self.toks[self.i + 1][0] == "num"

    # -- the query: one table, the relational clauses refused ---------------

    def parse(self) -> Query:
        if self.peek() == ("kw", "with"):
            raise UnsupportedSQL("WITH (common table expressions)")
        q = self.query()
        k, v = self.peek()
        if k == "kw" and v in ("union", "except", "intersect", "minus"):
            raise UnsupportedSQL(f"{v.upper()} (set operations)")
        if k != "eof":
            raise ValueError(f"Unexpected trailing token {v!r}")
        return q

    def query(self) -> Query:
        self.expect("kw", "select")
        if self.peek() == ("kw", "distinct"):
            raise UnsupportedSQL("SELECT DISTINCT")
        items = [self.select_item()]
        while self.peek() == ("punct", ","):
            self.next()
            items.append(self.select_item())
        if self.peek() != ("kw", "from"):
            raise UnsupportedSQL("SELECT without FROM")
        self.next()
        if self.peek() == ("punct", "("):
            raise UnsupportedSQL("a subquery in FROM (derived tables)")
        table = self.expect("ident")
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif (
            self.peek()[0] == "ident"
            and not self._at_offset_clause()
            and not self._at_ident_pair("lateral", "view")
            and not self._at_ident_pair("cross", ("kw", "join"))
        ):
            alias = self.next()[1]
        k, v = self.peek()
        if (k, v) == ("punct", ","):
            raise UnsupportedSQL("a comma-separated FROM list (joins)")
        if (k == "kw" and v in ("join", "inner", "left", "right", "full", "outer")) or (
            self._at_ident_pair("cross", ("kw", "join"))
        ):
            raise UnsupportedSQL("JOIN")
        if self._at_ident_pair("lateral", "view"):
            raise UnsupportedSQL("LATERAL VIEW")
        where = None
        if self.peek() == ("kw", "where"):
            self.next()
            where = self.or_pred()
        if self.peek() == ("kw", "group"):
            raise UnsupportedSQL("GROUP BY")
        if self.peek() == ("kw", "having"):
            raise UnsupportedSQL("HAVING")
        order: List[Tuple[Any, Any]] = []
        if self.peek() == ("kw", "order"):
            self.next()
            self.expect("kw", "by")
            order.append(self.order_item())
            while self.peek() == ("punct", ","):
                self.next()
                order.append(self.order_item())
        limit = None
        if self.peek() == ("kw", "limit"):
            self.next()
            limit = int(self.expect("num"))
        if self._at_offset_clause():
            raise UnsupportedSQL("OFFSET")
        return Query(items, table, alias, where, order, limit)

    def order_item(self) -> Tuple[Any, Any]:
        """A column stays a name; an integer literal is a select-item
        ordinal (ORDER BY 1); anything else an expression. NULLS
        FIRST/LAST (contextual words) make the direction a SortDir."""
        e = self.add_expr()
        asc: Any = True
        if self.peek() in (("kw", "asc"), ("kw", "desc")):
            asc = self.next()[1] == "asc"
        if self.peek()[0] == "ident" and self.peek()[1].lower() == "nulls":
            save = self.i
            self.next()
            k2, v2 = self.peek()
            if k2 in ("ident", "kw") and v2.lower() in ("first", "last"):
                self.next()
                asc = SortDir(asc, nulls_first=v2.lower() == "first")
            else:
                self.i = save  # a column named nulls
        return (e.name if isinstance(e, Col) else e), asc

    def select_item(self) -> SelectItem:
        if self.peek() == ("punct", "*"):
            self.next()
            return SelectItem("*", None)
        k, v = self.peek()
        if k == "ident" and v.endswith(".") and self.toks[self.i + 1] == ("punct", "*"):
            # qualified star: SELECT t.* / SELECT a.* (FROM t AS a)
            self.next()
            self.next()
            return SelectItem(QualifiedStar(v[:-1]), None)
        expr = self.add_expr()
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif self.peek()[0] == "ident":
            alias = self.next()[1]  # bare alias: SELECT f(x) emb
        return SelectItem(expr, alias)

    # -- expressions ---------------------------------------------------------

    def lambda_or_expr(self) -> Any:
        """A higher-order builtin's argument: ``x -> body``,
        ``(x, y) -> body``, or an ordinary expression. The body is a
        value expression, or a predicate when the value parse stops
        early (``x -> x > 2``)."""
        params = None
        if self.peek()[0] == "ident" and self.toks[self.i + 1][0] == "arrow":
            params = [self.next()[1]]
            self.next()
        elif self.peek() == ("punct", "("):
            j = self.i + 1
            ps = []
            while self.toks[j][0] == "ident":
                ps.append(self.toks[j][1])
                j += 1
                if self.toks[j] == ("punct", ","):
                    j += 1
                    continue
                break
            if ps and self.toks[j] == ("punct", ")") and self.toks[j + 1][0] == "arrow":
                if len(set(ps)) != len(ps):
                    raise ValueError(f"Duplicate lambda parameter in ({', '.join(ps)})")
                self.i = j + 2
                params = ps
        if params is None:
            return self.add_expr()
        save = self.i
        body = None
        try:
            candidate = self.add_expr()
            if self.peek() in (("punct", ","), ("punct", ")")):
                body = candidate
        except UnsupportedSQL:
            raise
        except ValueError:
            pass
        if body is None:
            self.i = save  # the value parse stopped early: a predicate body
            body = self.or_pred()
        _validate_lambda_body(body)
        return Lambda(params, body)

    def add_expr(self) -> Expr:
        e = self.mul_expr()
        while (self.peek()[0] == "arith" and self.peek()[1] in "+-") or self.peek()[0] == "concat":
            kind, op = self.next()
            rhs = self.mul_expr()
            if kind == "concat":
                # || is concat(): null propagates (Spark)
                e = Call("concat", e, False, [e, rhs])
            else:
                e = Arith(op, e, rhs)
        return e

    def mul_expr(self) -> Expr:
        e = self.atom_expr()
        while self.peek() in (("punct", "*"), ("arith", "/"), ("arith", "%")):
            op = self.next()[1]
            e = Arith(op, e, self.atom_expr())
        return e

    def atom_expr(self) -> Expr:
        k, v = self.peek()
        if (k, v) == ("kw", "case"):
            return self.case_expr()
        if (k, v) == ("kw", "null"):
            self.next()
            return Lit(None)
        if (
            k == "ident"
            and v.lower() in ("true", "false")
            and not self._raw_quoted()
            and self.toks[self.i + 1] != ("punct", "(")
        ):
            # TRUE/FALSE literals; `true` in backticks is the column
            self.next()
            return Lit(v.lower() == "true")
        if (k, v) == ("arith", "-"):
            self.next()
            inner = self.atom_expr()
            if isinstance(inner, Lit) and isinstance(inner.value, (int, float)):
                return Lit(-inner.value)  # -5 is a literal
            return Arith("neg", inner)
        if k == "num":
            self.next()
            return Lit(float(v) if "." in v else int(v))
        if k == "str":
            self.next()
            return Lit(v[1:-1].replace("\\'", "'"))
        if (k, v) == ("punct", "("):
            self.next()
            if self.peek() == ("kw", "select"):
                raise UnsupportedSQL("a scalar subquery")
            e = self.add_expr()
            self.expect("punct", ")")
            return e
        return self.expr()

    def case_expr(self) -> Case:
        """CASE in both forms. The simple form (CASE x WHEN v THEN r)
        desugars to equality predicates: a null operand matches no WHEN
        (Spark)."""
        self.expect("kw", "case")
        operand = None
        if self.peek() != ("kw", "when"):
            operand = self.add_expr()
            if self.peek() != ("kw", "when"):
                raise ValueError("Expected WHEN after the CASE operand")
        branches = []
        while self.peek() == ("kw", "when"):
            self.next()
            if operand is not None:
                pred = Predicate(operand, "=", self.add_expr())
            else:
                pred = self.or_pred()
            self.expect("kw", "then")
            branches.append((pred, self.add_expr()))
        default = None
        if self.peek() == ("kw", "else"):
            self.next()
            default = self.add_expr()
        self.expect("kw", "end")
        return Case(branches, default)

    def expr(self) -> Expr:
        kind, val = self.next()
        if kind == "kw" and val in ("exists", "left", "right") and self.peek() == ("punct", "("):
            # exists(arr, x -> ...) and left(s, n)/right(s, n), told from
            # EXISTS (SELECT) and LEFT JOIN by the '('
            kind = "ident"
        if kind != "ident":
            raise ValueError(f"Expected column or function, got {val!r}")
        if self.peek() != ("punct", "("):
            return Col(val)
        self.next()
        fn = val.lower()
        if fn == "try_cast":
            # CAST is already non-ANSI (null on error): TRY_CAST is CAST
            fn = "cast"
        if fn == "cast":
            arg = self.add_expr()
            self.expect("kw", "as")
            ty = self.expect("ident").lower()
            if ty not in _CAST_TYPES:
                raise ValueError(f"Unsupported CAST type {ty!r}; supported: {sorted(_CAST_TYPES)}")
            self.expect("punct", ")")
            return Call("cast", arg, False, [arg, Lit(ty)])
        if fn == "extract":
            field = self.expect("ident").lower()
            fn_e = _EXTRACT_FIELDS.get(field)
            if fn_e is None:
                raise ValueError(
                    f"Unsupported EXTRACT field {field!r}; supported: {sorted(_EXTRACT_FIELDS)}"
                )
            self.expect("kw", "from")
            arg = self.add_expr()
            self.expect("punct", ")")
            return Call(fn_e, arg, False, [arg])
        if fn in _WINDOW_FNS:
            raise UnsupportedSQL(f"the window function {val}() (OVER)")
        if fn in _GENERATOR_FNS:
            raise UnsupportedSQL(f"the generator {val}()")
        if self.peek() == ("punct", ")"):
            self.next()
            if self.peek() == ("kw", "over"):
                raise UnsupportedSQL("window functions (OVER)")
            if fn in _BUILTIN_FNS and _BUILTIN_FNS[fn][0] == 0:
                return Call(fn, None, False, [])
            raise ValueError(f"{val}() takes at least one argument")
        if self.peek() == ("punct", "*") or fn in _AGGREGATES:
            raise UnsupportedSQL(f"the aggregate {val}()")
        if self.peek() == ("kw", "distinct"):
            raise UnsupportedSQL(f"{val}(DISTINCT ...) (aggregates)")
        if fn in _HIGHER_ORDER_FNS:
            args = [self.lambda_or_expr()]
            while self.peek() == ("punct", ","):
                self.next()
                args.append(self.lambda_or_expr())
            self.expect("punct", ")")
            lo, hi = _HIGHER_ORDER_FNS[fn]
            if not lo <= len(args) <= hi:
                raise ValueError(
                    f"{val.upper()} takes {lo if hi == lo else f'{lo}..{hi}'} "
                    f"argument(s), got {len(args)}"
                )
            if not any(isinstance(a, Lambda) for a in args):
                raise ValueError(f"{val.upper()} requires a lambda argument (x -> ...)")
            if isinstance(args[0], Lambda):
                raise ValueError(f"{val.upper()}'s first argument is the collection, not the lambda")
            return Call(fn, args[0], False, args)
        args = [self.add_expr()]
        while self.peek() == ("punct", ","):
            self.next()
            args.append(self.add_expr())
        self.expect("punct", ")")
        if fn in ("timestampadd", "timestampdiff") and isinstance(args[0], Col) and "." not in args[0].name:
            # the unit is a bare keyword in Spark's grammar
            # (timestampadd(HOUR, 3, ts)): it parsed as a column
            args[0] = Lit(args[0].name)
        if fn in _BUILTIN_FNS:
            lo, hi, _ = _BUILTIN_FNS[fn]
            if len(args) < lo or (hi is not None and len(args) > hi):
                raise ValueError(
                    f"{val.upper()} takes {lo if hi == lo else f'{lo}..{hi or chr(8734)}'} "
                    f"argument(s), got {len(args)}"
                )
        elif fn in _NULL_SAFE_FNS:
            if fn == "coalesce" and len(args) < 2:
                raise ValueError("COALESCE needs at least two arguments")
            if fn in ("ifnull", "nvl") and len(args) != 2:
                raise ValueError(f"{val.upper()} takes exactly two arguments")
        elif fn in _NULL_SKIP_FNS:
            if len(args) < 2:
                raise ValueError(f"{val.upper()} needs at least two arguments")
        if self.peek() == ("kw", "over"):
            raise UnsupportedSQL("window functions (OVER)")
        return Call(val, args[0], False, args)

    # -- predicates ----------------------------------------------------------

    def or_pred(self):
        parts = [self.and_pred()]
        while self.peek() == ("kw", "or"):
            self.next()
            parts.append(self.and_pred())
        return parts[0] if len(parts) == 1 else BoolOp("or", parts)

    def and_pred(self):
        parts = [self.pred_atom()]
        while self.peek() == ("kw", "and"):
            self.next()
            parts.append(self.pred_atom())
        return parts[0] if len(parts) == 1 else BoolOp("and", parts)

    def pred_atom(self):
        if self.peek() == ("kw", "exists") or (
            self.peek() == ("kw", "not") and self.toks[self.i + 1] == ("kw", "exists")
        ):
            j = self.i + (2 if self.peek() == ("kw", "not") else 1)
            if self.toks[j] == ("punct", "(") and self.toks[j + 1] == ("kw", "select"):
                raise UnsupportedSQL("EXISTS (subqueries)")
            if self.peek() == ("kw", "exists"):
                # the higher-order builtin exists(arr, x -> ...)
                return self.predicate()
        if self.peek() == ("kw", "not"):
            # prefix NOT over any predicate atom, three-valued
            self.next()
            return NotOp(self.pred_atom())
        if self.peek() == ("punct", "("):
            # '(' opens a predicate group `(a > 1 OR b > 2)` or an
            # arithmetic operand `(v + 1) * 2 > 6`: try the group first
            # and back up when it is not one
            save = self.i
            try:
                self.next()
                inner = self.or_pred()
                self.expect("punct", ")")
                if self.peek()[0] in ("op", "arith") or self.peek() == ("punct", "*"):
                    raise ValueError("parenthesized expression")
                return inner
            except UnsupportedSQL:
                raise
            except ValueError:
                self.i = save
        return self.predicate()

    def literal(self):
        vk, vv = self.next()
        if (vk, vv) == ("arith", "-"):
            v = self.literal()
            if not isinstance(v, (int, float)):
                raise ValueError("Unary '-' needs a numeric literal")
            return -v
        if vk == "num":
            return float(vv) if "." in vv else int(vv)
        if vk == "str":
            return vv[1:-1].replace("\\'", "'")
        if (vk, vv) == ("kw", "null"):
            return None
        raise ValueError(f"Expected literal, got {vv!r}")

    def predicate(self) -> Predicate:
        lhs = self.add_expr()
        col = lhs.name if isinstance(lhs, Col) else lhs
        if (
            isinstance(lhs, Call)
            and lhs.fn.lower() in _BOOLEAN_FNS
            and self.peek()[0] != "op"
            and self.peek() not in (
                ("kw", "not"), ("kw", "is"), ("kw", "in"), ("kw", "between"), ("kw", "like"),
            )
            and not (self.peek()[0] == "ident" and self.peek()[1].lower() in ("rlike", "regexp"))
        ):
            # a boolean builtin alone as the condition: sugar for = TRUE
            return Predicate(lhs, "=", True)
        negate = False
        if self.peek() == ("kw", "not"):
            self.next()
            negate = True
        kind, val = self.next()
        if (kind, val) == ("kw", "is"):
            if negate:
                raise ValueError("Use IS NOT NULL, not NOT IS NULL")
            neg_is = False
            if self.peek() == ("kw", "not"):
                self.next()
                neg_is = True
            if self.peek() == ("kw", "distinct"):
                # IS NOT DISTINCT FROM is <=>; IS DISTINCT FROM its NOT
                self.next()
                self.expect("kw", "from")
                rhs = self.add_expr()
                if isinstance(rhs, Lit):
                    rhs = rhs.value
                eq = Predicate(col, "<=>", rhs)
                return eq if neg_is else NotOp(eq)
            self.expect("kw", "null")
            return Predicate(col, "notnull" if neg_is else "isnull")
        if (kind, val) == ("kw", "in"):
            self.expect("punct", "(")
            if self.peek() == ("kw", "select"):
                raise UnsupportedSQL("IN (SELECT ...) subqueries")
            elems = [self.add_expr()]
            while self.peek() == ("punct", ","):
                self.next()
                elems.append(self.add_expr())
            self.expect("punct", ")")
            if all(isinstance(e, Lit) for e in elems):
                items: Any = [e.value for e in elems]
            else:
                # expression elements evaluate per row
                items = DynItems(e.value if isinstance(e, Lit) else e for e in elems)
            return Predicate(col, "notin" if negate else "in", items)
        if (kind, val) == ("kw", "between"):
            lo = self.add_expr()
            self.expect("kw", "and")
            hi = self.add_expr()
            if isinstance(lo, Lit):
                lo = lo.value
            if isinstance(hi, Lit):
                hi = hi.value
            return Predicate(col, "notbetween" if negate else "between", (lo, hi))
        if (kind, val) == ("kw", "like"):
            if self.peek()[0] != "str":
                raise ValueError("LIKE needs a string pattern")
            return Predicate(col, "notlike" if negate else "like", self.literal())
        if kind == "ident" and val.lower() == "ilike":
            if self.peek()[0] != "str":
                raise ValueError("ILIKE needs a string pattern")
            return Predicate(col, "notilike" if negate else "ilike", self.literal())
        if kind == "ident" and val.lower() in ("rlike", "regexp"):
            if self.peek()[0] != "str":
                raise ValueError("RLIKE needs a string pattern")
            pat = self.literal()
            _compile_rlike(pat)  # an invalid regex fails at parse time
            return Predicate(col, "notrlike" if negate else "rlike", pat)
        if negate:
            raise ValueError("NOT is only supported as NOT IN / NOT BETWEEN / NOT LIKE / NOT RLIKE")
        if kind != "op":
            raise ValueError(f"Expected comparison after {col!r}")
        rhs = self.add_expr()
        if isinstance(rhs, Lit):
            rhs = rhs.value
        return Predicate(col, "<>" if val == "!=" else val, rhs)


# ---------------------------------------------------------------------------
# Row evaluation
# ---------------------------------------------------------------------------

_OPS = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


@functools.lru_cache(maxsize=256)
def _like_regex(pattern: str):
    """SQL LIKE pattern -> compiled regex (% = any run, _ = any one
    char; backslash escapes). Cached: the translation is per-predicate
    constant but evaluation is per-row."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out), re.S)


@functools.lru_cache(maxsize=256)
def _ilike_regex(pattern: str):
    return re.compile(_like_regex(pattern).pattern, re.S | re.I)


def _like_match(v, pattern: str, ignorecase: bool = False) -> bool:
    rx = _ilike_regex(pattern) if ignorecase else _like_regex(pattern)
    return rx.fullmatch(str(v)) is not None


@functools.lru_cache(maxsize=256)
def _compile_rlike(pattern: str):
    """One compile per RLIKE pattern (and an EARLY error at predicate
    construction, not a retried partition task)."""
    try:
        return re.compile(pattern)
    except re.error as e:
        raise ValueError(f"Invalid RLIKE pattern {pattern!r}: {e}") from e


def _eval_expr_row(e: Expr, row):
    """Row-at-a-time expression evaluation: columns, literals,
    arithmetic, CASE, builtins and higher-order calls (catalog-UDF calls
    are materialized to columns before this runs). Spark null
    semantics: null operand -> null, x/0 and x%0 -> null."""
    if isinstance(e, Col):
        return row[e.name]
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, Arith):
        a = _eval_expr_row(e.left, row)
        if e.op == "neg":
            return None if a is None else -a
        b = _eval_expr_row(e.right, row)
        if a is None or b is None:
            return None
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            return None if b == 0 else a / b
        if e.op == "%":
            if b == 0:
                return None
            # Spark/Java %: remainder takes the DIVIDEND's sign
            # (-7 % 3 = -1), unlike Python's floor-mod (= 2)
            r = math.fmod(a, b)
            return int(r) if isinstance(a, int) and isinstance(b, int) else r
    if isinstance(e, Case):
        for pred, ex in e.branches:
            if _eval_pred(pred, row):
                return _eval_expr_row(ex, row)
        return (
            None if e.default is None else _eval_expr_row(e.default, row)
        )
    if isinstance(e, Call) and e.fn.lower() in _HIGHER_ORDER_FNS:
        return _eval_hof(e, row)
    if _is_builtin_call(e):
        fn = e.fn.lower()
        if fn == "array":
            # array(a, b, NULL): nulls stay ELEMENTS (Spark), so the
            # default any-null-arg propagation must not apply
            return [_eval_expr_row(a, row) for a in e.all_args()]
        if fn == "typeof":
            # typeof(NULL) = 'void', not null — ahead of propagation
            return _typeof_sql(_eval_expr_row(e.all_args()[0], row))
        if fn == "isnan":
            # Spark isnan(NULL) is FALSE, not null — hence the
            # dedicated branch ahead of null propagation. bool() so a
            # numpy-backed cell cannot yield np.True_, which would fail
            # filter's `is True` check
            v0 = _eval_expr_row(e.all_args()[0], row)
            return bool(
                isinstance(v0, (float, _np.floating)) and v0 != v0
            )
        if fn == "concat_ws":
            # null separator -> null; null args SKIPPED (Spark); list
            # args flatten into the joined pieces
            vals = [_eval_expr_row(a, row) for a in e.all_args()]
            sep = vals[0]
            if sep is None:
                return None
            pieces: List[str] = []
            for x in vals[1:]:
                if x is None:
                    continue
                if isinstance(x, _np.ndarray):
                    x = x.tolist()  # tensor-block rows are list cells
                if isinstance(x, (list, tuple)):
                    pieces.extend(str(p) for p in x if p is not None)
                else:
                    pieces.append(str(x))
            return str(sep).join(pieces)
        if fn in _NULL_SAFE_FNS:  # coalesce/ifnull: first non-null wins
            for a in e.all_args():
                v = _eval_expr_row(a, row)
                if v is not None:
                    return v
            return None
        if fn in _NULL_SKIP_FNS:  # greatest/least skip nulls (Spark)
            vals = [
                v
                for v in (_eval_expr_row(a, row) for a in e.all_args())
                if v is not None
            ]
            if not vals:
                return None
            return max(vals) if fn == "greatest" else min(vals)
        vals = [_eval_expr_row(a, row) for a in e.all_args()]
        if fn in _ARRAY_INPUT_FNS:
            # tensor-block rows (ndarray cells) behave as list cells
            vals = [
                v.tolist() if isinstance(v, _np.ndarray) else v
                for v in vals
            ]
        if fn in _NULL_TOLERANT_FNS:
            # null VALUES are data here (struct fields / hash inputs),
            # not poison
            return _BUILTIN_FNS[fn][2](*vals)
        if any(v is None for v in vals):
            return None  # Spark null propagation
        return _BUILTIN_FNS[fn][2](*vals)
    raise TypeError(f"Cannot evaluate expression node {e!r}")


def _rebuild_call(e: "Call", new_args) -> "Call":
    """Reconstruct a Call with rewritten args, PRESERVING call-level
    metadata (_params of percentile/percentile_approx) that planner
    rewriters would otherwise silently drop."""
    out = Call(e.fn, new_args[0], e.distinct, new_args)
    p = getattr(e, "_params", None)
    if p is not None:
        out._params = p
    return out


def _is_builtin_call(e: Expr) -> bool:
    return isinstance(e, Call) and (
        e.fn.lower() in _BUILTIN_FNS
        or e.fn.lower() in _NULL_SAFE_FNS
        or e.fn.lower() in _NULL_SKIP_FNS
        or e.fn.lower() in _HIGHER_ORDER_FNS
    )


def _lambda_free_cols(e, bound: frozenset) -> set:
    """Free column names of an expression/predicate tree — lambda
    parameters bind inward (nested lambdas extend the bound set)."""
    out: set = set()
    if isinstance(e, Col):
        if e.name not in bound:
            out.add(e.name)
    elif isinstance(e, Lambda):
        out |= _lambda_free_cols(e.body, bound | frozenset(e.params))
    elif isinstance(e, Arith):
        out |= _lambda_free_cols(e.left, bound)
        if e.right is not None:
            out |= _lambda_free_cols(e.right, bound)
    elif isinstance(e, Case):
        for p, x in e.branches:
            out |= _lambda_free_cols(p, bound)
            out |= _lambda_free_cols(x, bound)
        if e.default is not None:
            out |= _lambda_free_cols(e.default, bound)
    elif isinstance(e, NotOp):
        out |= _lambda_free_cols(e.part, bound)
    elif isinstance(e, BoolOp):
        for p in e.parts:
            out |= _lambda_free_cols(p, bound)
    elif isinstance(e, Predicate):
        if isinstance(e.col, str):
            if e.col not in bound:
                out.add(e.col)
        elif e.col is not None:
            out |= _lambda_free_cols(e.col, bound)
        for v in _pred_value_exprs(e.value):
            out |= _lambda_free_cols(v, bound)
    elif isinstance(e, Call) and e.arg != "*":
        for a in e.all_args():
            out |= _lambda_free_cols(a, bound)
    return out


def _validate_lambda_body(body) -> None:
    """Parse/plan-time enforcement of the documented builtin-only
    lambda-body restriction: catalog UDFs must fail HERE with a named
    error, not as an opaque partition-task crash at execution."""
    if isinstance(body, Lambda):
        _validate_lambda_body(body.body)
        return
    if isinstance(body, Call):
        if not _is_builtin_call(body):
            raise ValueError(
                f"Lambda bodies are builtin-only; {body.fn!r} is not a "
                "builtin (catalog UDFs cannot run per-element — compute "
                "the UDF column with withColumn first, then transform "
                "the result)"
            )
        if body.arg != "*":
            for a in body.all_args():
                _validate_lambda_body(a)
        return
    if isinstance(body, Arith):
        _validate_lambda_body(body.left)
        if body.right is not None:
            _validate_lambda_body(body.right)
        return
    if isinstance(body, Case):
        for p, x in body.branches:
            _validate_lambda_body(p)
            _validate_lambda_body(x)
        if body.default is not None:
            _validate_lambda_body(body.default)
        return
    if isinstance(body, NotOp):
        _validate_lambda_body(body.part)
        return
    if isinstance(body, BoolOp):
        for p in body.parts:
            _validate_lambda_body(p)
        return
    if isinstance(body, Predicate):
        if body.col is not None and not isinstance(body.col, str):
            _validate_lambda_body(body.col)
        for v in _pred_value_exprs(body.value):
            _validate_lambda_body(v)
        return


class _LambdaScope:
    """Row view with lambda parameters bound on top — parameters
    SHADOW frame columns (Spark scoping); everything else falls
    through to the underlying row."""

    __slots__ = ("_row", "_binds")

    def __init__(self, row, binds):
        self._row = row
        self._binds = binds

    def __getitem__(self, key):
        b = self._binds
        return b[key] if key in b else self._row[key]


def _eval_lambda(lam: Lambda, row, *vals):
    scope = _LambdaScope(row, dict(zip(lam.params, vals)))
    if isinstance(lam.body, (Predicate, BoolOp, NotOp)):
        return _eval_pred3(lam.body, scope)  # three-valued, like WHERE
    return _eval_expr_row(lam.body, scope)


def _eval_bool_lambda(lam: Lambda, row, *vals) -> Optional[bool]:
    """Lambda as a condition: three-valued (None = unknown), non-bool
    value bodies coerce by truthiness."""
    b = _eval_lambda(lam, row, *vals)
    return None if b is None else bool(b)


def _hof_collection(a, row, fn: str):
    if isinstance(a, Lambda):
        raise ValueError(
            f"{fn}()'s lambda belongs after the collection argument"
        )
    out = _eval_expr_row(a, row)
    if isinstance(out, _np.ndarray):
        # tensor-block rows (ndarray cells) behave as list cells, so
        # transform/filter/... work on feature vectors directly
        return out.tolist()
    return out


def _hof_lambda_arg(a, fn: str, pos: str, n_params, what: str) -> Lambda:
    if not isinstance(a, Lambda):
        raise ValueError(f"{fn}()'s {pos} argument must be a lambda")
    if len(a.params) not in n_params:
        raise ValueError(
            f"{fn}()'s {pos} lambda takes {what} parameter(s), "
            f"got {len(a.params)}"
        )
    return a


def _eval_hof(e: Call, row):
    """Spark's higher-order collection functions. Lambda bodies are
    builtin-only expressions/predicates over parameters and bare frame
    columns (no catalog UDFs inside bodies)."""
    fn = e.fn.lower()
    args = e.all_args()
    if fn in ("transform", "filter"):
        lam = _hof_lambda_arg(
            args[1], fn, "second", (1, 2), "1 (element) or 2 (element, index)"
        )
        arr = _hof_collection(args[0], row, fn)
        if not _is_arr(arr):
            return None
        two = len(lam.params) == 2
        if fn == "transform":
            return [
                _eval_lambda(lam, row, *((x, i) if two else (x,)))
                for i, x in enumerate(arr)
            ]
        return [
            x
            for i, x in enumerate(arr)
            if _eval_bool_lambda(lam, row, *((x, i) if two else (x,)))
            is True
        ]
    if fn in ("exists", "forall"):
        lam = _hof_lambda_arg(args[1], fn, "second", (1,), "exactly 1")
        arr = _hof_collection(args[0], row, fn)
        if not _is_arr(arr):
            return None
        saw_unknown = False
        for x in arr:
            b = _eval_bool_lambda(lam, row, x)
            if fn == "exists" and b is True:
                return True
            if fn == "forall" and b is False:
                return False
            if b is None:
                saw_unknown = True
        if saw_unknown:
            return None  # three-valued, matching Spark
        return fn == "forall"
    if fn in ("aggregate", "reduce"):
        merge = _hof_lambda_arg(
            args[2], fn, "third", (2,), "exactly 2 (acc, element)"
        )
        arr = _hof_collection(args[0], row, fn)
        if not _is_arr(arr):
            return None
        acc = _hof_collection(args[1], row, fn)
        for x in arr:
            acc = _eval_lambda(merge, row, acc, x)
        if len(args) == 4:
            finish = _hof_lambda_arg(
                args[3], fn, "fourth", (1,), "exactly 1 (acc)"
            )
            acc = _eval_lambda(finish, row, acc)
        return acc
    if fn == "zip_with":
        lam = _hof_lambda_arg(args[2], fn, "third", (2,), "exactly 2")
        a = _hof_collection(args[0], row, fn)
        b = _hof_collection(args[1], row, fn)
        if not _is_arr(a) or not _is_arr(b):
            return None
        return [
            _eval_lambda(
                lam,
                row,
                a[i] if i < len(a) else None,
                b[i] if i < len(b) else None,
            )
            for i in range(max(len(a), len(b)))
        ]
    if fn in ("map_filter", "transform_keys", "transform_values"):
        lam = _hof_lambda_arg(
            args[1], fn, "second", (2,), "exactly 2 (key, value)"
        )
        m = _hof_collection(args[0], row, fn)
        if not isinstance(m, dict):
            return None
        if fn == "map_filter":
            return {
                k: v
                for k, v in m.items()
                if _eval_bool_lambda(lam, row, k, v) is True
            }
        if fn == "transform_keys":
            out = {}
            for k, v in m.items():
                nk = _eval_lambda(lam, row, k, v)
                if nk is None:
                    return None  # Spark errors on a null key; null here
                out[nk] = v
            return out
        return {k: _eval_lambda(lam, row, k, v) for k, v in m.items()}
    if fn == "map_zip_with":
        lam = _hof_lambda_arg(
            args[2], fn, "third", (3,), "exactly 3 (key, v1, v2)"
        )
        m1 = _hof_collection(args[0], row, fn)
        m2 = _hof_collection(args[1], row, fn)
        if not isinstance(m1, dict) or not isinstance(m2, dict):
            return None
        keys = list(m1) + [k for k in m2 if k not in m1]
        return {
            k: _eval_lambda(lam, row, k, m1.get(k), m2.get(k))
            for k in keys
        }
    raise ValueError(f"Unhandled higher-order function {fn!r}")


def _pred_value_exprs(value):
    """Every expression node inside a Predicate's value slot: a single
    operand, BETWEEN's (lo, hi) tuple, or an IN list with expression
    elements (DynItems) — one walker shared by the catalog-UDF
    detectors so none forgets a slot."""
    if isinstance(value, (Col, Lit, Arith, Case, Call)):
        yield value
    elif isinstance(value, tuple) or isinstance(value, DynItems):
        for v in value:
            if isinstance(v, (Col, Lit, Arith, Case, Call)):
                yield v


def _contains_catalog_call(e: Expr) -> bool:
    """Any catalog-UDF call (a non-builtin Call) in the
    tree: such calls dispatch partition-vectorized through
    ``_apply_expr``, never through the row-wise evaluator — the Column
    API uses this to pick the right application path."""
    return next(_iter_catalog_calls(e), None) is not None


def _iter_catalog_calls(e: Expr):
    """Yield every catalog-UDF Call node in an expression tree."""
    if isinstance(e, Call):
        if e.arg == "*":
            return
        if not _is_builtin_call(e):
            yield e
        for a in e.all_args():
            yield from _iter_catalog_calls(a)
    elif isinstance(e, Arith):
        yield from _iter_catalog_calls(e.left)
        if e.right is not None:
            yield from _iter_catalog_calls(e.right)
    elif isinstance(e, Case):
        for p, x in e.branches:
            yield from _iter_pred_catalog_calls(p)
            yield from _iter_catalog_calls(x)
        if e.default is not None:
            yield from _iter_catalog_calls(e.default)


def _iter_pred_catalog_calls(node):
    if isinstance(node, NotOp):
        yield from _iter_pred_catalog_calls(node.part)
        return
    if isinstance(node, BoolOp):
        for p in node.parts:
            yield from _iter_pred_catalog_calls(p)
        return
    if not isinstance(node, Predicate):
        return
    if not isinstance(node.col, str):
        yield from _iter_catalog_calls(node.col)
    for v in _pred_value_exprs(node.value):
        yield from _iter_catalog_calls(v)


def _pred_contains_catalog_call(node) -> bool:
    return next(_iter_pred_catalog_calls(node), None) is not None


def _eval_pred3(node, row) -> Optional[bool]:
    """SQL three-valued predicate evaluation: True / False / None
    (unknown). WHERE keeps only True rows (see :func:`_eval_pred`); the
    Column API's filter does the same collapse, which makes ~(x > 3)
    drop null-x rows, exactly Spark's semantics."""
    if isinstance(node, NotOp):
        b = _eval_pred3(node.part, row)
        return None if b is None else not b
    if isinstance(node, BoolOp):
        # short-circuit like Python's and/or (a False conjunct / True
        # disjunct must skip later parts that could crash on that row —
        # the type-guard idiom WHERE typ = 'num' AND val > 3)
        if node.op == "and":
            for p in node.parts:
                b = _eval_pred3(p, row)
                if b is not True:
                    # stop at the first False OR NULL conjunct: neither
                    # can make the AND true, and later conjuncts must
                    # not evaluate (the type-guard idiom `typ = 'num'
                    # AND val > 3` relies on it — a NULL typ must not
                    # reach the crashing comparison). Deviation from
                    # strict Kleene: AND(NULL, FALSE) yields NULL, not
                    # FALSE — indistinguishable under filter's is-True
                    # collapse.
                    return b
            return True
        saw_unknown = False
        for p in node.parts:
            b = _eval_pred3(p, row)
            if b is True:
                return True
            if b is None:
                saw_unknown = True
        return None if saw_unknown else False
    v = (
        row[node.col]
        if isinstance(node.col, str)
        else _eval_expr_row(node.col, row)
    )
    if node.op == "isnull":
        return v is None
    if node.op == "notnull":
        return v is not None
    value = node.value
    if isinstance(value, (Col, Lit, Arith, Case, Call)):
        value = _eval_expr_row(value, row)
    if node.op == "<=>":
        # null-safe equality: NEVER unknown (Spark's <=> / eqNullSafe)
        if v is None or value is None:
            return v is None and value is None
        return bool(v == value)
    if node.op in ("in", "notin"):
        if v is None:
            return None
        items = value
        if isinstance(items, DynItems):
            # Column-API in-list with expression elements: evaluate
            # them for this row (plain literal lists skip this path)
            items = [
                _eval_expr_row(x, row)
                if isinstance(x, (Col, Lit, Arith, Case, Call))
                else x
                for x in items
            ]
        if v in items:
            return node.op == "in"
        if any(x is None for x in items):
            return None  # x NOT IN (..., NULL) is unknown, never true
        return node.op == "notin"
    if v is None or value is None:
        return None
    if node.op in ("between", "notbetween"):
        lo, hi = value
        if isinstance(lo, (Col, Lit, Arith, Case, Call)):
            lo = _eval_expr_row(lo, row)
        if isinstance(hi, (Col, Lit, Arith, Case, Call)):
            hi = _eval_expr_row(hi, row)
        if lo is None or hi is None:
            return None
        hit = lo <= v <= hi
        return hit if node.op == "between" else not hit
    if node.op in ("like", "notlike"):
        hit = _like_match(v, value)
        return hit if node.op == "like" else not hit
    if node.op in ("ilike", "notilike"):
        hit = _like_match(v, value, ignorecase=True)
        return hit if node.op == "ilike" else not hit
    if node.op in ("rlike", "notrlike"):
        # Spark RLIKE: PARTIAL regex match (re.search, not fullmatch)
        hit = _compile_rlike(value).search(str(v)) is not None
        return hit if node.op == "rlike" else not hit
    return _OPS[node.op](v, value)


def _eval_pred(node, row) -> bool:
    """Collapsed predicate for WHERE/CASE: unknown (NULL) never keeps a
    row / never takes a branch."""
    return _eval_pred3(node, row) is True


def _pred_name(node) -> str:
    """Canonical rendering of a predicate tree (stable across parses of
    the same text — a condition Column's output name)."""
    if isinstance(node, NotOp):
        return f"(NOT {_pred_name(node.part)})"
    if isinstance(node, BoolOp):
        return f" {node.op.upper()} ".join(
            f"({_pred_name(p)})" for p in node.parts
        )
    col = node.col if isinstance(node.col, str) else _expr_name(node.col)
    if node.op in ("isnull", "notnull"):
        return f"{col} IS {'NOT ' if node.op == 'notnull' else ''}NULL"
    value = (
        _expr_name(node.value)
        if isinstance(node.value, (Col, Lit, Arith, Case))
        else repr(node.value)
    )
    return f"{col} {node.op} {value}"


def _expr_name(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Arith):
        if e.op == "neg":
            return f"(- {_expr_name(e.left)})"
        return f"({_expr_name(e.left)} {e.op} {_expr_name(e.right)})"
    if isinstance(e, Case):
        parts = [
            f"WHEN {_pred_name(p)} THEN {_expr_name(x)}"
            for p, x in e.branches
        ]
        if e.default is not None:
            parts.append(f"ELSE {_expr_name(e.default)}")
        return "CASE " + " ".join(parts) + " END"
    if isinstance(e, Lambda):
        body = (
            _pred_name(e.body)
            if isinstance(e.body, (Predicate, BoolOp, NotOp))
            else _expr_name(e.body)
        )
        ps = (
            e.params[0]
            if len(e.params) == 1
            else "(" + ", ".join(e.params) + ")"
        )
        return f"{ps} -> {body}"
    if e.fn.lower() == "cast" and e.args is not None and len(e.args) == 2:
        return (
            f"CAST({_expr_name(e.args[0])} AS {e.args[1].value.upper()})"
        )
    # UDF and builtin names keep the casing they were called with
    return f"{e.fn}({', '.join(_expr_name(a) for a in e.all_args())})"


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def _strip_qualifier(name: str, tables) -> str:
    if "." in name:
        t, _, c = name.partition(".")
        if t in tables and c:
            return c
    return name


def _materialize_calls(e: Expr, df: DataFrame, acc: List[str]):
    """Replace every Call subtree of ``e`` with a temp column (UDFs run
    batched on device; the remaining Col/Lit/Arith tree then evaluates
    row-at-a-time). Returns (rewritten expr, df); temp names land in
    ``acc`` for the caller to drop."""
    if isinstance(e, Call):
        if _is_builtin_call(e):
            # builtins evaluate row-wise: keep the node, materialize
            # any UDF calls inside its arguments
            new_args = []
            for a in e.all_args():
                a2, df = _materialize_calls(a, df, acc)
                new_args.append(a2)
            if not new_args:
                return e, df  # zero-arg builtin (current_date())
            return _rebuild_call(e, new_args), df
        name = f"__sql_tmp_{id(e)}"
        df = _apply_expr(df, e, name)
        acc.append(name)
        return Col(name), df
    if isinstance(e, Arith):
        left, df = _materialize_calls(e.left, df, acc)
        right = None
        if e.right is not None:
            right, df = _materialize_calls(e.right, df, acc)
        return Arith(e.op, left, right), df
    if isinstance(e, Case):
        branches = []
        for pred, ex in e.branches:
            pred2, df = _materialize_pred_calls(pred, df, acc)
            ex2, df = _materialize_calls(ex, df, acc)
            branches.append((pred2, ex2))
        default = None
        if e.default is not None:
            default, df = _materialize_calls(e.default, df, acc)
        return Case(branches, default), df
    return e, df


def _materialize_pred_calls(node, df: DataFrame, acc: List[str]):
    """Predicate counterpart of :func:`_materialize_calls`: replace
    every catalog-UDF Call inside a predicate tree (operands, values,
    BETWEEN bounds, expression IN-lists, nested CASE conditions) with a
    batched temp column, so WHERE / filter / CASE WHEN can hold UDF
    calls and still evaluate row-wise over the rewritten tree. Returns
    (rewritten pred, df); temp names land in ``acc``."""
    if isinstance(node, NotOp):
        part, df = _materialize_pred_calls(node.part, df, acc)
        return NotOp(part), df
    if isinstance(node, BoolOp):
        parts = []
        for p in node.parts:
            p2, df = _materialize_pred_calls(p, df, acc)
            parts.append(p2)
        return BoolOp(node.op, parts), df
    if not isinstance(node, Predicate):
        return node, df
    col = node.col
    if not isinstance(col, str):
        col, df = _materialize_calls(col, df, acc)
    value = node.value
    if isinstance(value, (Col, Lit, Arith, Case, Call)):
        value, df = _materialize_calls(value, df, acc)
    elif isinstance(value, DynItems):
        items = []
        for v in value:
            if isinstance(v, (Col, Lit, Arith, Case, Call)):
                v, df = _materialize_calls(v, df, acc)
            items.append(v)
        value = DynItems(items)
    elif isinstance(value, tuple):  # BETWEEN bounds
        bounds = []
        for v in value:
            if isinstance(v, (Col, Lit, Arith, Case, Call)):
                v, df = _materialize_calls(v, df, acc)
            bounds.append(v)
        value = tuple(bounds)
    return Predicate(col, node.op, value), df


def _expr_columns(e, out: set) -> bool:
    """Collect every source-column name an expression tree can read into
    ``out``. Returns False when the tree holds a node the walker cannot
    bound (unknown kinds) — the pushdown pass then
    skips its optimization rather than guess. Lambda parameters shadow
    frame columns (Spark scoping), so a HOF body contributes its free
    names only."""
    if e is None or e == "*" or isinstance(e, Lit):
        return True
    if isinstance(e, Col):
        out.add(e.name)
        return True
    if isinstance(e, Arith):
        return _expr_columns(e.left, out) and (
            e.right is None or _expr_columns(e.right, out)
        )
    if isinstance(e, Case):
        for p, x in e.branches:
            if not (_pred_columns(p, out) and _expr_columns(x, out)):
                return False
        return e.default is None or _expr_columns(e.default, out)
    if isinstance(e, Lambda):
        body: set = set()
        walker = (
            _pred_columns
            if isinstance(e.body, (Predicate, BoolOp, NotOp))
            else _expr_columns
        )
        if not walker(e.body, body):
            return False
        out |= body - set(e.params)
        return True
    if isinstance(e, Call):
        return all(_expr_columns(a, out) for a in e.all_args())
    return False


def _pred_columns(node, out: set) -> bool:
    """Predicate counterpart of :func:`_expr_columns`: every column a
    predicate tree can read (operands, values, BETWEEN bounds, IN-list
    expressions, nested CASE conditions), or False when unbounded."""
    if node is None:
        return True
    if isinstance(node, NotOp):
        return _pred_columns(node.part, out)
    if isinstance(node, BoolOp):
        return all(_pred_columns(p, out) for p in node.parts)
    if not isinstance(node, Predicate):
        return False
    if isinstance(node.col, str):
        out.add(node.col)
    elif not _expr_columns(node.col, out):
        return False
    value = node.value
    if isinstance(value, (Col, Lit, Arith, Case, Call)):
        return _expr_columns(value, out)
    if isinstance(value, tuple) or isinstance(value, DynItems):
        return all(
            _expr_columns(v, out)
            for v in value
            if isinstance(v, (Col, Lit, Arith, Case, Call))
        )
    return True  # plain literal / literal IN-list / None


def _query_referenced_columns(q: Query) -> Optional[set]:
    """Every source column the query can read (select items, WHERE,
    ORDER BY), or None under SELECT * or when a tree defeats the walk.
    ORDER BY names may be select aliases: harmless, the caller keeps
    the frame's columns that are in the set."""
    cols: set = set()
    for it in q.items:
        if it.expr == "*" or isinstance(it.expr, QualifiedStar):
            return None
        if not _expr_columns(it.expr, cols):
            return None
    if q.where is not None and not _pred_columns(q.where, cols):
        return None
    for c, _a in q.order:
        if isinstance(c, str):
            cols.add(c)
        elif not _expr_columns(c, cols):
            return None
    return cols


def _count_skipped_rows(n: int) -> None:
    metrics.inc("sql.pushdown.skipped_rows", n)


def _split_where_conjuncts(node):
    """Split a WHERE tree into (cheap, expensive): top-level AND
    conjuncts free of catalog-UDF calls versus the rest. Sound under SQL
    AND semantics — a row survives iff every conjunct is True, whatever
    the evaluation order (Spark's optimizer reorders the same way) — so
    the cheap half can filter before the UDF half's batched temp columns
    materialize, and the model never scores rows metadata already
    rejected. OR trees and lone UDF-bearing predicates land whole in the
    expensive half."""
    parts = (
        node.parts
        if isinstance(node, BoolOp) and node.op == "and"
        else [node]
    )
    cheap = [p for p in parts if not _pred_contains_catalog_call(p)]
    expensive = [p for p in parts if _pred_contains_catalog_call(p)]

    def _rebuild(ps):
        if not ps:
            return None
        return ps[0] if len(ps) == 1 else BoolOp("and", ps)

    return _rebuild(cheap), _rebuild(expensive)


def _filter_pred(df: DataFrame, node, pushed: bool) -> DataFrame:
    """Apply a (UDF-free after materialization) predicate tree. On the
    optimizer arm the filter evaluates over only the columns the tree
    reads (``filterOnColumns``), so element-lazy cells in unreferenced
    columns never decode for dropped rows; when the read set cannot be
    bounded — or a referenced name is unknown, which must keep the
    legacy KeyError surface — the plain all-columns row filter runs."""
    if pushed:
        cols: set = set()
        if _pred_columns(node, cols) and all(
            c in df.columns for c in cols
        ):
            return df.filterOnColumns(
                lambda r, node=node: _eval_pred(node, r),
                sorted(cols),
                on_skipped=_count_skipped_rows,
            )
    return df.filter(lambda r, node=node: _eval_pred(node, r))


def _apply_expr(df: DataFrame, e: Expr, out_name: str) -> DataFrame:
    """Materialize expression e as column out_name (UDFs run batched per
    partition through the catalog; arithmetic evaluates row-at-a-time
    over materialized operands)."""
    if isinstance(e, Col):
        if out_name == e.name:
            return df
        if udf_catalog.sql_vectorize_enabled():
            # column-level copy: the row path below builds a Row over
            # EVERY column per row just to read one cell, forcing
            # element-lazy cells (image decodes) in unrelated columns;
            # the partition op touches only the referenced column, and
            # a TensorColumn input stays one columnar block end to end
            return df.withColumnPartition(
                out_name, lambda part, c=e.name: {out_name: part[c]}
            )
        return df.withColumn(out_name, lambda r, c=e.name: r[c])
    if isinstance(e, (Lit, Arith, Case)) or _is_builtin_call(e):
        tmp: List[str] = []
        expr2, df = _materialize_calls(e, df, tmp)
        df = df.withColumn(
            out_name, lambda r, ex=expr2: _eval_expr_row(ex, r)
        )
        return df.drop(*tmp) if tmp else df
    if e.args is not None and len(e.args) != 1:
        raise ValueError(
            f"UDF {e.fn!r} takes exactly one argument, got "
            f"{len(e.args)} (multi-argument calls are for builtins)"
        )
    inner_name = f"__sql_tmp_{id(e)}"
    df = _apply_expr(df, e.arg, inner_name)
    df = udf_catalog.apply_udf(e.fn, df, inner_name, out_name)
    return df.drop(inner_name) if inner_name != out_name else df


class SQLContext:
    """Table registry and query entry point. A module-level default
    instance backs :func:`sql`, :func:`registerDataFrameAsTable` and
    ``DataFrame.createOrReplaceTempView``."""

    def __init__(self) -> None:
        self._tables: Dict[str, DataFrame] = {}
        self._lock = threading.Lock()

    def registerDataFrameAsTable(self, df: DataFrame, name: str) -> None:
        with self._lock:
            self._tables[name] = df

    def dropTempTable(self, name: str) -> bool:
        """Remove a registered table; whether it was there."""
        with self._lock:
            return self._tables.pop(name, None) is not None

    def table(self, name: str) -> DataFrame:
        with self._lock:
            if name not in self._tables:
                raise KeyError(f"Unknown table {name!r}; registered: {sorted(self._tables)}")
            return self._tables[name]

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def sql(self, query: str) -> DataFrame:
        return self._run_query(_Parser(_tokenize(query)).parse())

    @staticmethod
    def _resolve_order_keys(q: Query) -> None:
        """ORDER BY ordinals become the select item's output name."""
        out: List[Tuple[Any, Any]] = []
        for c, a in q.order:
            if isinstance(c, Lit):
                if not isinstance(c.value, int) or not 1 <= c.value <= len(q.items):
                    raise ValueError(
                        f"ORDER BY literal {c.value!r} must be a select-item ordinal in 1..{len(q.items)}"
                    )
                it = q.items[c.value - 1]
                if it.expr == "*" or isinstance(it.expr, QualifiedStar):
                    raise ValueError("ORDER BY ordinal cannot reference a * item")
                c = it.alias or _expr_name(it.expr)
            out.append((c, a))
        q.order = out

    @staticmethod
    def _strip_alias(q: Query) -> None:
        """``alias.col`` (or ``table.col`` when there is no alias) reads
        ``col``; under an alias the table's own name does not qualify.
        Lambda bodies name columns bare and are left as they are."""
        tables = {q.table_alias or q.table}

        def res(name: str) -> str:
            return _strip_qualifier(name, tables)

        def res_expr(e):
            if isinstance(e, Col):
                return Col(res(e.name))
            if isinstance(e, Call):
                new_args = [res_expr(a) for a in e.all_args()]
                return _rebuild_call(e, new_args) if new_args else e
            if isinstance(e, Arith):
                return Arith(e.op, res_expr(e.left), res_expr(e.right) if e.right is not None else None)
            if isinstance(e, Case):
                return Case(
                    [(res_pred(p), res_expr(x)) for p, x in e.branches],
                    res_expr(e.default) if e.default is not None else None,
                )
            return e

        def res_pred(node):
            if isinstance(node, NotOp):
                return NotOp(res_pred(node.part))
            if isinstance(node, BoolOp):
                return BoolOp(node.op, [res_pred(p) for p in node.parts])
            col = res(node.col) if isinstance(node.col, str) else res_expr(node.col)
            value = node.value
            if isinstance(value, (Col, Arith, Case, Call)):
                value = res_expr(value)
            return Predicate(col, node.op, value)

        q.items = [
            SelectItem(
                it.expr if it.expr == "*" or isinstance(it.expr, QualifiedStar) else res_expr(it.expr),
                it.alias,
            )
            for it in q.items
        ]
        if q.where is not None:
            q.where = res_pred(q.where)
        q.order = [(res(c) if isinstance(c, str) else res_expr(c), a) for c, a in q.order]

    @staticmethod
    def _expand_qualified_stars(q: Query) -> None:
        """``t.*`` is ``*`` when ``t`` is the table's alias (or its name
        when it has none)."""
        valid = q.table_alias or q.table
        for it in q.items:
            if isinstance(it.expr, QualifiedStar):
                if it.expr.qualifier != valid:
                    raise ValueError(
                        f"Unknown qualifier {it.expr.qualifier!r} for qualified star; FROM binds {valid!r}"
                    )
                it.expr = "*"

    @staticmethod
    def _check_functions(q: Query) -> None:
        """Every called name that is not a builtin is a catalog UDF
        (lambda bodies hold builtins only: the parser checks them)."""
        calls = [c for it in q.items if it.expr != "*" for c in _iter_catalog_calls(it.expr)]
        if q.where is not None:
            calls += list(_iter_pred_catalog_calls(q.where))
        calls += [c for k, _ in q.order if not isinstance(k, str) for c in _iter_catalog_calls(k)]
        registered = udf_catalog.list_udfs()
        unknown = sorted({c.fn for c in calls if c.fn not in registered})
        if unknown:
            raise ValueError(
                f"Unknown function(s) {unknown}: neither a builtin nor a registered UDF "
                f"(registered: {registered})"
            )

    def _run_query(self, q: Query) -> DataFrame:
        self._resolve_order_keys(q)
        df = self.table(q.table)
        self._strip_alias(q)
        self._expand_qualified_stars(q)
        self._check_functions(q)

        vectorize = udf_catalog.sql_vectorize_enabled()
        if vectorize:
            # projection pushdown: the scan keeps only what the query reads
            needed = _query_referenced_columns(q)
            if needed is not None:
                pruned = [c for c in df.columns if c in needed]
                if not pruned and df.columns:
                    pruned = [df.columns[0]]  # partitions count rows by a column
                if len(pruned) < len(df.columns):
                    metrics.inc("sql.pushdown.pruned_cols", len(df.columns) - len(pruned))
                    df = df.select(*pruned)

        if q.where is not None:
            # UDF calls in WHERE materialize batched first; on the
            # optimizer arm the UDF-free conjuncts filter before them
            tmp: List[str] = []
            if vectorize:
                cheap, expensive = _split_where_conjuncts(q.where)
                if cheap is not None and expensive is not None:
                    df = _filter_pred(df, cheap, True)
                    remaining = expensive
                else:
                    remaining = q.where
                where, df = _materialize_pred_calls(remaining, df, tmp)
                df = _filter_pred(df, where, True)
            else:
                where, df = _materialize_pred_calls(q.where, df, tmp)
                df = df.filter(lambda r, node=where: _eval_pred(node, r))
            if tmp:
                df = df.drop(*tmp)

        if len(q.items) > 1 and any(it.expr == "*" for it in q.items):
            # SELECT *, expr: the star is the source columns
            q.items = [
                x
                for it in q.items
                for x in ([SelectItem(Col(c), c) for c in df.columns] if it.expr == "*" else [it])
            ]

        if q.items[0].expr == "*" and len(q.items) == 1:
            if q.order:
                # expression keys sort on hidden columns, dropped after
                cols, asc, tmp = [], [], []
                for c, a in q.order:
                    if not isinstance(c, str):
                        name = _expr_name(c)
                        if name not in df.columns:
                            df = _apply_expr(df, c, name)
                            tmp.append(name)
                        c = name
                    cols.append(c)
                    asc.append(a)
                df = df.orderBy(*cols, ascending=asc)
                if tmp:
                    df = df.drop(*tmp)
            return df.limit(q.limit) if q.limit is not None else df

        output_names = [it.alias or _expr_name(it.expr) for it in q.items]
        oset = set(output_names)

        # an expression key sorts on an output of the same name, else on
        # a hidden column of the source frame, dropped after projection
        order: List[Tuple[str, Any]] = []
        for c, a in q.order:
            if not isinstance(c, str):
                name = _expr_name(c)
                if name not in oset and name not in df.columns:
                    df = _apply_expr(df, c, name)
                c = name
            order.append((c, a))

        def project(d: DataFrame, carry=()) -> DataFrame:
            for it, name in zip(q.items, output_names):
                d = _apply_expr(d, it.expr, name)
            return d.select(*output_names, *carry)

        if not order:
            # limit before the projection: no UDF scores a row the limit
            # drops
            if q.limit is not None:
                df = df.limit(q.limit)
            return project(df)
        order_cols = [c for c, _ in order]
        asc = [a for _, a in order]
        if all(c not in oset and c in df.columns for c in order_cols):
            # a sort on source columns alone: sort and limit, then project
            df = df.orderBy(*order_cols, ascending=asc)
            if q.limit is not None:
                df = df.limit(q.limit)
            return project(df)
        # a key names an output: project first, carrying source-only keys
        carry = [c for c in order_cols if c not in oset]
        for c in carry:
            if c not in df.columns:
                raise KeyError(f"Unknown ORDER BY column {c!r}")
        out = project(df, carry=carry).orderBy(*order_cols, ascending=asc)
        if carry:
            out = out.drop(*carry)
        return out.limit(q.limit) if q.limit is not None else out


_default = SQLContext()


def registerDataFrameAsTable(df: DataFrame, name: str) -> None:
    _default.registerDataFrameAsTable(df, name)


def dropTempTable(name: str) -> None:
    _default.dropTempTable(name)


def sql(query: str) -> DataFrame:
    return _default.sql(query)
