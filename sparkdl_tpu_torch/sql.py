"""SQL over registered DataFrames: model UDFs inside the JAX package's
dialect, its row expressions and its relational core.

Port of the JAX package's ``sql.py`` (upstream: ``registerKerasImageUDF(
"my_udf", model)``, then ``spark.sql("SELECT my_udf(image) FROM
images")``). The semantics are the JAX package's, row for row and in the
same order; the grammar is:

    [WITH name AS (query) [, name2 AS (query)]]
    query := SELECT [DISTINCT] item, ...
        [FROM table-ref [, table-ref] ...
            [[INNER | LEFT [OUTER] | RIGHT [OUTER] | FULL [OUTER]
              | LEFT SEMI | LEFT ANTI] JOIN table-ref ON a.k = b.k
             | CROSS JOIN table-ref] ...
            [LATERAL VIEW [OUTER] gen(expr) alias [AS col, ...]] ...]
        [WHERE pred]
        [GROUP BY expr | alias | ordinal, ... | ROLLUP(col, ...)
         | CUBE(col, ...) | GROUPING SETS ((col, ...), ...)]
        [HAVING pred over aggregates, keys and select aliases]
        [ORDER BY key [ASC|DESC] [NULLS FIRST|LAST], ...]
        [LIMIT n] [OFFSET m]
        [UNION [ALL] | EXCEPT | MINUS | INTERSECT query] ...
    table-ref := table [[AS] alias] | (query) [AS] alias
    item := * | alias.* | expr [[AS] alias]
          | explode[_outer](expr) | stack(n, expr, ...) | json_tuple(expr, 'k', ...)
    gen  := explode | explode_outer | posexplode | posexplode_outer
    key  := column | select-item ordinal | expr (aggregates too, when
            the query groups)
    expr := column | `quoted column` | literal (number, 'string', NULL,
            TRUE/FALSE) | fn(expr, ...) | CAST(expr AS type)
          | TRY_CAST(expr AS type) | EXTRACT(field FROM expr)
          | agg([DISTINCT] expr) [FILTER (WHERE pred)] | count(*)
          | (scalar query) | expr (+ - * / %) expr | expr || expr
          | - expr | (expr) | CASE WHEN pred THEN expr ... [ELSE expr] END
          | CASE expr WHEN expr THEN expr ... [ELSE expr] END
          | hof(expr, x -> body | (x, y) -> body, ...)
          | win(...) OVER ([PARTITION BY expr, ...] [ORDER BY key, ...]
                [ROWS | RANGE BETWEEN bound AND bound])
    win  := row_number | rank | dense_rank | percent_rank | cume_dist
          | ntile(n) | lag/lead(expr[, n[, default]]) | first_value
          | last_value | nth_value(expr, n) | an aggregate
    bound := UNBOUNDED PRECEDING | n PRECEDING | CURRENT ROW
           | n FOLLOWING | UNBOUNDED FOLLOWING
    pred := expr (= != <> < <= > >= <=>) expr | expr IS [NOT] NULL
          | expr IS [NOT] DISTINCT FROM expr
          | expr [NOT] IN (expr, ... | query) | [NOT] EXISTS (query)
          | expr [NOT] BETWEEN expr AND expr
          | expr [NOT] LIKE|ILIKE|RLIKE|REGEXP 'pattern'
          | boolean builtin | pred AND|OR pred | NOT pred | (pred)

``fn`` is a row builtin (``sql_builtins._BUILTIN_FNS``), a higher-order
builtin over lambdas, or a UDF of the process-global catalog
(``sparkdl_tpu_torch.udf``), which takes one argument. ``agg`` is one of
:data:`_AGGREGATES`, streamed partition by partition through the
accumulators of ``dataframe/frame.py`` (memory O(groups)); groups come out
in first-appearance order. Builtins evaluate row by row on the host; a
UDF call anywhere in an expression (inside CASE, COALESCE, arithmetic,
WHERE, an aggregate's argument, a join input or a subquery) is
materialized first, a partition at a time through the catalog, and the
rest of the tree then evaluates over its column. Subqueries are
uncorrelated: each runs once, before the query that holds it. NULL and
NaN follow Spark's semantics as the JAX package has them: comparisons
with NULL are unknown and WHERE keeps only true rows, NULL join keys
never match, arithmetic over NULL is NULL, ``x / 0`` and ``x % 0`` are
NULL, ``%`` takes the dividend's sign, CAST is non-ANSI (null when
unconvertible).

Windows run on the host over the collected frame (the collect guard
``SPARKDL_DRIVER_COLLECT_MAX_ROWS`` applies), in select items only: with an
ORDER BY an aggregate takes Spark's running RANGE frame, without one the
whole partition; ROWS frames are physical, RANGE frames take one ORDER BY
key; nulls sort first ascending and ties are peers. A generator is a
top-level select item, one per select and never beside a window; LATERAL
VIEW expands the FROM frame before WHERE, left to right.
:class:`UnsupportedSQL` (a ValueError naming ROADMAP Queue A item 8)
stays exported for code that catches it; since the pandas surfaces were
ported, nothing raises it.
A view registered by ``createGlobalTempView`` is the table
``global_temp.<name>``: an identifier may hold dots.

The optimizer arm (``SPARKDL_SQL_VECTORIZE``, default on): a scan, and
each input of a join, keeps only the columns the query reads, lambda
bodies, CASE branches, ON keys, LATERAL VIEW arguments and a join's
window operands included (``sql.pushdown.pruned_cols``; the JAX package
prunes no join input, and a single-table scan under a window is not
pruned, as in the JAX package); WHERE's top-level
conjuncts without a UDF call filter first, over only the columns they
read (``sql.pushdown.skipped_rows``), so no UDF scores a row they drop;
model UDFs dispatch batched through the shared feeder
(``sql.udf.batches``, ``sql.udf.batch_rows``); without ORDER BY, LIMIT
applies before the projection, so no UDF scores a row the limit drops.
0/off is the row-path planner, the A/B arm. No predicate skips rows on
file statistics: the port's scans keep none.
"""

from __future__ import annotations

import functools
import math
import re
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    """A construct of the JAX package's dialect that the port lacks. Kept
    for user code that catches it: the port now has every construct it
    once refused (the pandas surfaces were the last), so nothing raises
    it."""

    def __init__(self, construct: str):
        super().__init__(
            f"{construct}: not in the port's SQL dialect; it waits for "
            f"{_ITEM8}"
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
# OFFSET is CONTEXTUAL (like Spark's non-reserved treatment): only the
# ident 'offset' followed by a number in clause-tail position is the
# clause, so columns named offset stay usable without backticks.

# Window functions: pure-ranking fns plus the aggregates, computed over
# a PARTITION BY group (whole-partition frame; no ROWS BETWEEN).
_RANKING_FNS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
}
_VALUE_FNS = {"first_value", "last_value", "nth_value"}
_OFFSET_FNS = {"lag", "lead"}


def _window_needs_order(fn: str) -> bool:
    """Window functions whose result is meaningless without an ORDER BY
    (every non-aggregate window fn) — one rule for Column.over and the
    frame-side validation, next to the sets it reads."""
    return fn in _RANKING_FNS or fn in _OFFSET_FNS or fn in _VALUE_FNS \
        or fn == "ntile"

# Reserved aggregate function names (shadow any same-named UDF, as in
# Spark where builtins win over registered functions). first/last use
# ignore-nulls semantics (stream order decides, like Spark's
# order-nondeterministic first); collect_list/set hold O(values) per
# group. The streaming accumulators live in dataframe/frame.py.
_AGGREGATES = {
    "count", "sum", "avg", "min", "max", "stddev", "variance",
    "collect_list", "collect_set", "first", "last", "median",
    "stddev_pop", "stddev_samp", "var_pop", "var_samp", "skewness",
    "kurtosis", "sum_distinct", "approx_count_distinct", "percentile",
    "percentile_approx", "corr", "covar_pop", "covar_samp", "bool_and",
    "bool_or", "every", "any_value", "mode",
}
# aggregates whose second (and third) argument is a call-level literal
# parameter, not a column: the parser folds those literals into the
# Call's _params and keeps one value argument
_PARAM_AGGS = {"percentile", "percentile_approx"}
# two-column aggregates: the parser packs both args into one
# array(x, y) cell argument; the accumulator consumes pairs
_PAIR_AGGS = {"corr", "covar_pop", "covar_samp"}
# order-sensitive aggregates must see rows in frame order — they are
# excluded from the reversed suffix-frame streaming optimization
_ORDER_SENSITIVE_AGGS = {
    "first", "last", "collect_list", "collect_set", "any_value", "mode",
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


@dataclass
class Call:
    fn: str
    arg: "Expr"  # first argument (or "*"); kept for aggregate paths
    distinct: bool = False  # COUNT(DISTINCT col)
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
    that only cares about direction — window specs, set-op ordering,
    name rendering — keeps working unchanged; the frame's sort loop
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
    evaluation (Spark scoping). Planner rewrites (subquery resolution,
    alias qualification) deliberately do not descend into bodies —
    lambda bodies reference columns by bare name and builtins only."""

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


@dataclass
class Window:
    """fn() OVER (PARTITION BY ... [ORDER BY ...] [ROWS BETWEEN ...]):
    ranking functions need an ORDER BY; aggregate functions default to
    the whole partition (no ORDER BY) or Spark's running RANGE frame
    (with ORDER BY), unless an explicit ROWS frame is given.
    Select-item position only.

    arg / partition_by entries / order_by keys are column-name strings
    after the materialization pre-pass; expressions (sum(v * q) OVER
    (PARTITION BY upper(g))) are parsed as Expr nodes and materialized
    to hidden columns before computation."""

    fn: str  # ranking | aggregate | lag/lead
    arg: Any  # argument column name | Expr (None for ranking/count(*))
    partition_by: List[Any]
    order_by: List[Tuple[Any, bool]]
    offset: int = 1  # lag/lead row offset
    default: Any = None  # lag/lead value past the partition edge
    # explicit frame: (lo, hi) offsets relative to the current row,
    # None = unbounded on that side; None overall = default framing.
    # frame_kind 'rows' = physical row offsets; 'range' = ORDER-BY-value
    # offsets (requires exactly one order key; peers by value distance)
    frame: Optional[Tuple[Optional[Any], Optional[Any]]] = None
    frame_kind: str = "rows"

    def map_operands(self, fn: Callable[[Any], Any]) -> "Window":
        """Rebuild with ``fn`` applied to every column/expression operand
        (arg, PARTITION BY entries, ORDER BY keys) — the one place the
        walkers (alias stripping, join resolution, subquery resolution)
        share, so a new Window field only needs threading here."""
        return Window(
            self.fn,
            fn(self.arg) if self.arg is not None else None,
            [fn(c) for c in self.partition_by],
            [(fn(c), a) for c, a in self.order_by],
            self.offset,
            self.default,
            self.frame,
            self.frame_kind,
        )


Expr = Any  # Col | Call | Lit | Arith | Case


@dataclass
class Subquery:
    """Scalar subquery in expression position: (SELECT max(v) FROM t).

    Uncorrelated only (inner references resolve against the subquery's
    own tables). Resolved to a literal before planning: one column
    required, zero rows -> NULL, more than one row -> error (standard
    scalar-subquery semantics)."""

    q: Any  # Query | UnionQuery


@dataclass
class QualifiedStar:
    """``SELECT t.*`` — resolved against the FROM table/alias at
    planning (single-table queries; join queries need explicit column
    lists, where provenance after key-merging is ambiguous)."""

    qualifier: str


@dataclass
class SelectItem:
    expr: Expr  # or "*" or QualifiedStar
    alias: Optional[str]


@dataclass
class Predicate:
    col: Any  # str | Call (aggregate-call operands in HAVING)
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
class Join:
    table: Any  # str | Query | UnionQuery (derived table on the right)
    how: str  # 'inner' | 'left' | 'right' | 'outer' (FULL)
    left_key: str
    right_key: str
    alias: Optional[str] = None  # JOIN t b / JOIN (SELECT ...) b


@dataclass
class Query:
    items: List[SelectItem]
    distinct: bool
    table: Any  # str | Query (derived table: FROM (SELECT ...))
    joins: List[Join]
    where: Optional[Any]  # Predicate | BoolOp
    group: List[Any]  # group-key expressions (Col for plain columns)
    having: Optional[Any]  # Predicate | BoolOp over aggregated rows
    order: List[Tuple[Any, bool]]  # (column name | ordinal Lit | Expr, asc)
    limit: Optional[int]
    subquery_alias: Optional[str] = None  # set when used as FROM (...)
    table_alias: Optional[str] = None  # FROM t [AS] a (plain tables)
    offset: Optional[int] = None  # LIMIT n OFFSET m / bare OFFSET m
    group_mode: Optional[str] = None  # ROLLUP | CUBE | SETS
    grouping_sets: Optional[List[List[str]]] = None  # explicit SETS
    # LATERAL VIEW [OUTER] explode(...) alias AS c[, c2] entries:
    # (fn, arg_expr, outer, view_alias, col_names|None)
    lateral_views: Optional[List[Tuple]] = None


@dataclass
class UnionQuery:
    """Set-operator chain over queries: positional column matching
    (SQL); ``ops[i]`` ('union' | 'union_all' | 'except' | 'intersect')
    combines the running result with branch i+1, left-associatively.
    All but UNION ALL use distinct semantics, like Spark."""

    branches: List[Any]  # Query | UnionQuery (INTERSECT binds tighter)
    ops: List[str]
    order: List[Tuple[str, bool]]
    limit: Optional[int]
    offset: Optional[int] = None
    subquery_alias: Optional[str] = None  # set when used as FROM (...)


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        k, v = self.toks[self.i]
        # backtick-quoted true/false present as ordinary idents to the
        # WHOLE grammar (aliases, table names, ...); only the
        # boolean-literal rule consults _raw_quoted() to tell them
        # from the bare literals
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

    def _at_offset_clause(self) -> bool:
        k, v = self.peek()
        return (
            k == "ident"
            and v.lower() == "offset"
            and self.toks[self.i + 1][0] == "num"
        )

    def _at_lateral_view(self) -> bool:
        """CONTEXTUAL keyword pair: only the ident sequence 'lateral
        view' in table-alias position opens a lateral view — columns
        or tables named lateral stay usable elsewhere."""
        k, v = self.peek()
        return (
            k == "ident"
            and v.lower() == "lateral"
            and self.toks[self.i + 1][0] == "ident"
            and self.toks[self.i + 1][1].lower() == "view"
        )

    def _at_cross_join(self) -> bool:
        """CONTEXTUAL keyword pair like 'lateral view': only the ident
        'cross' immediately before JOIN opens a keyless cartesian join
        — columns or aliases named cross stay usable elsewhere."""
        k, v = self.peek()
        return (
            k == "ident"
            and v.lower() == "cross"
            and self.toks[self.i + 1] == ("kw", "join")
        )

    def _table_ref(self):
        """One FROM-clause table reference: a named table or a
        parenthesized derived table ``(SELECT ...)``, with an optional
        ``[AS] alias``. Returns ``(table, alias)`` where ``table`` is
        the name string or the parsed subquery (whose
        ``subquery_alias`` is set when aliased, so alias-qualified
        references resolve downstream). Bare aliases stay contextual:
        the OFFSET and LATERAL VIEW ident pairs never parse as one."""
        if self.peek() == ("punct", "("):
            self.next()
            table = self.parse_union()
            self.expect("punct", ")")
        else:
            table = self.expect("ident")
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif (
            self.peek()[0] == "ident"
            and not self._at_offset_clause()
            and not self._at_lateral_view()
            and not self._at_cross_join()
        ):
            alias = self.next()[1]
        if not isinstance(table, str):
            table.subquery_alias = alias
        return table, alias

    def parse(self):
        ctes: List[Tuple[str, Any]] = []
        if self.peek() == ("kw", "with"):
            # WITH name AS (SELECT ...) [, name2 AS (...)]: each CTE
            # may reference the ones before it; top-level only
            self.next()
            while True:
                name = self.expect("ident")
                self.expect("kw", "as")
                self.expect("punct", "(")
                cq = self.parse_union()
                self.expect("punct", ")")
                if any(n == name for n, _ in ctes):
                    raise ValueError(f"Duplicate CTE name {name!r}")
                ctes.append((name, cq))
                if self.peek() == ("punct", ","):
                    self.next()
                    continue
                break
        q = self.parse_union()
        if self.peek()[0] != "eof":
            raise ValueError(f"Unexpected trailing token {self.peek()[1]!r}")
        return (ctes, q) if ctes else q

    def parse_union(self):
        """query [UNION [ALL] | EXCEPT | INTERSECT query]... with
        standard precedence (INTERSECT binds tighter); ORDER BY/LIMIT
        written after the last branch apply to the COMBINED result, so
        they are lifted off that branch onto the set-op node."""
        q = self.parse_intersect()
        if self.peek() not in (
            ("kw", "union"), ("kw", "except"), ("kw", "minus"),
        ):
            return q
        branches = [q]
        ops = []
        while self.peek() in (
            ("kw", "union"), ("kw", "except"), ("kw", "minus"),
        ):
            kw = self.next()[1]
            op = "except" if kw == "minus" else kw
            if op == "union" and self.peek() == ("kw", "all"):
                self.next()
                op = "union_all"
            elif self.peek() == ("kw", "all"):
                raise ValueError(
                    f"{kw.upper()} ALL is not supported (distinct "
                    "semantics only)"
                )
            ops.append(op)
            branches.append(self.parse_intersect())
        return self._finish_setop(branches, ops)

    def parse_intersect(self):
        q = self.query()
        if self.peek() != ("kw", "intersect"):
            return q
        branches = [q]
        ops = []
        while self.peek() == ("kw", "intersect"):
            self.next()
            if self.peek() == ("kw", "all"):
                raise ValueError(
                    "INTERSECT ALL is not supported (distinct "
                    "semantics only)"
                )
            ops.append("intersect")
            branches.append(self.query())
        return self._finish_setop(branches, ops)

    @staticmethod
    def _finish_setop(branches, ops):
        # Query and UnionQuery both carry order/limit: a nested
        # INTERSECT chain that lifted its trailing ORDER BY/LIMIT is
        # just as much a non-last branch as a plain SELECT
        for b in branches[:-1]:
            if b.order or b.limit is not None or b.offset is not None:
                raise ValueError(
                    "ORDER BY/LIMIT/OFFSET inside a set-operator branch "
                    "is not supported; put them after the last SELECT "
                    "(they apply to the whole union)"
                )
        last = branches[-1]
        order, limit, offset = last.order, last.limit, last.offset
        last.order, last.limit, last.offset = [], None, None
        return UnionQuery(branches, ops, order, limit, offset)

    def query(self) -> Query:
        self.expect("kw", "select")
        distinct = False
        if self.peek() == ("kw", "distinct"):
            self.next()
            distinct = True
        items = [self.select_item()]
        while self.peek() == ("punct", ","):
            self.next()
            items.append(self.select_item())
        joins = []
        if self.peek() != ("kw", "from"):
            # FROM-less SELECT (Spark: SELECT 1, SELECT transform(...)):
            # the items evaluate over one synthetic empty row
            table = None
            table_alias = None
        else:
            self.next()
            table, table_alias = self._table_ref()
            while self.peek() == ("punct", ","):
                # comma-separated FROM list = implicit CROSS JOIN
                # (FROM t, m WHERE ... — the pre-ANSI join spelling)
                self.next()
                jt, jalias = self._table_ref()
                if jalias is None and not isinstance(jt, str):
                    raise ValueError(
                        "A derived table in a comma join needs an "
                        "alias: FROM t, (SELECT ...) m"
                    )
                if not isinstance(jt, str):
                    jt.subquery_alias = jalias
                joins.append(Join(jt, "cross", None, None, jalias))
        while True:
            jn = self.join_clause()
            if jn is None:
                break
            joins.append(jn)
        lateral_views: List[Tuple] = []
        while self._at_lateral_view():
            self.next()
            self.next()
            lv_outer = False
            if self.peek() == ("kw", "outer"):
                self.next()
                lv_outer = True
            k, fname = self.next()
            if k != "ident" or fname.lower() not in (
                "explode", "explode_outer", "posexplode",
                "posexplode_outer",
            ):
                raise ValueError(
                    "LATERAL VIEW supports explode/explode_outer/"
                    f"posexplode(_outer), got {fname!r}"
                )
            self.expect("punct", "(")
            lv_arg = self.add_expr()
            self.expect("punct", ")")
            lv_alias = self.expect("ident")  # required, like Hive
            lv_cols = None
            if self.peek() == ("kw", "as"):
                self.next()
                lv_cols = [self.expect("ident")]
                while self.peek() == ("punct", ","):
                    self.next()
                    lv_cols.append(self.expect("ident"))
            lateral_views.append(
                (fname.lower(), lv_arg, lv_outer, lv_alias, lv_cols)
            )
        where = None
        order: List[Tuple[str, bool]] = []
        limit = None
        if self.peek() == ("kw", "where"):
            self.next()
            where = self.or_pred()
        group: List[Any] = []
        group_mode = None
        grouping_sets = None
        if self.peek() == ("kw", "group"):
            self.next()
            self.expect("kw", "by")
            k, v = self.peek()
            if (
                k == "ident"
                and v.lower() == "grouping"
                and self.toks[self.i + 1][0] == "ident"
                and self.toks[self.i + 1][1].lower() == "sets"
                and self.toks[self.i + 2] == ("punct", "(")
            ):
                # GROUP BY GROUPING SETS ((a, b), (a), ()): explicit
                # set list; contextual keywords
                group_mode = "sets"
                self.next()
                self.next()
                self.next()
                explicit: List[List[str]] = []
                while True:
                    if self.peek()[0] == "ident":
                        # a bare column is a one-element set (standard
                        # SQL: GROUPING SETS (r, ()))
                        explicit.append([self.next()[1]])
                    else:
                        self.expect("punct", "(")
                        one: List[str] = []
                        if self.peek() != ("punct", ")"):
                            one.append(self.expect("ident"))
                            while self.peek() == ("punct", ","):
                                self.next()
                                one.append(self.expect("ident"))
                        self.expect("punct", ")")
                        explicit.append(one)
                    if self.peek() == ("punct", ","):
                        self.next()
                        continue
                    break
                self.expect("punct", ")")
                seen_cols: List[str] = []
                for s in explicit:
                    for c2 in s:
                        if c2 not in seen_cols:
                            seen_cols.append(c2)
                group.extend(Col(c2) for c2 in seen_cols)
                grouping_sets = explicit
            elif (
                k == "ident"
                and v.lower() in ("rollup", "cube")
                and self.toks[self.i + 1] == ("punct", "(")
            ):
                # GROUP BY ROLLUP(a, b) / CUBE(a, b): contextual
                # keywords; plain column keys only
                group_mode = v.lower()
                self.next()
                self.next()
                group.append(Col(self.expect("ident")))
                while self.peek() == ("punct", ","):
                    self.next()
                    group.append(Col(self.expect("ident")))
                self.expect("punct", ")")
            else:
                group.append(self.add_expr())
                while self.peek() == ("punct", ","):
                    self.next()
                    group.append(self.add_expr())
        having = None
        if self.peek() == ("kw", "having"):
            self.next()
            having = self.or_pred(having=True)
        if self.peek() == ("kw", "order"):
            self.next()
            self.expect("kw", "by")
            order.append(self.order_item())
            while self.peek() == ("punct", ","):
                self.next()
                order.append(self.order_item())
        if self.peek() == ("kw", "limit"):
            self.next()
            limit = int(self.expect("num"))
        offset = None
        if self._at_offset_clause():
            self.next()
            offset = int(self.expect("num"))
        return Query(
            items, distinct, table, joins, where, group, having, order,
            limit, table_alias=table_alias, offset=offset,
            group_mode=group_mode, grouping_sets=grouping_sets,
            lateral_views=lateral_views or None,
        )

    def join_clause(self) -> Optional[Join]:
        how = "inner"
        if self._at_cross_join():
            self.next()
            how = "cross"
            self.expect("kw", "join")
        elif self.peek() in (
            ("kw", "inner"), ("kw", "left"), ("kw", "right"),
            ("kw", "full"),
        ):
            how = self.next()[1]
            if how == "left" and self.peek()[0] == "ident" and self.peek()[
                1
            ].lower() in ("semi", "anti"):
                # contextual (like OFFSET): semi/anti stay usable as
                # column names everywhere else
                how = f"left_{self.next()[1].lower()}"
            elif how in ("left", "right", "full") and self.peek() == (
                "kw", "outer",
            ):
                self.next()
            if how == "full":
                how = "outer"
            self.expect("kw", "join")
        elif self.peek() == ("kw", "join"):
            self.next()
        else:
            return None
        if self.peek() == ("punct", "("):
            # derived table on the right: JOIN (SELECT ...) [AS] b ON ...
            self.next()
            table = self.parse_union()
            self.expect("punct", ")")
        else:
            table = self.expect("ident")
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif (
            self.peek()[0] == "ident"
            and not self._at_offset_clause()
            and not self._at_lateral_view()
            and not self._at_cross_join()
        ):
            alias = self.next()[1]
        if alias is None and not isinstance(table, str):
            raise ValueError(
                "A derived table in JOIN needs an alias: "
                "JOIN (SELECT ...) b ON ..."
            )
        if how == "cross":
            # keyless by definition — CROSS JOIN ... ON is a syntax
            # error in Spark too
            return Join(table, "cross", None, None, alias)
        self.expect("kw", "on")
        lk = self.expect("ident")
        self.expect("op", "=")
        rk = self.expect("ident")
        return Join(table, how, lk, rk, alias)

    def order_item(self) -> Tuple[Any, bool]:
        """ORDER BY key: plain columns stay strings (the common fast
        path); integer literals are select-item ordinals (ORDER BY 1);
        anything else is kept as an expression (ORDER BY price * qty,
        ORDER BY count(*) on grouped queries) and resolved at planning."""
        e = self.add_expr(top=True)
        asc = True
        if self.peek() in (("kw", "asc"), ("kw", "desc")):
            asc = self.next()[1] == "asc"
        if self.peek()[0] == "ident" and self.peek()[1].lower() == "nulls":
            # NULLS FIRST | NULLS LAST (contextual, like Spark): only
            # the ident 'nulls' in order-key tail position
            save = self.i
            self.next()
            k2, v2 = self.peek()
            if k2 in ("ident", "kw") and v2.lower() in ("first", "last"):
                self.next()
                asc = SortDir(asc, nulls_first=v2.lower() == "first")
            else:
                self.i = save  # a column named nulls? leave it alone
        if isinstance(e, Col):
            return e.name, asc
        return e, asc

    def select_item(self) -> SelectItem:
        if self.peek() == ("punct", "*"):
            self.next()
            return SelectItem("*", None)
        k, v = self.peek()
        if (
            k == "ident"
            and v.endswith(".")
            and self.toks[self.i + 1] == ("punct", "*")
        ):
            # qualified star: SELECT t.* / SELECT a.* (FROM t AS a)
            self.next()
            self.next()
            return SelectItem(QualifiedStar(v[:-1]), None)
        expr = self.add_expr(top=True)
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif self.peek()[0] == "ident":
            alias = self.next()[1]  # bare alias: SELECT f(x) emb
        return SelectItem(expr, alias)

    @staticmethod
    def _win_operand(e, what: str, allow_lit: bool = False):
        """A window operand (PARTITION BY / ORDER BY key, function
        argument): plain columns collapse to their name string (the
        common fast path); other expressions stay nodes and are
        materialized to hidden columns before the window computation."""
        if isinstance(e, Col):
            return e.name
        if isinstance(e, Lit) and not allow_lit:
            raise ValueError(
                f"window {what} must be a column or expression, not a "
                "literal"
            )
        if _contains_window(e):
            raise ValueError(f"window {what} cannot nest window functions")
        if _contains_aggregate(e):
            raise ValueError(f"window {what} cannot contain aggregates")
        return e

    def frame_bound(self, side: str, value_offsets: bool = False):
        """One bound of ROWS/RANGE BETWEEN, as an offset relative to the
        current row (None = unbounded on that side). ROWS offsets are
        row counts (ints); RANGE offsets (``value_offsets``) are
        ORDER-BY-value distances and may be fractional."""
        k, v = self.peek()
        if (k, v) == ("kw", "unbounded"):
            self.next()
            kw = self.next()[1]
            if side == "lo" and kw != "preceding":
                raise ValueError(
                    "the lower frame bound must be UNBOUNDED PRECEDING, "
                    "n PRECEDING/FOLLOWING, or CURRENT ROW"
                )
            if side == "hi" and kw != "following":
                raise ValueError(
                    "the upper frame bound must be UNBOUNDED FOLLOWING, "
                    "n PRECEDING/FOLLOWING, or CURRENT ROW"
                )
            return None
        if (k, v) == ("kw", "current"):
            self.next()
            self.expect("kw", "row")
            return 0
        neg = False
        if (k, v) == ("arith", "-"):
            self.next()
            neg = True
        raw = self.expect("num")
        n = float(raw) if value_offsets and "." in str(raw) else int(raw)
        if neg:
            raise ValueError("frame offsets must be non-negative")
        kw = self.next()
        if kw not in (("kw", "preceding"), ("kw", "following")):
            raise ValueError(
                f"Expected PRECEDING or FOLLOWING, got {kw[1]!r}"
            )
        return -n if kw[1] == "preceding" else n

    def window_spec(self, call) -> Window:
        if not isinstance(call, Call):
            raise ValueError("OVER must follow a function call")
        if getattr(call, "_params", None) is not None:
            # the Window node has no parameter channel; silently
            # defaulting the percentage would be worse than refusing
            raise ValueError(
                f"{call.fn.upper()} is not supported as a window "
                "function; compute it per group in a derived table"
            )
        if call.distinct:
            # the Window node has no distinct channel either
            raise ValueError(
                "DISTINCT aggregates are not supported as window "
                "functions"
            )
        self.expect("kw", "over")
        self.expect("punct", "(")
        partition: List[Any] = []
        if self.peek() == ("kw", "partition"):
            self.next()
            self.expect("kw", "by")
            while True:
                partition.append(
                    self._win_operand(self.add_expr(), "PARTITION BY key")
                )
                if self.peek() != ("punct", ","):
                    break
                self.next()
        order: List[Tuple[Any, bool]] = []
        if self.peek() == ("kw", "order"):
            self.next()
            self.expect("kw", "by")
            while True:
                key, asc = self.order_item()
                if not isinstance(key, str):
                    key = self._win_operand(key, "ORDER BY key")
                order.append((key, asc))
                if self.peek() != ("punct", ","):
                    break
                self.next()
        frame = None
        frame_kind = "rows"
        if self.peek() == ("kw", "range"):
            self.next()
            self.expect("kw", "between")
            lo = self.frame_bound("lo", value_offsets=True)
            self.expect("kw", "and")
            hi = self.frame_bound("hi", value_offsets=True)
            if lo is not None and hi is not None and lo > hi:
                raise ValueError(
                    "the lower frame bound cannot be beyond the upper"
                )
            if (lo, hi) == (None, 0):
                pass  # exactly the default ordered frame (Spark's)
            elif (lo, hi) == (None, None):
                frame = (None, None)  # whole partition: rows-equivalent
            else:
                # VALUE offsets: need exactly one ORDER BY key to
                # measure distance against (Spark's rule)
                if len(order) != 1:
                    raise ValueError(
                        "RANGE frames with value offsets require "
                        "exactly one ORDER BY key"
                    )
                frame = (lo, hi)
                frame_kind = "range"
        elif self.peek() == ("kw", "rows"):
            self.next()
            self.expect("kw", "between")
            lo = self.frame_bound("lo")
            self.expect("kw", "and")
            hi = self.frame_bound("hi")
            if lo is not None and hi is not None and lo > hi:
                raise ValueError(
                    "the lower frame bound cannot be beyond the upper"
                )
            frame = (lo, hi)
        self.expect("punct", ")")
        fn = call.fn.lower()
        offset, default = 1, None
        if fn in _RANKING_FNS:
            if call.all_args():
                raise ValueError(f"{fn}() takes no arguments")
            if not order:
                raise ValueError(
                    f"{fn}() requires ORDER BY in its window"
                )
            arg = None
        elif fn == "ntile":
            args = call.all_args()
            if (
                len(args) != 1
                or not isinstance(args[0], Lit)
                or not isinstance(args[0].value, int)
                or args[0].value < 1
            ):
                raise ValueError(
                    "ntile(n) needs one positive integer literal"
                )
            if not order:
                raise ValueError("ntile() requires ORDER BY in its window")
            arg = None
            offset = args[0].value  # bucket count rides the offset slot
        elif fn in _VALUE_FNS:
            args = call.all_args()
            if fn == "nth_value":
                if len(args) != 2:
                    raise ValueError(
                        "nth_value(expr, n) takes exactly two arguments"
                    )
                if (
                    not isinstance(args[1], Lit)
                    or not isinstance(args[1].value, int)
                    or args[1].value < 1
                ):
                    raise ValueError(
                        "nth_value n must be a positive integer literal"
                    )
                offset = args[1].value  # n rides the offset slot
            elif len(args) != 1:
                raise ValueError(
                    f"{fn}(expr) takes exactly one argument"
                )
            if not order:
                raise ValueError(
                    f"{fn}() requires ORDER BY in its window"
                )
            arg = self._win_operand(args[0], "argument", allow_lit=True)
        elif fn in _OFFSET_FNS:
            args = call.all_args()
            if not 1 <= len(args) <= 3:
                raise ValueError(
                    f"{fn}(expr[, offset[, default]]) takes one to "
                    "three arguments"
                )
            if not order:
                raise ValueError(
                    f"{fn}() requires ORDER BY in its window"
                )
            arg = self._win_operand(args[0], "argument")
            if len(args) >= 2:
                if not isinstance(args[1], Lit) or not isinstance(
                    args[1].value, int
                ):
                    raise ValueError(f"{fn}() offset must be an integer")
                offset = args[1].value
            if len(args) == 3:
                if not isinstance(args[2], Lit):
                    raise ValueError(f"{fn}() default must be a literal")
                default = args[2].value
        elif fn in _AGGREGATES:
            if call.distinct:
                raise ValueError(
                    "DISTINCT is not supported in window aggregates"
                )
            if call.arg == "*":
                if fn != "count":
                    raise ValueError(f"{fn.upper()}(*) is not valid SQL")
                arg = None
            else:
                arg = self._win_operand(
                    call.arg, "aggregate argument", allow_lit=True
                )
        else:
            raise ValueError(
                f"Unknown window function {call.fn!r}; supported: "
                f"{sorted(_RANKING_FNS | _VALUE_FNS | {'ntile'})}, "
                f"{sorted(_OFFSET_FNS)}, and {sorted(_AGGREGATES)}"
            )
        if frame is not None:
            if fn not in _AGGREGATES and fn not in _VALUE_FNS:
                raise ValueError(
                    f"ROWS/RANGE BETWEEN is not supported with {fn}()"
                )
            if not order:
                raise ValueError(
                    "ROWS/RANGE BETWEEN requires ORDER BY in its window"
                )
        return Window(
            fn, arg, partition, order, offset, default, frame, frame_kind
        )

    # -- arithmetic expression grammar (precedence: unary - > * / % > + -)

    def _bool_agg_arg(self, counting: bool) -> Expr:
        """bool_and/bool_or/every/count_if argument: a predicate
        (v > 1) or a boolean-valued expression. Predicates wrap in a
        CASE so the streaming engine sees True/False/null cells
        (unknown -> null -> skipped, Spark); count_if wraps as CASE
        WHEN p THEN 1 END so COUNT counts only true rows."""
        save = self.i
        p = None
        try:
            e = self.add_expr()
            if self.peek() == ("punct", ")"):
                if not counting:
                    return e  # boolean-valued column/expression
                p = Predicate(e, "=", True)
        except ValueError:
            pass
        if p is None:
            self.i = save
            p = self.or_pred()
        if counting:
            return Case([(p, Lit(1))], None)
        return Case([(p, Lit(True)), (NotOp(p), Lit(False))], None)

    def lambda_or_expr(self) -> Any:
        """A higher-order builtin's argument: ``x -> body``,
        ``(x, y) -> body``, or an ordinary expression. The body is a
        value expression, or — when trailing tokens show the value
        parse stopped early (x -> x > 2) — a predicate."""
        params = None
        if (
            self.peek()[0] == "ident"
            and self.toks[self.i + 1][0] == "arrow"
        ):
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
            if (
                ps
                and self.toks[j] == ("punct", ")")
                and self.toks[j + 1][0] == "arrow"
            ):
                if len(set(ps)) != len(ps):
                    raise ValueError(
                        f"Duplicate lambda parameter in ({', '.join(ps)})"
                    )
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
        except ValueError:
            pass
        if body is None:
            self.i = save  # value parse stopped early: predicate body
            body = self.or_pred()
        _validate_lambda_body(body)
        return Lambda(params, body)

    def add_expr(self, top: bool = False) -> Expr:
        # `top` (select-item position) propagates through the whole
        # operator chain: COUNT(*) is legal anywhere inside a top-level
        # item expression (SELECT sum(v) * 10 + count(*)), and stays
        # rejected in WHERE where top is False.
        e = self.mul_expr(top)
        while (
            self.peek()[0] == "arith" and self.peek()[1] in "+-"
        ) or self.peek()[0] == "concat":
            kind, op = self.next()
            rhs = self.mul_expr(top)
            if kind == "concat":
                # || is string concatenation (Spark): null propagates,
                # exactly the concat builtin's semantics
                e = Call("concat", e, False, [e, rhs])
            else:
                e = Arith(op, e, rhs)
        return e

    def mul_expr(self, top: bool = False) -> Expr:
        e = self.atom_expr(top)
        while self.peek() in (
            ("punct", "*"), ("arith", "/"), ("arith", "%"),
        ):
            op = self.next()[1]
            e = Arith(op, e, self.atom_expr(top))
        return e

    def atom_expr(self, top: bool = False) -> Expr:
        k, v = self.peek()
        if (k, v) == ("kw", "case"):
            return self.case_expr(top)
        if (k, v) == ("kw", "null"):
            # NULL literal in expression position (coalesce(NULL, v),
            # CASE ... ELSE NULL). Comparisons against it are never true
            # (SQL three-valued logic collapsed, as for null cells).
            self.next()
            return Lit(None)
        if (
            k == "ident"
            and v.lower() in ("true", "false")
            and not self._raw_quoted()
            and self.toks[self.i + 1] != ("punct", "(")
        ):
            # TRUE/FALSE literals (sort_array(a, false), flag = true);
            # contextual — `true` (backticks) is the COLUMN, and a
            # function named true() would still resolve
            self.next()
            return Lit(v.lower() == "true")
        if (k, v) == ("arith", "-"):
            self.next()
            inner = self.atom_expr(top)
            if isinstance(inner, Lit) and isinstance(
                inner.value, (int, float)
            ):
                return Lit(-inner.value)  # fold: -5 is a literal
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
                sub = self.parse_union()
                self.expect("punct", ")")
                return Subquery(sub)
            e = self.add_expr(top)
            self.expect("punct", ")")
            return e
        return self.expr(top)

    def case_expr(self, top: bool = False) -> Case:
        """CASE in both forms. Searched: WHEN takes a full predicate.
        Simple (CASE x WHEN v THEN r ...): desugars to the searched
        form with equality predicates — null operands never match any
        WHEN, exactly Spark's simple-CASE semantics. Aggregate
        placement rules follow the enclosing position via ``top``."""
        self.expect("kw", "case")
        operand = None
        if self.peek() != ("kw", "when"):
            operand = self.add_expr(top)
            _reject_udf_calls(operand, allow_agg=top)
            if self.peek() != ("kw", "when"):
                raise ValueError(
                    "Expected WHEN after the CASE operand"
                )
        branches = []
        while self.peek() == ("kw", "when"):
            self.next()
            if operand is not None:
                cmp_val = self.add_expr(top)
                _reject_udf_calls(cmp_val, allow_agg=top)
                pred = Predicate(operand, "=", cmp_val)
            else:
                # in select-item position the condition may compare
                # aggregates (CASE WHEN count(*) > 1 ...), like THEN
                pred = self.or_pred(allow_agg=top)
            self.expect("kw", "then")
            branches.append((pred, self.add_expr(top)))
        default = None
        if self.peek() == ("kw", "else"):
            self.next()
            default = self.add_expr(top)
        self.expect("kw", "end")
        return Case(branches, default)

    def _maybe_agg_filter(self, call: Call) -> Call:
        """agg(x) FILTER (WHERE p) rewrites to agg(CASE WHEN p THEN x
        END): every aggregate skips nulls, which is exactly FILTER's
        semantics (COUNT(*) counts a literal 1 instead). FILTER is a
        CONTEXTUAL keyword — only special immediately after an aggregate
        call, so columns named filter stay reachable."""
        if call.fn.lower() not in _AGGREGATES:
            return call
        k, v = self.peek()
        if k != "ident" or v.lower() != "filter":
            return call
        save = self.i
        self.next()
        if self.peek() != ("punct", "("):
            self.i = save  # a column named filter in alias position
            return call
        self.next()
        self.expect("kw", "where")
        pred = self.or_pred()
        self.expect("punct", ")")
        if call.arg == "*":
            arg = Case([(pred, Lit(1))], None)
            return Call("count", arg, False, [arg])
        arg = Case([(pred, call.arg)], None)
        out = Call(call.fn, arg, call.distinct, [arg])
        if getattr(call, "_params", None) is not None:
            out._params = call._params  # percentile(v, p) FILTER (...)
        return out

    def expr(self, top: bool = False) -> Expr:
        kind, val = self.next()
        if (
            kind == "kw"
            and val in ("exists", "left", "right")
            and self.peek() == ("punct", "(")
        ):
            # keyword/function clashes, disambiguated by the '(':
            # exists(arr, x -> ...) vs EXISTS (SELECT) (consumed by
            # pred_atom first); left(s, n)/right(s, n) vs LEFT JOIN
            kind = "ident"
        if kind != "ident":
            raise ValueError(f"Expected column or function, got {val!r}")
        if self.peek() == ("punct", "("):
            self.next()
            if val.lower() == "try_cast":
                # this dialect's CAST is already non-ANSI (null on
                # error), so TRY_CAST is the same operation
                val = "cast"
            if val.lower() == "cast":
                # CAST(expr AS type): dedicated rule (the AS inside the
                # parens is the cast grammar, not an alias); evaluates
                # as a builtin over (arg, type-literal)
                arg = self.add_expr(top)
                self.expect("kw", "as")
                ty = self.expect("ident").lower()
                if ty not in _CAST_TYPES:
                    raise ValueError(
                        f"Unsupported CAST type {ty!r}; supported: "
                        f"{sorted(_CAST_TYPES)}"
                    )
                self.expect("punct", ")")
                return Call("cast", arg, False, [arg, Lit(ty)])
            if val.lower() == "extract":
                # EXTRACT(FIELD FROM expr): dedicated grammar like CAST
                field = self.expect("ident").lower()
                fn_e = _EXTRACT_FIELDS.get(field)
                if fn_e is None:
                    raise ValueError(
                        f"Unsupported EXTRACT field {field!r}; "
                        f"supported: {sorted(_EXTRACT_FIELDS)}"
                    )
                self.expect("kw", "from")
                arg = self.add_expr(top)
                self.expect("punct", ")")
                return Call(fn_e, arg, False, [arg])
            if self.peek() == ("punct", ")"):
                # zero-argument call: a window ranking function
                # (row_number() OVER ...) or a zero-arg builtin
                # (current_date())
                self.next()
                call = Call(val, None, False, [])
                if self.peek() == ("kw", "over"):
                    return self.window_spec(call)
                fn0 = val.lower()
                if fn0 in _BUILTIN_FNS and _BUILTIN_FNS[fn0][0] == 0:
                    return Call(fn0, None, False, [])
                raise ValueError(
                    f"{val}() takes at least one argument "
                    "(zero-argument calls are window ranking functions "
                    "and need an OVER clause)"
                )
            if val.lower() in _AGGREGATES and self.peek() == ("punct", "*"):
                if not top:
                    raise ValueError(
                        f"{val.upper()}(*) is only allowed as a "
                        "top-level select item"
                    )
                self.next()
                self.expect("punct", ")")
                # non-count star aggregates are rejected at planning
                call = self._maybe_agg_filter(Call(val.lower(), "*"))
                if self.peek() == ("kw", "over"):
                    return self.window_spec(call)
                return call
            distinct = False
            if self.peek() == ("kw", "distinct"):
                if val.lower() not in ("count", "sum"):
                    raise ValueError(
                        f"DISTINCT is only supported in COUNT(DISTINCT "
                        f"col) and SUM(DISTINCT col), not {val.upper()}"
                    )
                self.next()
                distinct = True
            if val.lower() in ("bool_and", "bool_or", "every", "count_if"):
                # boolean aggregates take a CONDITION argument
                # (bool_and(v > 1)) or a boolean-valued expression
                arg = self._bool_agg_arg(val.lower() == "count_if")
                self.expect("punct", ")")
                fn_b = "count" if val.lower() == "count_if" else val.lower()
                call = self._maybe_agg_filter(Call(fn_b, arg, False, [arg]))
                if self.peek() == ("kw", "over"):
                    return self.window_spec(call)
                return call
            if val.lower() in _HIGHER_ORDER_FNS:
                # arguments may be lambdas: x -> expr | (x, y) -> expr
                args = [self.lambda_or_expr()]
                while self.peek() == ("punct", ","):
                    self.next()
                    args.append(self.lambda_or_expr())
                self.expect("punct", ")")
                fn = val.lower()
                lo, hi = _HIGHER_ORDER_FNS[fn]
                if not lo <= len(args) <= hi:
                    raise ValueError(
                        f"{val.upper()} takes "
                        f"{lo if hi == lo else f'{lo}..{hi}'} "
                        f"argument(s), got {len(args)}"
                    )
                if not any(isinstance(a, Lambda) for a in args):
                    raise ValueError(
                        f"{val.upper()} requires a lambda argument "
                        "(x -> ...)"
                    )
                if isinstance(args[0], Lambda):
                    raise ValueError(
                        f"{val.upper()}'s first argument is the "
                        "collection, not the lambda"
                    )
                return Call(fn, args[0], False, args)
            args = [self.add_expr()]
            while self.peek() == ("punct", ","):
                self.next()
                args.append(self.add_expr())
            self.expect("punct", ")")
            fn = val.lower()
            if (
                fn in ("timestampadd", "timestampdiff")
                and args
                and isinstance(args[0], Col)
                and "." not in args[0].name
            ):
                # the unit is a BARE keyword in Spark's grammar
                # (timestampadd(HOUR, 3, ts)) — it parsed as a column
                # ref; rewrite to the unit literal ('HOUR' works too)
                args[0] = Lit(args[0].name)
            if fn in _PAIR_AGGS:
                if len(args) != 2:
                    raise ValueError(
                        f"{val.upper()} takes exactly two arguments"
                    )
                # pack the pair into one array(x, y) cell — nulls stay
                # elements, so the accumulator can drop incomplete
                # observations (Spark)
                packed = Call("array", args[0], False, args)
                call = self._maybe_agg_filter(Call(fn, packed, False, [packed]))
                if self.peek() == ("kw", "over"):
                    return self.window_spec(call)
                return call
            if fn in _PARAM_AGGS:
                if not 2 <= len(args) <= 3:
                    raise ValueError(
                        f"{val.upper()} takes 2..3 arguments "
                        "(value, percentage[, accuracy])"
                    )
                pct = args[1]
                if isinstance(pct, Call) and pct.fn.lower() == "array":
                    if not all(isinstance(a, Lit) for a in pct.all_args()):
                        raise ValueError(
                            f"{val.upper()}'s percentage array must be "
                            "numeric literals"
                        )
                    pct_v = [float(a.value) for a in pct.all_args()]
                elif isinstance(pct, Lit):
                    pct_v = float(pct.value)
                else:
                    raise ValueError(
                        f"{val.upper()}'s percentage must be a literal "
                        "(or array of literals), not an expression"
                    )
                bad = (
                    [p for p in pct_v if not 0 <= p <= 1]
                    if isinstance(pct_v, list)
                    else ([] if 0 <= pct_v <= 1 else [pct_v])
                )
                if bad:
                    raise ValueError(
                        f"{val.upper()} percentage must be in [0, 1], "
                        f"got {bad[0]}"
                    )
                # accuracy (3rd arg) is accepted and ignored — the
                # engine computes exactly
                call = Call(fn, args[0], False, [args[0]])
                call._params = [pct_v]
                call = self._maybe_agg_filter(call)
                if self.peek() == ("kw", "over"):
                    return self.window_spec(call)
                return call
            if fn in _AGGREGATES and len(args) > 1:
                raise ValueError(
                    f"{val.upper()} takes exactly one argument"
                )
            if fn in _BUILTIN_FNS:
                lo, hi, _ = _BUILTIN_FNS[fn]
                if len(args) < lo or (hi is not None and len(args) > hi):
                    raise ValueError(
                        f"{val.upper()} takes "
                        f"{lo if hi == lo else f'{lo}..{hi or chr(8734)}'} "
                        f"argument(s), got {len(args)}"
                    )
            elif fn in _NULL_SAFE_FNS:
                if fn == "coalesce" and len(args) < 2:
                    raise ValueError("COALESCE needs at least two arguments")
                if fn in ("ifnull", "nvl") and len(args) != 2:
                    raise ValueError(
                        f"{val.upper()} takes exactly two arguments"
                    )
            elif fn in _NULL_SKIP_FNS:
                if len(args) < 2:
                    raise ValueError(
                        f"{val.upper()} needs at least two arguments"
                    )
            call = self._maybe_agg_filter(Call(val, args[0], distinct, args))
            if self.peek() == ("kw", "over"):
                # window binds at the CALL, so it composes with
                # arithmetic: v * 100 / sum(v) OVER (PARTITION BY g)
                return self.window_spec(call)
            return call
        return Col(val)

    def or_pred(self, having: bool = False, allow_agg: bool = False):
        parts = [self.and_pred(having, allow_agg)]
        while self.peek() == ("kw", "or"):
            self.next()
            parts.append(self.and_pred(having, allow_agg))
        return parts[0] if len(parts) == 1 else BoolOp("or", parts)

    def and_pred(self, having: bool = False, allow_agg: bool = False):
        parts = [self.pred_atom(having, allow_agg)]
        while self.peek() == ("kw", "and"):
            self.next()
            parts.append(self.pred_atom(having, allow_agg))
        return parts[0] if len(parts) == 1 else BoolOp("and", parts)

    def pred_atom(self, having: bool = False, allow_agg: bool = False):
        if self.peek() == ("kw", "exists") or (
            self.peek() == ("kw", "not")
            and self.toks[self.i + 1] == ("kw", "exists")
        ):
            # [NOT] EXISTS (SELECT ...): uncorrelated — the subquery
            # resolves ONCE to a constant truth value before planning
            save = self.i
            neg = self.peek() == ("kw", "not")
            if neg:
                self.next()
            self.next()
            self.expect("punct", "(")
            if self.peek() == ("kw", "select"):
                if having:
                    raise ValueError("EXISTS is not supported in HAVING")
                sub = self.parse_union()
                self.expect("punct", ")")
                return Predicate(
                    None, "notexists" if neg else "exists", sub
                )
            # the higher-order builtin exists(arr, x -> ...): reparse —
            # bare form as an ordinary comparison predicate (the HOF is
            # a scalar builtin, legal in HAVING too); the NOT form
            # falls THROUGH to the prefix-NOT branch, which wraps the
            # same parse in a NotOp
            self.i = save
            if not neg:
                return self.predicate(having, allow_agg)
        if self.peek() == ("kw", "not"):
            # prefix NOT over any predicate atom: NOT (a = 1 OR b = 2),
            # NOT x LIKE 'a%', NOT NOT p — three-valued via NotOp.
            # (NOT EXISTS was consumed above; the infix spellings
            # x NOT IN/BETWEEN/LIKE start with an operand, not NOT.)
            self.next()
            return NotOp(self.pred_atom(having, allow_agg))
        if self.peek() == ("punct", "("):
            # '(' is ambiguous: a predicate group `(a > 1 OR b > 2)` or a
            # parenthesized arithmetic lhs `(price + 1) * 2 > 6`. Try the
            # group parse first and backtrack on failure (the parser is
            # pure over the token list, so resetting the cursor is safe).
            save = self.i
            try:
                self.next()
                inner = self.or_pred(having, allow_agg)
                self.expect("punct", ")")
                if self.peek()[0] in ("op", "arith") or self.peek() == (
                    "punct", "*",
                ):
                    raise ValueError("parenthesized expression")
                return inner
            except ValueError:
                self.i = save
        return self.predicate(having, allow_agg)

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
            # IN (1, NULL) is legal; NOT IN over a set with NULL is
            # never true (handled at evaluation), BETWEEN with a NULL
            # bound is never true
            return None
        raise ValueError(f"Expected literal, got {vv!r}")

    def predicate(
        self, having: bool = False, allow_agg: bool = False
    ) -> Predicate:
        # HAVING operands may be aggregate calls (COUNT(*) > 2) or
        # select-list aliases; WHERE operands are expressions over
        # columns and literals (column-vs-column and arithmetic forms);
        # CASE conditions in select-item position (allow_agg) may also
        # compare aggregates.
        if having:
            # full expression grammar over aggregated rows:
            # HAVING sum(v) / count(*) > 2, HAVING length(k) > 1
            lhs = self.add_expr(top=True)
            col = lhs.name if isinstance(lhs, Col) else lhs
        else:
            lhs = self.add_expr(top=allow_agg)
            _reject_udf_calls(lhs, allow_agg)
            col = lhs.name if isinstance(lhs, Col) else lhs
        if (
            isinstance(lhs, Call)
            and lhs.fn.lower() in _BOOLEAN_FNS
            and self.peek()[0] not in ("op",)
            and self.peek() not in (
                ("kw", "not"), ("kw", "is"), ("kw", "in"),
                ("kw", "between"), ("kw", "like"),
            )
            and not (
                self.peek()[0] == "ident"
                and self.peek()[1].lower() in ("rlike", "regexp")
            )
        ):
            # a BOOLEAN builtin standing alone as the condition:
            # WHERE exists(a, x -> x = 2) — sugar for `= TRUE`
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
            k2, v2 = self.peek()
            if (k2, v2) == ("kw", "distinct"):
                # IS [NOT] DISTINCT FROM: null-safe inequality/equality
                # — IS NOT DISTINCT FROM is exactly <=> (Spark)
                self.next()
                self.expect("kw", "from")
                rhs = self.add_expr(top=allow_agg)
                _reject_udf_calls(rhs, allow_agg)
                if isinstance(rhs, Lit):
                    rhs = rhs.value
                eq = Predicate(col, "<=>", rhs)
                return eq if neg_is else NotOp(eq)
            self.expect("kw", "null")
            return Predicate(col, "notnull" if neg_is else "isnull")
        if (kind, val) == ("kw", "in"):
            self.expect("punct", "(")
            if self.peek() == ("kw", "select"):
                if having:
                    raise ValueError(
                        "IN (SELECT ...) is not supported in HAVING"
                    )
                sub = self.parse_union()
                self.expect("punct", ")")
                return Predicate(col, "notin" if negate else "in", sub)
            def in_element():
                e = self.add_expr(top=allow_agg)
                _reject_udf_calls(e, allow_agg)
                return e

            elems = [in_element()]
            while self.peek() == ("punct", ","):
                self.next()
                elems.append(in_element())
            self.expect("punct", ")")
            if all(isinstance(e, Lit) for e in elems):
                # literal-only list: O(1) membership dispatch
                items: Any = [e.value for e in elems]
            else:
                # expression elements (IN (v + 1, other_col)) evaluate
                # per row — same machinery as the Column API's isin
                items = DynItems(
                    e.value if isinstance(e, Lit) else e for e in elems
                )
            return Predicate(col, "notin" if negate else "in", items)
        if (kind, val) == ("kw", "between"):
            # full expression bounds (BETWEEN lo_col AND price * 2);
            # the arithmetic grammar stops at the keyword AND, so
            # BETWEEN's AND binds greedily as before. Literal bounds
            # collapse to raw values — the evaluator's fast path.
            lo = self.add_expr(top=allow_agg)
            _reject_udf_calls(lo, allow_agg)
            self.expect("kw", "and")
            hi = self.add_expr(top=allow_agg)
            _reject_udf_calls(hi, allow_agg)
            if isinstance(lo, Lit):
                lo = lo.value
            if isinstance(hi, Lit):
                hi = hi.value
            return Predicate(
                col, "notbetween" if negate else "between", (lo, hi)
            )
        if (kind, val) == ("kw", "like"):
            if self.peek()[0] != "str":
                raise ValueError("LIKE needs a string pattern")
            pat = self.literal()
            return Predicate(col, "notlike" if negate else "like", pat)
        if kind == "ident" and val.lower() == "ilike":
            # CONTEXTUAL like rlike: case-insensitive LIKE (Spark 3.3)
            if self.peek()[0] != "str":
                raise ValueError("ILIKE needs a string pattern")
            pat = self.literal()
            return Predicate(col, "notilike" if negate else "ilike", pat)
        if kind == "ident" and val.lower() in ("rlike", "regexp"):
            # CONTEXTUAL (non-reserved, like Spark): only an ident
            # rlike/regexp in operator position followed by a string
            # pattern is the predicate; columns with these names parse
            # as ordinary identifiers everywhere else
            if self.peek()[0] != "str":
                raise ValueError("RLIKE needs a string pattern")
            pat = self.literal()
            _compile_rlike(pat)  # invalid regex fails at PARSE time
            return Predicate(col, "notrlike" if negate else "rlike", pat)
        if negate:
            raise ValueError(
                "NOT is only supported as NOT IN / NOT BETWEEN / "
                "NOT LIKE / NOT RLIKE"
            )
        if kind != "op":
            raise ValueError(f"Expected comparison after {col!r}")
        if having:
            rhs = self.add_expr(top=True)
            if isinstance(rhs, Lit):
                rhs = rhs.value
        else:
            # rhs is a full expression: literal, column (column-vs-column
            # predicates), or arithmetic. Bare literals collapse to their
            # value; everything else stays an expr node for row-time eval.
            rhs = self.add_expr(top=allow_agg)
            _reject_udf_calls(rhs, allow_agg)
            if isinstance(rhs, Lit):
                rhs = rhs.value
        return Predicate(col, "<>" if val == "!=" else val, rhs)


# ---------------------------------------------------------------------------
# Execution
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


def _reject_udf_calls(e: Expr, allow_agg: bool = False) -> None:
    """Reject AGGREGATES in predicate positions (WHERE / CASE WHEN
    conditions) at parse time; aggregates are allowed only in
    select-item-position CASE conditions (``allow_agg``), where the
    GROUP BY planner evaluates them. Catalog-UDF calls are NOT rejected
    here any more: the planner materializes them to batched temp
    columns (``_materialize_pred_calls``) at execution, so
    ``WHERE my_udf(x) > 0`` works like Spark."""
    if isinstance(e, Call):
        if e.fn.lower() in _GENERATOR_FNS:
            raise ValueError(
                f"{e.fn.lower()}() is a generator and only works as a "
                "TOP-LEVEL select item, not in WHERE/conditions"
            )
        if e.fn.lower() in _AGGREGATES:
            if not allow_agg:
                raise ValueError(
                    f"Aggregate {_expr_name(e)} is not allowed in WHERE "
                    "(use HAVING, or a CASE condition in the select list)"
                )
            return  # aggregate args may hold UDF calls — materialized
        if _is_builtin_call(e):  # host row-wise, fine in predicates
            for a in e.all_args():
                _reject_udf_calls(a, allow_agg)
            return
        # catalog-UDF call: allowed; the planner materializes it to a
        # batched temp column before row-wise predicate evaluation
        for a in e.all_args():
            if a != "*":
                _reject_udf_calls(a, allow_agg)
        return
    if isinstance(e, Window):
        if allow_agg:
            return  # select-item CASE conditions may compare windows
        raise ValueError(
            "Window functions are not allowed in WHERE/HAVING; compute "
            "them in a derived table and filter on the alias outside "
            "(the top-N-per-group pattern)"
        )
    if isinstance(e, Arith):
        _reject_udf_calls(e.left, allow_agg)
        if e.right is not None:
            _reject_udf_calls(e.right, allow_agg)
    if isinstance(e, Case):
        for _, ex in e.branches:
            _reject_udf_calls(ex, allow_agg)
        if e.default is not None:
            _reject_udf_calls(e.default, allow_agg)


def _eval_expr_row(e: Expr, row):
    """Row-at-a-time expression evaluation (Col/Lit/Arith only — Call
    subtrees are materialized to columns before this runs). Spark null
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
    lambda-body restriction: catalog UDFs, aggregates, windows, and
    subqueries must fail HERE with a named error, not as an opaque
    partition-task crash at execution."""
    if isinstance(body, Window):
        raise ValueError(
            "Window functions are not allowed inside lambda bodies"
        )
    if isinstance(body, Subquery):
        raise ValueError("Subqueries are not allowed inside lambda bodies")
    if isinstance(body, Lambda):
        _validate_lambda_body(body.body)
        return
    if isinstance(body, Call):
        if body.fn.lower() in _AGGREGATES:
            raise ValueError(
                f"Aggregate {body.fn.upper()} is not allowed inside "
                "lambda bodies"
            )
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
    columns (no catalog UDFs, subqueries, or windows inside bodies)."""
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


def _iter_windows(e: Expr):
    """Yield every Window node in an expression tree, INCLUDING those in
    CASE conditions (one traversal shared by detection and planning)."""
    if isinstance(e, Window):
        yield e
    elif isinstance(e, Arith):
        yield from _iter_windows(e.left)
        if e.right is not None:
            yield from _iter_windows(e.right)
    elif isinstance(e, Case):
        for p, x in e.branches:
            yield from _iter_pred_windows(p)
            yield from _iter_windows(x)
        if e.default is not None:
            yield from _iter_windows(e.default)
    elif isinstance(e, Call) and e.arg != "*":
        for a in e.all_args():
            yield from _iter_windows(a)


def _iter_pred_windows(node):
    if isinstance(node, NotOp):
        yield from _iter_pred_windows(node.part)
        return
    if isinstance(node, BoolOp):
        for p in node.parts:
            yield from _iter_pred_windows(p)
        return
    if not isinstance(node.col, str):
        yield from _iter_windows(node.col)
    for v in _pred_value_exprs(node.value):
        yield from _iter_windows(v)


def _pred_value_exprs(value):
    """Every expression node inside a Predicate's value slot: a single
    operand, BETWEEN's (lo, hi) tuple, or an IN list with expression
    elements (DynItems) — one walker shared by the window / catalog-UDF
    / aggregate detectors so none forgets a slot."""
    if isinstance(value, (Col, Lit, Arith, Case, Call, Window)):
        yield value
    elif isinstance(value, tuple) or isinstance(value, DynItems):
        for v in value:
            if isinstance(v, (Col, Lit, Arith, Case, Call, Window)):
                yield v


def _contains_window(e: Expr) -> bool:
    return next(_iter_windows(e), None) is not None


def _contains_catalog_call(e: Expr) -> bool:
    """Any catalog-UDF call (non-builtin, non-aggregate Call) in the
    tree: such calls dispatch partition-vectorized through
    ``_apply_expr``, never through the row-wise evaluator — the Column
    API uses this to pick the right application path. Window nodes are
    deliberately not descended: their operand expressions materialize
    through _apply_expr inside the window engine, which handles
    catalog calls itself."""
    return next(_iter_catalog_calls(e), None) is not None


def _iter_catalog_calls(e: Expr):
    """Yield every catalog-UDF Call node in an expression tree."""
    if isinstance(e, Call):
        if e.arg == "*":
            return
        if not _is_builtin_call(e) and e.fn.lower() not in _AGGREGATES:
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


_GENERATOR_FNS = ("explode", "explode_outer", "stack", "json_tuple")

# EXTRACT(FIELD FROM expr) -> the equivalent date-part builtin
_EXTRACT_FIELDS = {
    "year": "year", "yearofweek": "year", "quarter": "quarter",
    "month": "month", "mon": "month", "week": "weekofyear",
    "day": "dayofmonth", "dd": "dayofmonth",
    "dayofweek": "dayofweek", "dow": "dayofweek",
    "doy": "dayofyear", "hour": "hour", "minute": "minute",
    "second": "second",
}


def _contains_generator(e: Expr) -> bool:
    """A generator call anywhere in the tree (explode produces rows,
    so it can only be a TOP-LEVEL select item)."""
    if isinstance(e, Call):
        if e.fn.lower() in _GENERATOR_FNS:
            return True
        return e.arg != "*" and any(
            _contains_generator(a) for a in e.all_args()
        )
    if isinstance(e, Arith):
        return _contains_generator(e.left) or (
            e.right is not None and _contains_generator(e.right)
        )
    if isinstance(e, Case):
        return any(
            _contains_generator(x) for _, x in e.branches
        ) or (e.default is not None and _contains_generator(e.default))
    return False


def _peer_runs(idxs, w, sort_key):
    """Yield (lo, hi) ranges of ORDER-BY peers (equal sort keys) within
    a window partition's sorted index list — the granularity of Spark's
    default RANGE frame."""
    keys = [
        tuple(sort_key(i, c) for c, _ in w.order_by) for i in idxs
    ]
    lo = 0
    while lo < len(idxs):
        hi = lo
        while hi + 1 < len(idxs) and keys[hi + 1] == keys[lo]:
            hi += 1
        yield lo, hi
        lo = hi + 1


def _eval_pred3(node, row) -> Optional[bool]:
    """SQL three-valued predicate evaluation: True / False / None
    (unknown). WHERE keeps only True rows (see :func:`_eval_pred`); the
    Column API's filter does the same collapse, which makes ~(x > 3)
    drop null-x rows, exactly Spark's semantics."""
    if isinstance(node, NotOp):
        b = _eval_pred3(node.part, row)
        return None if b is None else not b
    if isinstance(node, Predicate) and node.op == "const":
        # a resolved [NOT] EXISTS subquery
        return bool(node.value)
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
    the same text — used for aggregate-arg column keying)."""
    if isinstance(node, NotOp):
        return f"(NOT {_pred_name(node.part)})"
    if isinstance(node, Predicate) and node.op == "const":
        return "TRUE" if node.value else "FALSE"
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
    if isinstance(e, Window):
        def opname(c):
            return c if isinstance(c, str) else _expr_name(c)

        if e.fn in _RANKING_FNS:
            inner = ""
        elif e.fn == "ntile":
            inner = str(e.offset)
        elif e.fn in _OFFSET_FNS or e.fn == "nth_value":
            inner = f"{opname(e.arg)}, {e.offset}"
            if e.default is not None:
                inner += f", {e.default!r}"
        else:
            inner = opname(e.arg) if e.arg is not None else "*"
        spec = []
        if e.partition_by:
            spec.append(
                "PARTITION BY " + ", ".join(opname(c) for c in e.partition_by)
            )
        if e.order_by:
            spec.append(
                "ORDER BY "
                + ", ".join(
                    opname(c) + ("" if a else " DESC")
                    for c, a in e.order_by
                )
            )
        if e.frame is not None:
            def bound(v, side):
                if v is None:
                    return (
                        "UNBOUNDED PRECEDING"
                        if side == "lo"
                        else "UNBOUNDED FOLLOWING"
                    )
                if v == 0:
                    return "CURRENT ROW"
                return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"

            spec.append(
                f"{e.frame_kind.upper()} BETWEEN "
                f"{bound(e.frame[0], 'lo')} AND "
                f"{bound(e.frame[1], 'hi')}"
            )
        return f"{e.fn}({inner}) OVER ({' '.join(spec)})"
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
    # aggregate names normalize to lowercase (Spark's default naming);
    # UDF names keep their registered casing
    fn = e.fn.lower() if e.fn.lower() in _AGGREGATES else e.fn
    if e.arg == "*":
        return f"{fn}(*)"
    if getattr(e, "distinct", False):
        return f"{fn}(DISTINCT {_expr_name(e.arg)})"
    return f"{fn}({', '.join(_expr_name(a) for a in e.all_args())})"


def _check_expr_columns(e, columns) -> None:
    """Plan-time validation shared by the SQL planner and the Column
    API: every Col leaf must name an existing column — a typo must
    fail at planning, not surface as a retried partition task."""
    if isinstance(e, Col):
        if e.name not in columns:
            raise KeyError(f"Unknown column {e.name!r} in aggregate")
    elif isinstance(e, Arith):
        _check_expr_columns(e.left, columns)
        if e.right is not None:
            _check_expr_columns(e.right, columns)
    elif isinstance(e, Case):
        for pred, ex in e.branches:
            _check_pred_columns(pred, columns)
            _check_expr_columns(ex, columns)
        if e.default is not None:
            _check_expr_columns(e.default, columns)
    elif isinstance(e, Call) and e.arg != "*":
        for a in e.all_args():
            _check_expr_columns(a, columns)


def _check_pred_columns(node, columns) -> None:
    if isinstance(node, NotOp):
        _check_pred_columns(node.part, columns)
        return
    if isinstance(node, BoolOp):
        for p in node.parts:
            _check_pred_columns(p, columns)
        return
    if isinstance(node.col, str):
        if node.col not in columns:
            raise KeyError(f"Unknown column {node.col!r} in aggregate")
    else:
        _check_expr_columns(node.col, columns)
    if isinstance(node.value, (Col, Lit, Arith, Case, Call)):
        _check_expr_columns(node.value, columns)


def _is_aggregate(e: Expr) -> bool:
    """A single aggregate call: COUNT(*) or agg over a non-aggregate
    expression (SUM(price * qty) included — the arg is materialized as a
    column before the streamed aggregation)."""
    return (
        isinstance(e, Call)
        and e.fn.lower() in _AGGREGATES
        and (e.arg == "*" or not _contains_aggregate(e.arg))
    )


def _contains_aggregate(e: Expr) -> bool:
    if isinstance(e, Call):
        if e.fn.lower() in _AGGREGATES:
            return True
        return any(
            a != "*" and _contains_aggregate(a) for a in e.all_args()
        )
    if isinstance(e, Arith):
        return _contains_aggregate(e.left) or (
            e.right is not None and _contains_aggregate(e.right)
        )
    if isinstance(e, Case):
        # branch results AND conditions can hold aggregates (select-item
        # CASE conditions parse with allow_agg)
        return any(
            _pred_contains_aggregate(p) or _contains_aggregate(x)
            for p, x in e.branches
        ) or (e.default is not None and _contains_aggregate(e.default))
    return False


def _pred_contains_aggregate(node) -> bool:
    if isinstance(node, NotOp):
        return _pred_contains_aggregate(node.part)
    if isinstance(node, BoolOp):
        return any(_pred_contains_aggregate(p) for p in node.parts)
    if not isinstance(node.col, str) and _contains_aggregate(node.col):
        return True
    return any(
        _contains_aggregate(v) for v in _pred_value_exprs(node.value)
    )


# Aggregation (null semantics + the partition-streamed engine) lives in one
# place, shared with the DataFrame groupBy().agg() API.
from sparkdl_tpu_torch.dataframe.frame import (
    streaming_group_agg as _streaming_group_agg,
)


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
        if e.fn.lower() in _AGGREGATES:
            # unreachable from sql(): items containing aggregates route
            # to _aggregate and WHERE rejects calls — guards direct API
            # callers only
            raise ValueError(
                f"Aggregate {_expr_name(e)} cannot be materialized as a "
                "per-row column; aggregate queries go through the "
                "GROUP BY planner"
            )
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
    bound (subqueries, unknown kinds) — the pushdown pass then skips its
    optimization rather than guess. A window reads its argument, its
    PARTITION BY and its ORDER BY operands. Lambda parameters shadow
    frame columns (Spark scoping), so a HOF body contributes its free
    names only."""
    if e is None or e == "*" or isinstance(e, Lit):
        return True
    if isinstance(e, Col):
        out.add(e.name)
        return True
    if isinstance(e, Window):
        operands = [e.arg, *e.partition_by, *(c for c, _ in e.order_by)]
        for c in operands:
            if isinstance(c, str):
                out.add(c)
            elif not _expr_columns(c, out):
                return False
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
        if e.arg == "*":
            return True  # COUNT(*) reads rows, not a column
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
    if node.op == "const":
        return True  # resolved [NOT] EXISTS: reads nothing
    if isinstance(node.col, str):
        out.add(node.col)
    elif not _expr_columns(node.col, out):
        return False
    value = node.value
    if isinstance(value, (Col, Lit, Arith, Case, Call, Window)):
        return _expr_columns(value, out)
    if isinstance(value, tuple) or isinstance(value, DynItems):
        return all(
            _expr_columns(v, out)
            for v in value
            if isinstance(v, (Col, Lit, Arith, Case, Call, Window))
        )
    return True  # plain literal / literal IN-list / None


def _query_referenced_columns(q: "Query", windows: bool = False) -> Optional[set]:
    """The full set of source columns a star-free query can read — select
    items, LATERAL VIEW arguments, WHERE, GROUP BY (incl. grouping sets),
    HAVING, ORDER BY — or None when any expression defeats static analysis
    and scan pruning must be skipped. ORDER BY string keys may name select
    aliases rather than source columns; they are included as-is (the
    caller prunes by intersection with the frame's real columns, so an
    alias name is harmless). A window item declines, as in the JAX package
    (the window engine's collect guard then reads the unpruned scan),
    unless ``windows``: a join input counts the window's argument,
    PARTITION BY and ORDER BY operands."""
    cols: set = set()
    for it in q.items:
        if it.expr == "*" or isinstance(it.expr, QualifiedStar):
            return None
        if not windows and _contains_window(it.expr):
            return None
        if not _expr_columns(it.expr, cols):
            return None
    for _fn, arg, *_rest in q.lateral_views or []:
        if not _expr_columns(arg, cols):
            return None
    if q.where is not None and not _pred_columns(q.where, cols):
        return None
    if q.having is not None and not _pred_columns(q.having, cols):
        return None
    for g in q.group:
        if isinstance(g, str):
            cols.add(g)
        elif not _expr_columns(g, cols):
            return None
    for gs in q.grouping_sets or []:
        cols.update(gs)
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
    if e.fn.lower() in _AGGREGATES:
        raise ValueError(
            f"Aggregate {e.fn.upper()} is not allowed in nested "
            "expression position"
        )
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
    """Table registry + query entry point (the SparkSession.sql analogue).

    A module-level default instance backs :func:`sql` /
    :func:`registerDataFrameAsTable` for the common single-context case.
    """

    def __init__(self) -> None:
        self._tables: Dict[str, DataFrame] = {}
        self._lock = threading.Lock()
        # per-thread CTE overlay (WITH name AS ...): consulted before
        # the registered tables, alive only for the enclosing sql() call
        self._cte = threading.local()

    def registerDataFrameAsTable(self, df: DataFrame, name: str) -> None:
        with self._lock:
            self._tables[name] = df

    def _register_if_absent(self, df: DataFrame, name: str) -> bool:
        """Atomic register-unless-present (createTempView's refusal
        guarantee must hold under concurrent registration)."""
        with self._lock:
            if name in self._tables:
                return False
            self._tables[name] = df
            return True

    def dropTempTable(self, name: str) -> bool:
        """Remove a registered table; returns whether it existed
        (atomic under the context lock — spark.catalog.dropTempView
        relies on this to avoid a check-then-drop race)."""
        with self._lock:
            return self._tables.pop(name, None) is not None

    def table(self, name: str) -> DataFrame:
        overlay = getattr(self._cte, "frames", None)
        if overlay and name in overlay:
            return overlay[name]  # CTEs shadow registered tables (SQL)
        with self._lock:
            if name not in self._tables:
                raise KeyError(
                    f"Unknown table {name!r}; registered: "
                    f"{sorted(self._tables)}"
                    + (
                        f"; CTEs in scope: {sorted(overlay)}"
                        if overlay
                        else ""
                    )
                )
            return self._tables[name]

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def sql(self, query: str) -> DataFrame:
        parsed = _Parser(_tokenize(query)).parse()
        if isinstance(parsed, tuple):  # (ctes, main) from a WITH query
            ctes, main = parsed
            had = getattr(self._cte, "frames", None)
            self._cte.frames = dict(had) if had else {}
            try:
                for name, cq in ctes:
                    # each CTE sees the ones registered before it
                    self._cte.frames[name] = self._run_any(cq)
                return self._run_any(main)
            finally:
                self._cte.frames = had
        return self._run_any(parsed)

    def _run_any(self, q) -> DataFrame:
        if isinstance(q, UnionQuery):
            return self._run_union(q)
        return self._run_query(q)

    def _run_union(self, u: UnionQuery) -> DataFrame:
        if u.offset:
            off, lim = u.offset, u.limit
            u.offset = None
            u.limit = None if lim is None else lim + off
            return self._run_union(u).offset(off)
        frames = [
            self._run_union(b)
            if isinstance(b, UnionQuery)
            else self._run_query(b)
            for b in u.branches
        ]
        out = frames[0]
        ncols = len(out.columns)
        for i, nxt in enumerate(frames[1:]):
            if len(nxt.columns) != ncols:
                raise ValueError(
                    f"Set-operator branches have different column "
                    f"counts: {ncols} vs {len(nxt.columns)}"
                )
            # positional matching (SQL): rename to the first branch's
            # names through collision-proof temps (the direct rename
            # breaks when branch columns are a permutation of the
            # target names)
            if list(nxt.columns) != list(out.columns):
                tmps = [f"__union_{j}" for j in range(ncols)]
                for have, t in zip(list(nxt.columns), tmps):
                    nxt = nxt.withColumnRenamed(have, t)
                for t, want in zip(tmps, out.columns):
                    nxt = nxt.withColumnRenamed(t, want)
            op = u.ops[i]
            if op == "union_all":
                out = out.union(nxt)
            elif op == "union":
                out = out.union(nxt).distinct()
            elif op == "except":
                out = out.subtract(nxt)
            else:  # intersect
                out = out.intersect(nxt)
        if u.order:
            # ordinals index the combined result's columns; expressions
            # must name an output column of the union (canonical name)
            cols, asc = [], []
            for c, a in u.order:
                if isinstance(c, Lit):
                    if not isinstance(c.value, int) or not (
                        1 <= c.value <= len(out.columns)
                    ):
                        raise ValueError(
                            f"ORDER BY literal {c.value!r} must be a "
                            f"column ordinal in 1..{len(out.columns)}"
                        )
                    cols.append(out.columns[c.value - 1])
                elif isinstance(c, str):
                    cols.append(c)
                else:
                    name = _expr_name(c)
                    if name not in out.columns:
                        raise ValueError(
                            f"ORDER BY {name!r} on a set operation must "
                            "name an output column"
                        )
                    cols.append(name)
                asc.append(a)
            out = out.orderBy(*cols, ascending=asc)
        return out.limit(u.limit) if u.limit is not None else out

    def _resolve_in_subqueries(self, node):
        """Replace IN (SELECT ...) predicate values with the executed
        subquery's value set (uncorrelated subqueries only — column
        references inside resolve against the SUBQUERY's own tables).
        Walks predicate trees AND the expressions inside them, so the
        form also works nested in CASE conditions."""
        if isinstance(node, NotOp):
            return NotOp(self._resolve_in_subqueries(node.part))
        if isinstance(node, BoolOp):
            return BoolOp(
                node.op,
                [self._resolve_in_subqueries(p) for p in node.parts],
            )
        if node.op in ("exists", "notexists"):
            sub_df = (
                self._run_union(node.value)
                if isinstance(node.value, UnionQuery)
                else self._run_query(node.value)
            )
            hit = len(sub_df.limit(1).collect()) > 0
            return Predicate(
                None, "const", hit if node.op == "exists" else not hit
            )
        col = (
            node.col
            if isinstance(node.col, str)
            else self._resolve_expr_subqueries(node.col)
        )
        value = node.value
        if isinstance(value, (Query, UnionQuery)):
            sub_df = (
                self._run_union(value)
                if isinstance(value, UnionQuery)
                else self._run_query(value)
            )
            if len(sub_df.columns) != 1:
                raise ValueError(
                    "IN (SELECT ...) must select exactly one column; "
                    f"got {sub_df.columns}"
                )
            sub_col = sub_df.columns[0]
            value = {r[sub_col] for r in sub_df.collect()}
        elif isinstance(value, (Col, Lit, Arith, Case, Call, Subquery)):
            value = self._resolve_expr_subqueries(value)
        elif isinstance(value, DynItems):
            # expression IN-list elements may hold scalar subqueries
            # (v IN (1, (SELECT max(v) ...) - 1))
            value = DynItems(
                self._resolve_expr_subqueries(v)
                if isinstance(
                    v, (Col, Lit, Arith, Case, Call, Subquery)
                )
                else v
                for v in value
            )
        elif isinstance(value, tuple):  # BETWEEN bounds
            value = tuple(
                self._resolve_expr_subqueries(v)
                if isinstance(
                    v, (Col, Lit, Arith, Case, Call, Subquery)
                )
                else v
                for v in value
            )
        return Predicate(col, node.op, value)

    def _resolve_expr_subqueries(self, e):
        """Walk an expression for Case nodes whose conditions hold
        IN-subqueries (and any nested expression positions), and replace
        scalar subqueries with the literal they evaluate to."""
        if isinstance(e, Subquery):
            sub_df = (
                self._run_union(e.q)
                if isinstance(e.q, UnionQuery)
                else self._run_query(e.q)
            )
            if len(sub_df.columns) != 1:
                raise ValueError(
                    "Scalar subquery must select exactly one column; "
                    f"got {sub_df.columns}"
                )
            rows = sub_df.limit(2).collect()
            if len(rows) > 1:
                raise ValueError(
                    "Scalar subquery returned more than one row"
                )
            return Lit(rows[0][sub_df.columns[0]] if rows else None)
        if isinstance(e, Window):
            # scalar subqueries inside window operands:
            # sum(v + (SELECT min(v) FROM t)) OVER (...)
            return e.map_operands(
                lambda c: c
                if isinstance(c, str)
                else self._resolve_expr_subqueries(c)
            )
        if isinstance(e, Case):
            return Case(
                [
                    (
                        self._resolve_in_subqueries(p),
                        self._resolve_expr_subqueries(x),
                    )
                    for p, x in e.branches
                ],
                self._resolve_expr_subqueries(e.default)
                if e.default is not None
                else None,
            )
        if isinstance(e, Arith):
            return Arith(
                e.op,
                self._resolve_expr_subqueries(e.left),
                self._resolve_expr_subqueries(e.right)
                if e.right is not None
                else None,
            )
        if isinstance(e, Call) and e.arg != "*":
            new_args = [
                self._resolve_expr_subqueries(a) for a in e.all_args()
            ]
            if not new_args:
                return e  # zero-arg builtin (current_date())
            return _rebuild_call(e, new_args)
        return e

    @staticmethod
    def _resolve_order_keys(q: Query) -> None:
        """Normalize ORDER BY keys in place: ordinals (ORDER BY 1)
        become the referenced select item's OUTPUT name (Spark
        semantics); expressions stay expression nodes for the execution
        paths to materialize; window functions are rejected (compute in
        a derived table, like the top-N-per-group idiom)."""
        out: List[Tuple[Any, bool]] = []
        for c, a in q.order:
            if isinstance(c, Lit):
                if not isinstance(c.value, int) or not (
                    1 <= c.value <= len(q.items)
                ):
                    raise ValueError(
                        f"ORDER BY literal {c.value!r} must be a "
                        f"select-item ordinal in 1..{len(q.items)}"
                    )
                it = q.items[c.value - 1]
                if it.expr == "*" or isinstance(
                    it.expr, QualifiedStar
                ):
                    raise ValueError(
                        "ORDER BY ordinal cannot reference a * item"
                    )
                if (
                    isinstance(it.expr, Call)
                    and it.expr.fn.lower() in _GENERATOR_FNS
                ):
                    # an unaliased explode item's output is named 'col'
                    out.append((it.alias or "col", a))
                    continue
                out.append((it.alias or _expr_name(it.expr), a))
                continue
            if not isinstance(c, str) and _contains_window(c):
                raise ValueError(
                    "Window functions are not allowed in ORDER BY; "
                    "compute them in a derived table and sort outside"
                )
            out.append((c, a))
        q.order = out

    @staticmethod
    def _check_functions(q: Query) -> None:
        """Every called name that is neither a builtin nor an aggregate
        is a catalog UDF (lambda bodies hold builtins only: the parser
        checks them), so an unknown one fails here, at planning."""
        calls = [c for it in q.items if it.expr != "*" for c in _iter_catalog_calls(it.expr)]
        if q.where is not None:
            calls += list(_iter_pred_catalog_calls(q.where))
        calls += [c for g in q.group for c in _iter_catalog_calls(g)]
        calls += [c for k, _ in q.order if not isinstance(k, str) for c in _iter_catalog_calls(k)]
        registered = udf_catalog.list_udfs()
        unknown = sorted({
            c.fn for c in calls
            if c.fn not in registered and c.fn.lower() not in _GENERATOR_FNS
        })
        if unknown:
            raise ValueError(
                f"Unknown function(s) {unknown}: neither a builtin nor a registered UDF "
                f"(registered: {registered})"
            )

    def _run_query(self, q: Query) -> DataFrame:
        if q.offset:
            # OFFSET m: run the query with LIMIT raised to limit+m
            # (ORDER BY applies inside), then skip the first m rows —
            # the [m, m+limit) window, standard SQL
            off, lim = q.offset, q.limit
            q.offset = None
            q.limit = None if lim is None else lim + off
            return self._run_query(q).offset(off)
        self._resolve_order_keys(q)
        if isinstance(q.table, UnionQuery):
            df = self._run_union(q.table)
        elif isinstance(q.table, Query):
            # derived table: run the subquery, then treat its result as
            # the source frame under its alias (qualifier resolution)
            df = self._run_query(q.table)
        elif q.table is None:
            # FROM-less SELECT (Spark's OneRowRelation): the select
            # items evaluate over exactly one synthetic row, and the
            # projection below keeps only the items' outputs
            if any(it.expr == "*" for it in q.items):
                raise ValueError(
                    "SELECT * needs a FROM clause (a FROM-less SELECT "
                    "has no columns to expand)"
                )
            df = DataFrame.fromColumns({"__one_row__": [None]})
        else:
            df = self.table(q.table)

        if q.where is not None:
            q.where = self._resolve_in_subqueries(q.where)
        q.items = [
            SelectItem(
                it.expr
                if it.expr == "*"
                else self._resolve_expr_subqueries(it.expr),
                it.alias,
            )
            for it in q.items
        ]
        q.group = [self._resolve_expr_subqueries(g) for g in q.group]
        q.order = [
            (c if isinstance(c, str) else self._resolve_expr_subqueries(c), a)
            for c, a in q.order
        ]

        if q.joins:
            df = self._apply_joins(df, q)
        elif (
            isinstance(q.table, (Query, UnionQuery))
            and q.table.subquery_alias
        ):
            # no JOIN: alias-qualified references (sub.col) still work —
            # strip the derived table's own qualifier everywhere
            self._strip_alias(q, q.table.subquery_alias)
        elif isinstance(q.table, str):
            # plain table: qualified references (t.col, or a.col under
            # FROM t a) resolve by stripping the one valid qualifier;
            # under an alias the ORIGINAL name is not addressable (Spark)
            self._strip_alias(q, q.table_alias or q.table)

        if q.lateral_views:
            # LATERAL VIEW explode(arr) e AS x: expand the FROM frame
            # BEFORE WHERE/GROUP BY so the generated columns are plain
            # columns everywhere downstream (Hive semantics); chained
            # views compound left to right
            from sparkdl_tpu_torch.dataframe.column import Column as _LC
            from sparkdl_tpu_torch.dataframe.column import ExplodeNode as _LEx

            for j in range(len(q.lateral_views)):
                # re-read per iteration: _strip_alias REASSIGNS
                # q.lateral_views, and a later view's arg may qualify
                # an earlier view's alias (explode(a.pr))
                fname, arg, lv_outer, lv_alias, lv_cols = (
                    q.lateral_views[j]
                )
                iname = f"__sql_lv_{j}"
                df = _apply_expr(df, arg, iname)
                with_pos = fname.startswith("posexplode")
                outer2 = lv_outer or fname.endswith("_outer")
                need = 2 if with_pos else 1
                if lv_cols is None:
                    lv_cols = ["pos", "col"] if with_pos else ["col"]
                elif len(lv_cols) != need:
                    raise ValueError(
                        f"LATERAL VIEW {fname} produces {need} "
                        f"column(s); got {len(lv_cols)} AS name(s)"
                    )
                node = _LEx(Col(iname), outer2, with_pos)
                keep = [c for c in df.columns if c != iname]
                out_alias = (
                    tuple(lv_cols) if with_pos else lv_cols[0]
                )
                df = df.select(*keep, _LC(node, out_alias))
                # view-alias-qualified refs (e.x) read the plain
                # generated columns
                self._strip_alias(q, lv_alias)

        # SELECT t.* resolves against the FROM table/alias (single-table
        # queries; join provenance after key-merging is ambiguous);
        # e.* over a lateral view alias expands to its generated columns
        if any(isinstance(it.expr, QualifiedStar) for it in q.items):
            if q.joins:
                raise ValueError(
                    "Qualified star (t.*) is not supported in join "
                    "queries; list the columns explicitly"
                )
            valid = set()
            if isinstance(q.table, str):
                valid = {q.table_alias or q.table}
            elif getattr(q.table, "subquery_alias", None):
                valid = {q.table.subquery_alias}
            lv_stars = {}
            for fname, _, _, lv_alias, lv_cols in q.lateral_views or []:
                if lv_cols is None:
                    lv_cols = (
                        ["pos", "col"]
                        if fname.startswith("posexplode")
                        else ["col"]
                    )
                lv_stars[lv_alias] = lv_cols
            expanded_items: List[SelectItem] = []
            for it in q.items:
                if isinstance(it.expr, QualifiedStar):
                    qual = it.expr.qualifier
                    if qual in lv_stars:
                        expanded_items.extend(
                            SelectItem(Col(c), c) for c in lv_stars[qual]
                        )
                        continue
                    if qual not in valid:
                        raise ValueError(
                            f"Unknown qualifier {qual!r} for qualified "
                            f"star; FROM binds "
                            f"{sorted(valid | set(lv_stars))}"
                        )
                    it.expr = "*"
                expanded_items.append(it)
            q.items = expanded_items

        self._check_functions(q)

        # -- optimizer arm (SPARKDL_SQL_VECTORIZE, default on) ----------
        # Projection pushdown: prune the scan to the columns the query
        # can actually read, BEFORE the WHERE/projection ops build rows
        # — a pruned column's lazy cells are never touched at all.
        vectorize = udf_catalog.sql_vectorize_enabled()
        if vectorize and not q.joins:
            needed = _query_referenced_columns(q)
            if needed is not None:
                pruned = [c for c in df.columns if c in needed]
                if not pruned and df.columns:
                    # zero referenced columns (SELECT COUNT(*) / SELECT
                    # 1): keep one — partitions carry row counts in
                    # their columns
                    pruned = [df.columns[0]]
                if len(pruned) < len(df.columns):
                    metrics.inc(
                        "sql.pushdown.pruned_cols",
                        len(df.columns) - len(pruned),
                    )
                    df = df.select(*pruned)

        if q.where is not None:
            # UDF calls in WHERE materialize batched first (a no-op
            # returning the same tree when there are none), then the
            # tree row-evaluates like any predicate. The optimizer arm
            # additionally splits top-level AND conjuncts so cheap
            # metadata predicates filter BEFORE the batched UDF temp
            # columns materialize (predicate pushdown), and evaluates
            # each filter over only the columns it reads.
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

        if q.having is not None and next(
            _iter_pred_windows(q.having), None
        ):
            raise ValueError(
                "Window functions are not allowed in HAVING; compute "
                "them in a derived table and filter outside"
            )
        if q.having is not None and _pred_contains_catalog_call(q.having):
            # distinguish a real registered UDF (unsupported position,
            # pointed advice) from a typo'd function name
            names = sorted({
                c.fn for c in _iter_pred_catalog_calls(q.having)
            })
            unknown = [n for n in names if n not in udf_catalog.list_udfs()]
            if unknown:
                raise ValueError(
                    f"Unknown function(s) in HAVING: {unknown}"
                )
            raise ValueError(
                f"UDF calls ({names}) are not allowed in HAVING (it "
                "filters aggregated rows); compute the UDF in a "
                "derived table and filter outside"
            )

        # generators BEFORE windows: the row expansion must not run over
        # pre-explosion window values, and a nested generator needs its
        # pointed error rather than a UDF-lookup failure
        gen_items = [
            it
            for it in q.items
            if isinstance(it.expr, Call)
            and it.expr.fn.lower() in _GENERATOR_FNS
        ]
        if any(
            it.expr != "*"
            and it not in gen_items
            and _contains_generator(it.expr)
            for it in q.items
        ):
            raise ValueError(
                "explode() produces multiple rows and only works as a "
                "TOP-LEVEL select item (SELECT explode(arr) AS t ...)"
            )
        if gen_items:
            if any(
                it.expr != "*" and _contains_window(it.expr)
                for it in q.items
            ):
                raise ValueError(
                    "explode() cannot be combined with window functions "
                    "in one query level; explode in a derived table first"
                )
            return self._run_explode_select(df, q, gen_items)

        # SELECT *, expr (Spark allows the mix): expand the star to the
        # CURRENT source columns now — before window application widens
        # the frame with hidden __win/operand columns
        if len(q.items) > 1 and any(it.expr == "*" for it in q.items):
            expanded: List[SelectItem] = []
            for it in q.items:
                if it.expr == "*":
                    expanded.extend(
                        SelectItem(Col(c), c) for c in df.columns
                    )
                else:
                    expanded.append(it)
            q.items = expanded

        if any(
            it.expr != "*" and _contains_window(it.expr)
            for it in q.items
        ):
            if q.group:
                raise ValueError(
                    "Window functions cannot be combined with GROUP BY "
                    "in one query level; aggregate in a derived table "
                    "first"
                )
            df = self._apply_window_items(df, q.items)

        for it in q.items:
            if (
                isinstance(it.expr, Call)
                and it.expr.fn.lower() in _AGGREGATES
                and not _is_aggregate(it.expr)
            ):
                raise ValueError(
                    f"Nested aggregates are not supported: "
                    f"{_expr_name(it.expr)}"
                )
        if q.group or any(
            it.expr != "*" and _contains_aggregate(it.expr)
            for it in q.items
        ):
            return self._aggregate(df, q)
        if q.having is not None:
            raise ValueError(
                "HAVING requires GROUP BY or an aggregate select list"
            )

        if any(it.expr == "*" for it in q.items):
            if len(q.items) != 1:
                raise ValueError("SELECT * cannot be mixed with other items")
            if q.distinct:
                df = df.distinct()
            if q.order:
                # expression keys (ORDER BY v * 2) materialize as hidden
                # columns AFTER distinct (dedup must see original rows),
                # sort, then drop
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

        # expression ORDER BY keys resolve to their canonical name: an
        # output column if one matches, else a hidden column materialized
        # on the source frame (the carry logic below sorts on it and
        # drops it after projection)
        norm_order: List[Tuple[str, bool]] = []
        for c, a in q.order:
            if isinstance(c, str):
                norm_order.append((c, a))
                continue
            name = _expr_name(c)
            if name not in oset and name not in df.columns:
                df = _apply_expr(df, c, name)
            norm_order.append((name, a))
        q.order = norm_order

        def project(d: DataFrame, carry=()) -> DataFrame:
            for it, name in zip(q.items, output_names):
                d = _apply_expr(d, it.expr, name)
            return d.select(*output_names, *carry)

        if q.distinct:
            # SELECT DISTINCT: project -> distinct -> sort -> limit.
            # Early-limit shortcuts don't apply (dedup changes
            # cardinality), and — as in Spark — ORDER BY may only use
            # the select list (a source-only sort key would change
            # distinctness if carried through).
            bad = [c for c, _ in q.order if c not in oset]
            if bad:
                raise ValueError(
                    f"ORDER BY {bad[0]!r} is not in the SELECT DISTINCT "
                    "list"
                )
            out = project(df).distinct()
            if q.order:
                out = out.orderBy(
                    *[c for c, _ in q.order],
                    ascending=[a for _, a in q.order],
                )
            return out.limit(q.limit) if q.limit is not None else out

        # Spark ordering of clauses: WHERE -> ORDER BY -> LIMIT, with
        # ORDER BY keys resolved against the select list FIRST (an alias
        # shadows a same-named source column), then the source schema.
        if not q.order:
            # no sort: limit BEFORE projection — UDFs must never score
            # rows the limit then discards
            if q.limit is not None:
                df = df.limit(q.limit)
            return project(df)
        order_cols = [c for c, _ in q.order]
        asc = [a for _, a in q.order]
        if all(c not in oset and c in df.columns for c in order_cols):
            # pure source-column sort: sort + limit before projection
            df = df.orderBy(*order_cols, ascending=asc)
            if q.limit is not None:
                df = df.limit(q.limit)
            return project(df)
        # at least one key names an output: project first, carrying any
        # source-only keys through the projection for the sort
        carry = [c for c in order_cols if c not in oset]
        for c in carry:
            if c not in df.columns:
                raise KeyError(f"Unknown ORDER BY column {c!r}")
        out = project(df, carry=carry).orderBy(*order_cols, ascending=asc)
        if carry:
            out = out.drop(*carry)
        return out.limit(q.limit) if q.limit is not None else out

    def _run_explode_select(
        self, df: DataFrame, q: Query, gen_items: List[SelectItem]
    ) -> DataFrame:
        """SELECT explode(arr) [AS t] (Spark's generator-in-select):
        every select item materializes SQL-side (UDF calls batched via
        _apply_expr), then the row expansion rides the DataFrame
        Column machinery (_select_with_explode). ORDER BY/LIMIT apply
        AFTER the expansion, on output names."""
        from sparkdl_tpu_torch.dataframe.column import Column as _C
        from sparkdl_tpu_torch.dataframe.column import ExplodeNode as _Ex

        if len(gen_items) > 1:
            raise ValueError(
                "Only one generator (explode) is allowed per select"
            )
        if q.group or q.having is not None:
            raise ValueError(
                "explode() cannot be combined with GROUP BY/HAVING in "
                "one query level; explode in a derived table first"
            )
        if any(
            it.expr != "*" and _contains_aggregate(it.expr)
            for it in q.items
        ):
            raise ValueError(
                "explode() cannot be combined with aggregates in one "
                "query level; explode in a derived table first"
            )
        sel_cols: List[Any] = []
        for it in q.items:
            e = it.expr
            if e == "*":
                raise ValueError(
                    "SELECT * cannot be combined with explode(); name "
                    "the columns"
                )
            if (
                isinstance(e, Call)
                and e.fn.lower() in ("explode", "explode_outer")
            ):
                if len(e.all_args()) != 1:
                    raise ValueError(
                        f"{e.fn.lower()}(expr) takes exactly one argument"
                    )
                iname = f"__sql_exp_{id(it)}"
                df = _apply_expr(df, e.all_args()[0], iname)
                sel_cols.append(
                    _C(
                        _Ex(Col(iname), e.fn.lower() == "explode_outer"),
                        it.alias,
                    )
                )
            elif isinstance(e, Call) and e.fn.lower() == "stack":
                from sparkdl_tpu_torch.dataframe.column import (
                    StackNode as _Stk,
                )

                args = e.all_args()
                if len(args) < 2 or not isinstance(args[0], Lit):
                    raise ValueError(
                        "stack(n, expr, ...) needs a literal row count "
                        "and at least one value"
                    )
                tmps = []
                for j, a in enumerate(args[1:]):
                    t = f"__sql_stk_{id(it)}_{j}"
                    df = _apply_expr(df, a, t)
                    tmps.append(t)
                node = _Stk(int(args[0].value), [Col(t) for t in tmps])
                if it.alias is not None and node.width > 1:
                    raise ValueError(
                        f"stack produces {node.width} columns; a single "
                        "alias cannot name them (the outputs are "
                        "col0..colN — rename in an outer select)"
                    )
                sel_cols.append(_C(node, it.alias))
            elif isinstance(e, Call) and e.fn.lower() == "json_tuple":
                from sparkdl_tpu_torch.dataframe.column import (
                    JsonTupleNode as _Jt,
                )

                args = e.all_args()
                if len(args) < 2 or not all(
                    isinstance(a, Lit) and isinstance(a.value, str)
                    for a in args[1:]
                ):
                    raise ValueError(
                        "json_tuple(json, 'field', ...) needs string-"
                        "literal field names"
                    )
                t = f"__sql_jt_{id(it)}"
                df = _apply_expr(df, args[0], t)
                node = _Jt(Col(t), [a.value for a in args[1:]])
                if it.alias is not None and len(node.fields) > 1:
                    raise ValueError(
                        f"json_tuple produces {len(node.fields)} "
                        "columns; a single alias cannot name them"
                    )
                sel_cols.append(_C(node, it.alias))
            elif isinstance(e, Col) and it.alias in (None, e.name):
                sel_cols.append(e.name)
            else:
                name = it.alias or _expr_name(e)
                df = _apply_expr(df, e, name)
                sel_cols.append(name)
        out = df.select(*sel_cols)
        if q.distinct:
            out = out.distinct()
        if q.order:
            names, asc = [], []
            for c, a in q.order:
                name = c if isinstance(c, str) else _expr_name(c)
                if name not in out.columns:
                    raise KeyError(
                        f"ORDER BY {name!r} on an exploded select must "
                        f"name an output column; available: {out.columns}"
                    )
                names.append(name)
                asc.append(a)
            out = out.orderBy(*names, ascending=asc)
        return out.limit(q.limit) if q.limit is not None else out

    @staticmethod
    def _apply_window_items(df: DataFrame, items: List[SelectItem]) -> DataFrame:
        """Compute each window-function item into a column (driver-side,
        like orderBy/join — guarded by the same collect limit), keyed to
        the frame's current row order, then rewrite the item to a plain
        column reference (items are rewritten IN PLACE). Frame = the
        whole partition (no ROWS BETWEEN); null ordering matches
        DataFrame.orderBy (Spark's nulls-first ascending).

        Deliberately self-free (a staticmethod): the Column API's
        ``.over(Window...)`` path (dataframe/frame.py) routes through the
        same engine with synthetic SelectItems, so SQL text and
        ``F.row_number().over(...)`` cannot drift apart."""
        from sparkdl_tpu_torch.dataframe.frame import (
            _agg_final,
            _agg_init,
            _agg_update,
            _cell_key,
            _guard_collect,
        )
        from sparkdl_tpu_torch.dataframe.frame import (
            aggregate_values as _agg_values,
        )

        windows: List[Window] = []
        for it in items:
            if it.expr != "*":
                windows.extend(_iter_windows(it.expr))

        # materialize expression operands (sum(v * q) OVER (PARTITION BY
        # upper(g) ORDER BY v + r)) as hidden columns, so the window
        # computation below only ever sees column names; UDF calls in
        # operands run batched through the catalog like any select
        # expression. The hidden columns ride the rebuilt frame and are
        # dropped by the final projection.
        def _matname(expr) -> str:
            nonlocal df
            name = _expr_name(expr)
            if name not in df.columns:
                df = _apply_expr(df, expr, name)
            return name

        for w in windows:
            if w.arg is not None and not isinstance(w.arg, str):
                w.arg = _matname(w.arg)
            w.partition_by = [
                c if isinstance(c, str) else _matname(c)
                for c in w.partition_by
            ]
            w.order_by = [
                (c if isinstance(c, str) else _matname(c), a)
                for c, a in w.order_by
            ]

        _guard_collect(df, "window function")
        # columnar access: untouched columns (tensor blocks included)
        # pass through whole; only key/arg columns are indexed per row
        merged = df.collectColumns()
        n = len(merged[df.columns[0]]) if df.columns else 0
        new_cols: Dict[str, List[Any]] = {}
        win_name: Dict[int, str] = {}

        spec_names: Dict[tuple, str] = {}
        for w in windows:
            # identical specs share one computed column (the
            # percent-of-group idiom repeats sum(v) OVER (...) verbatim)
            spec = (
                w.fn, w.arg, tuple(w.partition_by), tuple(w.order_by),
                # repr: lag/lead defaults may be unhashable (list cells)
                w.offset, repr(w.default), w.frame, w.frame_kind,
            )
            if spec in spec_names:
                win_name[id(w)] = spec_names[spec]
                continue
            for c in (
                list(w.partition_by)
                + [c for c, _ in w.order_by]
                + ([w.arg] if w.arg else [])
            ):
                if c not in df.columns:
                    raise KeyError(f"Unknown column {c!r} in window")
            groups: Dict[tuple, List[int]] = {}
            order_seen: List[tuple] = []
            part_cols = [merged[c] for c in w.partition_by]
            for i in range(n):
                k = tuple(_cell_key(col[i]) for col in part_cols)
                if k not in groups:
                    groups[k] = []
                    order_seen.append(k)
                groups[k].append(i)

            def sort_key(i, col, null_rank=0):
                # default rank 0 serves the PEER-equality callers
                # (_peer_runs), where only same-vs-different matters
                v = merged[col][i]
                return (null_rank, 0) if v is None else (1, v)

            vals: List[Any] = [None] * n
            for k in order_seen:
                idxs = list(groups[k])
                if w.order_by:
                    for col, asc in list(w.order_by)[::-1]:
                        # honor NULLS FIRST/LAST (order_item's SortDir);
                        # defaults are Spark's (first asc, last desc) —
                        # same rank algebra as DataFrame.orderBy
                        asc_b = bool(asc)
                        nf = getattr(asc, "nulls_first", None)
                        if nf is None:
                            nf = asc_b
                        nr = (0 if nf else 2) if asc_b else (2 if nf else 0)
                        idxs.sort(
                            key=lambda i, c=col, r=nr: sort_key(i, c, r),
                            reverse=not asc_b,
                        )
                if w.frame is not None and w.frame_kind == "range":
                    # VALUE-offset frame over the single ORDER BY key
                    # (parser-validated): the frame holds rows whose key
                    # lies within [cur - preceding, cur + following]
                    # measured AGAINST the sort direction. Null keys sit
                    # in one contiguous run and frame only each other
                    # (value distance to null is unknown — Spark).
                    # Linear scan per row: driver-side like the rest of
                    # the window engine; fine at collect-guarded sizes.
                    lo, hi = w.frame
                    key_name = w.order_by[0][0]
                    asc = w.order_by[0][1]
                    key_col = merged[key_name]
                    arg_col = None if w.arg is None else merged[w.arg]
                    m = len(idxs)
                    keys = [key_col[i] for i in idxs]
                    probe = next(
                        (x for x in keys if x is not None), None
                    )
                    if probe is not None and (
                        isinstance(probe, bool)
                        or not isinstance(probe, (int, float))
                    ):
                        raise ValueError(
                            "RANGE frames with value offsets need a "
                            "NUMERIC ORDER BY key; column "
                            f"{key_name!r} holds "
                            f"{type(probe).__name__} values"
                        )
                    sign = 1 if asc else -1
                    for pos, i in enumerate(idxs):
                        kv = keys[pos]
                        if kv is None:
                            sel = [
                                j for j in range(m) if keys[j] is None
                            ]
                        else:
                            b1 = None if lo is None else kv + sign * lo
                            b2 = None if hi is None else kv + sign * hi
                            vlo, vhi = (b1, b2) if asc else (b2, b1)
                            sel = [
                                j
                                for j in range(m)
                                if keys[j] is not None
                                and (vlo is None or keys[j] >= vlo)
                                and (vhi is None or keys[j] <= vhi)
                            ]
                        if w.fn == "first_value":
                            vals[i] = (
                                arg_col[idxs[sel[0]]] if sel else None
                            )
                        elif w.fn == "last_value":
                            vals[i] = (
                                arg_col[idxs[sel[-1]]] if sel else None
                            )
                        elif w.fn == "nth_value":
                            vals[i] = (
                                arg_col[idxs[sel[w.offset - 1]]]
                                if len(sel) >= w.offset
                                else None
                            )
                        elif w.arg is None:  # count(*)
                            vals[i] = len(sel)
                        else:
                            vals[i] = _agg_values(
                                w.fn, [arg_col[idxs[j]] for j in sel]
                            )
                elif w.frame is not None:
                    # explicit ROWS frame: PHYSICAL row offsets in the
                    # sorted partition (no peer expansion — that is the
                    # difference from the default RANGE frame)
                    lo, hi = w.frame
                    arg_col = None if w.arg is None else merged[w.arg]
                    m = len(idxs)

                    def upd(acc, j):
                        return _agg_update(
                            w.fn,
                            acc,
                            None if arg_col is None else arg_col[j],
                            star=w.arg is None,
                        )

                    if w.fn in _AGGREGATES and lo is None:
                        # running frame (UNBOUNDED PRECEDING .. hi):
                        # stream once, advancing the cutoff — O(n), not
                        # O(n^2) re-aggregation per row
                        acc = _agg_init(w.fn)
                        ptr = 0
                        for pos, i in enumerate(idxs):
                            cut = (
                                m
                                if hi is None
                                else min(m, max(0, pos + hi + 1))
                            )
                            while ptr < cut:
                                acc = upd(acc, idxs[ptr])
                                ptr += 1
                            vals[i] = _agg_final(w.fn, acc)
                    elif (
                        w.fn in _AGGREGATES
                        and hi is None
                        and w.fn not in _ORDER_SENSITIVE_AGGS
                    ):
                        # suffix frame (lo .. UNBOUNDED FOLLOWING):
                        # stream from the end — only for COMMUTATIVE
                        # aggregates (first/last/collect_* would see the
                        # rows reversed; they take the per-row path)
                        acc = _agg_init(w.fn)
                        ptr = m - 1
                        for pos in range(m - 1, -1, -1):
                            start = max(0, pos + lo)
                            while ptr >= start:
                                acc = upd(acc, idxs[ptr])
                                ptr -= 1
                            vals[idxs[pos]] = _agg_final(w.fn, acc)
                    else:
                        # bounded frame / first_value / last_value:
                        # O(frame width) per row
                        for pos, i in enumerate(idxs):
                            a0 = 0 if lo is None else max(0, pos + lo)
                            a1 = (
                                m
                                if hi is None
                                else min(m, max(0, pos + hi + 1))
                            )
                            if a1 <= a0:
                                vals[i] = 0 if (
                                    w.fn == "count" or w.arg is None
                                ) and w.fn not in _VALUE_FNS else None
                            elif w.fn == "first_value":
                                vals[i] = arg_col[idxs[a0]]
                            elif w.fn == "last_value":
                                vals[i] = arg_col[idxs[a1 - 1]]
                            elif w.fn == "nth_value":
                                vals[i] = (
                                    arg_col[idxs[a0 + w.offset - 1]]
                                    if a1 - a0 >= w.offset
                                    else None
                                )
                            elif w.arg is None:  # count(*)
                                vals[i] = a1 - a0
                            else:
                                vals[i] = _agg_values(
                                    w.fn,
                                    [
                                        arg_col[idxs[j]]
                                        for j in range(a0, a1)
                                    ],
                                )
                elif w.fn == "ntile":
                    # Spark/SQL ntile: larger buckets first when uneven
                    base, extra = divmod(len(idxs), w.offset)
                    bounds = []
                    acc2 = 0
                    for b in range(w.offset):
                        acc2 += base + (1 if b < extra else 0)
                        bounds.append(acc2)
                    b = 0
                    for pos, i in enumerate(idxs, 1):
                        while pos > bounds[b]:
                            b += 1
                        vals[i] = b + 1
                elif w.fn in _VALUE_FNS:
                    arg_col = merged[w.arg]
                    if w.fn == "first_value":
                        v = arg_col[idxs[0]]
                        for i in idxs:
                            vals[i] = v
                    elif w.fn == "nth_value":
                        # default running frame: the nth row exists only
                        # once the frame (up to the current peer group)
                        # spans n rows (Spark: null before that)
                        n_th = w.offset
                        for lo, hi in _peer_runs(idxs, w, sort_key):
                            v = (
                                arg_col[idxs[n_th - 1]]
                                if hi + 1 >= n_th
                                else None
                            )
                            for t in range(lo, hi + 1):
                                vals[idxs[t]] = v
                    else:
                        # Spark's default frame (UNBOUNDED PRECEDING ..
                        # CURRENT ROW): last_value = the last PEER of
                        # the current row's ORDER BY group
                        for lo, hi in _peer_runs(idxs, w, sort_key):
                            v = arg_col[idxs[hi]]
                            for t in range(lo, hi + 1):
                                vals[idxs[t]] = v
                elif w.fn in _OFFSET_FNS:
                    arg_col = merged[w.arg]
                    step = -w.offset if w.fn == "lag" else w.offset
                    for pos, i in enumerate(idxs):
                        src = pos + step
                        vals[i] = (
                            arg_col[idxs[src]]
                            if 0 <= src < len(idxs)
                            else w.default
                        )
                elif w.fn == "row_number":
                    for pos, i in enumerate(idxs, 1):
                        vals[i] = pos
                elif w.fn in ("rank", "dense_rank", "percent_rank"):
                    m = len(idxs)
                    prev = object()
                    rank = dense = 0
                    for pos, i in enumerate(idxs, 1):
                        key = tuple(
                            sort_key(i, c) for c, _ in w.order_by
                        )
                        if key != prev:
                            dense += 1
                            rank = pos
                            prev = key
                        if w.fn == "rank":
                            vals[i] = rank
                        elif w.fn == "dense_rank":
                            vals[i] = dense
                        else:  # percent_rank = (rank-1)/(n-1), 0 if n=1
                            vals[i] = (
                                0.0 if m == 1 else (rank - 1) / (m - 1)
                            )
                elif w.fn == "cume_dist":
                    # fraction of rows <= the current row's peers
                    m = len(idxs)
                    for lo, hi in _peer_runs(idxs, w, sort_key):
                        v = (hi + 1) / m
                        for t in range(lo, hi + 1):
                            vals[idxs[t]] = v
                elif w.order_by:
                    # aggregate WITH ORDER BY: Spark's default running
                    # frame (UNBOUNDED PRECEDING .. CURRENT ROW, peers
                    # included) — the running-total idiom
                    acc = _agg_init(w.fn)
                    arg_col = None if w.arg is None else merged[w.arg]
                    for lo, hi in _peer_runs(idxs, w, sort_key):
                        for t in range(lo, hi + 1):
                            i = idxs[t]
                            acc = _agg_update(
                                w.fn,
                                acc,
                                None if arg_col is None else arg_col[i],
                                star=w.arg is None,
                            )
                        v = _agg_final(w.fn, acc)
                        for t in range(lo, hi + 1):
                            vals[idxs[t]] = v
                else:  # aggregate without ORDER BY: whole partition
                    if w.arg is None:  # count(*)
                        v = len(idxs)
                    else:
                        arg_col = merged[w.arg]
                        v = _agg_values(
                            w.fn, [arg_col[i] for i in idxs]
                        )
                    for i in idxs:
                        vals[i] = v
            name = f"__win_{len(new_cols)}"
            new_cols[name] = vals
            win_name[id(w)] = name
            spec_names[spec] = name

        def rewrite(e):
            if isinstance(e, Window):
                return Col(win_name[id(e)])
            if isinstance(e, Arith):
                return Arith(
                    e.op,
                    rewrite(e.left),
                    rewrite(e.right) if e.right is not None else None,
                )
            if isinstance(e, Case):
                return Case(
                    [
                        (rewrite_pred(p), rewrite(x))
                        for p, x in e.branches
                    ],
                    rewrite(e.default) if e.default is not None else None,
                )
            if isinstance(e, Call) and e.arg != "*":
                new_args = [rewrite(a) for a in e.all_args()]
                if not new_args:
                    return e  # zero-arg builtin (current_date())
                return _rebuild_call(e, new_args)
            return e

        def rewrite_pred(node):
            if isinstance(node, NotOp):
                return NotOp(rewrite_pred(node.part))
            if isinstance(node, BoolOp):
                return BoolOp(
                    node.op, [rewrite_pred(p) for p in node.parts]
                )
            col = (
                node.col
                if isinstance(node.col, str)
                else rewrite(node.col)
            )
            value = node.value
            if isinstance(value, (Col, Lit, Arith, Case, Call, Window)):
                value = rewrite(value)
            elif isinstance(value, tuple):  # BETWEEN bounds
                value = tuple(
                    rewrite(v)
                    if isinstance(
                        v, (Col, Lit, Arith, Case, Call, Window)
                    )
                    else v
                    for v in value
                )
            elif isinstance(value, DynItems):
                value = DynItems(
                    rewrite(v)
                    if isinstance(
                        v, (Col, Lit, Arith, Case, Call, Window)
                    )
                    else v
                    for v in value
                )
            return Predicate(col, node.op, value)

        for it in items:
            if it.expr != "*" and _contains_window(it.expr):
                # default output name reflects the ORIGINAL expression
                it.alias = it.alias or _expr_name(it.expr)
                it.expr = rewrite(it.expr)

        rebuilt = {c: merged[c] for c in df.columns}
        rebuilt.update(new_cols)
        return DataFrame.fromColumns(
            rebuilt, numPartitions=max(1, df.numPartitions)
        )

    def _strip_alias(self, q: Query, alias: str) -> None:
        """Strip ``alias.`` qualifiers from every reference in a
        single-table query over an aliased derived table (the JOIN path
        has its own, rename-aware resolution)."""
        tables = {alias}

        def res(name: str) -> str:
            return _strip_qualifier(name, tables)

        def res_expr(e):
            if isinstance(e, Col):
                return Col(res(e.name))
            if isinstance(e, Call):
                if e.arg == "*":
                    return e
                new_args = [res_expr(a) for a in e.all_args()]
                if not new_args:
                    return e  # zero-arg builtin (current_date())
                return _rebuild_call(e, new_args)
            if isinstance(e, Arith):
                return Arith(
                    e.op,
                    res_expr(e.left),
                    res_expr(e.right) if e.right is not None else None,
                )
            if isinstance(e, Case):
                return Case(
                    [(res_pred(p), res_expr(x)) for p, x in e.branches],
                    res_expr(e.default) if e.default is not None else None,
                )
            if isinstance(e, Window):
                return e.map_operands(
                    lambda c: res(c) if isinstance(c, str) else res_expr(c)
                )
            return e

        def res_pred(node):
            if isinstance(node, NotOp):
                return NotOp(res_pred(node.part))
            if isinstance(node, BoolOp):
                return BoolOp(node.op, [res_pred(p) for p in node.parts])
            col = (
                res(node.col)
                if isinstance(node.col, str)
                else res_expr(node.col)
            )
            value = node.value
            if isinstance(value, (Col, Arith, Case, Call)):
                value = res_expr(value)
            return Predicate(col, node.op, value)

        q.items = [
            SelectItem(
                it.expr if it.expr == "*" else res_expr(it.expr), it.alias
            )
            for it in q.items
        ]
        if q.where is not None:
            q.where = res_pred(q.where)
        if q.having is not None:
            q.having = res_pred(q.having)
        q.group = [res_expr(g) for g in q.group]
        if q.grouping_sets:
            q.grouping_sets = [
                [res(c) for c in s] for s in q.grouping_sets
            ]
        q.order = [
            (res(c) if isinstance(c, str) else res_expr(c), a)
            for c, a in q.order
        ]
        if q.lateral_views:
            # LATERAL VIEW args may reference the aliased table
            # (explode(s.tags) under FROM t s)
            q.lateral_views = [
                (fn, res_expr(arg), o, a, c)
                for fn, arg, o, a, c in q.lateral_views
            ]

    def _apply_joins(self, df: DataFrame, q: Query) -> DataFrame:
        """Execute the JOIN chain left-to-right (Spark's associativity)
        over an internally QUALIFIED namespace: every source column is
        renamed to <qual>.<col> (qual = alias or table name) for the
        duration of the join, which makes self-joins (FROM t a JOIN t b
        ON a.id = b.id) and derived tables on either side well-defined.
        Afterwards, columns whose bare name is unique are renamed back
        (so SELECT * and unqualified references look like the flat
        namespace Spark presents), ambiguous ones keep their qualified
        name, and every downstream reference resolves through one map.
        ON keys join by renaming the right key onto the left key's
        column, so references to the right key — qualified always,
        unqualified when unambiguous — follow the rename."""
        if isinstance(q.table, (Query, UnionQuery)):
            src_qual = q.table.subquery_alias or "__subquery"
        else:
            src_qual = q.table_alias or q.table
        quals: List[str] = [src_qual]

        def qualify(frame: DataFrame, qual: str) -> DataFrame:
            for c in list(frame.columns):
                frame = frame.withColumnRenamed(c, f"{qual}.{c}")
            return frame

        # the optimizer arm scans each join input for only what the query
        # reads: every column whose name, or bare name, a select item,
        # WHERE, GROUP BY, HAVING, ORDER BY or an ON key names. A bare
        # name keeps every side's column of that name, so which names
        # collide (and stay qualified) is what the unpruned join has.
        needed = (
            _query_referenced_columns(q, windows=True)
            if udf_catalog.sql_vectorize_enabled()
            else None
        )
        if needed is not None:
            for jn in q.joins:
                needed.update(k for k in (jn.left_key, jn.right_key) if k)
            needed |= {c.partition(".")[2] for c in needed if "." in c}

        def prune(frame: DataFrame) -> DataFrame:
            if needed is None:
                return frame
            keep = [c for c in frame.columns if c in needed] or frame.columns[:1]
            if len(keep) == len(frame.columns):
                return frame
            metrics.inc("sql.pushdown.pruned_cols", len(frame.columns) - len(keep))
            return frame.select(*keep)

        df = qualify(prune(df), src_qual)
        renames: Dict[str, str] = {}  # renamed-away qualified -> kept

        def resolve_side(raw, frame_cols, own_quals):
            """Resolve one ON operand within one side's qualified
            columns; None when it does not belong to that side."""
            if "." in raw:
                t, _, c = raw.partition(".")
                if t in own_quals and c:
                    qname = renames.get(f"{t}.{c}", f"{t}.{c}")
                    return qname if qname in frame_cols else None
                return None
            cands = [
                fc for fc in frame_cols if fc.partition(".")[2] == raw
            ]
            if not cands:
                # an earlier join's renamed-away right key stays
                # addressable by its bare name (JOIN b ON a.id = b.bid
                # JOIN c ON bid = c.x follows bid -> a.id)
                cands = sorted({
                    tgt
                    for src, tgt in renames.items()
                    if src.partition(".")[2] == raw and tgt in frame_cols
                })
            if len(cands) > 1:
                raise ValueError(
                    f"Ambiguous join key {raw!r} (candidates: "
                    f"{sorted(cands)}); qualify it as <table>.{raw}"
                )
            return cands[0] if cands else None

        for jn in q.joins:
            qual = jn.alias or jn.table  # parser guarantees str here
            if qual in quals:
                raise ValueError(
                    f"Table name/alias {qual!r} appears twice in the "
                    "join chain; alias each occurrence "
                    "(FROM t a JOIN t b ON a.k = b.k)"
                )
            if isinstance(jn.table, UnionQuery):
                right = self._run_union(jn.table)
            elif isinstance(jn.table, Query):
                right = self._run_query(jn.table)
            else:
                right = self.table(jn.table)
            right = qualify(prune(right), qual)

            if jn.left_key is None and jn.right_key is None:
                # keyless cartesian branch (FROM t, m and CROSS JOIN m):
                # no ON keys to resolve or rename — the qualified
                # namespaces are disjoint, so the product is direct
                df = df.crossJoin(right)
                quals.append(qual)
                continue

            quals_set = set(quals)
            lk_raw, rk_raw = jn.left_key, jn.right_key
            lq = resolve_side(lk_raw, df.columns, quals_set)
            rq = resolve_side(rk_raw, right.columns, {qual})
            if lq is None or rq is None:
                # the ON may be written reversed (ON b.k = a.k)
                lq2 = resolve_side(rk_raw, df.columns, quals_set)
                rq2 = resolve_side(lk_raw, right.columns, {qual})
                if lq2 is not None and rq2 is not None:
                    lq, rq = lq2, rq2
                    lk_raw, rk_raw = rk_raw, lk_raw
            if lq is None:
                raise KeyError(
                    f"Join key {lk_raw!r} not found among joined tables "
                    f"{sorted(quals)}"
                )
            if rq is None:
                raise KeyError(
                    f"Join key {rk_raw!r} not found in table {qual!r}"
                )
            right = right.withColumnRenamed(rq, lq)
            renames[rq] = lq
            df = df.join(right, on=lq, how=jn.how)
            quals.append(qual)

        # Demote each qualified column to its bare name where that is
        # unique across the joined frame; self-join collisions keep the
        # qualified spelling (Spark keeps duplicate flat names instead,
        # which this DataFrame cannot represent).
        bare_count: Dict[str, int] = {}
        for c in df.columns:
            b = c.partition(".")[2]
            bare_count[b] = bare_count.get(b, 0) + 1
        final: Dict[str, str] = {}
        for c in list(df.columns):
            b = c.partition(".")[2]
            final[c] = b if bare_count[b] == 1 else c
            if final[c] != c:
                df = df.withColumnRenamed(c, final[c])

        # bare name -> possible final names, including renamed-away
        # right keys (references to them follow the rename when no
        # other column claims the name)
        bare_map: Dict[str, set] = {}
        for qname, out in final.items():
            bare_map.setdefault(qname.partition(".")[2], set()).add(out)
        for rq_, lq_ in renames.items():
            bare_map.setdefault(rq_.partition(".")[2], set()).add(
                final[lq_]
            )
        quals_set = set(quals)

        def resolve(name: str) -> str:
            if "." in name:
                t, _, c = name.partition(".")
                if t in quals_set and c:
                    qname = renames.get(f"{t}.{c}", f"{t}.{c}")
                    out = final.get(qname)
                    if out is None:
                        raise KeyError(
                            f"Unknown column {name!r} among joined "
                            f"tables {sorted(quals)}"
                        )
                    return out
                return name
            targets = bare_map.get(name)
            if targets is None:
                return name  # not a join column; downstream validates
            if len(targets) > 1:
                raise ValueError(
                    f"Ambiguous reference {name!r} (candidates: "
                    f"{sorted(targets)}); qualify it as <table>.{name}"
                )
            return next(iter(targets))

        def resolve_expr(e):
            if isinstance(e, Col):
                return Col(resolve(e.name))
            if isinstance(e, Call):
                if e.arg == "*":
                    return e
                new_args = [resolve_expr(a) for a in e.all_args()]
                if not new_args:
                    return e  # zero-arg builtin (current_date())
                return _rebuild_call(e, new_args)
            if isinstance(e, Arith):
                return Arith(
                    e.op,
                    resolve_expr(e.left),
                    resolve_expr(e.right) if e.right is not None else None,
                )
            if isinstance(e, Case):
                return Case(
                    [
                        (resolve_pred(p), resolve_expr(x))
                        for p, x in e.branches
                    ],
                    resolve_expr(e.default)
                    if e.default is not None
                    else None,
                )
            if isinstance(e, Window):
                return e.map_operands(
                    lambda c: resolve(c)
                    if isinstance(c, str)
                    else resolve_expr(c)
                )
            return e

        def resolve_pred(node):
            if isinstance(node, NotOp):
                return NotOp(resolve_pred(node.part))
            if isinstance(node, BoolOp):
                return BoolOp(
                    node.op, [resolve_pred(p) for p in node.parts]
                )
            col = node.col
            col = (
                resolve(col)
                if isinstance(col, str)
                else resolve_expr(col)
            )
            value = node.value
            if isinstance(value, (Col, Arith, Case, Call)):
                value = resolve_expr(value)
            return Predicate(col, node.op, value)

        q.items = [
            SelectItem(
                it.expr if it.expr == "*" else resolve_expr(it.expr),
                it.alias,
            )
            for it in q.items
        ]
        if q.where is not None:
            q.where = resolve_pred(q.where)
        if q.having is not None:
            q.having = resolve_pred(q.having)
        q.group = [resolve_expr(g) for g in q.group]
        if q.grouping_sets:
            q.grouping_sets = [
                [resolve(c) for c in s] for s in q.grouping_sets
            ]
        q.order = [
            (resolve(c) if isinstance(c, str) else resolve_expr(c), a)
            for c, a in q.order
        ]
        if q.lateral_views:
            # a table-qualified lateral arg under a JOIN
            # (explode(t.tags)) resolves through the same rename map
            q.lateral_views = [
                (fn, resolve_expr(arg), o, a, c)
                for fn, arg, o, a, c in q.lateral_views
            ]
        return df

    def _aggregate_grouping_sets(
        self, df: DataFrame, q: Query
    ) -> DataFrame:
        """GROUP BY ROLLUP/CUBE: one streamed aggregation pass per
        grouping set (the honest way — subtotals cannot generally be
        derived from the finest level), key columns absent from a set
        emit as NULL (standard SQL), results union positionally, and
        ORDER BY/LIMIT apply to the combined rows."""
        # resolve alias keys (ROLLUP(region) where region aliases a
        # plain column), mirroring plain GROUP BY's alias branch
        cols = []
        for g in q.group:
            name = g.name
            if name not in df.columns:
                for it in q.items:
                    if it.alias == name and isinstance(it.expr, Col):
                        name = it.expr.name
                        break
            cols.append(name)
        rename = dict(zip([g.name for g in q.group], cols))
        if q.group_mode == "sets":
            sets = [
                [rename.get(c, c) for c in s]
                for s in (q.grouping_sets or [])
            ]
        elif q.group_mode == "rollup":
            sets = [cols[:i] for i in range(len(cols), -1, -1)]
        else:  # cube: every subset, preserving column order
            sets = [[]]
            for c in cols:
                sets = sets + [s + [c] for s in sets]
            sets.sort(key=len, reverse=True)
        if q.distinct:
            raise ValueError(
                "SELECT DISTINCT with ROLLUP/CUBE is not supported; "
                "dedup in an outer query"
            )
        frames: List[DataFrame] = []
        for gs in sets:
            gset = set(gs)
            absent = set(cols) - gset

            def null_absent(e):
                """References to keys OUTSIDE this grouping set become
                NULL (so upper(r) in a subtotal row evaluates to
                upper(NULL) -> null, like Spark); aggregate subtrees
                stay untouched — their args see the detail rows."""
                if isinstance(e, Col):
                    return Lit(None) if e.name in absent else e
                if isinstance(e, Arith):
                    return Arith(
                        e.op,
                        null_absent(e.left),
                        null_absent(e.right)
                        if e.right is not None
                        else None,
                    )
                if isinstance(e, Case):
                    return Case(
                        [
                            (null_absent_pred(p), null_absent(x))
                            for p, x in e.branches
                        ],
                        null_absent(e.default)
                        if e.default is not None
                        else None,
                    )
                if (
                    isinstance(e, Call)
                    and e.arg != "*"
                    and not _is_aggregate(e)
                    and e.all_args()
                ):
                    new_args = [null_absent(a) for a in e.all_args()]
                    return _rebuild_call(e, new_args)
                return e

            def null_absent_pred(node):
                if isinstance(node, NotOp):
                    return NotOp(null_absent_pred(node.part))
                if isinstance(node, BoolOp):
                    return BoolOp(
                        node.op,
                        [null_absent_pred(p) for p in node.parts],
                    )
                col = node.col
                if isinstance(col, str):
                    col = Lit(None) if col in absent else col
                else:
                    col = null_absent(col)
                value = (
                    null_absent(node.value)
                    if isinstance(
                        node.value, (Col, Lit, Arith, Case, Call)
                    )
                    else node.value
                )
                return Predicate(col, node.op, value)

            items2: List[SelectItem] = []
            for it in q.items:
                e = it.expr
                name = it.alias or (
                    _expr_name(e) if e != "*" else "*"
                )
                if e != "*":
                    e = null_absent(e)
                items2.append(SelectItem(e, it.alias or name))
            having2 = (
                null_absent_pred(q.having)
                if q.having is not None
                else None
            )
            q2 = Query(
                items2, False, q.table, [], None,
                [Col(g) for g in gs], having2, [], None,
            )
            frames.append(self._aggregate(df, q2))
        out = frames[0]
        for f in frames[1:]:
            out = out.union(f)
        if q.order:
            names, asc = [], []
            for c, a in q.order:
                name = c if isinstance(c, str) else _expr_name(c)
                if name not in out.columns:
                    raise KeyError(
                        f"ORDER BY {name!r} on a ROLLUP/CUBE query must "
                        f"name an output column; available: {out.columns}"
                    )
                names.append(name)
                asc.append(a)
            out = out.orderBy(*names, ascending=asc)
        # q.offset is always consumed by _run_query's rewrite before
        # aggregation; only limit can remain here
        return out.limit(q.limit) if q.limit is not None else out

    def _aggregate(self, df: DataFrame, q: Query) -> DataFrame:
        """GROUP BY / global aggregation, STREAMED partition-at-a-time
        (memory O(groups), never O(rows) — BASELINE config 2 'SQL scoring
        at scale' must aggregate ImageNet-sized tables)."""
        if q.group_mode:
            return self._aggregate_grouping_sets(df, q)
        # GROUP BY expressions (GROUP BY upper(x), GROUP BY CASE ...):
        # materialize each non-column key as a canonical-named column so
        # the streamed engine only ever groups by names; select items
        # repeating the same expression text match via that name
        group_names: List[str] = []
        for g in q.group:
            if isinstance(g, Lit):
                # Spark ordinal semantics: GROUP BY 1 = first select item
                if not isinstance(g.value, int) or not (
                    1 <= g.value <= len(q.items)
                ):
                    raise ValueError(
                        f"GROUP BY literal {g.value!r} must be a "
                        f"select-item ordinal in 1..{len(q.items)}"
                    )
                g = q.items[g.value - 1].expr
                if g == "*" or _contains_aggregate(g):
                    raise ValueError(
                        "GROUP BY ordinal must reference a non-aggregate "
                        "select item"
                    )
            if isinstance(g, Col) and g.name not in df.columns:
                # GROUP BY <select alias> (SELECT upper(x) AS d ...
                # GROUP BY d): the alias resolves only when no source
                # column claims the name, matching Spark's precedence
                for it in q.items:
                    if it.alias == g.name and it.expr != "*":
                        if _contains_aggregate(it.expr) or _contains_window(
                            it.expr
                        ):
                            raise ValueError(
                                f"GROUP BY alias {g.name!r} must reference "
                                "a non-aggregate select item"
                            )
                        g = it.expr
                        break
            if isinstance(g, Col):
                group_names.append(g.name)
                continue
            if _contains_aggregate(g) or _contains_window(g):
                raise ValueError(
                    "GROUP BY expressions cannot contain aggregates or "
                    f"window functions: {_expr_name(g)}"
                )
            name = _expr_name(g)
            if name not in df.columns:
                df = _apply_expr(df, g, name)
            group_names.append(name)
        q = Query(
            q.items, q.distinct, q.table, q.joins, q.where,
            group_names, q.having, q.order, q.limit, q.subquery_alias,
        )
        group_set = set(q.group)

        def valid_pred(node) -> bool:
            """CASE conditions inside grouped items may reference group
            columns, aggregates, and literals only."""
            if isinstance(node, NotOp):
                return valid_pred(node.part)
            if isinstance(node, BoolOp):
                return all(valid_pred(p) for p in node.parts)
            col_ok = (
                node.col in group_set
                if isinstance(node.col, str)
                else valid_item(node.col)
            )
            value_ok = (
                valid_item(node.value)
                if isinstance(node.value, (Col, Arith, Case, Call))
                else True
            )
            return col_ok and value_ok

        def valid_item(e) -> bool:
            """aggregate | group column/expression | literal | CASE /
            arithmetic over those"""
            if _is_aggregate(e):
                return True
            if isinstance(e, Col):
                return e.name in group_set
            if not isinstance(e, Lit) and _expr_name(e) in group_set:
                return True  # repeats a GROUP BY expression verbatim
            if isinstance(e, Lit):
                return True
            if isinstance(e, Arith):
                return valid_item(e.left) and (
                    e.right is None or valid_item(e.right)
                )
            if isinstance(e, Case):
                return all(
                    valid_pred(p) and valid_item(x) for p, x in e.branches
                ) and (e.default is None or valid_item(e.default))
            if isinstance(e, Lambda):
                # a lambda argument is valid when every FREE column its
                # body references (params bind inward) is a group key
                return all(
                    name in group_set
                    for name in _lambda_free_cols(e, frozenset())
                )
            if _is_builtin_call(e):
                return all(valid_item(a) for a in e.all_args())
            return False

        for it in q.items:
            if it.expr == "*" or not valid_item(it.expr):
                raise ValueError(
                    f"Select item {_expr_name(it.expr) if it.expr != '*' else '*'!s}"
                    " must be a GROUP BY column, an aggregate, or "
                    "arithmetic over those"
                )
        for g in q.group:
            if g not in df.columns:
                raise KeyError(f"Unknown column {g!r} in GROUP BY")

        # one spec per aggregate item; plain items echo their group key
        specs: List[Tuple[str, Optional[str]]] = []
        spec_idx: Dict[int, int] = {}

        def add_spec(call) -> int:
            nonlocal df
            fn = call.fn.lower()
            if call.arg == "*":
                if fn != "count":
                    raise ValueError(f"{fn.upper()}(*) is not valid SQL")
                col = None
            elif isinstance(call.arg, Col):
                col = call.arg.name
                if col not in df.columns:
                    raise KeyError(f"Unknown column {col!r} in aggregate")
            else:
                # aggregate over an expression (SUM(price * qty)):
                # materialize the arg as a column before the streamed
                # pass. Keyed by the CANONICAL expression name so the
                # same textual aggregate (select list + HAVING) shares
                # one helper column and one spec — the engine stays
                # O(groups), not O(occurrences x rows). Column refs
                # validate EAGERLY (plan time), like plain-column args.
                _check_expr_columns(call.arg, df.columns)
                col = f"__sql_aggarg_{_expr_name(call.arg)}"
                if col not in df.columns:
                    df = _apply_expr(df, call.arg, col)
            if call.distinct:
                fn = "sum_distinct" if fn == "sum" else "count_distinct"
            from sparkdl_tpu_torch.dataframe.frame import _agg_spec_key

            fn = _agg_spec_key(fn, getattr(call, "_params", None))
            spec = (fn, col)
            if spec in specs:
                return specs.index(spec)
            specs.append(spec)
            return len(specs) - 1

        # arithmetic-over-aggregate items: register every aggregate leaf as a
        # spec now (before the streamed pass) and keep a rewritten tree
        # whose Call leaves point at placeholder columns for row-time eval
        item_tree: Dict[int, Any] = {}

        def rewrite_pred(node):
            if isinstance(node, NotOp):
                return NotOp(rewrite_pred(node.part))
            if isinstance(node, BoolOp):
                return BoolOp(
                    node.op, [rewrite_pred(p) for p in node.parts]
                )
            col = (
                node.col
                if isinstance(node.col, str)
                else rewrite_tree(node.col)
            )
            value = node.value
            if isinstance(value, (Col, Arith, Case, Call)):
                value = rewrite_tree(value)
            elif isinstance(value, tuple):  # BETWEEN bounds
                value = tuple(
                    rewrite_tree(v)
                    if isinstance(v, (Col, Arith, Case, Call))
                    else v
                    for v in value
                )
            elif isinstance(value, DynItems):
                value = DynItems(
                    rewrite_tree(v)
                    if isinstance(v, (Col, Arith, Case, Call))
                    else v
                    for v in value
                )
            return Predicate(col, node.op, value)

        def rewrite_tree(e):
            if _is_aggregate(e):
                return Col(f"__agg_{add_spec(e)}")
            if not isinstance(e, (Col, Lit)) and _expr_name(e) in group_set:
                # a verbatim repeat of a GROUP BY expression reads the
                # materialized key column
                return Col(_expr_name(e))
            if isinstance(e, Arith):
                return Arith(
                    e.op,
                    rewrite_tree(e.left),
                    rewrite_tree(e.right) if e.right is not None else None,
                )
            if isinstance(e, Case):
                return Case(
                    [
                        (rewrite_pred(p), rewrite_tree(x))
                        for p, x in e.branches
                    ],
                    rewrite_tree(e.default)
                    if e.default is not None
                    else None,
                )
            if _is_builtin_call(e):
                new_args = [rewrite_tree(a) for a in e.all_args()]
                if not new_args:
                    return e  # zero-arg builtin (current_date())
                return _rebuild_call(e, new_args)
            return e

        for it in q.items:
            if _is_aggregate(it.expr):
                spec_idx[id(it)] = add_spec(it.expr)
            elif (
                isinstance(it.expr, (Arith, Lit, Case))
                or _is_builtin_call(it.expr)
                or (
                    not isinstance(it.expr, Col)
                    and _expr_name(it.expr) in group_set
                )
            ):
                item_tree[id(it)] = rewrite_tree(it.expr)

        select_names = {
            it.alias or _expr_name(it.expr) for it in q.items
        }

        # HAVING: full expression grammar over the aggregated rows.
        # Operands may be aggregates (absent from the select list too —
        # hidden specs), group keys/expressions, select output names,
        # and arithmetic/CASE/builtins over those. References to select
        # outputs substitute the item's computation; aggregate leaves
        # rewrite onto __agg_ placeholder columns exactly like ORDER BY
        # trees; everything else must be a group key — validated
        # EAGERLY, so a typo fails even when aggregation yields zero
        # groups.
        having_tree = None
        if q.having is not None:
            alias_tree: Dict[str, Any] = {}
            for it in q.items:
                if it.expr == "*":
                    continue
                keyname = it.alias or _expr_name(it.expr)
                if _is_aggregate(it.expr):
                    tree: Any = Col(f"__agg_{spec_idx[id(it)]}")
                elif id(it) in item_tree:
                    tree = item_tree[id(it)]
                elif isinstance(it.expr, Col):
                    tree = it.expr
                else:
                    continue
                alias_tree.setdefault(keyname, tree)

            def subst(e):
                if isinstance(e, Col):
                    return alias_tree.get(e.name, e)
                if isinstance(e, Arith):
                    return Arith(
                        e.op,
                        subst(e.left),
                        subst(e.right) if e.right is not None else None,
                    )
                if isinstance(e, Case):
                    return Case(
                        [
                            (subst_pred(p), subst(x))
                            for p, x in e.branches
                        ],
                        subst(e.default)
                        if e.default is not None
                        else None,
                    )
                if (
                    isinstance(e, Call)
                    and e.arg != "*"
                    and not _is_aggregate(e)
                ):
                    new_args = [subst(a) for a in e.all_args()]
                    if not new_args:
                        return e  # zero-arg builtin (current_date())
                    return _rebuild_call(e, new_args)
                return e

            def subst_pred(node):
                if isinstance(node, NotOp):
                    return NotOp(subst_pred(node.part))
                if isinstance(node, BoolOp):
                    return BoolOp(
                        node.op, [subst_pred(p) for p in node.parts]
                    )
                col = node.col
                if isinstance(col, str):
                    col = alias_tree.get(col, col)
                    if isinstance(col, Col):
                        col = col.name  # alias of a plain column
                else:
                    col = subst(col)
                value = (
                    subst(node.value)
                    if isinstance(node.value, (Col, Lit, Arith, Case, Call))
                    else node.value
                )
                return Predicate(col, node.op, value)

            having_tree = rewrite_pred(subst_pred(q.having))

            def hval_name(name: str) -> None:
                if name in group_set or name.startswith("__agg_"):
                    return
                raise KeyError(
                    f"Unknown HAVING reference {name!r}; available: "
                    f"{sorted(select_names | set(q.group))}"
                )

            def hcheck(e) -> None:
                if isinstance(e, Col):
                    hval_name(e.name)
                elif isinstance(e, Arith):
                    hcheck(e.left)
                    if e.right is not None:
                        hcheck(e.right)
                elif isinstance(e, Case):
                    for p, x in e.branches:
                        hcheck_pred(p)
                        hcheck(x)
                    if e.default is not None:
                        hcheck(e.default)
                elif isinstance(e, Call) and e.arg != "*":
                    if not _is_builtin_call(e):
                        # aggregates were rewritten onto __agg_ columns
                        # already; anything left must be a builtin (a
                        # typo'd function must fail at planning, even
                        # when aggregation yields zero groups)
                        raise ValueError(
                            f"Unknown function {_expr_name(e)} in "
                            "HAVING; operands are aggregates, group "
                            "keys, and builtin scalars"
                        )
                    for a in e.all_args():
                        hcheck(a)

            def hcheck_pred(node) -> None:
                if isinstance(node, NotOp):
                    hcheck_pred(node.part)
                    return
                if isinstance(node, BoolOp):
                    for p in node.parts:
                        hcheck_pred(p)
                    return
                if isinstance(node.col, str):
                    hval_name(node.col)
                else:
                    hcheck(node.col)
                if isinstance(node.value, (Col, Lit, Arith, Case, Call)):
                    hcheck(node.value)

            hcheck_pred(having_tree)

        # ORDER BY expressions on a grouped query (ORDER BY count(*)
        # DESC, ORDER BY sum(v) / count(*)): register their aggregate
        # leaves as hidden specs NOW (before the streamed pass) and keep
        # rewritten trees for per-group evaluation; string keys resolve
        # against the output as before
        order_plan: List[Tuple[str, Any, bool]] = []
        for c, a in q.order:
            if isinstance(c, str):
                order_plan.append(("name", c, a))
                continue
            name = _expr_name(c)
            if name in select_names:
                order_plan.append(("name", name, a))
                continue
            if q.distinct:
                raise ValueError(
                    f"ORDER BY {name} must be in the select list of a "
                    "SELECT DISTINCT query"
                )
            if not valid_item(c):
                raise ValueError(
                    f"ORDER BY {name} on a grouped query must be an "
                    "aggregate, a group key, or arithmetic over those"
                )
            order_plan.append(("tree", rewrite_tree(c), a))

        key_rows, agg_cols = _streaming_group_agg(df, q.group, specs)

        # per-group evaluation scope for rewritten trees (select items
        # and ORDER BY expressions), computed once per group row
        need_scopes = (
            bool(item_tree)
            or having_tree is not None
            or any(k == "tree" for k, _, _ in order_plan)
        )
        scopes: List[Dict[str, Any]] = []
        if need_scopes:
            for i in range(len(key_rows)):
                scope = {
                    f"__agg_{j}": agg_cols[j][i] for j in range(len(specs))
                }
                for gi, g in enumerate(q.group):
                    scope[g] = key_rows[i][gi]
                scopes.append(scope)

        order_tree_vals: List[List[Any]] = [
            [_eval_expr_row(payload, s) for s in scopes]
            for kind, payload, _ in order_plan
            if kind == "tree"
        ]

        out: Dict[str, List[Any]] = {}
        for it in q.items:
            name = it.alias or _expr_name(it.expr)
            if name in out:
                raise ValueError(
                    f"Duplicate output column {name!r} in select list"
                )
            if _is_aggregate(it.expr):
                out[name] = agg_cols[spec_idx[id(it)]]
            elif id(it) in item_tree:
                tree = item_tree[id(it)]
                out[name] = [_eval_expr_row(tree, s) for s in scopes]
            else:
                gi = q.group.index(it.expr.name)
                out[name] = [kr[gi] for kr in key_rows]

        if q.having is not None:
            # the rewritten tree evaluates per group row against the
            # same scopes the item/ORDER BY trees use — one predicate
            # engine (SQL three-valued, collapsed: NULL drops the group)
            keep = [_eval_pred(having_tree, s) for s in scopes]
            out = {
                name: [v for v, k in zip(vals, keep) if k]
                for name, vals in out.items()
            }
            order_tree_vals = [
                [v for v, k in zip(vals, keep) if k]
                for vals in order_tree_vals
            ]

        # ORDER BY: resolve every key to a COLUMN name — output columns
        # directly, hidden columns for expression keys and for group
        # keys absent from the select list (legal Spark) — then sort
        # through the one DataFrame.orderBy implementation and drop the
        # hidden keys. With DISTINCT, hidden keys would change
        # distinctness, so only output names are allowed (trees were
        # rejected at planning).
        hidden: Dict[str, List[Any]] = {}
        cols: List[str] = []
        asc: List[bool] = []
        ti = 0
        for kind, payload, a in order_plan:
            if kind == "tree":
                name = f"__ord_{ti}"
                hidden[name] = order_tree_vals[ti]
                ti += 1
            elif payload in out:
                name = payload
            elif not q.distinct and payload in q.group:
                gi = q.group.index(payload)
                vals = [kr[gi] for kr in key_rows]
                if q.having is not None:
                    vals = [v for v, k in zip(vals, keep) if k]
                name = f"__ordkey_{gi}"
                hidden[name] = vals
            else:
                raise KeyError(
                    f"Unknown ORDER BY column {payload!r}; available: "
                    f"{sorted(set(out) | set(q.group))}"
                )
            cols.append(name)
            asc.append(a)

        res = DataFrame.fromColumns({**out, **hidden})
        if q.distinct:
            # SELECT DISTINCT over an aggregated projection dedups the
            # RESULT rows (visible when the select list omits some group
            # keys: SELECT DISTINCT k ... GROUP BY k, v); hidden is
            # always empty here
            res = res.distinct()
        if cols:
            res = res.orderBy(*cols, ascending=asc)
            if hidden:
                res = res.drop(*hidden)
        return res.limit(q.limit) if q.limit is not None else res


_default = SQLContext()


def registerDataFrameAsTable(df: DataFrame, name: str) -> None:
    _default.registerDataFrameAsTable(df, name)


def dropTempTable(name: str) -> None:
    _default.dropTempTable(name)


def sql(query: str) -> DataFrame:
    return _default.sql(query)
