"""SQL scoring: SELECT over registered DataFrames with model UDFs.

Port of the subset of the JAX package's ``sql.py`` that model scoring
runs (upstream: ``registerKerasImageUDF("my_udf", model)``, then
``spark.sql("SELECT my_udf(image) FROM images")``). The semantics are
the JAX package's; the grammar is this much of it:

    SELECT item, ... FROM table [[AS] alias] [WHERE pred]
        [ORDER BY col | ordinal | expr [ASC|DESC], ...] [LIMIT n]
    item := * | expr [[AS] alias]
    expr := column | literal | NULL | udf(expr) | expr (+ - * / %) expr
          | - expr | (expr)
    pred := expr (= != <> < <= > >=) expr | expr IS [NOT] NULL
          | expr [NOT] IN (literal, ...) | expr [NOT] LIKE 'pattern'
          | expr [NOT] BETWEEN expr AND expr | pred AND|OR pred
          | NOT pred | (pred)

Columns may be qualified by the table's alias (or by its name when it
has none). A function is a UDF of the process-global catalog
(``sparkdl_tpu_torch.udf``) and takes one argument; calls nest and may
stand in WHERE, where they are materialized batched before the
predicate runs row by row. NULL follows SQL's three-valued logic:
comparisons with NULL are unknown and WHERE keeps only true rows;
arithmetic over NULL is NULL, and ``x / 0`` and ``x % 0`` are NULL.

Anything else (joins, GROUP BY and aggregates, windows, WITH, set
operations, DISTINCT, subqueries, CASE, CAST, LATERAL VIEW, the row
builtins) raises ValueError naming the construct and ROADMAP Queue A
item 8, where the rest of the JAX package's dialect waits.

The optimizer arm (``SPARKDL_SQL_VECTORIZE``, default on): the scan is
pruned to the columns the query reads (``sql.pushdown.pruned_cols``);
WHERE's UDF-free conjuncts filter first, over only the columns they
read (``sql.pushdown.skipped_rows``), so no UDF scores a row they drop;
model UDFs dispatch batched through the shared feeder (``sql.udf.*``);
without ORDER BY, LIMIT applies before the projection, so no UDF scores
a row the limit drops. 0/off is the row-path planner, the A/B arm.
"""

from __future__ import annotations

import functools
import math
import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.utils.metrics import metrics

_ITEM8 = "ROADMAP Queue A item 8"


class UnsupportedSQL(ValueError):
    """A construct of the JAX package's dialect that this subset lacks."""

    def __init__(self, construct: str):
        super().__init__(
            f"{construct}: not in the port's SQL subset (SELECT over one "
            f"table with one-argument UDFs, WHERE, ORDER BY, LIMIT); it "
            f"waits for {_ITEM8}"
        )


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<comment>--[^\n]*|/\*(?s:.*?)\*/)
      | (?P<num>\d+\.\d+|\d+)
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<qident>`[^`]+`)
      | (?P<op><=>|<=|>=|!=|<>|=|<|>)
      | (?P<concat>\|\|)
      | (?P<arith>[+\-/%])
      | (?P<punct>[(),*])
      | (?P<ident>[A-Za-z_][A-Za-z_0-9.]*)
    )""",
    re.VERBOSE,
)

#: the JAX dialect's reserved words, so that a name parses the same way
#: in both packages (a column named like one needs backticks)
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

#: the JAX dialect's aggregate names, refused where they are called
_AGGREGATES = {
    "count", "sum", "avg", "min", "max", "stddev", "variance",
    "collect_list", "collect_set", "first", "last", "median",
    "stddev_pop", "stddev_samp", "var_pop", "var_samp", "skewness",
    "kurtosis", "sum_distinct", "approx_count_distinct", "percentile",
    "percentile_approx", "corr", "covar_pop", "covar_samp", "bool_and",
    "bool_or", "every", "any_value", "mode",
}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise ValueError(f"SQL syntax error near: {text[pos:pos + 20]!r}")
            break
        pos = m.end()
        kind = m.lastgroup
        val = m.group(kind)
        if kind == "arith" and val == "/" and text[pos:pos + 1] == "*":
            raise ValueError(
                "unterminated block comment: '/*' without a closing "
                f"'*/' near: {text[m.start(kind):m.start(kind) + 20]!r}"
            )
        if kind == "comment":
            continue
        if kind == "qident":
            # backticks quote a column named like a keyword; a quoted
            # true/false is the column, not the literal
            name = val[1:-1]
            out.append(("bident" if name.lower() in ("true", "false") else "ident", name))
        elif kind == "ident" and val.lower() in _KEYWORDS:
            out.append(("kw", val.lower()))
        else:
            out.append((kind, val))
    out.append(("eof", ""))
    return out


@dataclass
class Col:
    name: str


@dataclass
class Lit:
    value: Any


@dataclass
class Arith:
    """+ - * / % and unary 'neg'; NULL in, NULL out; x/0 and x%0 NULL."""

    op: str
    left: Any
    right: Any = None


@dataclass
class Call:
    """A catalog UDF over one argument."""

    fn: str
    arg: Any


Expr = Any  # Col | Lit | Arith | Call


@dataclass
class Predicate:
    col: Any  # column name | Expr
    op: str  # comparison, 'isnull', 'notnull', '[not]in', '[not]between', '[not]like'
    value: Any = None


@dataclass
class BoolOp:
    op: str  # 'and' | 'or'
    parts: List[Any]


@dataclass
class NotOp:
    part: Any


@dataclass
class SelectItem:
    expr: Any  # Expr or "*"
    alias: Optional[str]


@dataclass
class Query:
    items: List[SelectItem]
    table: str
    table_alias: Optional[str]
    where: Optional[Any]
    order: List[Tuple[Any, bool]]  # (column name | ordinal Lit | Expr, asc)
    limit: Optional[int]


_EXPR_TYPES = (Col, Lit, Arith, Call)


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        k, v = self.toks[self.i]
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
        order: List[Tuple[Any, bool]] = []
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

    def order_item(self) -> Tuple[Any, bool]:
        """A column stays a name; an integer literal is a select-item
        ordinal (ORDER BY 1); anything else an expression."""
        e = self.add_expr()
        asc = True
        if self.peek() in (("kw", "asc"), ("kw", "desc")):
            asc = self.next()[1] == "asc"
        if self.peek()[0] == "ident" and self.peek()[1].lower() == "nulls":
            k2, v2 = self.toks[self.i + 1]
            if k2 in ("ident", "kw") and v2.lower() in ("first", "last"):
                raise UnsupportedSQL("NULLS FIRST/LAST")
        return (e.name if isinstance(e, Col) else e), asc

    def select_item(self) -> SelectItem:
        if self.peek() == ("punct", "*"):
            self.next()
            return SelectItem("*", None)
        k, v = self.peek()
        if k == "ident" and v.endswith(".") and self.toks[self.i + 1] == ("punct", "*"):
            raise UnsupportedSQL("a qualified star (t.*)")
        expr = self.add_expr()
        alias = None
        if self.peek() == ("kw", "as"):
            self.next()
            alias = self.expect("ident")
        elif self.peek()[0] == "ident":
            alias = self.next()[1]  # bare alias: SELECT f(x) emb
        return SelectItem(expr, alias)

    def add_expr(self) -> Expr:
        e = self.mul_expr()
        while (self.peek()[0] == "arith" and self.peek()[1] in "+-") or self.peek()[0] == "concat":
            kind, op = self.next()
            if kind == "concat":
                raise UnsupportedSQL("|| (string concatenation, a row builtin)")
            e = Arith(op, e, self.mul_expr())
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
            raise UnsupportedSQL("CASE")
        if (k, v) == ("kw", "null"):
            self.next()
            return Lit(None)
        if (
            k == "ident"
            and v.lower() in ("true", "false")
            and not self._raw_quoted()
            and self.toks[self.i + 1] != ("punct", "(")
        ):
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

    def expr(self) -> Expr:
        kind, val = self.next()
        if kind == "kw" and val in ("exists", "left", "right") and self.peek() == ("punct", "("):
            raise UnsupportedSQL(f"{val}() (a row builtin)")
        if kind != "ident":
            raise ValueError(f"Expected column or function, got {val!r}")
        if self.peek() != ("punct", "("):
            return Col(val)
        self.next()
        fn = val.lower()
        if fn in ("cast", "try_cast", "extract"):
            raise UnsupportedSQL(fn.upper())
        if self.peek() == ("punct", ")"):
            raise UnsupportedSQL(f"the zero-argument call {val}() (window ranking functions, row builtins)")
        if self.peek() == ("punct", "*") or fn in _AGGREGATES:
            raise UnsupportedSQL(f"the aggregate {val}()")
        if self.peek() == ("kw", "distinct"):
            raise UnsupportedSQL(f"{val}(DISTINCT ...) (aggregates)")
        arg = self.add_expr()
        if self.peek() == ("punct", ","):
            raise UnsupportedSQL(f"the multi-argument call {val}(...) (row builtins; a UDF takes one argument)")
        self.expect("punct", ")")
        if self.peek() == ("kw", "over"):
            raise UnsupportedSQL("window functions (OVER)")
        return Call(val, arg)

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
            raise UnsupportedSQL("EXISTS (subqueries)")
        if self.peek() == ("kw", "not"):
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

    def predicate(self) -> Predicate:
        lhs = self.add_expr()
        col = lhs.name if isinstance(lhs, Col) else lhs
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
                raise UnsupportedSQL("IS [NOT] DISTINCT FROM")
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
            if not all(isinstance(e, Lit) for e in elems):
                raise UnsupportedSQL("IN over expressions (the subset takes IN (literals))")
            return Predicate(col, "notin" if negate else "in", [e.value for e in elems])
        if (kind, val) == ("kw", "between"):
            lo = self.add_expr()
            self.expect("kw", "and")
            hi = self.add_expr()
            lo = lo.value if isinstance(lo, Lit) else lo
            hi = hi.value if isinstance(hi, Lit) else hi
            return Predicate(col, "notbetween" if negate else "between", (lo, hi))
        if (kind, val) == ("kw", "like"):
            if self.peek()[0] != "str":
                raise ValueError("LIKE needs a string pattern")
            pat = self.next()[1][1:-1].replace("\\'", "'")
            return Predicate(col, "notlike" if negate else "like", pat)
        if kind == "ident" and val.lower() in ("ilike", "rlike", "regexp"):
            raise UnsupportedSQL(val.upper())
        if negate:
            raise ValueError("NOT is only supported as NOT IN / NOT BETWEEN / NOT LIKE")
        if kind != "op":
            raise ValueError(f"Expected comparison after {col!r}")
        if val == "<=>":
            raise UnsupportedSQL("<=> (null-safe equality)")
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
    """SQL LIKE -> regex: % any run, _ any one character, backslash
    escapes the next."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return re.compile("".join(out), re.S)


def _eval_expr_row(e: Expr, row):
    """One row's value of a Col/Lit/Arith tree (UDF calls are columns by
    now)."""
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
        if b == 0:
            return None
        # SQL's % takes the dividend's sign (-7 % 3 = -1), not Python's
        r = math.fmod(a, b)
        return int(r) if isinstance(a, int) and isinstance(b, int) else r
    raise TypeError(f"Cannot evaluate expression node {e!r}")


def _eval_pred3(node, row) -> Optional[bool]:
    """Three-valued predicate: True, False or None (unknown)."""
    if isinstance(node, NotOp):
        b = _eval_pred3(node.part, row)
        return None if b is None else not b
    if isinstance(node, BoolOp):
        if node.op == "and":
            # stops at the first conjunct that is not true, so later ones
            # never see a row an earlier one rejected
            for p in node.parts:
                b = _eval_pred3(p, row)
                if b is not True:
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
    v = row[node.col] if isinstance(node.col, str) else _eval_expr_row(node.col, row)
    if node.op == "isnull":
        return v is None
    if node.op == "notnull":
        return v is not None
    value = node.value
    if isinstance(value, _EXPR_TYPES):
        value = _eval_expr_row(value, row)
    if node.op in ("in", "notin"):
        if v is None:
            return None
        if v in value:
            return node.op == "in"
        if any(x is None for x in value):
            return None  # x NOT IN (..., NULL) is never true
        return node.op == "notin"
    if v is None or value is None:
        return None
    if node.op in ("between", "notbetween"):
        lo, hi = (
            _eval_expr_row(b, row) if isinstance(b, _EXPR_TYPES) else b
            for b in value
        )
        if lo is None or hi is None:
            return None
        hit = lo <= v <= hi
        return hit if node.op == "between" else not hit
    if node.op in ("like", "notlike"):
        hit = _like_regex(value).fullmatch(str(v)) is not None
        return hit if node.op == "like" else not hit
    return _OPS[node.op](v, value)


def _eval_pred(node, row) -> bool:
    """WHERE keeps a row only when its predicate is true, not unknown."""
    return _eval_pred3(node, row) is True


def _expr_name(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Arith):
        if e.op == "neg":
            return f"(- {_expr_name(e.left)})"
        return f"({_expr_name(e.left)} {e.op} {_expr_name(e.right)})"
    return f"{e.fn}({_expr_name(e.arg)})"


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def _map_exprs(e: Expr, fn) -> Expr:
    """``e`` rebuilt with ``fn`` applied to every Col leaf."""
    if isinstance(e, Col):
        return fn(e)
    if isinstance(e, Arith):
        return Arith(e.op, _map_exprs(e.left, fn), None if e.right is None else _map_exprs(e.right, fn))
    if isinstance(e, Call):
        return Call(e.fn, _map_exprs(e.arg, fn))
    return e


def _map_pred(node, fn):
    if isinstance(node, NotOp):
        return NotOp(_map_pred(node.part, fn))
    if isinstance(node, BoolOp):
        return BoolOp(node.op, [_map_pred(p, fn) for p in node.parts])
    col = fn(Col(node.col)).name if isinstance(node.col, str) else _map_exprs(node.col, fn)
    value = node.value
    if isinstance(value, _EXPR_TYPES):
        value = _map_exprs(value, fn)
    elif isinstance(value, tuple):  # BETWEEN bounds
        value = tuple(_map_exprs(b, fn) for b in value)
    return Predicate(col, node.op, value)


def _iter_calls(e: Expr):
    if isinstance(e, Call):
        yield e
        yield from _iter_calls(e.arg)
    elif isinstance(e, Arith):
        yield from _iter_calls(e.left)
        if e.right is not None:
            yield from _iter_calls(e.right)


def _iter_pred_calls(node):
    if isinstance(node, NotOp):
        yield from _iter_pred_calls(node.part)
    elif isinstance(node, BoolOp):
        for p in node.parts:
            yield from _iter_pred_calls(p)
    else:
        if not isinstance(node.col, str):
            yield from _iter_calls(node.col)
        values = node.value if isinstance(node.value, tuple) else (node.value,)
        for v in values:
            yield from _iter_calls(v)


def _pred_has_call(node) -> bool:
    return next(_iter_pred_calls(node), None) is not None


def _materialize_calls(e: Expr, df: DataFrame, acc: List[str]):
    """Replace every UDF call in ``e`` by a temp column (the UDF runs a
    partition at a time); the rest of the tree then evaluates row by
    row. Returns (rewritten expr, df); the temp names go to ``acc``."""
    if isinstance(e, Call):
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
    return e, df


def _materialize_pred_calls(node, df: DataFrame, acc: List[str]):
    """:func:`_materialize_calls` over a predicate tree: operands and
    BETWEEN bounds."""
    if isinstance(node, NotOp):
        part, df = _materialize_pred_calls(node.part, df, acc)
        return NotOp(part), df
    if isinstance(node, BoolOp):
        parts = []
        for p in node.parts:
            p2, df = _materialize_pred_calls(p, df, acc)
            parts.append(p2)
        return BoolOp(node.op, parts), df
    col = node.col
    if not isinstance(col, str):
        col, df = _materialize_calls(col, df, acc)
    value = node.value
    if isinstance(value, _EXPR_TYPES):
        value, df = _materialize_calls(value, df, acc)
    elif isinstance(value, tuple):
        bounds = []
        for b in value:
            b, df = _materialize_calls(b, df, acc)
            bounds.append(b)
        value = tuple(bounds)
    return Predicate(col, node.op, value), df


def _expr_columns(e: Expr, out: set) -> None:
    if isinstance(e, Col):
        out.add(e.name)
    elif isinstance(e, Arith):
        _expr_columns(e.left, out)
        if e.right is not None:
            _expr_columns(e.right, out)
    elif isinstance(e, Call):
        _expr_columns(e.arg, out)


def _pred_columns(node, out: set) -> None:
    if isinstance(node, NotOp):
        _pred_columns(node.part, out)
    elif isinstance(node, BoolOp):
        for p in node.parts:
            _pred_columns(p, out)
    else:
        if isinstance(node.col, str):
            out.add(node.col)
        else:
            _expr_columns(node.col, out)
        for v in node.value if isinstance(node.value, tuple) else (node.value,):
            _expr_columns(v, out)


def _query_referenced_columns(q: Query) -> Optional[set]:
    """Every source column the query can read, or None under SELECT *.
    ORDER BY names may be select aliases: harmless, the caller keeps the
    frame's columns that are in the set."""
    cols: set = set()
    for it in q.items:
        if it.expr == "*":
            return None
        _expr_columns(it.expr, cols)
    if q.where is not None:
        _pred_columns(q.where, cols)
    for c, _ in q.order:
        if isinstance(c, str):
            cols.add(c)
        else:
            _expr_columns(c, cols)
    return cols


def _count_skipped_rows(n: int) -> None:
    metrics.inc("sql.pushdown.skipped_rows", n)


def _split_where_conjuncts(node):
    """(cheap, expensive): WHERE's top-level AND conjuncts without UDF
    calls, and the rest. A row survives iff every conjunct is true in any
    order, so the cheap half may filter before the UDFs of the other half
    run."""
    parts = node.parts if isinstance(node, BoolOp) and node.op == "and" else [node]
    cheap = [p for p in parts if not _pred_has_call(p)]
    expensive = [p for p in parts if _pred_has_call(p)]

    def rebuild(ps):
        if not ps:
            return None
        return ps[0] if len(ps) == 1 else BoolOp("and", ps)

    return rebuild(cheap), rebuild(expensive)


def _filter_pred(df: DataFrame, node) -> DataFrame:
    """A UDF-free predicate over only the columns it reads
    (``filterOnColumns``); an unknown column name keeps the row filter's
    KeyError."""
    cols: set = set()
    _pred_columns(node, cols)
    if all(c in df.columns for c in cols):
        return df.filterOnColumns(
            lambda r, node=node: _eval_pred(node, r),
            sorted(cols),
            on_skipped=_count_skipped_rows,
        )
    return df.filter(lambda r, node=node: _eval_pred(node, r))


def _apply_expr(df: DataFrame, e: Expr, out_name: str) -> DataFrame:
    """``e`` as the column ``out_name``: UDFs a partition at a time
    through the catalog, arithmetic row by row over their outputs."""
    if isinstance(e, Col):
        if out_name == e.name:
            return df
        if udf_catalog.sql_vectorize_enabled():
            # a column copy that reads no other column's cells
            return df.withColumnPartition(out_name, lambda part, c=e.name: {out_name: part[c]})
        return df.withColumn(out_name, lambda r, c=e.name: r[c])
    if isinstance(e, (Lit, Arith)):
        tmp: List[str] = []
        expr2, df = _materialize_calls(e, df, tmp)
        df = df.withColumn(out_name, lambda r, ex=expr2: _eval_expr_row(ex, r))
        return df.drop(*tmp) if tmp else df
    # a UDF call: its argument lands in a temp column that the UDF's
    # output then replaces (the same name when called by
    # _materialize_calls)
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
        out: List[Tuple[Any, bool]] = []
        for c, a in q.order:
            if isinstance(c, Lit):
                if not isinstance(c.value, int) or not 1 <= c.value <= len(q.items):
                    raise ValueError(
                        f"ORDER BY literal {c.value!r} must be a select-item ordinal in 1..{len(q.items)}"
                    )
                it = q.items[c.value - 1]
                if it.expr == "*":
                    raise ValueError("ORDER BY ordinal cannot reference a * item")
                c = it.alias or _expr_name(it.expr)
            out.append((c, a))
        q.order = out

    @staticmethod
    def _strip_alias(q: Query) -> None:
        """``alias.col`` (or ``table.col`` when there is no alias) reads
        ``col``; under an alias the table's own name does not qualify."""
        qualifier = q.table_alias or q.table

        def res(c: Col) -> Col:
            t, _, name = c.name.partition(".")
            return Col(name) if t == qualifier and name else c

        q.items = [
            SelectItem(it.expr if it.expr == "*" else _map_exprs(it.expr, res), it.alias)
            for it in q.items
        ]
        if q.where is not None:
            q.where = _map_pred(q.where, res)
        q.order = [
            (res(Col(c)).name if isinstance(c, str) else _map_exprs(c, res), a)
            for c, a in q.order
        ]

    @staticmethod
    def _check_functions(q: Query) -> None:
        """Every called name is a catalog UDF: the row builtins and
        aggregates of the JAX dialect are not in this subset."""
        calls = [c for it in q.items if it.expr != "*" for c in _iter_calls(it.expr)]
        if q.where is not None:
            calls += list(_iter_pred_calls(q.where))
        calls += [c for k, _ in q.order if not isinstance(k, str) for c in _iter_calls(k)]
        registered = udf_catalog.list_udfs()
        unknown = sorted({c.fn for c in calls if c.fn not in registered})
        if unknown:
            raise UnsupportedSQL(
                f"the functions {unknown} (not registered UDFs, registered: "
                f"{registered}; row builtins and aggregates)"
            )

    def _run_query(self, q: Query) -> DataFrame:
        self._resolve_order_keys(q)
        df = self.table(q.table)
        self._strip_alias(q)
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
                    df = _filter_pred(df, cheap)
                    remaining = expensive
                else:
                    remaining = q.where
                where, df = _materialize_pred_calls(remaining, df, tmp)
                df = _filter_pred(df, where)
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
        order: List[Tuple[str, bool]] = []
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
