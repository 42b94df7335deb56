"""pyspark-style Column expressions: ``F.col("x") > 3``, ``(F.col("v")
* 2).alias("d")``.

The port's copy of the JAX package's ``dataframe/column.py``, its
row-expression and aggregate half. A Column wraps the SQL layer's expression nodes
(``sparkdl_tpu_torch.sql``'s Col/Lit/Arith/Call/Case/Predicate: one
representation and one evaluator for both surfaces) and compiles down to
the row-callables the DataFrame takes, so ``df.filter(F.col("x") > 3)``
and ``df.filter(lambda r: r["x"] > 3)`` run through the same path.

Semantics follow Spark:

- comparisons against null are unknown, and filter keeps only true, so
  ``~(F.col("x") > 3)`` drops null-x rows (three-valued logic via the SQL
  layer's ``_eval_pred3``);
- ``&``/``|``/``~`` combine conditions (Python's and/or/not raise, as in
  pyspark, because they cannot be overloaded soundly);
- arithmetic propagates null; ``/ 0`` and ``% 0`` yield null;
- ``withColumn`` of a condition produces a True/False/None column.
- an aggregate Column (``F.sum("v")``) works only inside
  ``groupBy(...).agg(...)`` / ``df.agg(...)``; row-wise positions refuse it.

Columns are frame-agnostic expression trees: names resolve when the
expression meets a DataFrame, exactly like SQL text. ``Column.over``
binds a window function or an aggregate to a ``WindowSpec`` (the SQL
layer's Window node); the generators (``ExplodeNode``, ``StackNode``,
``JsonTupleNode``) and the partition-seeded ``NondetNode`` are markers that
only ``DataFrame.select``/``withColumn`` understand.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from sparkdl_tpu_torch import sql as _sql

__all__ = ["Column"]

_PRED_TYPES = (_sql.Predicate, _sql.BoolOp, _sql.NotOp)


class ExplodeNode:
    """Marker for the generator F.explode/explode_outer/posexplode: one
    output row per element of a list cell. Only DataFrame.select
    understands it — generators change row counts, so they cannot ride
    the row-wise evaluator like ordinary expressions."""

    def __init__(self, inner: Any, outer: bool, with_pos: bool = False):
        self.inner = inner  # the list-producing expression
        self.outer = outer  # keep empty/null rows with a null element
        self.with_pos = with_pos  # posexplode: emit (pos, col)


class StackNode:
    """Marker for the generator F.stack(n, e1..ek): n output rows per
    input row, ceil(k/n) columns (col0..col{w-1}); the trailing row
    pads with nulls when n does not divide k (Spark). Top-level
    select item only, like every generator."""

    def __init__(self, n: int, args: list):
        if int(n) < 1:
            raise ValueError(f"stack row count must be >= 1, got {n}")
        self.n = int(n)
        self.args = list(args)  # expression trees
        if not self.args:
            raise ValueError("stack needs at least one value argument")
        self.width = -(-len(self.args) // self.n)  # ceil


class JsonTupleNode:
    """Marker for F.json_tuple(js, f1..fk): k output columns
    (c0..c{k-1}) extracted from TOP-LEVEL JSON fields — row count
    unchanged, but multi-output, so it rides the generator select
    path. Rendering matches get_json_object (scalars as strings,
    containers as JSON text, misses/bad JSON as null)."""

    def __init__(self, src, fields: list):
        self.src = src  # the JSON-string expression
        self.fields = [str(f) for f in fields]
        if not self.fields:
            raise ValueError("json_tuple needs at least one field")


class NondetNode:
    """Marker for partition-seeded generators
    (F.monotonically_increasing_id / F.rand / F.randn): their values
    need the PARTITION INDEX (uniqueness / seed determinism), which only
    the frame's indexed-op path has — so they work as top-level
    select/withColumn items, not inside other expressions."""

    def __init__(self, kind: str, seed: Optional[int] = None):
        self.kind = kind  # 'mono_id' | 'rand' | 'randn'
        self.seed = seed


def _operand(v: Any):
    """A Column's expression, or a literal wrapped as one."""
    if isinstance(v, Column):
        if isinstance(v._expr, (ExplodeNode, StackNode, JsonTupleNode)):
            raise TypeError(
                "generators (explode/stack/json_tuple) produce multiple "
                "rows/columns and only work as TOP-LEVEL select items, "
                "not inside another expression"
            )
        if isinstance(v._expr, NondetNode):
            raise TypeError(
                f"{v._expr.kind} is partition-seeded and only works as "
                "a TOP-LEVEL select/withColumn item; compute it into a "
                "column first, then combine"
            )
        if v._is_pred():
            raise TypeError(
                "A boolean condition cannot be used as a value here; "
                "wrap it with F.when(cond, ...) to turn it into a value"
            )
        return v._expr
    return _sql.Lit(v)


def _pred_of(v: Any):
    """A Column's predicate tree (for &, |, ~ and filter)."""
    if not isinstance(v, Column):
        raise TypeError(
            f"Expected a Column condition, got {type(v).__name__}"
        )
    if not v._is_pred():
        e = v._expr
        if (
            _sql._is_builtin_call(e)
            and e.fn.lower() in _sql._BOOLEAN_FNS
        ):
            # boolean builtins compose like any condition
            # (~F.isnan(c), F.exists(...) & pred): wrap as an equality
            # predicate — null results stay UNKNOWN under 3VL
            return _sql.Predicate(e, "=", True)
        raise TypeError(
            f"Column {v._output_name()!r} is not a condition; build one "
            "with comparisons (>, ==, .isNull(), .isin(), ...)"
        )
    return v._expr


def _like_escape(s: str) -> str:
    """Escape a literal for use inside a LIKE pattern."""
    return (
        str(s).replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
    )


class Column:
    """An unevaluated expression over DataFrame rows (pyspark Column)."""

    __hash__ = None  # == builds a condition, so identity-hash would lie

    def __init__(self, expr: Any, alias: Optional[str] = None):
        self._expr = expr
        self._alias = alias
        self._sort: Optional[bool] = None  # asc()/desc() marker
        # explicit NULLS FIRST/LAST override (None = Spark's default:
        # first when ascending, last when descending)
        self._sort_nulls: Optional[bool] = None

    # -- naming ---------------------------------------------------------

    def alias(self, *names: str) -> "Column":
        """Output name. Multi-output generators take one name per
        output column: posexplode two, stack its width, json_tuple one
        per field."""
        e = self._expr
        multi = None
        if isinstance(e, ExplodeNode) and e.with_pos:
            multi = 2
        elif isinstance(e, StackNode):
            multi = e.width
        elif isinstance(e, JsonTupleNode):
            multi = len(e.fields)
        if multi is not None and multi > 1:
            if len(names) != multi:
                raise ValueError(
                    f"this generator produces {multi} columns; alias "
                    f"all of them (.alias({', '.join(repr(chr(97 + i)) for i in range(multi))}))"
                )
            return Column(e, tuple(names))
        if len(names) != 1:
            raise ValueError("alias() takes one name here")
        return Column(e, names[0])

    name = alias  # pyspark offers both spellings

    def asc(self) -> "Column":
        """Sort-direction marker for orderBy (nulls first, Spark)."""
        c = Column(self._expr, self._alias)
        c._sort = True
        return c

    def desc(self) -> "Column":
        """Sort-direction marker for orderBy (nulls last, Spark)."""
        c = Column(self._expr, self._alias)
        c._sort = False
        return c

    def _sorted_nulls(self, asc: bool, nulls_first: bool) -> "Column":
        c = Column(self._expr, self._alias)
        c._sort = asc
        c._sort_nulls = nulls_first
        return c

    def asc_nulls_first(self) -> "Column":
        """Ascending with nulls first (the ascending default)."""
        return self._sorted_nulls(True, True)

    def asc_nulls_last(self) -> "Column":
        """Ascending with nulls LAST (overrides Spark's default)."""
        return self._sorted_nulls(True, False)

    def desc_nulls_first(self) -> "Column":
        """Descending with nulls FIRST (overrides Spark's default)."""
        return self._sorted_nulls(False, True)

    def desc_nulls_last(self) -> "Column":
        """Descending with nulls last (the descending default)."""
        return self._sorted_nulls(False, False)

    def _is_pred(self) -> bool:
        return isinstance(self._expr, _PRED_TYPES)

    def _has_catalog_call(self) -> bool:
        """Any catalog-UDF call (F.udf / registered UDF) in the tree —
        those dispatch partition-vectorized via the SQL layer's
        _apply_expr, not the row-wise evaluator."""
        return (
            _sql._pred_contains_catalog_call(self._expr)
            if self._is_pred()
            else not isinstance(self._expr, ExplodeNode)
            and _sql._contains_catalog_call(self._expr)
        )

    def _has_window(self) -> bool:
        """Any Window node in the tree — such Columns only work as
        select/withColumn items (the frame routes them through the SQL
        window engine)."""
        if isinstance(self._expr, ExplodeNode):
            return False
        it = (
            _sql._iter_pred_windows(self._expr)
            if self._is_pred()
            else _sql._iter_windows(self._expr)
        )
        return next(it, None) is not None

    def _plain_name(self) -> Optional[str]:
        """The bare column name when this is an unadorned reference."""
        if isinstance(self._expr, _sql.Col):
            return self._expr.name
        return None

    def _output_name(self) -> str:
        if self._alias is not None:
            return self._alias
        if isinstance(self._expr, ExplodeNode):
            return "col"  # pyspark's default explode output name
        if isinstance(self._expr, NondetNode):
            return self._expr.kind
        if self._is_pred():
            return _sql._pred_name(self._expr)
        return _sql._expr_name(self._expr)

    def __repr__(self) -> str:
        return f"Column<{self._output_name()!r}>"

    # -- evaluation bridges (what DataFrame consumes) -------------------

    def _reject_window(self, where: str) -> None:
        if self._has_window():
            if isinstance(self._expr, _sql.Window) and not (
                self._expr.partition_by or self._expr.order_by
            ):
                raise TypeError(
                    f"Window function {self._expr.fn}() needs a window: "
                    "call .over(Window.partitionBy(...).orderBy(...))"
                )
            raise TypeError(
                f"Window Column {self._output_name()!r} cannot be used "
                f"in {where}; window expressions only work as "
                "select()/withColumn() items"
            )

    def _reject_aggregates(self) -> None:
        expr = self._expr
        has_agg = (
            _sql._pred_contains_aggregate(expr)
            if self._is_pred()
            else _sql._contains_aggregate(expr)
        )
        if has_agg:
            raise TypeError(
                f"Aggregate Column {self._output_name()!r} only works "
                "in groupBy().agg(...) / df.agg(...), not in row-wise "
                "positions (select/withColumn/filter)"
            )

    def _row_fn(self) -> Callable[[Any], Any]:
        """row -> value; conditions produce True/False/None cells."""
        if isinstance(self._expr, ExplodeNode):
            raise TypeError(
                "explode() produces multiple rows and only works as a "
                "select item (df.select(..., F.explode(c).alias(...)))"
            )
        if isinstance(self._expr, NondetNode):
            raise TypeError(
                f"{self._expr.kind} needs the partition index and only "
                "works as a top-level select/withColumn item"
            )
        self._reject_window("this position")
        self._reject_aggregates()
        if self._has_catalog_call():
            raise TypeError(
                f"Column {self._output_name()!r} calls a UDF, which "
                "dispatches batched and cannot evaluate row-wise here; "
                "compute it with withColumn/select first"
            )
        expr = self._expr
        if self._is_pred():
            return lambda row: _sql._eval_pred3(expr, row)
        return lambda row: _sql._eval_expr_row(expr, row)

    def _filter_fn(self) -> Callable[[Any], bool]:
        """row -> keep?; three-valued collapse (only True keeps)."""
        self._reject_window(
            "filter (compute it with withColumn first, then filter on "
            "the result, as in Spark)"
        )
        self._reject_aggregates()
        if self._has_catalog_call():
            raise TypeError(
                "A UDF call cannot evaluate row-wise inside filter; "
                "compute it with withColumn first, then filter on the "
                "result"
            )
        expr = self._expr
        if self._is_pred():
            return lambda row: _sql._eval_pred3(expr, row) is True
        bool_builtin = (
            _sql._is_builtin_call(expr)
            and expr.fn.lower() in _sql._BOOLEAN_FNS
        )
        if self._plain_name() is not None or bool_builtin:
            # a bare boolean-valued column (filter(F.col("flag"))) or a
            # BOOLEAN builtin (isnan/array_contains); non-boolean
            # builtins keep the pointed not-a-condition error below
            return lambda row: _sql._eval_expr_row(expr, row) is True
        raise TypeError(
            f"Column {self._output_name()!r} is not a condition; build "
            "one with comparisons (>, ==, .isNull(), .isin(), ...)"
        )

    # -- arithmetic -----------------------------------------------------

    def _arith(self, op: str, other: Any, swap: bool = False) -> "Column":
        a, b = _operand(self), _operand(other)
        if swap:
            a, b = b, a
        return Column(_sql.Arith(op, a, b))

    def __add__(self, other):
        return self._arith("+", other)

    def __radd__(self, other):
        return self._arith("+", other, swap=True)

    def __sub__(self, other):
        return self._arith("-", other)

    def __rsub__(self, other):
        return self._arith("-", other, swap=True)

    def __mul__(self, other):
        return self._arith("*", other)

    def __rmul__(self, other):
        return self._arith("*", other, swap=True)

    def __truediv__(self, other):
        return self._arith("/", other)

    def __rtruediv__(self, other):
        return self._arith("/", other, swap=True)

    def __mod__(self, other):
        return self._arith("%", other)

    def __rmod__(self, other):
        return self._arith("%", other, swap=True)

    def __neg__(self):
        return Column(_sql.Arith("neg", _operand(self)))

    # -- comparisons (build conditions) ---------------------------------

    def _cmp(self, op: str, other: Any) -> "Column":
        return Column(
            _sql.Predicate(_operand(self), op, _operand(other))
        )

    def __gt__(self, other):
        return self._cmp(">", other)

    def __ge__(self, other):
        return self._cmp(">=", other)

    def __lt__(self, other):
        return self._cmp("<", other)

    def __le__(self, other):
        return self._cmp("<=", other)

    def __eq__(self, other):  # noqa: D105 — condition, not identity
        return self._cmp("=", other)

    def __ne__(self, other):
        return self._cmp("<>", other)

    # -- boolean combination --------------------------------------------

    def __and__(self, other):
        return Column(
            _sql.BoolOp("and", [_pred_of(self), _pred_of(other)])
        )

    __rand__ = __and__

    def __or__(self, other):
        return Column(
            _sql.BoolOp("or", [_pred_of(self), _pred_of(other)])
        )

    __ror__ = __or__

    def __invert__(self):
        return Column(_sql.NotOp(_pred_of(self)))

    def __bool__(self):
        raise TypeError(
            "Cannot convert a Column to bool: use '&' for AND, '|' for "
            "OR, '~' for NOT (Python's and/or/not cannot be overloaded)"
        )

    # -- predicate helpers ----------------------------------------------

    def isNull(self) -> "Column":
        return Column(_sql.Predicate(_operand(self), "isnull"))

    def isNotNull(self) -> "Column":
        return Column(_sql.Predicate(_operand(self), "notnull"))

    def isin(self, *values: Any) -> "Column":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        if any(isinstance(v, Column) for v in values):
            # Column elements evaluate per row; literal-only lists keep
            # the fast constant-membership path
            items = _sql.DynItems(
                _operand(v) if isinstance(v, Column) else v
                for v in values
            )
        else:
            items = list(values)
        return Column(_sql.Predicate(_operand(self), "in", items))

    def between(self, lower: Any, upper: Any) -> "Column":
        lo = _operand(lower) if isinstance(lower, Column) else lower
        hi = _operand(upper) if isinstance(upper, Column) else upper
        return Column(_sql.Predicate(_operand(self), "between", (lo, hi)))

    def like(self, pattern: str) -> "Column":
        return Column(_sql.Predicate(_operand(self), "like", pattern))

    def rlike(self, pattern: str) -> "Column":
        """Partial regex match (Spark RLIKE semantics); an invalid
        pattern fails here, not inside a retried partition task."""
        _sql._compile_rlike(pattern)
        return Column(_sql.Predicate(_operand(self), "rlike", pattern))

    def ilike(self, pattern: str) -> "Column":
        """Case-insensitive LIKE (Spark 3.3 Column.ilike)."""
        return Column(_sql.Predicate(_operand(self), "ilike", pattern))

    def _bitwise(self, fn: str, other: Any) -> "Column":
        a, b = _operand(self), _operand(other)
        return Column(_sql.Call(fn, a, False, [a, b]))

    def bitwiseAND(self, other: Any) -> "Column":
        """64-bit (Java long) bitwise AND (pyspark bitwiseAND)."""
        return self._bitwise("bitand", other)

    def bitwiseOR(self, other: Any) -> "Column":
        return self._bitwise("bitor", other)

    def bitwiseXOR(self, other: Any) -> "Column":
        return self._bitwise("bitxor", other)

    def eqNullSafe(self, other: Any) -> "Column":
        """Null-safe equality (<=>): never UNKNOWN — null <=> null is
        True, null <=> value is False (Spark)."""
        return Column(
            _sql.Predicate(_operand(self), "<=>", _operand(other))
        )

    def contains(self, s: str) -> "Column":
        return self.like(f"%{_like_escape(s)}%")

    def startswith(self, s: str) -> "Column":
        return self.like(f"{_like_escape(s)}%")

    def endswith(self, s: str) -> "Column":
        return self.like(f"%{_like_escape(s)}")

    def substr(self, startPos: Any, length: Any) -> "Column":
        """1-based substring (pyspark Column.substr); the position and
        length may be ints or Columns."""
        arg = _operand(self)
        sp = (
            _operand(startPos)
            if isinstance(startPos, Column)
            else _sql.Lit(int(startPos))
        )
        ln = (
            _operand(length)
            if isinstance(length, Column)
            else _sql.Lit(int(length))
        )
        return Column(_sql.Call("substring", arg, False, [arg, sp, ln]))

    def getItem(self, key: Any) -> "Column":
        """0-based list index / dict key lookup on a cell (pyspark
        Column.getItem); out-of-bounds yields null."""
        arg = _operand(self)
        if isinstance(key, int):
            return Column(
                _sql.Call("get", arg, False, [arg, _sql.Lit(key)])
            )
        return Column(
            _sql.Call("element_at", arg, False, [arg, _sql.Lit(key)])
        )

    def getField(self, name: str) -> "Column":
        """Struct-cell field access (pyspark ``Column.getField``);
        missing field / null struct -> null."""
        return self.getItem(str(name))

    def __getattr__(self, name: str) -> "Column":
        """pyspark's attribute sugar for struct fields:
        ``df.meta.device`` == ``df.meta.getField("device")``. Like
        pyspark, only DUNDER names are blocked — Spark's tuple-struct
        fields are named _1/_2 and must stay reachable as
        ``col._1``; real methods and instance attributes (all set in
        __init__) win normal lookup first and never reach here."""
        if name.startswith("__"):
            raise AttributeError(name)
        return self.getField(name)

    def __getitem__(self, key: Any) -> "Column":
        """pyspark's indexing sugar: ``col[key]`` == getItem; a slice
        is pyspark's idiosyncratic substr spelling — ``col[1:3]`` means
        ``substr(startPos=1, length=3)``, the start/stop passed RAW
        (1-based position and LENGTH, not a Python slice)."""
        if isinstance(key, slice):
            if key.step is not None:
                raise ValueError("Column slices do not support a step")
            if key.start is None or key.stop is None:
                raise ValueError(
                    "Column slices need both bounds (col[1:3] means "
                    "substr(startPos=1, length=3), like pyspark)"
                )
            return self.substr(key.start, key.stop)
        return self.getItem(key)

    def __iter__(self):
        # without this, __getitem__(int) (which never raises
        # IndexError) would make `for x in col` / list(col) loop
        # forever through Python's legacy iteration protocol
        raise TypeError("Column is not iterable")

    def withField(self, fieldName: str, col: Any) -> "Column":
        """Copy of the struct cell with one field added or replaced
        (pyspark ``Column.withField``); null struct stays null, a null
        VALUE becomes a null field."""
        arg = _operand(self)
        val = _operand(col) if isinstance(col, Column) else _sql.Lit(col)
        return Column(
            _sql.Call(
                "with_field",
                arg,
                False,
                [arg, _sql.Lit(str(fieldName)), val],
            )
        )

    def dropFields(self, *fieldNames: str) -> "Column":
        """Copy of the struct cell without the named fields (pyspark
        ``Column.dropFields``)."""
        if not fieldNames:
            raise ValueError("dropFields needs at least one field name")
        arg = _operand(self)
        args = [arg] + [_sql.Lit(str(n)) for n in fieldNames]
        return Column(_sql.Call("drop_fields", arg, False, args))

    # -- windowing ------------------------------------------------------

    def over(self, window) -> "Column":
        """Bind a window function or aggregate to a window spec
        (pyspark ``Column.over``): ``F.row_number().over(Window
        .partitionBy("k").orderBy("v"))``, ``F.sum("v").over(w)``.
        Compiles to the SQL layer's Window node — identical semantics
        to ``... OVER (PARTITION BY ...)`` in sql() text."""
        from sparkdl_tpu_torch.dataframe.window import WindowSpec

        if not isinstance(window, WindowSpec):
            raise TypeError(
                f".over() takes a WindowSpec (Window.partitionBy(...)"
                f".orderBy(...)), got {type(window).__name__}"
            )
        e = self._expr
        if isinstance(e, _sql.Window):
            if e.partition_by or e.order_by:
                raise TypeError(
                    f"{e.fn}() is already bound to a window; build a "
                    "fresh function Column for each .over()"
                )
            win = _sql.Window(
                e.fn,
                e.arg,
                list(window._partition_by),
                list(window._order_by),
                e.offset,
                e.default,
                window._frame,
                window._frame_kind,
            )
        elif isinstance(e, _sql.Call) and e.fn in _sql._AGGREGATES:
            if e.distinct:
                raise ValueError(
                    f"DISTINCT aggregates ({e.fn}) are not supported "
                    "over windows"
                )
            if getattr(e, "_params", None) is not None:
                # the Window node has no parameter channel; silently
                # computing the 0.5 default would be worse than
                # refusing (mirrors sql.py window_spec's guard)
                raise ValueError(
                    f"{e.fn}() is not supported as a window function; "
                    "compute it per group with groupBy().agg() instead"
                )
            arg = e.arg
            if arg == "*":
                arg = None  # count(*) over the window
            elif isinstance(arg, _sql.Col):
                arg = arg.name
            win = _sql.Window(
                e.fn,
                arg,
                list(window._partition_by),
                list(window._order_by),
                frame=window._frame,
                frame_kind=window._frame_kind,
            )
        else:
            raise TypeError(
                f"Column {self._output_name()!r} is not a window "
                "function or aggregate; .over() applies to "
                "F.row_number()/rank()/lag()/... and aggregates like "
                "F.sum(col)"
            )
        if _sql._window_needs_order(win.fn) and not win.order_by:
            raise ValueError(
                f"{win.fn}() requires an ordered window: add "
                ".orderBy(...) to the Window spec"
            )
        if win.frame is not None and (
            win.fn in _sql._RANKING_FNS
            or win.fn in _sql._OFFSET_FNS
            or win.fn == "ntile"
        ):
            raise ValueError(
                f"{win.fn}() takes no window frame; drop "
                "rowsBetween/rangeBetween from the spec"
            )
        if win.frame_kind == "range" and win.frame is not None:
            if len(win.order_by) != 1:
                raise ValueError(
                    "rangeBetween with value offsets requires exactly "
                    "one orderBy key (Spark's rule)"
                )
        return Column(win, self._alias)

    # -- casting / conditionals -----------------------------------------

    def try_cast(self, ty: str) -> "Column":
        """Spark 3.5 try_cast — identical to :meth:`cast` here (this
        dialect's cast is already null-on-error, non-ANSI)."""
        return self.cast(ty)

    def cast(self, ty: str) -> "Column":
        ty = ty.lower()
        if ty not in _sql._CAST_TYPES:
            raise ValueError(
                f"Unsupported cast type {ty!r}; supported: "
                f"{sorted(_sql._CAST_TYPES)}"
            )
        arg = _operand(self)
        return Column(
            _sql.Call("cast", arg, False, [arg, _sql.Lit(ty)])
        )

    astype = cast  # pyspark alias

    def when(self, condition: "Column", value: Any) -> "Column":
        """Chain onto F.when(...): add another WHEN branch."""
        if not isinstance(self._expr, _sql.Case):
            raise TypeError(
                ".when() chains onto F.when(cond, value) columns"
            )
        if self._expr.default is not None:
            raise TypeError(".when() cannot follow .otherwise()")
        branches: List = list(self._expr.branches)
        branches.append((_pred_of(condition), _operand(value)))
        return Column(_sql.Case(branches, None), self._alias)

    def otherwise(self, value: Any) -> "Column":
        """Close an F.when(...) chain with the ELSE value."""
        if not isinstance(self._expr, _sql.Case):
            raise TypeError(
                ".otherwise() chains onto F.when(cond, value) columns"
            )
        if self._expr.default is not None:
            raise TypeError(".otherwise() was already given")
        return Column(
            _sql.Case(list(self._expr.branches), _operand(value)),
            self._alias,
        )
