"""Column — user-facing expression wrapper with Spark's operator surface;
counterpart of `spark_rapids_tpu/api/column.py` for the operators whose
expressions the port has: arithmetic (+ - * / % and unary -),
comparisons with `eqNullSafe`, boolean & | ~, `alias`, `cast`, the null
and NaN tests `isNull`, `isNotNull` and `isNaN`, `isin`, the string
predicates `startswith`, `endswith`, `contains` and `rlike`, the sort
directions (`asc`, `desc` and their nulls variants, consumed by orderBy
and window specs) and `over`."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.expr import (
    Add,
    Alias,
    And,
    Cast,
    Contains,
    Divide,
    EndsWith,
    EqualNullSafe,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    In,
    IsNaN,
    IsNotNull,
    IsNull,
    LessThan,
    LessThanOrEqual,
    Literal,
    Multiply,
    Not,
    Or,
    Remainder,
    RLike,
    StartsWith,
    Subtract,
    UnaryMinus,
)
from spark_rapids_tpu_torch.expr.core import Expression


def _expr(v: Any) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


class Column:
    def __init__(self, expr: Expression, name: str = None):
        self.expr = expr
        self._name = name

    @property
    def name(self) -> str:
        if self._name:
            return self._name
        if isinstance(self.expr, Alias):
            return self.expr.name
        return repr(self.expr)

    def alias(self, name: str) -> "Column":
        base = self.expr.children[0] if isinstance(self.expr, Alias) \
            else self.expr
        return Column(Alias(base, name), name)

    def getItem(self, index) -> "Column":
        """array[index] (0-based; out of bounds -> null)."""
        from spark_rapids_tpu_torch.expr.collections import GetArrayItem

        return Column(GetArrayItem(self.expr, _expr(index)), "getItem")

    def getField(self, name: str) -> "Column":
        """struct.field."""
        from spark_rapids_tpu_torch.expr.structs import GetStructField

        return Column(GetStructField(self.expr, name), name)

    def __getitem__(self, key) -> "Column":
        """col[i] on an array (getItem), col["name"] on a struct
        (getField), as PySpark's Column indexes them."""
        if isinstance(key, str):
            return self.getField(key)
        return self.getItem(key)

    def cast(self, to) -> "Column":
        if isinstance(to, str):
            from spark_rapids_tpu_torch.sqltypes.datatypes import (
                parse_type_name,
            )

            to = parse_type_name(to)
        return Column(Cast(self.expr, to))

    # arithmetic
    def __add__(self, o):
        return Column(Add(self.expr, _expr(o)))

    def __radd__(self, o):
        return Column(Add(_expr(o), self.expr))

    def __sub__(self, o):
        return Column(Subtract(self.expr, _expr(o)))

    def __rsub__(self, o):
        return Column(Subtract(_expr(o), self.expr))

    def __mul__(self, o):
        return Column(Multiply(self.expr, _expr(o)))

    def __rmul__(self, o):
        return Column(Multiply(_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(Divide(self.expr, _expr(o)))

    def __rtruediv__(self, o):
        return Column(Divide(_expr(o), self.expr))

    def __mod__(self, o):
        return Column(Remainder(self.expr, _expr(o)))

    def __neg__(self):
        return Column(UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, o):  # noqa: E711
        return Column(EqualTo(self.expr, _expr(o)))

    def __ne__(self, o):  # noqa: E711
        return Column(Not(EqualTo(self.expr, _expr(o))))

    def __lt__(self, o):
        return Column(LessThan(self.expr, _expr(o)))

    def __le__(self, o):
        return Column(LessThanOrEqual(self.expr, _expr(o)))

    def __gt__(self, o):
        return Column(GreaterThan(self.expr, _expr(o)))

    def __ge__(self, o):
        return Column(GreaterThanOrEqual(self.expr, _expr(o)))

    def eqNullSafe(self, o):
        return Column(EqualNullSafe(self.expr, _expr(o)))

    # boolean
    def __and__(self, o):
        return Column(And(self.expr, _expr(o)))

    def __or__(self, o):
        return Column(Or(self.expr, _expr(o)))

    def __invert__(self):
        return Column(Not(self.expr))

    # predicates
    def isNull(self):
        return Column(IsNull(self.expr))

    def isNotNull(self):
        return Column(IsNotNull(self.expr))

    def isNaN(self):
        return Column(IsNaN(self.expr))

    def isin(self, *values):
        vals = values[0] if len(values) == 1 and isinstance(
            values[0], (list, tuple)) else values
        return Column(In(self.expr, list(vals)))

    # strings

    def startswith(self, s: str):
        return Column(StartsWith(self.expr, s))

    def endswith(self, s: str):
        return Column(EndsWith(self.expr, s))

    def contains(self, s: str):
        return Column(Contains(self.expr, s))

    def rlike(self, pattern: str):
        return Column(RLike(self.expr, pattern))

    # sort direction / window

    def asc(self) -> "SortColumn":
        return SortColumn(self.expr, True)

    def desc(self) -> "SortColumn":
        return SortColumn(self.expr, False)

    def asc_nulls_first(self) -> "SortColumn":
        return SortColumn(self.expr, True, nulls_first=True)

    def asc_nulls_last(self) -> "SortColumn":
        return SortColumn(self.expr, True, nulls_first=False)

    def desc_nulls_first(self) -> "SortColumn":
        return SortColumn(self.expr, False, nulls_first=True)

    def desc_nulls_last(self) -> "SortColumn":
        return SortColumn(self.expr, False, nulls_first=False)

    def over(self, window_spec) -> "Column":
        from spark_rapids_tpu_torch.expr.windows import WindowExpression

        base = self.expr.children[0] if isinstance(self.expr, Alias) \
            else self.expr
        return Column(WindowExpression(base, window_spec.to_spec_def()))

    def __repr__(self):
        return f"Column<{self.expr!r}>"

    def __hash__(self):
        return id(self)


class SortColumn:
    """Column + sort direction marker (Column.asc()/desc()); consumed by
    orderBy on DataFrame and WindowSpec. Nulls sort first ascending and
    last descending unless the marker says otherwise (Spark's default)."""

    def __init__(self, expr, ascending: bool, nulls_first=None):
        self.expr = expr
        self.ascending = ascending
        self.nulls_first = (ascending if nulls_first is None
                            else nulls_first)
