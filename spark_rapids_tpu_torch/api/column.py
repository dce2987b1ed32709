"""Column — user-facing expression wrapper with Spark's operator surface;
counterpart of `spark_rapids_tpu/api/column.py` for the operators whose
expressions the port has: arithmetic (+ - * /), comparisons, boolean
& | ~, and `alias`."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.expr import (
    Add,
    Alias,
    And,
    Divide,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    LessThan,
    LessThanOrEqual,
    Literal,
    Multiply,
    Not,
    Or,
    Subtract,
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

    # boolean
    def __and__(self, o):
        return Column(And(self.expr, _expr(o)))

    def __or__(self, o):
        return Column(Or(self.expr, _expr(o)))

    def __invert__(self):
        return Column(Not(self.expr))

    def __repr__(self):
        return f"Column<{self.expr!r}>"

    def __hash__(self):
        return id(self)
