"""Column functions — counterpart of the part of
`spark_rapids_tpu/api/functions.py` the port's expressions cover: `col`,
`lit`, the sum, avg (mean), count, min, max, first and last aggregates
(first and last over window frames only), the sort directions `asc` and
`desc`, and the window functions `row_number`, `rank`, `dense_rank`,
`percent_rank`, `cume_dist`, `ntile`, `lead` and `lag`."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.api.column import Column, SortColumn, _expr
from spark_rapids_tpu_torch.expr import (
    Average,
    Count,
    First,
    Last,
    Literal,
    Max,
    Min,
    Sum,
)


class UnresolvedColumn:
    """A column named by the user, bound to an ordinal when the DataFrame
    resolves the expression against its schema."""

    def __init__(self, name: str):
        self.name = name


def col(name: str) -> Column:
    return Column(UnresolvedColumn(name), name)  # type: ignore[arg-type]


def lit(v: Any) -> Column:
    return Column(Literal(v))


def expr_of(c) -> Any:
    if isinstance(c, Column):
        return c.expr
    if isinstance(c, str):
        # bare strings name columns (pyspark convention for functions)
        return UnresolvedColumn(c)
    return _expr(c)


def sum(c) -> Column:  # noqa: A001
    return Column(Sum(expr_of(c)))


def count(c="*") -> Column:
    if isinstance(c, str) and c == "*":
        return Column(Count(None))
    return Column(Count(expr_of(c)))


def avg(c) -> Column:
    return Column(Average(expr_of(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(Min(expr_of(c)))


def max(c) -> Column:  # noqa: A001
    return Column(Max(expr_of(c)))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(First(expr_of(c), ignore_nulls=ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(Last(expr_of(c), ignore_nulls=ignorenulls), "last")


def asc(c) -> SortColumn:
    return SortColumn(expr_of(c), True)


def desc(c) -> SortColumn:
    return SortColumn(expr_of(c), False)


# ---------------------------------------------------------------- windows

def row_number() -> Column:
    from spark_rapids_tpu_torch.expr.windows import RowNumber

    return Column(RowNumber())


def rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import Rank

    return Column(Rank())


def dense_rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import DenseRank

    return Column(DenseRank())


def percent_rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import PercentRank

    return Column(PercentRank())


def cume_dist() -> Column:
    from spark_rapids_tpu_torch.expr.windows import CumeDist

    return Column(CumeDist())


def ntile(n: int) -> Column:
    from spark_rapids_tpu_torch.expr.windows import NTile

    return Column(NTile(n))


def lit_or(v):
    return v if isinstance(v, Column) else lit(v)


def lead(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.expr.windows import Lead

    d = None if default is None else _expr(lit_or(default))
    return Column(Lead(expr_of(c), offset, d))


def lag(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.expr.windows import Lag

    d = None if default is None else _expr(lit_or(default))
    return Column(Lag(expr_of(c), offset, d))
