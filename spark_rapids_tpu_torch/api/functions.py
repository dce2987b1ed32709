"""Column functions — counterpart of the part of
`spark_rapids_tpu/api/functions.py` the port's expressions cover: `col`,
`lit`, the sum, avg (mean) and count aggregates, the sort directions
`asc` and `desc`, and the ranking window functions `row_number`, `rank`
and `dense_rank`."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.api.column import Column, SortColumn, _expr
from spark_rapids_tpu_torch.expr import Average, Count, Literal, Sum


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
