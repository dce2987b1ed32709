"""Window expressions — a host-only copy of
`spark_rapids_tpu/expr/windows.py` over the port's expressions (the
GpuWindowExpression analog; reference: GpuWindowExpression.scala,
GpuWindowExecMeta.scala:673; function registry GpuOverrides.scala window
expr rules).

A `WindowExpression` pairs a window function (ranking function, lead/lag,
or any AggregateFunction) with a `WindowSpecDef` (partition exprs, sort
orders, frame). Evaluation happens inside `TpuWindowExec`
(exec/operators.py) over ops/windowops.py; expression nodes here only
carry structure and types.
The port evaluates every function here, and the aggregates Sum, Count,
Average, Min, Max, First and Last over frames; the planner refuses the
reference's other window aggregates (collect and variance frames).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.expr.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expr.core import Expression, Literal
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.sqltypes import DataType
from spark_rapids_tpu_torch.sqltypes.datatypes import double, integer


class WindowFrame:
    """ROWS/RANGE frame; lower/upper: None = UNBOUNDED, 0 = CURRENT ROW,
    other values = offsets (negative = PRECEDING)."""

    def __init__(self, frame_type: str, lower, upper):
        assert frame_type in ("rows", "range")
        self.frame_type = frame_type
        self.lower = lower
        self.upper = upper

    def key(self) -> Tuple:
        return (self.frame_type, self.lower, self.upper)

    def __repr__(self):
        def b(v, side):
            if v is None:
                return f"unbounded {side}"
            if v == 0:
                return "current row"
            return f"{abs(v)} {'preceding' if v < 0 else 'following'}"
        return (f"{self.frame_type} between {b(self.lower, 'preceding')} "
                f"and {b(self.upper, 'following')}")


class WindowSpecDef:
    def __init__(self, partitions: Sequence[Expression],
                 orders: Sequence[SortOrder],
                 frame: Optional[WindowFrame] = None):
        self.partitions = list(partitions)
        self.orders = list(orders)
        self.frame = frame

    def sort_key(self) -> Tuple:
        """Groups window expressions that can share one sorted pass."""
        return (tuple(p.key() for p in self.partitions),
                tuple((o.expr.key(), o.ascending, o.nulls_first)
                      for o in self.orders))

    def key(self) -> Tuple:
        return self.sort_key() + (
            self.frame.key() if self.frame else None,)


class WindowFunction(Expression):
    """Ranking/offset functions valid only inside a window spec."""

    needs_order = True

    @property
    def nullable(self):
        return False


class RowNumber(WindowFunction):
    @property
    def dtype(self) -> DataType:
        return integer


class Rank(WindowFunction):
    @property
    def dtype(self) -> DataType:
        return integer


class DenseRank(WindowFunction):
    @property
    def dtype(self) -> DataType:
        return integer


class PercentRank(WindowFunction):
    @property
    def dtype(self) -> DataType:
        return double


class CumeDist(WindowFunction):
    @property
    def dtype(self) -> DataType:
        return double


class NTile(WindowFunction):
    def __init__(self, n: int):
        super().__init__()
        assert n >= 1
        self.n = n

    @property
    def dtype(self) -> DataType:
        return integer

    def key(self):
        return ("ntile", self.n)


class Lead(WindowFunction):
    """lead(input, offset, default); Lag is Lead with negative offset."""

    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        super().__init__([child] if default is None else [child, default])
        self.offset = offset

    @property
    def input(self) -> Expression:
        return self.children[0]

    @property
    def default(self) -> Optional[Expression]:
        return self.children[1] if len(self.children) > 1 else None

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def nullable(self):
        return True

    def key(self):
        return ("lead", self.offset,
                tuple(c.key() for c in self.children))

    def with_children(self, children):
        d = children[1] if len(children) > 1 else None
        node = Lead(children[0], self.offset, d)
        node.__class__ = type(self)
        return node


class Lag(Lead):
    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        # pyspark: lag(c, -n) == lead(c, n), so negate rather than -abs
        super().__init__(child, -offset, default)


class WindowExpression(Expression):
    """function OVER spec. Children = [function, *partition_exprs,
    *order_exprs] so bottom-up resolution/rewrites reach the spec."""

    def __init__(self, function: Expression, spec: WindowSpecDef):
        assert isinstance(function, (WindowFunction, AggregateFunction)), \
            f"not a window function: {function!r}"
        if spec.frame is not None and not spec.orders:
            raise ValueError(
                "a window frame (rowsBetween/rangeBetween) requires "
                "ORDER BY in the window spec (Spark analysis rule)")
        children = ([function] + list(spec.partitions) +
                    [o.expr for o in spec.orders])
        super().__init__(children)
        self.spec = spec

    @property
    def function(self) -> Expression:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return self.function.dtype

    @property
    def nullable(self):
        if isinstance(self.function, AggregateFunction):
            return True
        return self.function.nullable

    def with_children(self, children):
        np_ = len(self.spec.partitions)
        func = children[0]
        parts = children[1:1 + np_]
        oexprs = children[1 + np_:]
        orders = [SortOrder(e, o.ascending, o.nulls_first)
                  for e, o in zip(oexprs, self.spec.orders)]
        return WindowExpression(
            func, WindowSpecDef(parts, orders, self.spec.frame))

    def key(self):
        return ("winexpr", self.function.key(), self.spec.key())

    def __repr__(self):
        return f"{self.function!r} OVER {self.spec.key()!r}"


def contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpression):
        return True
    return any(contains_window(c) for c in e.children)
