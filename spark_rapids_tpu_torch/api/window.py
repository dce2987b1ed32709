"""pyspark.sql.window-compatible Window/WindowSpec builder — a host-only
copy of `spark_rapids_tpu/api/window.py`."""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.api.column import Column, SortColumn, _expr
from spark_rapids_tpu_torch.expr.windows import WindowFrame, WindowSpecDef
from spark_rapids_tpu_torch.plan.logical import SortOrder

_UNBOUNDED = (1 << 63) - 1


def _order_of(c) -> SortOrder:
    if isinstance(c, SortColumn):
        return SortOrder(c.expr, c.ascending, c.nulls_first)
    if isinstance(c, str):
        from spark_rapids_tpu_torch.api.functions import UnresolvedColumn

        return SortOrder(UnresolvedColumn(c))
    return SortOrder(_expr(c))


def _part_of(c):
    if isinstance(c, str):
        from spark_rapids_tpu_torch.api.functions import UnresolvedColumn

        return UnresolvedColumn(c)
    return _expr(c)


def _bound(v):
    """pyspark boundary value -> internal (None=unbounded, 0=current);
    float offsets (rangeBetween over double keys) pass through intact."""
    if v <= -_UNBOUNDED or v >= _UNBOUNDED:
        return None
    return int(v) if isinstance(v, int) else float(v)


class WindowSpec:
    def __init__(self, partitions=(), orders=(),
                 frame: Optional[WindowFrame] = None):
        self._partitions = list(partitions)
        self._orders = list(orders)
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self._partitions + [_part_of(c) for c in cols],
                          self._orders, self._frame)

    def orderBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self._partitions,
                          self._orders + [_order_of(c) for c in cols],
                          self._frame)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partitions, self._orders,
                          WindowFrame("rows", _bound(start), _bound(end)))

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partitions, self._orders,
                          WindowFrame("range", _bound(start), _bound(end)))

    def to_spec_def(self) -> WindowSpecDef:
        return WindowSpecDef(self._partitions, self._orders, self._frame)


class Window:
    unboundedPreceding = -_UNBOUNDED
    unboundedFollowing = _UNBOUNDED
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rowsBetween(start, end)

    @staticmethod
    def rangeBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rangeBetween(start, end)
