"""Declarative aggregate functions with update / merge / evaluate phases —
counterpart of `spark_rapids_tpu/expr/aggregates.py` for Sum, Count and
Average over long and double inputs (decimal buffers and the 128-bit sums
are not ported yet).

- update: raw input values -> per-group partial buffers (segmented
  reductions, kernel K4),
- merge: partial buffers from many batches -> combined buffers,
- evaluate: buffers -> final value.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.ops import segmented
from spark_rapids_tpu_torch.sqltypes import (
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import double, long, torch_dtype


class AggregateFunction(Expression):
    """Base; children are the input expressions (if any)."""

    name: str = "agg"

    def buffer_types(self) -> List[DataType]:
        raise NotImplementedError

    def update(self, values: DeviceColumn, live, gid, cap
               ) -> List[DeviceColumn]:
        """Segmented partial aggregation over grouped input rows."""
        raise NotImplementedError

    def merge(self, buffers: List[DeviceColumn], live, gid, cap
              ) -> List[DeviceColumn]:
        """Combine partial buffers grouped by key."""
        raise NotImplementedError

    def evaluate(self, buffers: List[DeviceColumn]) -> DeviceColumn:
        raise NotImplementedError


def _sum_result_type(t: DataType) -> DataType:
    if isinstance(t, (FloatType, DoubleType)):
        return double
    if isinstance(t, DecimalType):
        raise NotImplementedError("decimal sums are not ported yet")
    return long


def _ones(cnt: torch.Tensor) -> torch.Tensor:
    return torch.ones(cnt.shape, dtype=torch.bool, device=cnt.device)


class Sum(AggregateFunction):
    name = "sum"

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return _sum_result_type(self.children[0].dtype)

    def buffer_types(self):
        return [self.dtype, long]  # (sum, count_nonnull)

    def update(self, values, live, gid, cap):
        out_t = self.dtype
        valid = values.validity & live
        data = values.data.to(torch_dtype(out_t))
        s, cnt = segmented.seg_sum_count(data, valid, gid, cap)
        return [DeviceColumn(out_t, s, cnt > 0),
                DeviceColumn(long, cnt, _ones(cnt))]

    def merge(self, buffers, live, gid, cap):
        cnt = segmented.seg_sum(buffers[1].data, live, gid, cap)
        buf = buffers[0]
        s = segmented.seg_sum(buf.data, buf.validity & live, gid, cap)
        return [DeviceColumn(buf.dtype, s, cnt > 0),
                DeviceColumn(long, cnt, _ones(cnt))]

    def evaluate(self, buffers):
        return buffers[0]


class Count(AggregateFunction):
    """count(expr) skips nulls; count(*) counts rows (child=None)."""

    name = "count"

    def __init__(self, child: Expression = None):
        super().__init__([child] if child is not None else [])

    @property
    def dtype(self):
        return long

    @property
    def nullable(self):
        return False

    def buffer_types(self):
        return [long]

    def update(self, values, live, gid, cap):
        valid = live if values is None else values.validity & live
        cnt = segmented.seg_count(valid, gid, cap)
        return [DeviceColumn(long, cnt, _ones(cnt))]

    def merge(self, buffers, live, gid, cap):
        cnt = segmented.seg_sum(buffers[0].data, live, gid, cap)
        return [DeviceColumn(long, cnt, _ones(cnt))]

    def evaluate(self, buffers):
        return buffers[0]


class Average(AggregateFunction):
    name = "avg"

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        if isinstance(self.children[0].dtype, DecimalType):
            raise NotImplementedError("decimal averages are not ported yet")
        return double

    def buffer_types(self):
        return [_sum_result_type(self.children[0].dtype), long]

    def update(self, values, live, gid, cap):
        return Sum(self.children[0]).update(values, live, gid, cap)

    def merge(self, buffers, live, gid, cap):
        return Sum(self.children[0]).merge(buffers, live, gid, cap)

    def evaluate(self, buffers):
        s, cnt = buffers
        safe = cnt.data.clamp(min=1)
        data = s.data.to(torch.float64) / safe.to(torch.float64)
        return DeviceColumn(self.dtype, data, cnt.data > 0)
