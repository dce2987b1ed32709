"""Comparison predicates with Spark null semantics — counterpart of
`spark_rapids_tpu/expr/predicates.py` (EqualTo, LessThan, GreaterThan,
LessThanOrEqual, GreaterThanOrEqual, And, Or, Not). Comparisons propagate
null; And and Or are Kleene. String comparison is lexicographic over
UTF-8 bytes via the packed orderable keys; `<encoded column> = <string
literal>` compares dictionary codes (columnar/encoding.py).
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.ops.common import (
    _float_orderable,
    _string_orderable,
)
from spark_rapids_tpu_torch.sqltypes import (
    DecimalType,
    DoubleType,
    FloatType,
    NumericType,
    StringType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean, double


def _comparable(col: DeviceColumn) -> List[torch.Tensor]:
    """Tensors whose tuple-wise lexicographic order == SQL comparison
    order (floats in Java total order, NaN greatest)."""
    if isinstance(col.dtype, StringType):
        return _string_orderable(col)
    if isinstance(col.dtype, (FloatType, DoubleType)):
        return [_float_orderable(col.data)]
    return [col.data.to(torch.int64)]


def _tuple_lt(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    decided = torch.zeros_like(lt)
    for x, y in zip(a, b):
        lt = lt | (~decided & (x < y))
        decided = decided | (x != y)
    return lt


def _tuple_eq(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        eq = eq & (x == y)
    return eq


def _pad_string(col: DeviceColumn, mb: int) -> DeviceColumn:
    if col.max_bytes == mb:
        return col
    return DeviceColumn(
        col.dtype, torch.nn.functional.pad(col.data, (0, mb - col.max_bytes)),
        col.validity, col.lengths)


def _as_double(col: DeviceColumn) -> DeviceColumn:
    return DeviceColumn(double, col.data.to(torch.float64), col.validity)


def _coerce_numeric(lc: DeviceColumn, rc: DeviceColumn):
    """Promote mismatched numeric operands (Spark's ImplicitTypeCasts):
    int vs float and float vs double compare as doubles; two integral
    widths compare exactly as int64 keys. Decimal comparisons are not
    ported yet."""
    lt, rt = lc.dtype, rc.dtype
    if not (isinstance(lt, NumericType) and isinstance(rt, NumericType)):
        return lc, rc
    if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
        raise NotImplementedError("decimal comparison is not ported yet")
    l_float = isinstance(lt, (FloatType, DoubleType))
    r_float = isinstance(rt, (FloatType, DoubleType))
    if l_float or r_float:
        return _as_double(lc), _as_double(rc)
    return lc, rc


class BinaryComparison(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self):
        return boolean

    def _operands(self, ctx: EvalContext):
        lc = self.children[0].eval(ctx)
        rc = self.children[1].eval(ctx)
        # pad string operands to a common byte width before keying
        if isinstance(lc.dtype, StringType) and lc.max_bytes != rc.max_bytes:
            mb = max(lc.max_bytes, rc.max_bytes)
            lc = _pad_string(lc, mb)
            rc = _pad_string(rc, mb)
        if lc.dtype != rc.dtype:
            lc, rc = _coerce_numeric(lc, rc)
        return lc, rc


class EqualTo(BinaryComparison):
    def eval(self, ctx):
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        # encoded fast path: `<dictionary column> = <string literal>`
        # compares codes against one host-probed code (!= composes
        # through Not(EqualTo))
        fast = _enc.encoded_equality(self.children[0], self.children[1],
                                     ctx)
        if fast is not None:
            return fast
        lc, rc = self._operands(ctx)
        # Spark EqualTo on floats: NaN == NaN is true, -0.0 == 0.0 is true
        if isinstance(lc.dtype, (FloatType, DoubleType)):
            both_nan = torch.isnan(lc.data) & torch.isnan(rc.data)
            eq = (lc.data == rc.data) | both_nan
        else:
            eq = _tuple_eq(_comparable(lc), _comparable(rc))
        return DeviceColumn(boolean, eq, binary_validity(lc, rc))


class LessThan(BinaryComparison):
    def eval(self, ctx):
        lc, rc = self._operands(ctx)
        if isinstance(lc.dtype, (FloatType, DoubleType)):
            r = lc.data < rc.data
            # Spark: NaN is greater than everything, itself included
            lnan, rnan = torch.isnan(lc.data), torch.isnan(rc.data)
            r = torch.where(lnan, False, r)
            r = torch.where(rnan & ~lnan, True, r)
        else:
            r = _tuple_lt(_comparable(lc), _comparable(rc))
        return DeviceColumn(boolean, r, binary_validity(lc, rc))


class GreaterThan(BinaryComparison):
    def eval(self, ctx):
        return LessThan(self.children[1], self.children[0]).eval(ctx)


class LessThanOrEqual(BinaryComparison):
    def eval(self, ctx):
        gt = LessThan(self.children[1], self.children[0]).eval(ctx)
        return DeviceColumn(boolean, ~gt.data, gt.validity)


class GreaterThanOrEqual(BinaryComparison):
    def eval(self, ctx):
        lt = LessThan(self.children[0], self.children[1]).eval(ctx)
        return DeviceColumn(boolean, ~lt.data, lt.validity)


class And(Expression):
    """Kleene: false & null = false."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        lc = self.children[0].eval(ctx)
        rc = self.children[1].eval(ctx)
        false_l = lc.validity & ~lc.data
        false_r = rc.validity & ~rc.data
        valid = (lc.validity & rc.validity) | false_l | false_r
        res = lc.data & rc.data & ~(false_l | false_r)
        return DeviceColumn(boolean, res, valid)


class Or(Expression):
    """Kleene: true | null = true."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        lc = self.children[0].eval(ctx)
        rc = self.children[1].eval(ctx)
        true_l = lc.validity & lc.data
        true_r = rc.validity & rc.data
        valid = (lc.validity & rc.validity) | true_l | true_r
        return DeviceColumn(boolean, true_l | true_r, valid)


class Not(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(boolean, ~c.data, c.validity)
