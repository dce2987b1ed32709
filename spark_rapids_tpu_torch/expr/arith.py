"""Arithmetic with Spark semantics — counterpart of
`spark_rapids_tpu/expr/arith.py` for Add, Subtract, Multiply and Divide
over non-decimal numerics: binary type promotion, null propagation,
integral wraparound (the non-ANSI mode; the ANSI overflow checks of
expr/ansicheck.py are not ported yet), and Spark's `/`, which is always
double and null on a zero divisor.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.sqltypes import DataType, DecimalType
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    double,
    numeric_promotion,
    torch_dtype,
)


class BinaryArithmetic(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def _result_type(self) -> DataType:
        lt, rt = self.left.dtype, self.right.dtype
        if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            raise NotImplementedError(
                "decimal arithmetic is not ported yet")
        return numeric_promotion(lt, rt)

    @property
    def dtype(self):
        return self._result_type()

    def _promote(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        out_t = self._result_type()
        tdt = torch_dtype(out_t)
        return lc.data.to(tdt), rc.data.to(tdt), lc, rc, out_t


class Add(BinaryArithmetic):
    _negate_right = False

    def eval(self, ctx):
        ld, rd, lc, rc, out_t = self._promote(ctx)
        if self._negate_right:
            rd = -rd
        return DeviceColumn(out_t, ld + rd, binary_validity(lc, rc))


class Subtract(Add):
    _negate_right = True


class Multiply(BinaryArithmetic):
    def eval(self, ctx):
        ld, rd, lc, rc, out_t = self._promote(ctx)
        return DeviceColumn(out_t, ld * rd, binary_validity(lc, rc))


class Divide(BinaryArithmetic):
    """Spark `/`: double for non-decimal inputs; a zero divisor gives
    null (non-ANSI)."""

    def _result_type(self):
        if isinstance(self.left.dtype, DecimalType) or isinstance(
                self.right.dtype, DecimalType):
            raise NotImplementedError(
                "decimal arithmetic is not ported yet")
        return double

    def eval(self, ctx):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        ld = lc.data.to(torch.float64)
        rd = rc.data.to(torch.float64)
        zero = rd == 0
        out = ld / torch.where(zero, torch.ones_like(rd), rd)
        return DeviceColumn(double, out, binary_validity(lc, rc) & ~zero)
