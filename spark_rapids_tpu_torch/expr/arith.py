"""Arithmetic with Spark semantics — counterpart of
`spark_rapids_tpu/expr/arith.py` for Add, Subtract, Multiply, Divide,
IntegralDivide (`div`), Remainder (`%`), Pmod, UnaryMinus and Abs over
non-decimal numerics: binary type promotion, null propagation, integral
wraparound (the non-ANSI mode; the ANSI overflow checks of
expr/ansicheck.py are not ported yet), Spark's `/`, which is always
double, and a zero divisor giving null for `/`, `div`, `%` and pmod.
Decimal operands raise, naming ROADMAP A3.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.sqltypes import (
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    double,
    long,
    numeric_promotion,
    torch_dtype,
)


_DECIMAL = "decimal arithmetic is not ported yet (ROADMAP A3)"


def _no_decimal(*dts) -> None:
    if any(isinstance(t, DecimalType) for t in dts):
        raise NotImplementedError(_DECIMAL)


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
            raise NotImplementedError(_DECIMAL)
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
            raise NotImplementedError(_DECIMAL)
        return double

    def eval(self, ctx):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        ld = lc.data.to(torch.float64)
        rd = rc.data.to(torch.float64)
        zero = rd == 0
        out = ld / torch.where(zero, torch.ones_like(rd), rd)
        return DeviceColumn(double, out, binary_validity(lc, rc) & ~zero)


class IntegralDivide(BinaryArithmetic):
    """Spark `div`: a long, truncated toward zero; a zero divisor gives
    null."""

    def _result_type(self):
        _no_decimal(self.left.dtype, self.right.dtype)
        return long

    def eval(self, ctx):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        ld = lc.data.to(torch.int64)
        rd = rc.data.to(torch.int64)
        zero = rd == 0
        rd_safe = torch.where(zero, torch.ones_like(rd), rd)
        q = (torch.sign(ld) * torch.sign(rd_safe)
             * (torch.abs(ld) // torch.abs(rd_safe)))
        return DeviceColumn(long, q, binary_validity(lc, rc) & ~zero)


class Remainder(BinaryArithmetic):
    """Spark `%`: the sign follows the dividend (Java's truncated
    quotient); a zero divisor gives null."""

    def eval(self, ctx):
        ld, rd, lc, rc, out_t = self._promote(ctx)
        zero = rd == 0
        rd_safe = torch.where(zero, torch.ones_like(rd), rd)
        if isinstance(out_t, (FloatType, DoubleType)):
            r = ld - torch.trunc(ld / rd_safe) * rd_safe
        else:
            r = ld - (torch.sign(ld) * torch.sign(rd_safe)
                      * (torch.abs(ld) // torch.abs(rd_safe))) * rd_safe
        return DeviceColumn(out_t, r, binary_validity(lc, rc) & ~zero)


class Pmod(BinaryArithmetic):
    """Positive modulus: the floor modulus (torch's %, as jnp's), moved
    up by |d| where it is below zero; a zero divisor gives null."""

    def eval(self, ctx):
        ld, rd, lc, rc, out_t = self._promote(ctx)
        zero = rd == 0
        rd_safe = torch.where(zero, torch.ones_like(rd), rd)
        r = torch.remainder(ld, rd_safe)
        r = torch.where(r < 0, r + torch.abs(rd_safe), r)
        return DeviceColumn(out_t, r, binary_validity(lc, rc) & ~zero)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        _no_decimal(self.children[0].dtype)
        return self.children[0].dtype

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, -c.data, c.validity, c.lengths)


class Abs(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        _no_decimal(self.children[0].dtype)
        return self.children[0].dtype

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, torch.abs(c.data), c.validity,
                            c.lengths)
