"""Arithmetic with Spark semantics — counterpart of
`spark_rapids_tpu/expr/arith.py` for Add, Subtract, Multiply, Divide,
IntegralDivide (`div`), Remainder (`%`), Pmod, UnaryMinus and Abs: binary
type promotion, null propagation, integral wraparound (the non-ANSI mode;
the ANSI overflow checks of expr/ansicheck.py are not ported yet), Spark's
`/`, which is double for non-decimal inputs, and a zero divisor giving
null for `/`, `div`, `%` and pmod.

Decimals follow the reference's types, which differ from Spark's: an
integral operand counts as decimal(19, 0), Add and Subtract give
decimal(max(lp - ls, rp - rs) + s + 1, s), Multiply decimal(lp + rp + 1,
ls + rs), Divide decimal(18, min(18, max(6, ls + rp + 1))), all capped at
38 digits. Narrow results (<= 18 digits) are elementwise int64 torch, as
they are elementwise jnp in the reference, with no overflow test; a wide
result goes through kernel K31 (ops/decimal128.py), valid only where it
fits its precision: Add and Subtract of narrow or wide operands, and the
64 x 64 -> 128-bit product of two narrow ones. A wide operand of Multiply
or Divide runs on the reference's CPU engine; here the planner refuses it
(ROADMAP A9). `div`, `%` and pmod over decimals are not ported (A3).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.ops import decimal128 as d128
from spark_rapids_tpu_torch.sqltypes import (
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegralType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    double,
    is_wide,
    long,
    numeric_promotion,
    torch_dtype,
)


_DECIMAL = ("{} over decimals is not ported yet (ROADMAP A3: decimal "
            "expressions outside the arithmetic, comparisons, casts and "
            "aggregates)")
_WIDE = ("{} of a decimal(>18) operand runs on the reference's CPU engine; "
         "the port has no CPU engine yet (ROADMAP A9)")


def _no_decimal(name: str, *dts) -> None:
    if any(isinstance(t, DecimalType) for t in dts):
        raise NotImplementedError(_DECIMAL.format(name))


def _dec_prec_scale(dt: DataType):
    if isinstance(dt, DecimalType):
        return dt.precision, dt.scale
    if isinstance(dt, IntegralType):
        return 19, 0  # the widest integral as decimal(19, 0)
    raise TypeError(f"not decimal-compatible: {dt}")


def _any_wide(*dts) -> bool:
    return any(is_wide(dt) for dt in dts)


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
            return self._decimal_result_type()
        return numeric_promotion(lt, rt)

    def _decimal_result_type(self) -> DataType:
        lp, ls = _dec_prec_scale(self.left.dtype)
        rp, rs = _dec_prec_scale(self.right.dtype)
        return self._dec_type(lp, ls, rp, rs)

    def _dec_type(self, lp, ls, rp, rs) -> DataType:
        _no_decimal(type(self).__name__, self.left.dtype, self.right.dtype)

    @property
    def dtype(self):
        return self._result_type()

    def _promote(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        out_t = self._result_type()
        tdt = torch_dtype(out_t)
        return lc.data.to(tdt), rc.data.to(tdt), lc, rc, out_t

    def _scales(self):
        return (_dec_prec_scale(self.left.dtype)[1],
                _dec_prec_scale(self.right.dtype)[1])


class Add(BinaryArithmetic):
    _negate_right = False

    def _dec_type(self, lp, ls, rp, rs):
        s = max(ls, rs)
        p = min(DecimalType.MAX_PRECISION, max(lp - ls, rp - rs) + s + 1)
        return DecimalType(p, s)

    def eval(self, ctx):
        out_t = self._result_type()
        if _any_wide(out_t, self.left.dtype, self.right.dtype):
            # both sides widened to the output scale, K31's add
            lc, rc = self.left.eval(ctx), self.right.eval(ctx)
            ls, rs = self._scales()
            s = out_t.scale
            data, valid = d128.add(
                lc.data, s - ls, rc.data, s - rs, binary_validity(lc, rc),
                out_t.precision, subtract=self._negate_right)
            return DeviceColumn(out_t, data, valid)
        ld, rd, lc, rc, out_t = self._promote(ctx)
        if isinstance(out_t, DecimalType):
            ls, rs = self._scales()
            ld = ld * (10 ** (out_t.scale - ls))
            rd = rd * (10 ** (out_t.scale - rs))
        if self._negate_right:
            rd = -rd
        return DeviceColumn(out_t, ld + rd, binary_validity(lc, rc))


class Subtract(Add):
    _negate_right = True


class Multiply(BinaryArithmetic):
    def _dec_type(self, lp, ls, rp, rs):
        s = min(DecimalType.MAX_PRECISION, ls + rs)
        p = min(DecimalType.MAX_PRECISION, lp + rp + 1)
        return DecimalType(p, s)

    def eval(self, ctx):
        out_t = self._result_type()
        if _any_wide(self.left.dtype, self.right.dtype):
            raise NotImplementedError(_WIDE.format("multiplication"))
        if _any_wide(out_t):
            # narrow x narrow -> wide: K31's 64 x 64 -> 128-bit product
            lc, rc = self.left.eval(ctx), self.right.eval(ctx)
            data, valid = d128.multiply(lc.data, rc.data,
                                        binary_validity(lc, rc),
                                        out_t.precision)
            return DeviceColumn(out_t, data, valid)
        ld, rd, lc, rc, out_t = self._promote(ctx)
        return DeviceColumn(out_t, ld * rd, binary_validity(lc, rc))


class Divide(BinaryArithmetic):
    """Spark `/`: double for non-decimal inputs, the reference's
    decimal(18, s) for decimal ones (l * 10^(s + rs - ls) / r in int64,
    HALF_UP); a zero divisor gives null (non-ANSI)."""

    def _result_type(self):
        if isinstance(self.left.dtype, DecimalType) or isinstance(
                self.right.dtype, DecimalType):
            return self._decimal_result_type()
        return double

    def _dec_type(self, lp, ls, rp, rs):
        # Spark: scale = max(6, ls + rp + 1); capped to 18 digits here
        s = min(DecimalType.MAX_LONG_DIGITS, max(6, ls + rp + 1))
        return DecimalType(DecimalType.MAX_LONG_DIGITS, s)

    def eval(self, ctx):
        out_t = self._result_type()
        if isinstance(out_t, DecimalType):
            if _any_wide(self.left.dtype, self.right.dtype):
                raise NotImplementedError(_WIDE.format("division"))
            lc, rc = self.left.eval(ctx), self.right.eval(ctx)
            ls, rs = self._scales()
            # (l / r) at scale s: l * 10^(s + rs - ls) / r, HALF_UP; the
            # numerator wraps unchecked, as the reference's does
            num = lc.data.to(torch.int64) * (10 ** (out_t.scale + rs - ls))
            den = rc.data.to(torch.int64)
            zero = den == 0
            den_safe = torch.where(zero, torch.ones_like(den), den)
            qt = torch.abs(num) // torch.abs(den_safe)
            rem = torch.abs(num) - qt * torch.abs(den_safe)
            qt = qt + (2 * rem >= torch.abs(den_safe)).to(torch.int64)
            signed = torch.sign(num) * torch.sign(den_safe) * qt
            return DeviceColumn(out_t, signed,
                                binary_validity(lc, rc) & ~zero)
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
        _no_decimal("div", self.left.dtype, self.right.dtype)
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
        return self.children[0].dtype

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if c.data.dim() == 2 and isinstance(c.dtype, DecimalType):
            return DeviceColumn(self.dtype, d128.negate(c.data), c.validity)
        return DeviceColumn(self.dtype, -c.data, c.validity, c.lengths)


class Abs(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if c.data.dim() == 2 and isinstance(c.dtype, DecimalType):
            return DeviceColumn(self.dtype, d128.absolute(c.data),
                                c.validity)
        return DeviceColumn(self.dtype, torch.abs(c.data), c.validity,
                            c.lengths)
