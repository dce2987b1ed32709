"""Math, rounding, bitwise and hex expressions with Spark semantics —
counterpart of `spark_rapids_tpu/expr/mathexpr.py`.

Everything but Hex is elementwise torch, as the reference's is
elementwise jnp that XLA fuses into the enclosing operator: the unary
double functions (Java Math semantics), the logs that give null outside
their domain, Logarithm, Pow, Atan2, Hypot, Round (HALF_UP, judged on the
binary double) and BRound (HALF_EVEN), Ceil and Floor (a long, converted
as Java converts a double: NaN to 0, saturating at the ends), the bitwise
operators and the shifts (the count masked to 5 or 6 bits, as Java's).
Hex writes its text through kernel K24's hex mode
(kernels/csrc/str_format.cu) on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.cast import _format
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.sqltypes import (
    DoubleType,
    FloatType,
    IntegralType,
    LongType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    double,
    long,
    numeric_promotion,
    string as string_t,
    torch_dtype,
)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root: |x|^(1/3) with the sign, refined by one Newton step
    (1/3 is not exact, and the power alone is off by up to ~60 ulp at
    1e300)."""
    a = torch.abs(x)
    y = torch.pow(a, 1.0 / 3.0)
    ok = torch.isfinite(y) & (y > 0)
    ys = torch.where(ok, y, torch.ones_like(y))
    y = torch.where(ok, ys - (ys * ys * ys - a) / (3.0 * ys * ys), y)
    return torch.copysign(y, x)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt, correctly rounded: CUDA's is; torch's vectorised CPU
    float64 sqrt can be one ulp off, so a CPU tensor takes numpy's."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


#: 10^0 .. 10^22, every power of ten a double holds exactly
_POW10 = [float(10 ** k) for k in range(23)]


def _log10(x: torch.Tensor) -> torch.Tensor:
    """log10 with Java's Math.log10 contract: 10^n gives exactly n (a
    libm within an ulp may give 2.9999999999999996 for 1000, which a
    floor() would band one lower)."""
    r = torch.log10(x)
    k = torch.round(torch.nan_to_num(r, 0.0, 0.0, 0.0)).clamp(
        0, len(_POW10) - 1)
    p = torch.tensor(_POW10, dtype=x.dtype, device=x.device)[k.long()]
    return torch.where(p == x, k, r)


def _signum(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN and -0.0 stays -0.0 (torch.sign gives 0)."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


class UnaryMath(Expression):
    """double -> double elementwise math (Java Math semantics)."""

    _fn = None  # staticmethod set by subclasses

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return double

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        c = self.children[0].eval(ctx)
        x = c.data.to(torch.float64)
        return DeviceColumn(double, type(self)._fn(x), c.validity)


class Sqrt(UnaryMath):
    _fn = staticmethod(_sqrt)


class Exp(UnaryMath):
    _fn = staticmethod(torch.exp)


class Expm1(UnaryMath):
    _fn = staticmethod(torch.expm1)


class Cbrt(UnaryMath):
    _fn = staticmethod(_cbrt)


class Rint(UnaryMath):
    _fn = staticmethod(torch.round)  # HALF_EVEN, Java Math.rint


class Signum(UnaryMath):
    _fn = staticmethod(_signum)


class Sin(UnaryMath):
    _fn = staticmethod(torch.sin)


class Cos(UnaryMath):
    _fn = staticmethod(torch.cos)


class Tan(UnaryMath):
    _fn = staticmethod(torch.tan)


class Cot(UnaryMath):
    _fn = staticmethod(lambda x: 1.0 / torch.tan(x))


class Asin(UnaryMath):
    _fn = staticmethod(torch.asin)


class Acos(UnaryMath):
    _fn = staticmethod(torch.acos)


class Atan(UnaryMath):
    _fn = staticmethod(torch.atan)


class Sinh(UnaryMath):
    _fn = staticmethod(torch.sinh)


class Cosh(UnaryMath):
    _fn = staticmethod(torch.cosh)


class Tanh(UnaryMath):
    _fn = staticmethod(torch.tanh)


class Asinh(UnaryMath):
    _fn = staticmethod(torch.asinh)


class Acosh(UnaryMath):
    _fn = staticmethod(torch.acosh)


class Atanh(UnaryMath):
    _fn = staticmethod(torch.atanh)


class ToDegrees(UnaryMath):
    _fn = staticmethod(lambda x: x * (180.0 / math.pi))


class ToRadians(UnaryMath):
    _fn = staticmethod(lambda x: x * (math.pi / 180.0))


class _NullDomainLog(Expression):
    """Log family: an input at or below the bound gives null (Spark's
    non-ANSI Logarithm); NaN stays NaN (Java's `input <= 0` is false)."""

    _bound = 0.0  # the input must be strictly greater than this
    _fn = None

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return double

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        x = c.data.to(torch.float64)
        out_of_domain = x <= self._bound
        safe = torch.where(out_of_domain, torch.ones_like(x), x)
        return DeviceColumn(double, type(self)._fn(safe),
                            c.validity & ~out_of_domain)


class Log(_NullDomainLog):
    _fn = staticmethod(torch.log)


class Log10(_NullDomainLog):
    _fn = staticmethod(_log10)


class Log2(_NullDomainLog):
    _fn = staticmethod(torch.log2)


class Log1p(_NullDomainLog):
    _bound = -1.0
    _fn = staticmethod(torch.log1p)


class _BinaryDouble(Expression):
    """Two numeric children promoted to double, null in either -> null."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self):
        return double

    def _operands(self, ctx) -> Tuple[DeviceColumn, DeviceColumn,
                                      torch.Tensor, torch.Tensor]:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        return a, b, a.data.to(torch.float64), b.data.to(torch.float64)


class Logarithm(_BinaryDouble):
    """log(base, expr); null when expr <= 0 or base <= 0."""

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        b, c, bd, cd = self._operands(ctx)
        ok = (bd > 0.0) & (cd > 0.0)
        r = (torch.log(torch.where(cd > 0, cd, torch.ones_like(cd)))
             / torch.log(torch.where(bd > 0, bd, torch.full_like(bd, 2.0))))
        return DeviceColumn(double, r, binary_validity(b, c) & ok)


class Pow(_BinaryDouble):
    def eval(self, ctx):
        a, b, ad, bd = self._operands(ctx)
        return DeviceColumn(double, torch.pow(ad, bd), binary_validity(a, b))


class Atan2(_BinaryDouble):
    def eval(self, ctx):
        a, b, ad, bd = self._operands(ctx)
        return DeviceColumn(double, torch.atan2(ad, bd),
                            binary_validity(a, b))


class Hypot(_BinaryDouble):
    def eval(self, ctx):
        a, b, ad, bd = self._operands(ctx)
        return DeviceColumn(double, torch.hypot(ad, bd),
                            binary_validity(a, b))


class Round(Expression):
    """round(x, scale): HALF_UP (ties away from zero). Ties are judged on
    the binary double, as in the reference: Spark rounds the decimal
    rendering, so 1.005 (binary 1.00499...) can differ by one unit of the
    scale (docs/compatibility.md)."""

    _half_even = False

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__([child])
        self.scale = scale

    @property
    def dtype(self):
        dt = self.children[0].dtype
        if isinstance(dt, (FloatType, DoubleType)):
            return double
        return dt

    def key(self):
        return (type(self).__name__.lower(), self.scale,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        dt = self.children[0].dtype
        s = self.scale
        if isinstance(dt, IntegralType):
            if s >= 0:
                return DeviceColumn(self.dtype, c.data, c.validity)
            f = 10 ** (-s)
            x = c.data.to(torch.int64)
            if self._half_even:
                q = _to_long(torch.round(_div(x.to(torch.float64), f)))
            else:
                q = (torch.abs(x) + f // 2) // f * torch.sign(x)
            return DeviceColumn(self.dtype, (q * f).to(torch_dtype(dt)),
                                c.validity)
        x = c.data.to(torch.float64)
        f = 10.0 ** s
        scaled = x * f
        if self._half_even:
            r = torch.round(scaled)
        else:
            t = torch.trunc(scaled)
            r = torch.where(torch.abs(scaled - t) >= 0.5,
                            t + torch.sign(scaled), t)
        r = _div(r, f)
        return DeviceColumn(double, torch.where(torch.isfinite(x), r, x),
                            c.validity)


def _div(x: torch.Tensor, f: float) -> torch.Tensor:
    """x / f, IEEE-rounded: on the card torch divides by a Python scalar as
    a multiply by its reciprocal (1 ulp off, e.g. 42342447 * 0.01 =
    423424.47000000003), so f goes in as a tensor on x's device."""
    return x / torch.full_like(x, f)


class BRound(Round):
    """bround(x, scale): HALF_EVEN."""

    _half_even = True


def _to_long(x: torch.Tensor) -> torch.Tensor:
    """double -> long as Java converts (and XLA's saturating convert):
    NaN to 0, values past the int64 range to its ends."""
    big = x >= 9.223372036854775808e18
    out = torch.where(torch.isnan(x) | big, torch.zeros_like(x),
                      x.clamp(min=-9.223372036854775808e18)).to(torch.int64)
    return torch.where(big, torch.full_like(out, 2 ** 63 - 1), out)


class _Integral(Expression):
    """Ceil and Floor: a long; an integral input is only widened."""

    _fn = None

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return long

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if isinstance(self.children[0].dtype, IntegralType):
            return DeviceColumn(long, c.data.to(torch.int64), c.validity)
        return DeviceColumn(
            long, _to_long(type(self)._fn(c.data.to(torch.float64))),
            c.validity)


class Ceil(_Integral):
    _fn = staticmethod(torch.ceil)


class Floor(_Integral):
    _fn = staticmethod(torch.floor)


# ------------------------------------------------------------- bitwise

class _BitwiseBinary(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self):
        return numeric_promotion(self.children[0].dtype,
                                 self.children[1].dtype)

    def eval(self, ctx):
        lc = self.children[0].eval(ctx)
        rc = self.children[1].eval(ctx)
        out_t = self.dtype
        tdt = torch_dtype(out_t)
        return DeviceColumn(out_t,
                            self._op(lc.data.to(tdt), rc.data.to(tdt)),
                            binary_validity(lc, rc))


class BitwiseAnd(_BitwiseBinary):
    def _op(self, a, b):
        return a & b


class BitwiseOr(_BitwiseBinary):
    def _op(self, a, b):
        return a | b


class BitwiseXor(_BitwiseBinary):
    def _op(self, a, b):
        return a ^ b


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, ~c.data, c.validity)


class _Shift(Expression):
    """Java shift semantics: the count masked to the type's bit width."""

    def __init__(self, child: Expression, amount: Expression):
        super().__init__([child, amount])

    @property
    def dtype(self):
        return self.children[0].dtype

    def _mask(self):
        return 63 if isinstance(self.children[0].dtype, LongType) else 31

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        a = self.children[1].eval(ctx)
        cnt = (a.data.to(torch.int32) & self._mask()).to(c.data.dtype)
        return DeviceColumn(self.dtype, self._op(c.data, cnt),
                            binary_validity(c, a))


class ShiftLeft(_Shift):
    def _op(self, x, cnt):
        return x << cnt


class ShiftRight(_Shift):
    def _op(self, x, cnt):
        return x >> cnt  # arithmetic on signed integers


class ShiftRightUnsigned(_Shift):
    def _op(self, x, cnt):
        return shift_right_logical(x, cnt)


def shift_right_logical(x: torch.Tensor, cnt) -> torch.Tensor:
    """x >>> cnt over signed integers of any width (lax's logical shift:
    0 once cnt reaches the width)."""
    bits = torch.iinfo(x.dtype).bits
    if bits < 64:
        u = x.to(torch.int64) & ((1 << bits) - 1)
        r = u >> torch.as_tensor(cnt, device=x.device).to(torch.int64)
        return torch.where(r >= 1 << (bits - 1), r - (1 << bits),
                           r).to(x.dtype)
    cnt = torch.as_tensor(cnt, device=x.device).to(torch.int64)
    keep = (torch.ones_like(cnt) << (64 - cnt).clamp(max=63)) - 1
    keep = torch.where(cnt == 0, torch.full_like(keep, -1), keep)
    return (x >> cnt) & keep


# ----------------------------------------------------------------- hex

#: the nibbles of an int64
HEX_WIDTH = 16


def hex_plain(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K24's hex mode: int64 -> uppercase hex
    text of its two's complement bits without leading zeros ("0" for 0),
    as ([n, 16] uint8, int32 lengths)."""
    x = v.to(torch.int64)
    shifts = (HEX_WIDTH - 1 - torch.arange(HEX_WIDTH, device=x.device)) * 4
    nib = shift_right_logical(x[:, None].expand(-1, HEX_WIDTH),
                              shifts[None, :].expand(x.shape[0], -1)) & 0xF
    chars = torch.where(nib < 10, nib + ord("0"), nib - 10 + ord("A"))
    nz = nib != 0
    first = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1),
                        torch.full_like(x, HEX_WIDTH - 1))
    length = HEX_WIDTH - first
    pos = torch.arange(HEX_WIDTH, device=x.device)[None, :]
    src = (first[:, None] + pos).clamp(max=HEX_WIDTH - 1)
    out = torch.gather(chars, 1, src)
    out = torch.where(pos < length[:, None], out, torch.zeros_like(out))
    return out.to(torch.uint8), length.to(torch.int32)


def hex_text(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hex's text: one K24 launch in hex mode on the card, the plain
    version for a CPU tensor."""
    if v.device.type == "cpu":
        return hex_plain(v)
    return _format(kernels.FORMAT_HEX, v.to(torch.int64), HEX_WIDTH)


class Hex(Expression):
    """hex(long): uppercase hex text without leading zeros."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, lengths = hex_text(c.data)
        return DeviceColumn(string_t, data, c.validity, lengths)


UNARY_MATH = (Sqrt, Exp, Expm1, Cbrt, Rint, Signum, Sin, Cos, Tan, Cot,
              Asin, Acos, Atan, Sinh, Cosh, Tanh, Asinh, Acosh, Atanh,
              ToDegrees, ToRadians)
NULL_DOMAIN_LOGS = (Log, Log10, Log2, Log1p)
BITWISE = (BitwiseAnd, BitwiseOr, BitwiseXor, BitwiseNot)
SHIFTS = (ShiftLeft, ShiftRight, ShiftRightUnsigned)
MATH_EXPRESSIONS = (UNARY_MATH + NULL_DOMAIN_LOGS + BITWISE + SHIFTS
                    + (Logarithm, Pow, Atan2, Hypot, Round, BRound, Ceil,
                       Floor, Hex))
