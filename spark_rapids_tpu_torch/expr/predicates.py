"""Comparison predicates with Spark null semantics — counterpart of
`spark_rapids_tpu/expr/predicates.py`: EqualTo, EqualNullSafe, LessThan,
GreaterThan, LessThanOrEqual, GreaterThanOrEqual, And, Or, Not, IsNull,
IsNotNull, IsNaN and In. Comparisons propagate null; EqualNullSafe (`<=>`)
and the null tests never return null; And and Or are Kleene. String comparison is lexicographic over
UTF-8 bytes via the packed orderable keys; `<encoded column> = <string
literal>` compares dictionary codes (columnar/encoding.py), and so does
In over such a column, one code a literal.

Decimals compare as the reference aligns them: against a float or double
both sides as doubles; otherwise at the common scale s, as int64 when
every digit fits 18 (decimal(18, s)), else both widened to decimal(38, s)
[n, 2] limbs (an integral counts as decimal(19, 0)), which kernel K31
rescales and orders (ops/decimal128.py: `rescale_data`, `compare`). A
wide decimal becomes a double through K31 too, and every division by a
power of ten divides by a tensor, so it stays IEEE-exact on the card.
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
from spark_rapids_tpu_torch.ops import decimal128 as d128
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
    if col.data.dim() == 2:  # decimal(> 18) limbs
        return d128.orderable_limbs(col.data)
    return [col.data.to(torch.int64)]


def _wide_pair(lc: DeviceColumn, rc: DeviceColumn) -> bool:
    return (lc.data.dim() == 2 and isinstance(lc.dtype, DecimalType)
            and rc.data.dim() == 2)


def _cmp(lc: DeviceColumn, rc: DeviceColumn) -> torch.Tensor:
    """K31's -1 / 0 / 1 order of two decimal(> 18) limb columns."""
    return d128.compare(lc.data, rc.data)


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
    """A numeric column as double; a decimal's unscaled value divided by
    10.0 ** scale (a tensor divisor: IEEE division on the card too)."""
    if isinstance(col.dtype, DecimalType):
        s = col.dtype.scale
        if col.data.dim() == 2:
            return DeviceColumn(double, d128.to_double(col.data, s),
                                col.validity)
        p = torch.tensor(10.0 ** s, dtype=torch.float64,
                         device=col.data.device)
        return DeviceColumn(double, col.data.to(torch.float64) / p,
                            col.validity)
    return DeviceColumn(double, col.data.to(torch.float64), col.validity)


def _coerce_decimal(lc: DeviceColumn, rc: DeviceColumn):
    """The reference's decimal alignment (`expr/predicates.py:84-135`)."""
    lt, rt = lc.dtype, rc.dtype
    ld, rd = isinstance(lt, DecimalType), isinstance(rt, DecimalType)
    if isinstance(lt, (FloatType, DoubleType)) or isinstance(
            rt, (FloatType, DoubleType)):
        return _as_double(lc), _as_double(rc)  # decimal vs float
    ls = lt.scale if ld else 0
    rs = rt.scale if rd else 0
    s = max(ls, rs)
    lp = lt.precision if ld else 19
    rp = rt.precision if rd else 19
    need = max(lp - ls, rp - rs) + s  # digits at the common scale
    if lc.data.dim() == 2 or rc.data.dim() == 2 or need > 18:
        # a wide side, or too many digits: both as decimal(38, s) limbs
        out_t = DecimalType(DecimalType.MAX_PRECISION, s)

        def widen(col, delta):
            data, _ = d128.rescale_data(col.data, delta, None)
            return DeviceColumn(out_t, data, col.validity)

        return widen(lc, s - ls), widen(rc, s - rs)
    out_t = DecimalType(DecimalType.MAX_LONG_DIGITS, s)
    return (DeviceColumn(out_t, lc.data.to(torch.int64) * (10 ** (s - ls)),
                         lc.validity, lc.lengths),
            DeviceColumn(out_t, rc.data.to(torch.int64) * (10 ** (s - rs)),
                         rc.validity, rc.lengths))


def _coerce_numeric(lc: DeviceColumn, rc: DeviceColumn):
    """Promote mismatched numeric operands (Spark's ImplicitTypeCasts):
    int vs float and float vs double compare as doubles; two integral
    widths compare exactly as int64 keys; decimals align as
    `_coerce_decimal` says."""
    lt, rt = lc.dtype, rc.dtype
    if not (isinstance(lt, NumericType) and isinstance(rt, NumericType)):
        return lc, rc
    if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
        return _coerce_decimal(lc, rc)
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
        elif _wide_pair(lc, rc):
            eq = _cmp(lc, rc) == 0
        else:
            eq = _tuple_eq(_comparable(lc), _comparable(rc))
        return DeviceColumn(boolean, eq, binary_validity(lc, rc))


class EqualNullSafe(BinaryComparison):
    """<=>: null <=> null is true; never null."""

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        lc, rc = self._operands(ctx)
        if isinstance(lc.dtype, (FloatType, DoubleType)):
            both_nan = torch.isnan(lc.data) & torch.isnan(rc.data)
            veq = (lc.data == rc.data) | both_nan
        elif _wide_pair(lc, rc):
            veq = _cmp(lc, rc) == 0
        else:
            veq = _tuple_eq(_comparable(lc), _comparable(rc))
        both_null = ~lc.validity & ~rc.validity
        res = both_null | (lc.validity & rc.validity & veq)
        return DeviceColumn(boolean, res, torch.ones_like(res))


class LessThan(BinaryComparison):
    def eval(self, ctx):
        lc, rc = self._operands(ctx)
        if isinstance(lc.dtype, (FloatType, DoubleType)):
            r = lc.data < rc.data
            # Spark: NaN is greater than everything, itself included
            lnan, rnan = torch.isnan(lc.data), torch.isnan(rc.data)
            r = torch.where(lnan, False, r)
            r = torch.where(rnan & ~lnan, True, r)
        elif _wide_pair(lc, rc):
            r = _cmp(lc, rc) < 0
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


def _is_reference(e: Expression) -> bool:
    from spark_rapids_tpu_torch.expr.core import Alias, BoundReference

    return isinstance(e.children[0] if isinstance(e, Alias) else e,
                      BoundReference)


class _Evaluated(Expression):
    """A child already evaluated in this context."""

    def __init__(self, col: DeviceColumn):
        super().__init__()
        self.col = col

    @property
    def dtype(self):
        return self.col.dtype

    def eval(self, ctx):
        return self.col


def _validity_of(child: Expression, ctx: EvalContext) -> DeviceColumn:
    """The column whose validity a null test reads: the raw batch column
    behind a bare reference (an encoded column stays encoded), else the
    child's value."""
    from spark_rapids_tpu_torch.columnar import encoding as _enc

    c = _enc.raw_column(child, ctx)
    return c if c is not None else child.eval(ctx)


class IsNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        v = _validity_of(self.children[0], ctx).validity
        return DeviceColumn(boolean, ~v, torch.ones_like(v))


class IsNotNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        v = _validity_of(self.children[0], ctx).validity
        return DeviceColumn(boolean, v.clone(), torch.ones_like(v))


class IsNaN(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(boolean, torch.isnan(c.data) & c.validity,
                            torch.ones_like(c.validity))


class In(Expression):
    """IN over a literal list: an OR of EqualTo over the values (each
    compares codes when the child is an encoded column); a null in the
    list makes a miss null, a null child is null."""

    def __init__(self, child: Expression, values):
        super().__init__([child])
        self.values = list(values)

    @property
    def dtype(self):
        return boolean

    def key(self):
        return ("in", self.children[0].key(), tuple(map(repr, self.values)))

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.core import Literal

        child = self.children[0]
        c = _validity_of(child, ctx)
        if not _is_reference(child):
            child = _Evaluated(c)  # evaluated once, not once a value
        hit = torch.zeros_like(c.validity)
        any_null = False
        for v in self.values:
            if v is None:
                any_null = True
                continue
            eq = EqualTo(child, Literal(v, child.dtype)).eval(ctx)
            hit = hit | (eq.data & eq.validity)
        valid = c.validity & (hit | (not any_null))
        return DeviceColumn(boolean, hit, valid)
