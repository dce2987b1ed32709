"""Conditional expressions — counterpart of
`spark_rapids_tpu/expr/conditional.py`: If, CaseWhen, Coalesce, Greatest,
Least, Nvl2 and NaNvl.

Every branch is evaluated over the whole batch and the rows are then
selected, as in the reference (elementwise `where`s, no kernel). Strings
of different widths are zero-padded to the widest first
(`_common_width`), so a selected row keeps its bytes and its length.
Numeric values of different types select in their common type (Spark's
coercion); the reference types the result as its first value, so
coalesce(NULL, a double) comes out a bigint there (ROADMAP C).
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceColumn,
    pad_trailing,
    row_select,
)
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.sqltypes import (
    DoubleType,
    FloatType,
    IntegralType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    double,
    numeric_promotion,
    torch_dtype,
)


def _select(pred: torch.Tensor, a: DeviceColumn, b: DeviceColumn
            ) -> DeviceColumn:
    """Row-wise select; the operands share dtype and trailing widths (pad
    first with _common_width)."""
    lengths = None
    if a.lengths is not None:
        lengths = torch.where(pred, a.lengths, b.lengths)
    ev = (None if a.elem_validity is None
          else row_select(pred, a.elem_validity, b.elem_validity))
    return DeviceColumn(a.dtype, row_select(pred, a.data, b.data),
                        torch.where(pred, a.validity, b.validity), lengths,
                        elem_validity=ev)


def _common_width(cols: List[DeviceColumn]) -> List[DeviceColumn]:
    """Pad variable-width columns (strings, arrays) to common trailing
    widths so _select's wheres line up."""
    nd = max(c.data.dim() for c in cols)
    if nd == 1:
        return cols
    target = tuple(
        max(int(c.data.shape[ax]) if c.data.dim() > ax else 1
            for c in cols)
        for ax in range(1, nd))
    out = []
    for c in cols:
        if c.data.dim() == 1 or tuple(c.data.shape[1:]) == target:
            out.append(c)
            continue
        out.append(c.replace(
            data=pad_trailing(c.data, target),
            elem_validity=pad_trailing(c.elem_validity, target[:1])))
    return out


_NUMERIC = (IntegralType, FloatType, DoubleType)


def _value_type(values):
    """The result type of conditional values: their common numeric type
    where they are numbers of different types, else the first's."""
    types = [v.dtype for v in values]
    if len({repr(t) for t in types}) == 1 or not all(
            isinstance(t, _NUMERIC) for t in types):
        return types[0]
    out = types[0]
    for t in types[1:]:
        out = numeric_promotion(out, t)
    return out


def _as_type(cols, dt):
    """Columns with their numeric data in dt's torch type."""
    if not isinstance(dt, _NUMERIC):
        return cols
    tdt = torch_dtype(dt)
    return [c if c.data.dtype == tdt and repr(c.dtype) == repr(dt)
            else c.replace(dtype=dt, data=c.data.to(tdt)) for c in cols]


def _all_null_like(c: DeviceColumn) -> DeviceColumn:
    """A column of c's layout with every leaf zeroed (all null)."""
    def z(x):
        return None if x is None else torch.zeros_like(x)

    return DeviceColumn(c.dtype, z(c.data), z(c.validity), z(c.lengths),
                        elem_validity=z(c.elem_validity))


class If(Expression):
    def __init__(self, pred: Expression, then: Expression, els: Expression):
        super().__init__([pred, then, els])

    @property
    def dtype(self):
        return _value_type(self.children[1:])

    def eval(self, ctx):
        p = self.children[0].eval(ctx)
        t = self.children[1].eval(ctx)
        e = self.children[2].eval(ctx)
        t, e = _as_type(_common_width([t, e]), self.dtype)
        return _select(p.data & p.validity, t, e)  # null -> else branch


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... [ELSE e] END; the first branch whose
    condition is true (not null) wins."""

    def __init__(self, branches, else_expr=None):
        children = []
        for c, v in branches:
            children.extend([c, v])
        self.n_branches = len(branches)
        self.has_else = else_expr is not None
        if else_expr is not None:
            children.append(else_expr)
        super().__init__(children)

    @property
    def dtype(self):
        vals = [self.children[2 * i + 1] for i in range(self.n_branches)]
        return _value_type(vals + self.children[2 * self.n_branches:])

    @property
    def nullable(self):
        if not self.has_else:
            return True
        return any(c.nullable for c in self.children)

    def key(self):
        return ("case", self.n_branches, self.has_else,
                tuple(c.key() for c in self.children))

    def eval(self, ctx):
        vals, conds = [], []
        for i in range(self.n_branches):
            c = self.children[2 * i].eval(ctx)
            vals.append(self.children[2 * i + 1].eval(ctx))
            conds.append(c.data & c.validity)
        els = (self.children[-1].eval(ctx) if self.has_else
               else _all_null_like(vals[0]))
        cols = _as_type(_common_width(vals + [els]), self.dtype)
        vals, out = cols[:-1], cols[-1]
        taken = torch.zeros_like(conds[0])
        for cond, v in zip(conds, vals):
            out = _select(cond & ~taken, v, out)
            taken = taken | cond
        return out


class Coalesce(Expression):
    def __init__(self, *exprs):
        super().__init__(list(exprs))

    @property
    def dtype(self):
        return _value_type(self.children)

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)

    def eval(self, ctx):
        cols = _as_type(_common_width([c.eval(ctx)
                                       for c in self.children]), self.dtype)
        out = cols[0]
        for c in cols[1:]:
            out = _select(out.validity, out, c)
        return out


class Greatest(Expression):
    """greatest(...): the largest non-null input; NaN is the greatest
    (Spark's ordering); null only when every input is null."""

    _is_greatest = True

    def __init__(self, *exprs):
        super().__init__(list(exprs))

    @property
    def dtype(self):
        t = self.children[0].dtype
        for c in self.children[1:]:
            t = numeric_promotion(t, c.dtype)
        return t

    def eval(self, ctx):
        out_t = self.dtype
        tdt = torch_dtype(out_t)
        cols = [c.eval(ctx) for c in self.children]
        datas = [c.data.to(tdt) for c in cols]
        valids = [c.validity for c in cols]
        any_valid = valids[0]
        for v in valids[1:]:
            any_valid = any_valid | v
        pick = torch.maximum if self._is_greatest else torch.minimum
        if isinstance(out_t, (FloatType, DoubleType)):
            # greatest() is NaN when any valid input is NaN; least() when
            # every valid input is
            neutral = -float("inf") if self._is_greatest else float("inf")
            acc = torch.full_like(datas[0], neutral)
            any_nan = torch.zeros_like(any_valid)
            all_nan = torch.ones_like(any_valid)
            for d, v in zip(datas, valids):
                isnan = torch.isnan(d) & v
                any_nan = any_nan | isnan
                all_nan = all_nan & (~v | torch.isnan(d))
                acc = pick(acc, torch.where(v & ~isnan, d,
                                            torch.full_like(d, neutral)))
            nan_wins = any_nan if self._is_greatest \
                else (all_nan & any_valid)
            acc = torch.where(nan_wins, torch.full_like(acc, float("nan")),
                              acc)
        else:
            info = torch.iinfo(tdt)
            neutral = info.min if self._is_greatest else info.max
            acc = torch.full_like(datas[0], neutral)
            for d, v in zip(datas, valids):
                acc = pick(acc, torch.where(v, d,
                                            torch.full_like(d, neutral)))
        return DeviceColumn(out_t, acc, any_valid)


class Least(Greatest):
    _is_greatest = False


class Nvl2(Expression):
    """nvl2(a, b, c): b where a is not null, else c."""

    def __init__(self, a, b, c):
        super().__init__([a, b, c])

    @property
    def dtype(self):
        return _value_type(self.children[1:])

    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        c = self.children[2].eval(ctx)
        b, c = _as_type(_common_width([b, c]), self.dtype)
        return _select(a.validity, b, c)


class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN, else a (doubles)."""

    def __init__(self, a, b):
        super().__init__([a, b])

    @property
    def dtype(self):
        return double

    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        ad = a.data.to(torch.float64)
        bd = b.data.to(torch.float64)
        isnan = torch.isnan(ad) & a.validity
        return DeviceColumn(double, torch.where(isnan, bd, ad),
                            torch.where(isnan, b.validity, a.validity))


CONDITIONAL_EXPRESSIONS = (If, CaseWhen, Coalesce, Greatest, Least, Nvl2,
                           NaNvl)
