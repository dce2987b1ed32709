"""Arithmetic with Spark semantics — counterpart of
`spark_rapids_tpu/expr/arith.py` for `Multiply` over non-decimal numerics:
binary type promotion, null propagation, and integral wraparound (the
non-ANSI mode; the ANSI overflow checks of expr/ansicheck.py are not
ported yet).
"""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.sqltypes import DataType, DecimalType
from spark_rapids_tpu_torch.sqltypes.datatypes import (
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


class Multiply(BinaryArithmetic):
    def eval(self, ctx):
        ld, rd, lc, rc, out_t = self._promote(ctx)
        return DeviceColumn(out_t, ld * rd, binary_validity(lc, rc))
