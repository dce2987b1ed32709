"""Expression tree core — counterpart of `spark_rapids_tpu/expr/core.py`.

`Expression.eval(ctx)` runs torch operations on the batch's device and
returns a DeviceColumn. Null semantics follow Spark: every node declares
nullability and propagates validity masks explicitly. `key()` is the
structural description the planner's plan keys (cache matching) are
built from; `references()` and `transform()` serve the optimizer.
"""

from __future__ import annotations

import copy
import decimal
from typing import Any, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch, DeviceColumn
from spark_rapids_tpu_torch.sqltypes import (
    DataType,
    DecimalType,
    LongType,
    StringType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide, torch_dtype


class EvalContext:
    """Carries the input batch plus derived values during evaluation."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch
        self.live = batch.live_mask()

    @property
    def capacity(self) -> int:
        return self.batch.capacity

    @property
    def device(self) -> torch.device:
        return self.batch.device


class Expression:
    """Base expression node."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children = list(children)

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        raise NotImplementedError

    def key(self) -> Tuple:
        return (type(self).__name__,
                tuple(c.key() for c in self.children))

    def references(self) -> List[int]:
        out: List[int] = []
        for c in self.children:
            out.extend(c.references())
        return out

    def transform(self, fn) -> "Expression":
        """Bottom-up rewrite; fn(node) returns node or a replacement."""
        node = self.with_children([c.transform(fn) for c in self.children])
        return fn(node)

    def with_children(self, children: List["Expression"]) -> "Expression":
        node = copy.copy(self)
        node.children = list(children)
        return node

    def __repr__(self):
        cs = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__}({cs})"


class BoundReference(Expression):
    """Reference to an input column by ordinal."""

    def __init__(self, ordinal: int, dtype: DataType, nullable: bool = True):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        col = ctx.batch.columns[self.ordinal]
        if col.encoding is not None:
            # encoded columns decode here by default; the consumers that
            # run on codes (grouping, bare projections, equality probes)
            # read the batch column directly (encoding.raw_column)
            from spark_rapids_tpu_torch.columnar import encoding as _enc

            return _enc.decode_column(col)
        return col

    def key(self):
        return ("ref", self.ordinal, repr(self._dtype))

    def references(self):
        return [self.ordinal]

    def __repr__(self):
        return f"col#{self.ordinal}"


class Literal(Expression):
    """A constant, broadcast to the batch capacity. Python floats are
    double (float64), ints int or long and a `decimal.Decimal` the
    decimal(max(digits, scale), scale) of its digits, as in the reference;
    a decimal value is stored unscaled at its type's scale ([cap, 2] limbs
    past 18 digits)."""

    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        super().__init__()
        if dtype is None:
            dtype = _infer_literal_type(value)
        self.value = value
        self._dtype = dtype

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        cap, device = ctx.capacity, ctx.device
        dt = self._dtype
        if isinstance(dt, StringType):
            raw = (self.value or "").encode("utf-8")
            mb = max(8, 1 << max(0, (len(raw) - 1)).bit_length())
            row = torch.zeros(mb, dtype=torch.uint8)
            row[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
            data = row.to(device)[None, :].expand(cap, mb)
            lengths = torch.full((cap,), len(raw), dtype=torch.int32,
                                 device=device)
            valid = torch.full((cap,), self.value is not None,
                               dtype=torch.bool, device=device)
            return DeviceColumn(dt, data, valid, lengths)
        tdt = torch_dtype(dt)
        wide = is_wide(dt)
        if self.value is None:
            return DeviceColumn(
                dt, torch.zeros((cap, 2) if wide else cap, dtype=tdt,
                                device=device),
                torch.zeros(cap, dtype=torch.bool, device=device))
        v = self.value
        if isinstance(dt, DecimalType):
            # the unscaled value at the type's scale, rounded as
            # Decimal's to_integral_value rounds (HALF_EVEN)
            with decimal.localcontext() as dctx:
                dctx.prec = 50
                v = int(decimal.Decimal(str(v)).scaleb(dt.scale)
                        .to_integral_value())
            if wide:
                lo = v & ((1 << 64) - 1)
                row = torch.tensor([v >> 64, lo - (1 << 64) if lo >> 63
                                    else lo], dtype=torch.int64)
                return DeviceColumn(
                    dt, row.to(device)[None, :].expand(cap, 2),
                    torch.ones(cap, dtype=torch.bool, device=device))
        return DeviceColumn(
            dt, torch.full((cap,), v, dtype=tdt, device=device),
            torch.ones(cap, dtype=torch.bool, device=device))

    def key(self):
        return ("lit", repr(self.value), repr(self._dtype))

    def __repr__(self):
        return f"lit({self.value!r})"


def _infer_literal_type(v: Any) -> DataType:
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        boolean, double, integer, long, string,
    )

    if v is None:
        return LongType()
    if isinstance(v, bool):
        return boolean
    if isinstance(v, int):
        return integer if -(2**31) <= v < 2**31 else long
    if isinstance(v, float):
        return double
    if isinstance(v, str):
        return string
    if isinstance(v, decimal.Decimal):
        _, digits, exp = v.as_tuple()
        scale = max(0, -exp)
        return DecimalType(max(len(digits), scale), scale)
    raise TypeError(f"literal type of {v!r} is not ported yet")


class Alias(Expression):
    """Named wrapper — transparent at eval time."""

    def __init__(self, child: Expression, name: str):
        super().__init__([child])
        self.name = name

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return self.children[0].nullable

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def key(self):
        return ("alias", self.children[0].key())

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.name}"


def binary_validity(left: DeviceColumn, right: DeviceColumn) -> torch.Tensor:
    return left.validity & right.validity
