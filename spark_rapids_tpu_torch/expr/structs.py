"""Struct expressions — counterpart of `spark_rapids_tpu/expr/structs.py`:
GetStructField and CreateNamedStruct over struct-of-arrays columns
(DeviceColumn.children), and NullGate. All three only rewire leaves or
AND validities (elementwise)."""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.sqltypes import StructField, StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean


class GetStructField(Expression):
    """struct.field extraction; a parent-null row yields a null field
    (Spark GetStructField semantics)."""

    def __init__(self, child: Expression, name: str):
        super().__init__([child])
        self.name = name

    @property
    def _ordinal(self) -> int:
        return self.children[0].dtype.field_index(self.name)

    @property
    def dtype(self):
        return self.children[0].dtype.fields[self._ordinal].dataType

    @property
    def nullable(self):
        return True

    def key(self):
        return ("get_struct_field", self.name, self.children[0].key())

    def eval(self, ctx) -> DeviceColumn:
        col = self.children[0].eval(ctx)
        kid = col.children[self._ordinal]
        return kid.with_validity(kid.validity & col.validity)

    def __repr__(self):
        return f"{self.children[0]!r}.{self.name}"


class CreateNamedStruct(Expression):
    """struct(col1, col2, ...) — field expressions to a struct column.
    Never null itself, like Spark's CreateNamedStruct, unless `valid_from`
    is given (a final extra child): then the struct's validity copies
    that child's."""

    def __init__(self, names: List[str], exprs: List[Expression],
                 valid_from: Expression = None):
        assert len(names) == len(exprs)
        kids = list(exprs) + ([valid_from] if valid_from is not None
                              else [])
        super().__init__(kids)
        self.names = list(names)
        self._has_gate = valid_from is not None

    @property
    def _fields(self):
        return self.children[:-1] if self._has_gate else self.children

    @property
    def dtype(self):
        return StructType([
            StructField(n, e.dtype, e.nullable)
            for n, e in zip(self.names, self._fields)])

    @property
    def nullable(self):
        return self._has_gate

    def key(self):
        return ("create_named_struct", tuple(self.names), self._has_gate,
                tuple(c.key() for c in self.children))

    def eval(self, ctx) -> DeviceColumn:
        kids = [e.eval(ctx) for e in self._fields]
        # struct() with no fields is legal Spark; size from the batch
        cap = kids[0].capacity if kids else ctx.capacity
        validity = (self.children[-1].eval(ctx).validity if self._has_gate
                    else torch.ones(cap, dtype=torch.bool, device=ctx.device))
        return DeviceColumn(self.dtype, torch.zeros(cap, dtype=torch.int8,
                                                    device=ctx.device),
                            validity, children=kids)

    def __repr__(self):
        return "struct(" + ", ".join(self.names) + ")"


class NullGate(Expression):
    """Boolean column that is TRUE where the child is non-null and NULL
    where it is null: a struct key's top-level nullability as an orderable
    primitive key."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return self.children[0].nullable

    def key(self):
        return ("null_gate", self.children[0].key())

    def eval(self, ctx) -> DeviceColumn:
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, torch.ones_like(c.validity),
                            c.validity)

    def __repr__(self):
        return f"null_gate({self.children[0]!r})"


STRUCT_EXPRESSIONS = (GetStructField, CreateNamedStruct, NullGate)
