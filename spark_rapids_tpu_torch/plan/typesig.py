"""Device-support checks — the part of `spark_rapids_tpu/plan/typesig.py`
and `plan/expr_sigs.py` that `TpuOverrides.tag` consults for the port's
slice: which types and expression classes the port runs on the device.

The port has no CPU engine to fall back to, so a reason returned here
makes the planner raise NotImplementedError naming the ROADMAP item that
ports the missing piece.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.expr import (
    Add,
    Alias,
    And,
    Average,
    BoundReference,
    Count,
    Divide,
    EqualTo,
    Expression,
    First,
    GreaterThan,
    GreaterThanOrEqual,
    Last,
    LessThan,
    LessThanOrEqual,
    Literal,
    Max,
    Min,
    Multiply,
    Not,
    Or,
    Subtract,
    Sum,
)
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    BooleanType,
    DataType,
    DateType,
    DoubleType,
    FloatType,
    IntegralType,
    MapType,
    NullType,
    StringType,
    StructType,
    TimestampType,
)

DEVICE_TYPES = (BooleanType, IntegralType, FloatType, DoubleType,
                StringType, DateType, TimestampType)

#: expression classes the port evaluates on the device
PORTED_EXPRESSIONS = (BoundReference, Literal, Alias, Add, Subtract,
                      Multiply, Divide, EqualTo, LessThan, GreaterThan,
                      LessThanOrEqual, GreaterThanOrEqual, And, Or, Not,
                      Sum, Count, Average, Min, Max, First, Last)


def type_supported(dt: DataType) -> Optional[str]:
    if isinstance(dt, NullType) or isinstance(dt, DEVICE_TYPES):
        return None
    return (f"type {dt} is not ported yet (ROADMAP A3: decimal, array, "
            "map and struct columns)")


def key_type_supported(dt: DataType) -> Optional[str]:
    """Grouping and join keys additionally need orderable device keys."""
    if isinstance(dt, (ArrayType, StructType, MapType)):
        return f"{dt}-typed keys have no orderable device keys"
    return type_supported(dt)


def expr_unsupported_reasons(expr: Expression, conf=None) -> List[str]:
    """Every reason an expression tree cannot run on the device; empty
    when it can. `conf` carries the per-expression disable switches."""
    reasons: List[str] = []

    def walk(e: Expression):
        name = type(e).__name__
        if conf is not None and not conf.expression_enabled(name):
            reasons.append(f"{name} disabled via spark.rapids.sql."
                           f"expression.{name}=false")
        if not isinstance(e, PORTED_EXPRESSIONS):
            reasons.append(f"expression {name} is not ported yet "
                           "(ROADMAP A12)")
            return
        try:
            r = type_supported(e.dtype)
        except NotImplementedError as err:
            r = str(err)
        if r:
            reasons.append(f"{name}: {r}")
        for c in e.children:
            walk(c)

    walk(expr)
    return reasons

