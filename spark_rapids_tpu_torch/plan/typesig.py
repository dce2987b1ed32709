"""Device-support checks — the part of `spark_rapids_tpu/plan/typesig.py`
and `plan/expr_sigs.py` that `TpuOverrides.tag` consults for the port's
slice: which types and expression classes the port runs on the device,
the child types of the string and regex expressions (the reference's
ExprSig rows), the regex checks (an untranspilable pattern,
spark.rapids.sql.regexp.enabled=false) and the regex expressions the
reference runs on its CPU engine only.

The port has no CPU engine to fall back to, so a reason returned here
makes the planner raise NotImplementedError naming the ROADMAP item that
ports the missing piece.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.expr import strings as S
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
    RegexpExtract,
    RegexpReplace,
    RLike,
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
                      Sum, Count, Average, Min, Max, First, Last, RLike,
                      *S.STRING_EXPRESSIONS)

#: expressions the reference evaluates on its CPU engine only (no device
#: implementation); the port has no CPU engine yet
CPU_ONLY_EXPRESSIONS = (RegexpExtract, RegexpReplace)
_REGEX_EXPRESSIONS = (RLike, RegexpExtract, RegexpReplace)

#: the types every child of a string or regex expression may have (the
#: reference's plan/expr_sigs.py rows; scalar arguments such as needles,
#: pads and positions are constructor attributes)
_CHILD_TYPES = {cls: (StringType,)
                for cls in (*S.STRING_EXPRESSIONS, *_REGEX_EXPRESSIONS)}
_CHILD_TYPES[S.Chr] = (IntegralType,)


def _child_type_reasons(e: Expression) -> List[str]:
    ok = _CHILD_TYPES.get(type(e))
    if ok is None:
        return []
    return [f"{type(e).__name__} parameter {i}: {c.dtype} input has no "
            "device lowering" for i, c in enumerate(e.children)
            if not isinstance(c.dtype, (NullType,) + ok)]


def _regex_reasons(e: Expression, conf) -> List[str]:
    """The reference's regexp-enabled check and RLike's transpiler check
    (plan/typesig.py `_rlike_check`); each names A9, since the reference
    would run the expression on its CPU engine."""
    if not isinstance(e, _REGEX_EXPRESSIONS):
        return []
    no_cpu = "; the port has no CPU engine yet (ROADMAP A9)"
    out = []
    if conf is not None and not conf.get(rc.REGEXP_ENABLED):
        out.append("regex on device disabled via "
                   "spark.rapids.sql.regexp.enabled=false" + no_cpu)
    r = e.device_supported()
    if r:
        out.append(r + no_cpu)
    return out


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
        reasons.extend(_regex_reasons(e, conf))
        if not isinstance(e, PORTED_EXPRESSIONS + CPU_ONLY_EXPRESSIONS):
            reasons.append(f"expression {name} is not ported yet "
                           "(ROADMAP A12)")
            return
        reasons.extend(_child_type_reasons(e))
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

