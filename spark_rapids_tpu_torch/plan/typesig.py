"""Device-support checks — the part of `spark_rapids_tpu/plan/typesig.py`
and `plan/expr_sigs.py` that `TpuOverrides.tag` consults for the port's
slice: which types and expression classes the port runs on the device,
the child types of the string, regex, datetime, predicate, arithmetic,
conditional, math and hash expressions (the reference's ExprSig rows), the regex checks (an untranspilable pattern,
spark.rapids.sql.regexp.enabled=false), the expressions the reference
runs on its CPU engine only, and the device checks of Cast and
DateFormat (`device_supported`), whose refusals the reference would also
send to its CPU engine.

The port has no CPU engine to fall back to, so a reason returned here
makes the planner raise NotImplementedError naming the ROADMAP item that
ports the missing piece. Decimals run where the reference runs them on
its device and the port has them (arithmetic, comparisons, IN, casts,
the null tests, murmur3/xxhash64 of a decimal(<= 18), the aggregates);
what the reference sends to its CPU engine (a decimal(> 18) grouping or
join key, division or Multiply operand, hash input, float or string to
decimal(> 18), decimal(> 18, scale > 18) to string) names A9, and the
rest of the library over decimals (math, `div`, `%`, pmod, the
conditionals, greatest and least) names A3. Nested types are the
reference's device types: arrays of primitive, decimal(<= 18) or string
elements (the string cube only for size, contains, getItem, element_at,
explode and selection: `_cube_reasons`), maps of flat primitive entries,
structs of flat fields; the rest, which the reference runs on its CPU
engine, names A9, as do array, map and struct keys.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.expr import arith as A
from spark_rapids_tpu_torch.expr import collections as CX
from spark_rapids_tpu_torch.expr import conditional as C
from spark_rapids_tpu_torch.expr import datetimes as D
from spark_rapids_tpu_torch.expr import hashexpr as H
from spark_rapids_tpu_torch.expr import mathexpr as M
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import structs as ST
from spark_rapids_tpu_torch.expr.generators import Explode, PosExplode
from spark_rapids_tpu_torch.expr import aggregates as AGG
from spark_rapids_tpu_torch.expr import (
    Add,
    Alias,
    And,
    Average,
    BoundReference,
    Cast,
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
    DecimalType,
    DoubleType,
    FloatType,
    IntegralType,
    MapType,
    NullType,
    StringType,
    StructType,
    TimestampType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide

#: the scalar types every ported expression takes
_SCALAR = (BooleanType, IntegralType, FloatType, DoubleType, StringType,
           DateType, TimestampType)
DEVICE_TYPES = _SCALAR + (DecimalType,)

#: expression classes the port evaluates on the device
PORTED_EXPRESSIONS = (BoundReference, Literal, Alias, Add, Subtract,
                      Multiply, Divide, EqualTo, LessThan, GreaterThan,
                      LessThanOrEqual, GreaterThanOrEqual, And, Or, Not,
                      Sum, Count, Average, Min, Max, First, Last, RLike,
                      *S.STRING_EXPRESSIONS, Cast, *D.DATETIME_EXPRESSIONS,
                      AGG._Moments, AGG._Bivariate, AGG._BoolReduce,
                      AGG.CollectList, AGG.CountDistinct, AGG.Percentile,
                      P.EqualNullSafe, P.IsNull, P.IsNotNull, P.IsNaN, P.In,
                      A.IntegralDivide, A.Remainder, A.Pmod, A.UnaryMinus,
                      A.Abs, *C.CONDITIONAL_EXPRESSIONS,
                      *M.MATH_EXPRESSIONS, *H.HASH_EXPRESSIONS,
                      *CX.COLLECTION_EXPRESSIONS, *ST.STRUCT_EXPRESSIONS,
                      Explode, PosExplode)

#: expressions the reference evaluates on its CPU engine only (no device
#: implementation); the port has no CPU engine yet
CPU_ONLY_EXPRESSIONS = (RegexpExtract, RegexpReplace)
_REGEX_EXPRESSIONS = (RLike, RegexpExtract, RegexpReplace)

_DATETIME = (DateType, TimestampType)
_NUMERIC = (IntegralType, FloatType, DoubleType)
_FP = (FloatType, DoubleType)
#: the reference's ORDERABLE (and COMMON, the hashes' inputs), ALL (the
#: conditionals' values) and ALL_NESTED (the null tests' input), without
#: the decimals the port does not take there yet (A3)
_ORDERABLE = _SCALAR
_ALL = _SCALAR + (ArrayType, MapType)
_ALL_NESTED = DEVICE_TYPES + (ArrayType, MapType, StructType)
#: the same with decimals, where the port takes them
_ORDERABLE_DEC = DEVICE_TYPES
_NUMERIC_DEC = _NUMERIC + (DecimalType,)

#: the types each child of a string, regex or datetime expression may
#: have: one tuple for every child, or a list of one tuple a parameter
#: (the reference's plan/expr_sigs.py rows; scalar arguments such as
#: needles, pads, formats and zones are constructor attributes)
_CHILD_TYPES = {cls: (StringType,)
                for cls in (*S.STRING_EXPRESSIONS, *_REGEX_EXPRESSIONS)}
_CHILD_TYPES.update({
    S.Chr: (IntegralType,),
    D.DateAdd: [(DateType,), (IntegralType,)],
    D.DateSub: [(DateType,), (IntegralType,)],
    D.DateDiff: _DATETIME,
    D.AddMonths: [(DateType,), (IntegralType,)],
    D.MonthsBetween: _DATETIME,
    D.NextDay: (DateType,),
    D.LastDay: _DATETIME,
    D.TruncDate: (DateType,),
    D.DateTrunc: (TimestampType,),
    D.UnixTimestamp: _DATETIME,
    D.SecondsToTimestamp: _NUMERIC,
    D.MakeDate: (IntegralType,),
    D.FromUtcTimestamp: (TimestampType,),
    D.ToUtcTimestamp: (TimestampType,),
    # FromUnixtime wraps its input in SecondsToTimestamp when it is built
    D.FromUnixtime: (TimestampType,),
    D.DateFormat: _DATETIME,
})
_CHILD_TYPES.update({cls: _DATETIME for cls in (
    D.Year, D.Month, D.DayOfMonth, D.DayOfWeek, D.WeekDay, D.DayOfYear,
    D.WeekOfYear, D.Quarter)})
_CHILD_TYPES.update({cls: (TimestampType,)
                     for cls in (D.Hour, D.Minute, D.Second)})
_CHILD_TYPES.update({
    P.EqualNullSafe: _ORDERABLE_DEC,
    P.IsNull: _ALL_NESTED,
    P.IsNotNull: _ALL_NESTED,
    P.IsNaN: _FP,
    P.In: _ORDERABLE_DEC,
    A.IntegralDivide: _NUMERIC,
    A.Remainder: _NUMERIC,
    A.Pmod: _NUMERIC,
    A.UnaryMinus: _NUMERIC_DEC,
    A.Abs: _NUMERIC_DEC,
    M.Pow: _NUMERIC,
    M.Atan2: _NUMERIC,
    M.Hypot: _NUMERIC,
    M.Logarithm: _NUMERIC,
    M.Round: _NUMERIC,
    M.BRound: _NUMERIC,
    M.Ceil: _NUMERIC,
    M.Floor: _NUMERIC,
    M.Hex: (IntegralType,),
    C.If: [(BooleanType,), _ALL, _ALL],
    C.CaseWhen: _ALL,
    C.Coalesce: _ALL,
    C.Greatest: _ORDERABLE,
    C.Least: _ORDERABLE,
    C.Nvl2: _ALL,
    C.NaNvl: _FP,
    H.Murmur3Hash: _ORDERABLE_DEC,
    H.XxHash64: _ORDERABLE_DEC,
})
_CHILD_TYPES.update({
    Explode: (ArrayType,),
    PosExplode: (ArrayType,),
    ST.GetStructField: (StructType,),
    ST.CreateNamedStruct: _ORDERABLE_DEC,
})
_CHILD_TYPES.update({cls: _NUMERIC
                     for cls in M.UNARY_MATH + M.NULL_DOMAIN_LOGS})
_CHILD_TYPES.update({cls: (IntegralType,)
                     for cls in M.BITWISE + M.SHIFTS})

_NO_CPU = "; the port has no CPU engine yet (ROADMAP A9)"
_DEC_A3 = (" (ROADMAP A3: decimals outside the arithmetic, comparisons, "
           "casts and aggregates)")


def _child_type_reasons(e: Expression) -> List[str]:
    sig = _CHILD_TYPES.get(type(e))
    if sig is None:
        return []
    return [f"{type(e).__name__} parameter {i}: {c.dtype} input has no "
            "device lowering" + (_DEC_A3 if isinstance(c.dtype, DecimalType)
                                 else "")
            for i, c in enumerate(e.children)
            if not isinstance(c.dtype, (NullType,) + (
                sig[i] if isinstance(sig, list) else sig))]


def _wide_decimal_reasons(e: Expression) -> List[str]:
    """What the reference runs on its CPU engine for decimal(> 18)
    operands (plan/typesig.py `_divide_check`, `_multiply_check`, and the
    128-bit hash it lacks); each names A9."""
    if not any(is_wide(c.dtype) for c in e.children):
        return []
    if isinstance(e, Divide):
        return ["decimal(>18) division runs on the reference's CPU engine "
                "(128/128 device division not lowered)" + _NO_CPU]
    if isinstance(e, Multiply):
        return ["decimal(>18) operand multiplication runs on the "
                "reference's CPU engine (only 64x64 -> 128 is lowered)"
                + _NO_CPU]
    if isinstance(e, H.HASH_EXPRESSIONS):
        return [f"{type(e).__name__} of a decimal(>18) has no device hash "
                "of 128-bit values in the reference" + _NO_CPU]
    return []


#: the collection expressions that take no array<string> cube (the
#: reference's `_register_cube_gates`: only contains, getItem,
#: element_at, size, explode and plain selection are cube-aware)
_CUBE_GATED = (CX.ArrayTransform, CX.ArrayFilter, CX.ArrayMax, CX.ArrayMin,
               CX.SortArray, CX.Slice, CX.ArrayPosition, CX.ArrayRemove,
               CX.ArrayDistinct, CX.Reverse, CX.ArrayExists, CX.ArrayForall,
               CX.ConcatArrays, CX.ArraysOverlap, CX.ArrayIntersect,
               CX.ArrayExcept, CX.ArrayUnion, CX.CreateArray, Literal)


def _is_cube(dt) -> bool:
    return isinstance(dt, ArrayType) and isinstance(dt.elementType,
                                                    StringType)


def _cube_reasons(e: Expression) -> List[str]:
    """What the reference runs on its CPU engine over array<string> (and
    array literals, which its Literal does not fill); each names A9."""
    if not isinstance(e, _CUBE_GATED):
        return []
    if isinstance(e, Literal) and isinstance(e.dtype, ArrayType):
        return ["an array literal runs on the reference's CPU engine"
                + _NO_CPU]
    if any(_is_cube(c.dtype) for c in e.children) or _is_cube(e.dtype):
        return [f"{type(e).__name__} over array<string> runs on the "
                "reference's CPU engine (no cube lowering)" + _NO_CPU]
    return []


def _device_check_reasons(e: Expression) -> List[str]:
    """Cast's and DateFormat's device checks (the reference's
    `_cast_check` and `_date_format_check`); the reference runs what they
    refuse on its CPU engine, so each names A9."""
    if isinstance(e, Cast) and not e.device_supported():
        return [f"cast {e.children[0].dtype} -> {e.to} runs on the "
                "reference's CPU engine" + _NO_CPU]
    if isinstance(e, D.DateFormat):
        r = e.device_supported()
        return [r + _NO_CPU] if r else []
    return []


def _regex_reasons(e: Expression, conf) -> List[str]:
    """The reference's regexp-enabled check and RLike's transpiler check
    (plan/typesig.py `_rlike_check`); each names A9, since the reference
    would run the expression on its CPU engine."""
    if not isinstance(e, _REGEX_EXPRESSIONS):
        return []
    out = []
    if conf is not None and not conf.get(rc.REGEXP_ENABLED):
        out.append("regex on device disabled via "
                   "spark.rapids.sql.regexp.enabled=false" + _NO_CPU)
    r = e.device_supported()
    if r:
        out.append(r + _NO_CPU)
    return out


def type_supported(dt: DataType) -> Optional[str]:
    """The reference's device types (its `type_supported`): arrays of
    primitive, decimal(<= 18) or string elements, maps of primitive or
    decimal(<= 18) keys and values, structs of flat fields. The nested
    types it runs on its CPU engine name A9."""
    if isinstance(dt, NullType) or isinstance(dt, DEVICE_TYPES):
        return None
    if isinstance(dt, ArrayType):
        et = dt.elementType
        if isinstance(et, StringType):
            return None  # the [cap, elems, bytes] cube
        if isinstance(et, (ArrayType, StructType, MapType)) or is_wide(et):
            return (f"array element type {et.simpleString} runs on the "
                    "reference's CPU engine (device arrays hold primitive "
                    "and string elements)" + _NO_CPU)
        return type_supported(et)
    if isinstance(dt, MapType):
        for part, t in (("key", dt.keyType), ("value", dt.valueType)):
            if isinstance(t, (StringType, ArrayType, MapType, StructType)) \
                    or is_wide(t):
                return (f"map {part} type {t.simpleString} runs on the "
                        "reference's CPU engine (device maps hold "
                        "primitive entries)" + _NO_CPU)
            r = type_supported(t)
            if r:
                return r
        return None
    if isinstance(dt, StructType):
        for f in dt.fields:
            if isinstance(f.dataType, (ArrayType, MapType, StructType)):
                return (f"struct field {f.name!r} type "
                        f"{f.dataType.simpleString} runs on the reference's "
                        "CPU engine (device structs hold flat fields)"
                        + _NO_CPU)
            r = type_supported(f.dataType)
            if r:
                return r
        return None
    return f"type {dt} is not supported on the device"


def sort_key_type_supported(dt: DataType) -> Optional[str]:
    """Sort keys need orderable device keys (a decimal(> 18) orders by its
    two limbs in K9); the reference runs array, struct and map keys on
    its CPU engine."""
    if isinstance(dt, StructType):
        return ("struct-typed keys take the reference's struct-key rewrite "
                "(plan/struct_keys.py), which is not ported yet (ROADMAP "
                "A9)")
    if isinstance(dt, (ArrayType, MapType)):
        return (f"{dt.simpleString}-typed keys run on the reference's CPU "
                "engine (no orderable device keys)" + _NO_CPU)
    return type_supported(dt)


def key_type_supported(dt: DataType) -> Optional[str]:
    """Grouping and join keys additionally need a device hash: the
    reference runs a decimal(> 18) key on its CPU engine."""
    if is_wide(dt):
        return ("decimal(>18) grouping/join keys run on the reference's "
                "CPU engine (no device hash for 128-bit keys)" + _NO_CPU)
    return sort_key_type_supported(dt)


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
        reasons.extend(_device_check_reasons(e))
        reasons.extend(_cube_reasons(e))
        if not isinstance(e, PORTED_EXPRESSIONS + CPU_ONLY_EXPRESSIONS):
            reasons.append(f"expression {name} is not ported yet "
                           "(ROADMAP A12)")
            return
        reasons.extend(_child_type_reasons(e))
        reasons.extend(_wide_decimal_reasons(e))
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

