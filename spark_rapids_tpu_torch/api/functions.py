"""Column functions — counterpart of the part of
`spark_rapids_tpu/api/functions.py` the port's expressions cover: `col`,
`lit`, the sum, avg (mean), count, min, max, first, last and any_value
aggregates, the statistical ones (`stddev`, `stddev_pop`, `stddev_samp`,
`variance`, `var_pop`, `var_samp`, `skewness`, `kurtosis`, `corr`,
`covar_pop`, `covar_samp`), `bool_and` (`every`) and `bool_or` (`some`),
`countDistinct`, `sumDistinct`, `approx_count_distinct` (exact, as the
reference's), `percentile` and `percentile_approx`, `collect_list` and
`collect_set` (array results), the sort directions `asc` and
`desc`, the window functions `row_number`, `rank`, `dense_rank`,
`percent_rank`, `cume_dist`, `ntile`, `lead` and `lag`, and the string
functions (`concat`, `substring`, `upper`, `lower`, `length`, the trim
and pad families, `repeat`, `reverse`, `initcap`, `instr`, `locate`,
`translate`, `replace`, `concat_ws`, `ascii`, `chr_`, `substring_index`)
with `rlike`, `regexp_extract` and `regexp_replace` (the last two have no
device implementation: the planner refuses them, naming ROADMAP A9), and
the date and time functions (`year` through `quarter`, `last_day`,
`date_add`, `date_sub`, `datediff`, `add_months`, `months_between`,
`next_day`, `trunc`, `date_trunc`, `unix_timestamp`, `from_unixtime`,
`timestamp_seconds`, `make_date`, `from_utc_timestamp`,
`to_utc_timestamp`, `date_format`, `to_date`, `to_timestamp`,
`current_date`, `current_timestamp`), the conditionals (`when` ...
`otherwise`, `coalesce`, `nvl`, `nvl2`, `nanvl`, `greatest`, `least`), the
math functions (`abs`, `round`, `bround`, `ceil`, `floor`, `pow`, `log`,
`log10`, `log2`, `log1p`, `atan2`, `hypot`, the unary double functions
`sqrt` through `radians`, `pmod`), the bitwise ones (`bitwise_not`,
`shiftleft`, `shiftright`, `shiftrightunsigned`) and the hashes and hex
(`hash`, `xxhash64`, `hex`), and the nested ones: `size`,
`array_contains`, `element_at`, `array`, `get_item`, `struct`,
`explode`, `posexplode`, `transform`, `filter_array`, `exists`,
`forall`, `array_max`, `array_min`, `sort_array`, `slice`,
`array_position`, `array_remove`, `array_distinct`, `reverse` (strings
and arrays), `array_union`, `array_intersect`, `array_except`,
`arrays_overlap`, `concat_arrays`, `map_keys`, `map_values`,
`map_contains_key`, `create_map` and `map_from_arrays`. `pmod` is
PySpark's; the reference's module
has none (its Pmod expression is reached through the Column API
there)."""

from __future__ import annotations

from typing import Any

from spark_rapids_tpu_torch.api.column import Column, SortColumn, _expr
from spark_rapids_tpu_torch.expr import aggregates as AGG
from spark_rapids_tpu_torch.expr import datetimes as DT
from spark_rapids_tpu_torch.expr import mathexpr as M
from spark_rapids_tpu_torch.expr import (
    Abs,
    Ascii,
    Average,
    CaseWhen,
    Cast,
    Chr,
    Coalesce,
    Concat,
    ConcatWs,
    Count,
    First,
    Greatest,
    InitCap,
    Last,
    Least,
    Length,
    Literal,
    Lower,
    Max,
    Min,
    Murmur3Hash,
    NaNvl,
    Nvl2,
    Pmod,
    RegexpExtract,
    RegexpReplace,
    RLike,
    StringInstr,
    StringLocate,
    StringLPad,
    StringRepeat,
    StringReplace,
    StringReverse,
    StringRPad,
    StringTranslate,
    StringTrim,
    StringTrimLeft,
    StringTrimRight,
    Substring,
    SubstringIndex,
    Sum,
    Upper,
    XxHash64,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import date as date_t
from spark_rapids_tpu_torch.sqltypes.datatypes import timestamp as timestamp_t


class UnresolvedColumn:
    """A column named by the user, bound to an ordinal when the DataFrame
    resolves the expression against its schema."""

    def __init__(self, name: str):
        self.name = name


def col(name: str) -> Column:
    return Column(UnresolvedColumn(name), name)  # type: ignore[arg-type]


def lit(v: Any) -> Column:
    return Column(Literal(v))


def expr_of(c) -> Any:
    if isinstance(c, Column):
        return c.expr
    if isinstance(c, str):
        # bare strings name columns (pyspark convention for functions)
        return UnresolvedColumn(c)
    return _expr(c)


def sum(c) -> Column:  # noqa: A001
    return Column(Sum(expr_of(c)))


def count(c="*") -> Column:
    if isinstance(c, str) and c == "*":
        return Column(Count(None))
    return Column(Count(expr_of(c)))


def avg(c) -> Column:
    return Column(Average(expr_of(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(Min(expr_of(c)))


def max(c) -> Column:  # noqa: A001
    return Column(Max(expr_of(c)))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(First(expr_of(c), ignore_nulls=ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(Last(expr_of(c), ignore_nulls=ignorenulls), "last")


def _agg1(cls, c) -> Column:
    return Column(cls(expr_of(c)))


def stddev(c) -> Column:
    return _agg1(AGG.StddevSamp, c)


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return _agg1(AGG.StddevPop, c)


def variance(c) -> Column:
    return _agg1(AGG.VarianceSamp, c)


var_samp = variance


def var_pop(c) -> Column:
    return _agg1(AGG.VariancePop, c)


def skewness(c) -> Column:
    return _agg1(AGG.Skewness, c)


def kurtosis(c) -> Column:
    return _agg1(AGG.Kurtosis, c)


def corr(x, y) -> Column:
    return Column(AGG.Corr(expr_of(x), expr_of(y)))


def covar_pop(x, y) -> Column:
    return Column(AGG.CovarPop(expr_of(x), expr_of(y)))


def covar_samp(x, y) -> Column:
    return Column(AGG.CovarSamp(expr_of(x), expr_of(y)))


def collect_list(c) -> Column:
    return _agg1(AGG.CollectList, c)


array_agg = collect_list


def collect_set(c) -> Column:
    return _agg1(AGG.CollectSet, c)


def countDistinct(c) -> Column:
    return _agg1(AGG.CountDistinct, c)


count_distinct = countDistinct


def sumDistinct(c) -> Column:
    return _agg1(AGG.SumDistinct, c)


sum_distinct = sumDistinct


def approx_count_distinct(c, rsd: float = 0.05) -> Column:
    """The exact distinct count, as the reference gives it (its contract
    is an approximation; `rsd` is taken for API parity)."""
    return _agg1(AGG.CountDistinct, c)


def percentile(c, percentage: float) -> Column:
    return Column(AGG.Percentile(expr_of(c), percentage))


def percentile_approx(c, percentage: float,
                      accuracy: int = 10000) -> Column:
    return Column(AGG.ApproxPercentile(expr_of(c), percentage, accuracy))


approx_percentile = percentile_approx


def bool_and(c) -> Column:
    return _agg1(AGG.BoolAnd, c)


every = bool_and


def bool_or(c) -> Column:
    return _agg1(AGG.BoolOr, c)


some = bool_or


def any_value(c, ignorenulls: bool = True) -> Column:
    return Column(AGG.AnyValue(expr_of(c), ignore_nulls=ignorenulls))


def asc(c) -> SortColumn:
    return SortColumn(expr_of(c), True)


def desc(c) -> SortColumn:
    return SortColumn(expr_of(c), False)


# ---------------------------------------------------------------- windows

def row_number() -> Column:
    from spark_rapids_tpu_torch.expr.windows import RowNumber

    return Column(RowNumber())


def rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import Rank

    return Column(Rank())


def dense_rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import DenseRank

    return Column(DenseRank())


def percent_rank() -> Column:
    from spark_rapids_tpu_torch.expr.windows import PercentRank

    return Column(PercentRank())


def cume_dist() -> Column:
    from spark_rapids_tpu_torch.expr.windows import CumeDist

    return Column(CumeDist())


def ntile(n: int) -> Column:
    from spark_rapids_tpu_torch.expr.windows import NTile

    return Column(NTile(n))


def lit_or(v):
    return v if isinstance(v, Column) else lit(v)


def lead(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.expr.windows import Lead

    d = None if default is None else _expr(lit_or(default))
    return Column(Lead(expr_of(c), offset, d))


def lag(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.expr.windows import Lag

    d = None if default is None else _expr(lit_or(default))
    return Column(Lag(expr_of(c), offset, d))


# ---------------------------------------------------------------- strings

def concat(*cs) -> Column:
    return Column(Concat(*[expr_of(c) for c in cs]))


def substring(c, pos: int, length: int) -> Column:
    return Column(Substring(expr_of(c), pos, length))


def _u(cls):
    def f(c):
        return Column(cls(expr_of(c)))
    f.__name__ = cls.__name__.lower()
    return f


upper = _u(Upper)
lower = _u(Lower)
length = _u(Length)
ascii = _u(Ascii)  # noqa: A001
initcap = _u(InitCap)
#: a string's characters reversed; `reverse` below takes arrays too
reverse = _u(StringReverse)
ltrim = _u(StringTrimLeft)
rtrim = _u(StringTrimRight)
trim = _u(StringTrim)


def lpad(c, length: int, pad: str = " ") -> Column:
    return Column(StringLPad(expr_of(c), length, pad))


def rpad(c, length: int, pad: str = " ") -> Column:
    return Column(StringRPad(expr_of(c), length, pad))


def repeat(c, n: int) -> Column:
    return Column(StringRepeat(expr_of(c), n))


def instr(c, substr: str) -> Column:
    return Column(StringInstr(expr_of(c), substr))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(StringLocate(expr_of(c), substr, pos))


def translate(c, matching: str, replace: str) -> Column:
    return Column(StringTranslate(expr_of(c), matching, replace))


def regexp_replace_literal(c, search: str, replacement: str) -> Column:
    """Literal (non-regex) replace — Spark's `replace`."""
    return Column(StringReplace(expr_of(c), search, replacement))


replace = regexp_replace_literal


def concat_ws(sep: str, *cs) -> Column:
    return Column(ConcatWs(sep, *[expr_of(c) for c in cs]))


def chr_(c) -> Column:
    return Column(Chr(expr_of(lit_or(c))))


def substring_index(c, delim: str, count: int) -> Column:
    return Column(SubstringIndex(expr_of(c), delim, count))


def rlike(c, pattern: str) -> Column:
    return Column(RLike(expr_of(c), pattern))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    return Column(RegexpExtract(expr_of(c), pattern, idx))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return Column(RegexpReplace(expr_of(c), pattern, replacement))


# ------------------------------------------------------- casts and dates

year = _u(DT.Year)
month = _u(DT.Month)
dayofmonth = _u(DT.DayOfMonth)
hour = _u(DT.Hour)
minute = _u(DT.Minute)
second = _u(DT.Second)
dayofweek = _u(DT.DayOfWeek)
weekday = _u(DT.WeekDay)
dayofyear = _u(DT.DayOfYear)
weekofyear = _u(DT.WeekOfYear)
quarter = _u(DT.Quarter)


def last_day(c) -> Column:
    return Column(DT.LastDay(expr_of(c)))


def date_add(c, days) -> Column:
    return Column(DT.DateAdd(expr_of(c), expr_of(lit_or(days))))


def date_sub(c, days) -> Column:
    return Column(DT.DateSub(expr_of(c), expr_of(lit_or(days))))


def datediff(end, start) -> Column:
    return Column(DT.DateDiff(expr_of(end), expr_of(start)))


def add_months(c, months) -> Column:
    return Column(DT.AddMonths(expr_of(c), expr_of(lit_or(months))))


def months_between(end, start, roundOff: bool = True) -> Column:
    return Column(DT.MonthsBetween(expr_of(end), expr_of(start), roundOff))


def next_day(c, dayOfWeek: str) -> Column:
    return Column(DT.NextDay(expr_of(c), dayOfWeek))


def trunc(c, fmt: str) -> Column:
    return Column(DT.TruncDate(expr_of(c), fmt))


def date_trunc(fmt: str, c) -> Column:
    return Column(DT.DateTrunc(fmt, expr_of(c)))


def unix_timestamp(c) -> Column:
    """Seconds since the epoch; a string or date input is cast to a
    timestamp first (a no-op for timestamps)."""
    return Column(DT.UnixTimestamp(Cast(expr_of(c), timestamp_t)))


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    return Column(DT.FromUnixtime(expr_of(c), fmt))


def timestamp_seconds(c) -> Column:
    return Column(DT.SecondsToTimestamp(expr_of(c)))


def make_date(y, m, d) -> Column:
    return Column(DT.MakeDate(expr_of(y), expr_of(m), expr_of(d)))


def from_utc_timestamp(c, tz: str) -> Column:
    return Column(DT.FromUtcTimestamp(expr_of(c), tz))


def to_utc_timestamp(c, tz: str) -> Column:
    return Column(DT.ToUtcTimestamp(expr_of(c), tz))


def date_format(c, fmt: str) -> Column:
    return Column(DT.DateFormat(expr_of(c), fmt))


def to_date(c, fmt: str = None) -> Column:
    if fmt is not None and fmt not in ("yyyy-MM-dd",):
        raise ValueError(
            f"to_date format {fmt!r} unsupported in v1 (default "
            "'yyyy-MM-dd' only)")
    return Column(Cast(expr_of(c), date_t))


def to_timestamp(c, fmt: str = None) -> Column:
    if fmt is not None and fmt not in ("yyyy-MM-dd HH:mm:ss",
                                       "yyyy-MM-dd"):
        raise ValueError(f"to_timestamp format {fmt!r} unsupported in v1")
    return Column(Cast(expr_of(c), timestamp_t))


def current_date() -> Column:
    return Column(DT.CurrentDate())


def current_timestamp() -> Column:
    return Column(DT.CurrentTimestamp())


# ------------------------------------------ conditionals, math and hashes

def when(condition: Column, value) -> "WhenBuilder":
    return WhenBuilder([(expr_of(condition), expr_of(lit_or(value)))])


class WhenBuilder(Column):
    """CASE WHEN being built: `.when(...)` adds a branch, `.otherwise(v)`
    closes it with an else; used as it stands, rows no branch takes are
    null."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(CaseWhen(branches))

    def when(self, condition: Column, value) -> "WhenBuilder":
        return WhenBuilder(self._branches
                           + [(expr_of(condition), expr_of(lit_or(value)))])

    def otherwise(self, value) -> Column:
        return Column(CaseWhen(self._branches, expr_of(lit_or(value))))


def abs(c) -> Column:  # noqa: A001
    return Column(Abs(expr_of(c)))


def coalesce(*cs) -> Column:
    return Column(Coalesce(*[expr_of(c) for c in cs]))


def nvl(a, b) -> Column:
    return Column(Coalesce(expr_of(a), expr_of(lit_or(b))))


def nvl2(a, b, c) -> Column:
    return Column(Nvl2(expr_of(a), expr_of(lit_or(b)), expr_of(lit_or(c))))


def nanvl(a, b) -> Column:
    return Column(NaNvl(expr_of(a), expr_of(lit_or(b))))


def greatest(*cs) -> Column:
    return Column(Greatest(*[expr_of(c) for c in cs]))


def least(*cs) -> Column:
    return Column(Least(*[expr_of(c) for c in cs]))


sqrt = _u(M.Sqrt)
exp = _u(M.Exp)
expm1 = _u(M.Expm1)
cbrt = _u(M.Cbrt)
rint = _u(M.Rint)
signum = _u(M.Signum)
sin = _u(M.Sin)
cos = _u(M.Cos)
tan = _u(M.Tan)
cot = _u(M.Cot)
asin = _u(M.Asin)
acos = _u(M.Acos)
atan = _u(M.Atan)
sinh = _u(M.Sinh)
cosh = _u(M.Cosh)
tanh = _u(M.Tanh)
asinh = _u(M.Asinh)
acosh = _u(M.Acosh)
atanh = _u(M.Atanh)
degrees = _u(M.ToDegrees)
radians = _u(M.ToRadians)
log10 = _u(M.Log10)
log2 = _u(M.Log2)
log1p = _u(M.Log1p)
bitwise_not = _u(M.BitwiseNot)
bitwiseNOT = bitwise_not
hex = _u(M.Hex)  # noqa: A001


def log(arg1, arg2=None) -> Column:
    """log(col) is the natural log; log(base, col) the log to a base."""
    if arg2 is None:
        return Column(M.Log(expr_of(arg1)))
    return Column(M.Logarithm(expr_of(lit_or(arg1)), expr_of(arg2)))


def pow(base, exponent) -> Column:  # noqa: A001
    return Column(M.Pow(expr_of(lit_or(base)), expr_of(lit_or(exponent))))


def atan2(y, x) -> Column:
    return Column(M.Atan2(expr_of(lit_or(y)), expr_of(lit_or(x))))


def hypot(a, b) -> Column:
    return Column(M.Hypot(expr_of(lit_or(a)), expr_of(lit_or(b))))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(M.Round(expr_of(c), scale))


def bround(c, scale: int = 0) -> Column:
    return Column(M.BRound(expr_of(c), scale))


def ceil(c) -> Column:
    return Column(M.Ceil(expr_of(c)))


def floor(c) -> Column:
    return Column(M.Floor(expr_of(c)))


def pmod(dividend, divisor) -> Column:
    return Column(Pmod(expr_of(dividend), expr_of(divisor)))


def shiftleft(c, n: int) -> Column:
    return Column(M.ShiftLeft(expr_of(c), expr_of(lit(n))))


def shiftright(c, n: int) -> Column:
    return Column(M.ShiftRight(expr_of(c), expr_of(lit(n))))


def shiftrightunsigned(c, n: int) -> Column:
    return Column(M.ShiftRightUnsigned(expr_of(c), expr_of(lit(n))))


def hash(*cs) -> Column:  # noqa: A001
    return Column(Murmur3Hash(*[expr_of(c) for c in cs]))


def xxhash64(*cs) -> Column:
    return Column(XxHash64(*[expr_of(c) for c in cs]))


# --- collection functions (collectionOperations.scala analog) ---

def _coll(cls_name: str, *args, name: str = None) -> Column:
    from spark_rapids_tpu_torch.expr import collections as CX

    return Column(getattr(CX, cls_name)(*args), name)


def size(c) -> Column:
    return _coll("Size", expr_of(c), name="size")


def array_contains(c, value) -> Column:
    return _coll("ArrayContains", expr_of(c), expr_of(value),
                 name="array_contains")


def element_at(c, index) -> Column:
    return _coll("ElementAt", expr_of(c), expr_of(index), name="element_at")


def array(*cols) -> Column:
    return _coll("CreateArray", *[expr_of(c) for c in cols], name="array")


def get_item(c, index) -> Column:
    return _coll("GetArrayItem", expr_of(c), expr_of(index), name="getItem")


def struct(*cols) -> Column:
    """struct(col1, col2, ...) named after each column's output name
    (Spark's CreateNamedStruct)."""
    from spark_rapids_tpu_torch.expr.structs import CreateNamedStruct

    names = []
    for i, c in enumerate(cols):
        if isinstance(c, Column):
            names.append(c._name or f"col{i + 1}")
        elif isinstance(c, str):
            names.append(c)
        else:
            names.append(f"col{i + 1}")
    return Column(CreateNamedStruct(names, [expr_of(c) for c in cols]),
                  "struct")


def explode(c) -> Column:
    from spark_rapids_tpu_torch.expr.generators import Explode

    return Column(Explode(expr_of(c)), "col")


def posexplode(c) -> Column:
    from spark_rapids_tpu_torch.expr.generators import PosExplode

    return Column(PosExplode(expr_of(c)), "col")


def transform(c, fn) -> Column:
    """transform(arr, x -> f(x)): fn takes and returns a Column; the
    lambda tree is built once the array column resolves to its type."""
    from spark_rapids_tpu_torch.expr.collections import ArrayTransform

    return Column(ArrayTransform(expr_of(c), fn=fn), "transform")


def filter_array(c, fn) -> Column:
    """filter(arr, x -> pred(x))."""
    from spark_rapids_tpu_torch.expr.collections import ArrayFilter

    return Column(ArrayFilter(expr_of(c), fn=fn), "filter")


def exists(c, fn) -> Column:
    from spark_rapids_tpu_torch.expr.collections import ArrayExists

    return Column(ArrayExists(expr_of(c), fn=fn))


def forall(c, fn) -> Column:
    from spark_rapids_tpu_torch.expr.collections import ArrayForall

    return Column(ArrayForall(expr_of(c), fn=fn))


def array_max(c) -> Column:
    return _coll("ArrayMax", expr_of(c), name="array_max")


def array_min(c) -> Column:
    return _coll("ArrayMin", expr_of(c), name="array_min")


def sort_array(c, asc: bool = True) -> Column:
    return _coll("SortArray", expr_of(c), asc, name="sort_array")


def slice(c, start, length) -> Column:  # noqa: A001
    return _coll("Slice", expr_of(c), expr_of(lit_or(start)),
                 expr_of(lit_or(length)))


def array_position(c, v) -> Column:
    return _coll("ArrayPosition", expr_of(c), expr_of(lit_or(v)))


def array_remove(c, v) -> Column:
    return _coll("ArrayRemove", expr_of(c), expr_of(lit_or(v)))


def array_distinct(c) -> Column:
    return _coll("ArrayDistinct", expr_of(c))


def reverse(c) -> Column:  # noqa: F811 (strings and arrays)
    return _coll("Reverse", expr_of(c))


def array_union(a, b) -> Column:
    return _coll("ArrayUnion", expr_of(a), expr_of(b))


def array_intersect(a, b) -> Column:
    return _coll("ArrayIntersect", expr_of(a), expr_of(b))


def array_except(a, b) -> Column:
    return _coll("ArrayExcept", expr_of(a), expr_of(b))


def arrays_overlap(a, b) -> Column:
    return _coll("ArraysOverlap", expr_of(a), expr_of(b))


def concat_arrays(*cs) -> Column:
    return _coll("ConcatArrays", *[expr_of(c) for c in cs])


def map_keys(c) -> Column:
    return _coll("MapKeys", expr_of(c))


def map_values(c) -> Column:
    return _coll("MapValues", expr_of(c))


def map_contains_key(c, key) -> Column:
    return _coll("MapContainsKey", expr_of(c), expr_of(lit_or(key)))


def create_map(*cols) -> Column:
    return _coll("CreateMap", *[expr_of(lit_or(c)) for c in cols])


def map_from_arrays(keys, values) -> Column:
    return _coll("MapFromArrays", expr_of(keys), expr_of(values))
