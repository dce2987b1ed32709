"""Date and time expressions — counterpart of
`spark_rapids_tpu/expr/datetimes.py`, with the reference's semantics.

Dates are int32 days since 1970-01-01 and timestamps int64 microseconds
since the epoch in UTC, as in the reference. Expressions whose answer
depends on the session time zone (`TzAware`, Cast) carry a `tz` zone id
that the session stamps when it resolves them
(api/dataframe.py `_stamp_session`); a non-UTC zone rebases through
ops/tzdb.py, whose `utc_to_local` and `local_to_utc` run kernel K23 on
the card.

The calendar arithmetic is Howard Hinnant's civil-from-days algorithm in
integer torch operations, elementwise, as it is elementwise jnp in the
reference. Every `//` and `%` floors, as jnp's do (torch's floor too), so
pre-1970 dates and negative instants give the reference's fields.
`DateFormat` (and `FromUnixtime`) write their text with kernel K24
(csrc/str_format.cu, through expr/cast.py's launcher); its plain version
is the reference's body. `CurrentDate` and `CurrentTimestamp` are markers
the session pins to one literal a query (`_pin_query_time`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression, binary_validity
from spark_rapids_tpu_torch.ops import tzdb
from spark_rapids_tpu_torch.sqltypes import TimestampType
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    date as date_t,
    double,
    integer,
    long,
    string as string_t,
    timestamp as timestamp_t,
)

_US_PER_DAY = 86_400_000_000
_US_PER_SEC = 1_000_000


class TzAware:
    """Mixin: an expression whose semantics depend on the session time
    zone. `tz` is stamped by the session at resolution time and is part
    of the expression's key."""

    tz: str = "UTC"

    def key(self):
        return (type(self).__name__, self.tz,
                tuple(c.key() for c in self.children))


def civil_from_days(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """days-since-epoch -> (year, month, day), proleptic Gregorian."""
    z = z.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d) -> torch.Tensor:
    y = torch.as_tensor(y).to(torch.int64)
    m = torch.as_tensor(m).to(torch.int64)
    d = torch.as_tensor(d).to(torch.int64)
    y = y - (m <= 2).to(torch.int64)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _local_us(col: DeviceColumn, tz: str) -> torch.Tensor:
    """Timestamp column -> local wall-clock epoch-us."""
    if tzdb.is_utc(tz):
        return col.data
    return tzdb.utc_to_local(col.data, tz)


def _days_of(col: DeviceColumn, tz: str = "UTC") -> torch.Tensor:
    if isinstance(col.dtype, TimestampType):
        return torch.div(_local_us(col, tz), _US_PER_DAY,
                         rounding_mode="floor")
    return col.data.to(torch.int64)


def _floor(x: torch.Tensor, unit: int) -> torch.Tensor:
    return torch.div(x, unit, rounding_mode="floor") * unit


class _DatePart(TzAware, Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return integer

    def _part(self, y, m, d):
        raise NotImplementedError

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        y, m, d = civil_from_days(_days_of(c, self.tz))
        return DeviceColumn(integer, self._part(y, m, d).to(torch.int32),
                            c.validity)


class Year(_DatePart):
    def _part(self, y, m, d):
        return y


class Month(_DatePart):
    def _part(self, y, m, d):
        return m


class DayOfMonth(_DatePart):
    def _part(self, y, m, d):
        return d


class _TimePart(TzAware, Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return integer

    divisor = 1
    modulus = 1

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        us = _local_us(c, self.tz)
        us_in_day = us - _floor(us, _US_PER_DAY)
        val = (us_in_day // self.divisor) % self.modulus
        return DeviceColumn(integer, val.to(torch.int32), c.validity)


class Hour(_TimePart):
    divisor = 3_600_000_000
    modulus = 24


class Minute(_TimePart):
    divisor = 60_000_000
    modulus = 60


class Second(_TimePart):
    divisor = 1_000_000
    modulus = 60


# ------------------------------------------------------- calendar parts


class DayOfWeek(_DatePart):
    """Spark dayofweek: 1 = Sunday .. 7 = Saturday."""

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        d = _days_of(c, self.tz)
        return DeviceColumn(integer, ((d + 4) % 7 + 1).to(torch.int32),
                            c.validity)


class WeekDay(_DatePart):
    """Spark weekday: 0 = Monday .. 6 = Sunday."""

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        d = _days_of(c, self.tz)
        return DeviceColumn(integer, ((d + 3) % 7).to(torch.int32),
                            c.validity)


def _jan1(y: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(y)
    return days_from_civil(y, one, one)


class DayOfYear(_DatePart):
    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        d = _days_of(c, self.tz)
        y, _, _ = civil_from_days(d)
        return DeviceColumn(integer, (d - _jan1(y) + 1).to(torch.int32),
                            c.validity)


class WeekOfYear(_DatePart):
    """ISO-8601 week number (the week containing Thursday)."""

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        d = _days_of(c, self.tz)
        thu = d - (d + 3) % 7 + 3
        y, _, _ = civil_from_days(thu)
        week = (thu - _jan1(y)) // 7 + 1
        return DeviceColumn(integer, week.to(torch.int32), c.validity)


class Quarter(_DatePart):
    def _part(self, y, m, d):
        return (m - 1) // 3 + 1


def _month_len(y, m):
    nxt_m = torch.where(m == 12, 1, m + 1)
    nxt_y = torch.where(m == 12, y + 1, y)
    one = torch.ones_like(m)
    return (days_from_civil(nxt_y, nxt_m, one)
            - days_from_civil(y, m, one))


class LastDay(_DatePart):
    @property
    def dtype(self):
        return date_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        y, m, _ = civil_from_days(_days_of(c, self.tz))
        nd = days_from_civil(y, m, torch.ones_like(m)) + _month_len(y, m) - 1
        return DeviceColumn(date_t, nd.to(torch.int32), c.validity)


# ------------------------------------------------------- date arithmetic


class DateAdd(Expression):
    """date_add(date, n). DateSub flips the sign."""

    _sign = 1

    def __init__(self, date: Expression, n: Expression):
        super().__init__([date, n])

    @property
    def dtype(self):
        return date_t

    def eval(self, ctx):
        d = self.children[0].eval(ctx)
        n = self.children[1].eval(ctx)
        days = d.data.to(torch.int32) + self._sign * n.data.to(torch.int32)
        return DeviceColumn(date_t, days.to(torch.int32),
                            binary_validity(d, n))


class DateSub(DateAdd):
    _sign = -1


class DateDiff(Expression):
    """datediff(end, start) in days."""

    def __init__(self, end: Expression, start: Expression):
        super().__init__([end, start])

    @property
    def dtype(self):
        return integer

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)
        return DeviceColumn(
            integer, e.data.to(torch.int32) - s.data.to(torch.int32),
            binary_validity(e, s))


class AddMonths(Expression):
    def __init__(self, date: Expression, n: Expression):
        super().__init__([date, n])

    @property
    def dtype(self):
        return date_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        n = self.children[1].eval(ctx)
        y, m, d = civil_from_days(c.data.to(torch.int64))
        m0 = y * 12 + (m - 1) + n.data.to(torch.int32)
        ny = torch.div(m0, 12, rounding_mode="floor")
        nm = m0 - ny * 12 + 1
        nd = torch.minimum(d, _month_len(ny, nm))
        return DeviceColumn(date_t, days_from_civil(ny, nm, nd),
                            binary_validity(c, n))


def _div(x: torch.Tensor, f: float) -> torch.Tensor:
    """x / f, IEEE-rounded: on the card torch divides by a Python scalar as
    a multiply by its reciprocal (1 ulp off on some values), so f goes in
    as a tensor on x's device."""
    return x / torch.full_like(x, f)


class MonthsBetween(TzAware, Expression):
    """months_between(end, start[, roundOff]): Spark's 31-day-month
    fractional rule: integral when both are the same day of month or both
    are month ends, else the day and time difference over 31 days."""

    def __init__(self, end: Expression, start: Expression,
                 round_off: bool = True):
        super().__init__([end, start])
        self.round_off = round_off

    @property
    def dtype(self):
        return double

    def key(self):
        return ("months_between", self.tz, self.round_off,
                tuple(c.key() for c in self.children))

    def _fields(self, col):
        if isinstance(col.dtype, TimestampType):
            us = _local_us(col, self.tz)
        else:
            us = col.data.to(torch.int64) * _US_PER_DAY
        days = torch.div(us, _US_PER_DAY, rounding_mode="floor")
        tod = _div((us - days * _US_PER_DAY).to(torch.float64), _US_PER_SEC)
        y, m, d = civil_from_days(days)
        return y, m, d, tod

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)
        y1, m1, d1, t1 = self._fields(e)
        y2, m2, d2, t2 = self._fields(s)
        months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
        last1 = d1 == _month_len(y1, m1)
        last2 = d2 == _month_len(y2, m2)
        integral = (d1 == d2) | (last1 & last2)
        sec1 = d1.to(torch.float64) * 86400.0 + t1
        sec2 = d2.to(torch.float64) * 86400.0 + t2
        frac = _div(sec1 - sec2, 31.0 * 86400.0)
        out = torch.where(integral, months, months + frac)
        if self.round_off:
            # half to even, as jnp.round
            out = _div(torch.round(out * 1e8), 1e8)
        return DeviceColumn(double, out, binary_validity(e, s))


_DAY_NAMES = {
    "MO": 1, "MON": 1, "MONDAY": 1, "TU": 2, "TUE": 2, "TUESDAY": 2,
    "WE": 3, "WED": 3, "WEDNESDAY": 3, "TH": 4, "THU": 4, "THURSDAY": 4,
    "FR": 5, "FRI": 5, "FRIDAY": 5, "SA": 6, "SAT": 6, "SATURDAY": 6,
    "SU": 7, "SUN": 7, "SUNDAY": 7,
}


def _all_null(dtype, c: DeviceColumn) -> DeviceColumn:
    return DeviceColumn(dtype, torch.zeros_like(c.data),
                        torch.zeros(c.data.shape, dtype=torch.bool,
                                    device=c.data.device))


class NextDay(Expression):
    """next_day(date, 'Mon'): the first date strictly after `date` that
    falls on the given weekday; an invalid day name gives null."""

    def __init__(self, date: Expression, day_name: str):
        super().__init__([date])
        self.target = _DAY_NAMES.get(str(day_name).strip().upper())

    @property
    def dtype(self):
        return date_t

    @property
    def nullable(self):
        return True

    def key(self):
        return ("next_day", self.target, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self.target is None:
            return _all_null(date_t, c)
        d = c.data.to(torch.int32)
        # ISO dow: Monday=1..Sunday=7; 1970-01-01 is Thursday(4)
        dow = (d + 3) % 7 + 1
        delta = (self.target - dow + 7) % 7
        delta = torch.where(delta == 0, 7, delta)
        return DeviceColumn(date_t, (d + delta).to(torch.int32), c.validity)


# ------------------------------------------------------------ truncation

_TRUNC_DATE_FMTS = {
    "YEAR": "year", "YYYY": "year", "YY": "year",
    "QUARTER": "quarter", "MONTH": "month", "MON": "month",
    "MM": "month", "WEEK": "week",
}
_TRUNC_TS_FMTS = dict(_TRUNC_DATE_FMTS, **{
    "DAY": "day", "DD": "day", "HOUR": "hour", "MINUTE": "minute",
    "SECOND": "second",
})


def _trunc_days(days, unit):
    y, m, d = civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "year":
        return days_from_civil(y, one, one)
    if unit == "quarter":
        return days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    if unit == "month":
        return days_from_civil(y, m, one)
    if unit == "week":  # Monday start
        return (days - (days + 3) % 7).to(torch.int32)
    raise ValueError(unit)


class TruncDate(Expression):
    """trunc(date, fmt) -> date; an unknown fmt gives null (Spark)."""

    def __init__(self, date: Expression, fmt: str):
        super().__init__([date])
        self.unit = _TRUNC_DATE_FMTS.get(str(fmt).strip().upper())

    @property
    def dtype(self):
        return date_t

    @property
    def nullable(self):
        return True

    def key(self):
        return ("trunc_date", self.unit, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self.unit is None:
            return _all_null(date_t, c)
        days = _trunc_days(c.data.to(torch.int64), self.unit)
        return DeviceColumn(date_t, days.to(torch.int32), c.validity)


class DateTrunc(TzAware, Expression):
    """date_trunc(fmt, timestamp) -> timestamp, truncated in the session
    zone's wall clock, then rebased to UTC."""

    def __init__(self, fmt: str, ts: Expression):
        super().__init__([ts])
        self.unit = _TRUNC_TS_FMTS.get(str(fmt).strip().upper())

    @property
    def dtype(self):
        return timestamp_t

    @property
    def nullable(self):
        return True

    def key(self):
        return ("date_trunc", self.unit, self.tz, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self.unit is None:
            return _all_null(timestamp_t, c)
        us = _local_us(c, self.tz)
        step = {"second": _US_PER_SEC, "minute": 60 * _US_PER_SEC,
                "hour": 3600 * _US_PER_SEC, "day": _US_PER_DAY}.get(self.unit)
        if step is not None:
            out = _floor(us, step)
        else:
            days = _trunc_days(torch.div(us, _US_PER_DAY,
                                         rounding_mode="floor"), self.unit)
            out = days.to(torch.int64) * _US_PER_DAY
        if not tzdb.is_utc(self.tz):
            out = tzdb.local_to_utc(out, self.tz)
        return DeviceColumn(timestamp_t, out, c.validity)


# ------------------------------------------------------ epoch conversion


class UnixTimestamp(Expression):
    """unix_timestamp(ts) -> seconds since the epoch (long)."""

    def __init__(self, ts: Expression):
        super().__init__([ts])

    @property
    def dtype(self):
        return long

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(
            long, torch.div(c.data, _US_PER_SEC, rounding_mode="floor"),
            c.validity)


class SecondsToTimestamp(Expression):
    """timestamp_seconds(col): numeric seconds -> timestamp."""

    def __init__(self, secs: Expression):
        super().__init__([secs])

    @property
    def dtype(self):
        return timestamp_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if c.data.dtype.is_floating_point:
            us = torch.round(c.data * _US_PER_SEC).to(torch.int64)
        else:
            us = c.data.to(torch.int64) * _US_PER_SEC
        return DeviceColumn(timestamp_t, us, c.validity)


class MakeDate(Expression):
    def __init__(self, y: Expression, m: Expression, d: Expression):
        super().__init__([y, m, d])

    @property
    def dtype(self):
        return date_t

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        y = self.children[0].eval(ctx)
        m = self.children[1].eval(ctx)
        d = self.children[2].eval(ctx)
        yy = y.data.to(torch.int32)
        mm = m.data.to(torch.int32)
        dd = d.data.to(torch.int32)
        mc = torch.clamp(mm, 1, 12)
        ok = ((mm >= 1) & (mm <= 12) & (dd >= 1)
              & (dd <= _month_len(yy, mc)))
        days = days_from_civil(yy, mc, torch.clamp(dd, 1, 31))
        return DeviceColumn(date_t, days,
                            y.validity & m.validity & d.validity & ok)


class FromUtcTimestamp(Expression):
    """from_utc_timestamp(ts, zone): reinterpret a UTC instant as the
    given zone's wall clock (an explicit zone, not the session's)."""

    _to_utc = False

    def __init__(self, ts: Expression, zone: str):
        super().__init__([ts])
        self.zone = str(zone)

    @property
    def dtype(self):
        return timestamp_t

    def key(self):
        return (type(self).__name__, self.zone, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self._to_utc:
            out = tzdb.local_to_utc(c.data, self.zone)
        else:
            out = tzdb.utc_to_local(c.data, self.zone)
        return DeviceColumn(timestamp_t, out, c.validity)


class ToUtcTimestamp(FromUtcTimestamp):
    _to_utc = True


# ------------------------------------------------------------ formatting

_FMT_TOKENS = ("yyyy", "MM", "dd", "HH", "mm", "ss", "SSS")
#: each token's field (the order of `_pattern_fields`) and digit count
_FMT_FIELDS = {"yyyy": (0, 4), "MM": (1, 2), "dd": (2, 2), "HH": (3, 2),
               "mm": (4, 2), "ss": (5, 2), "SSS": (6, 3)}


def _tokenize_format(fmt: str):
    """Java SimpleDateFormat subset -> [(kind, text)] or None if the
    pattern uses letters outside the supported set."""
    out = []
    i = 0
    while i < len(fmt):
        for tok in _FMT_TOKENS:
            if fmt.startswith(tok, i):
                out.append(("tok", tok))
                i += len(tok)
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                return None  # unsupported pattern letter
            out.append(("lit", ch))
            i += 1
    return out


def _pattern_width(tokens) -> int:
    return sum(_FMT_FIELDS[t][1] if k == "tok" else 1 for k, t in tokens)


def _pattern_codes(tokens) -> np.ndarray:
    """K24's descriptor of a token list: one int32 per output byte, the
    byte itself (>= 0) for a literal, else -(1 + field * 8 + place) for
    the digit of 10^place of a field."""
    codes = []
    for kind, t in tokens:
        if kind == "lit":
            codes.append(ord(t) & 0xFF)  # jnp.uint8(ord(t)) wraps too
            continue
        field, w = _FMT_FIELDS[t]
        codes.extend(-(1 + field * 8 + (w - 1 - j)) for j in range(w))
    return np.asarray(codes, dtype=np.int32)


@lru_cache(maxsize=64)
def _device_codes(fmt: str, device: str) -> torch.Tensor:
    return torch.from_numpy(_pattern_codes(_tokenize_format(fmt))).to(
        torch.device(device))


def _pattern_fields(us: torch.Tensor):
    days = torch.div(us, _US_PER_DAY, rounding_mode="floor")
    in_day = us - days * _US_PER_DAY
    y, m, d = civil_from_days(days)
    return (y.to(torch.int64), m.to(torch.int64), d.to(torch.int64),
            in_day // 3_600_000_000, (in_day // 60_000_000) % 60,
            (in_day // _US_PER_SEC) % 60, (in_day // 1000) % 1000)


def _pattern_to_string_plain(values: torch.Tensor, days_input: bool,
                             fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K24's pattern mode: the reference's
    DateFormat.eval body over int32 days or int64 local microseconds."""
    tokens = _tokenize_format(fmt)
    us = (values.to(torch.int64) * _US_PER_DAY if days_input
          else values)
    fields = _pattern_fields(us)
    width = _pattern_width(tokens)
    mb = max(8, 1 << (width - 1).bit_length())
    n = values.shape[0]
    mat = torch.zeros((n, mb), dtype=torch.uint8, device=values.device)
    for pos, code in enumerate(_pattern_codes(tokens).tolist()):
        if code >= 0:
            mat[:, pos] = code
        else:
            field, place = divmod(-code - 1, 8)
            mat[:, pos] = ((fields[field] // (10 ** place)) % 10
                           + ord("0")).to(torch.uint8)
    return mat, torch.full((n,), width, dtype=torch.int32,
                           device=values.device)


def _pattern_to_string(values: torch.Tensor, days_input: bool, fmt: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K24 (pattern mode): DateFormat's text of int32 days or int64
    local microseconds, [n, max(8, next_pow2(width))] bytes and lengths."""
    if values.device.type == "cpu":
        return _pattern_to_string_plain(values, days_input, fmt)
    # expr/cast.py imports this module: its launcher is imported here
    from spark_rapids_tpu_torch.expr.cast import _format

    width = _pattern_width(_tokenize_format(fmt))
    return _format(kernels.FORMAT_PATTERN, values,
                   max(8, 1 << (width - 1).bit_length()),
                   codes=_device_codes(fmt, str(values.device)),
                   days_input=days_input)


class DateFormat(TzAware, Expression):
    """date_format(ts, fmt) for the fixed-width token subset
    yyyy/MM/dd/HH/mm/ss/SSS (plus literal separators). The reference runs
    other patterns on its CPU engine; the planner refuses them here
    (`device_supported`)."""

    def __init__(self, ts: Expression, fmt: str):
        super().__init__([ts])
        self.fmt = str(fmt)
        self.tokens = _tokenize_format(self.fmt)

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("date_format", self.fmt, self.tz, self.children[0].key())

    def device_supported(self):
        if self.tokens is None:
            return (f"date_format pattern {self.fmt!r} outside the "
                    "device token subset (yyyy MM dd HH mm ss SSS)")
        return None

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if isinstance(c.dtype, TimestampType):
            mat, lengths = _pattern_to_string(_local_us(c, self.tz), False,
                                              self.fmt)
        else:
            mat, lengths = _pattern_to_string(c.data, True, self.fmt)
        return DeviceColumn(string_t, mat, c.validity, lengths)


class FromUnixtime(DateFormat):
    """from_unixtime(secs[, fmt]) -> text in the session zone (default
    'yyyy-MM-dd HH:mm:ss')."""

    def __init__(self, secs: Expression,
                 fmt: str = "yyyy-MM-dd HH:mm:ss"):
        super().__init__(SecondsToTimestamp(secs), fmt)

    def key(self):
        return ("from_unixtime", self.fmt, self.tz, self.children[0].key())


class CurrentDate(TzAware, Expression):
    """Marker; physical planning pins it to ONE literal date a query
    (api/dataframe.py `_pin_query_time`, as Spark's QueryExecution)."""

    @property
    def dtype(self):
        return date_t

    @property
    def nullable(self):
        return False


class CurrentTimestamp(Expression):
    """Marker; pinned to one literal timestamp a query at physical
    planning time."""

    @property
    def dtype(self):
        return timestamp_t

    @property
    def nullable(self):
        return False


#: the datetime expression classes the port evaluates on the device
DATETIME_EXPRESSIONS = (
    Year, Month, DayOfMonth, Hour, Minute, Second, DayOfWeek, WeekDay,
    DayOfYear, WeekOfYear, Quarter, LastDay, DateAdd, DateSub, DateDiff,
    AddMonths, MonthsBetween, NextDay, TruncDate, DateTrunc, UnixTimestamp,
    SecondsToTimestamp, MakeDate, FromUtcTimestamp, ToUtcTimestamp,
    DateFormat, FromUnixtime)
