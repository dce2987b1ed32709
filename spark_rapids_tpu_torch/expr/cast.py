"""Cast — the Spark-compatible conversion matrix, counterpart of
`spark_rapids_tpu/expr/cast.py` (GpuCast's role), non-ANSI: a cast never
raises, and an invalid input gives null.

- numeric <-> numeric: integral narrowing wraps (Java semantics); float
  -> integral truncates toward zero and saturates, NaN -> 0 (Java's
  (long)(double)); integral -> float widens. Elementwise torch, as it is
  elementwise jnp in the reference.
- boolean <-> numeric.
- date -> timestamp: local midnight in the session zone, rebased to UTC;
  timestamp -> date: the floor of the local day (ops/tzdb.py, K23).
- string -> boolean/integral/float/double/date/timestamp: ops/stringcast.py
  (kernel K22); a parsed timestamp is a wall clock in the session zone,
  rebased to UTC (K23).
- integral/boolean/date/timestamp/decimal -> string: integral, date,
  timestamp and decimal text is written by kernel K24
  (csrc/str_format.cu) through `_int_to_string`, `_date_to_string`,
  `_timestamp_to_string` and `_decimal_to_string`, whose plain versions
  are the reference's digit-by-digit bodies; a timestamp is rebased into
  the session zone first (K23). Widths are the reference's: 32, 16, 32
  and 48 bytes (a decimal of scale 0 and <= 18 digits prints as its
  integral, width 32).
- decimal casts (the reference's `_cast_decimal`, `_cast_decimal_wide`):
  integral <-> decimal, decimal <-> decimal with HALF_UP when the scale
  drops, float -> decimal(<= 18) with HALF_UP, decimal -> float and
  integral (the fraction truncated); a target over its precision is null.
  Between narrow types (<= 18 digits) each is elementwise int64 torch, as
  in the reference; a wide side goes through kernel K31
  (ops/decimal128.py: `rescale_data`, `to_double`, `to_long`). string ->
  decimal(<= 18) is K22's decimal mode. Float or string -> decimal(> 18)
  and decimal(> 18, scale > 18) -> string run on the reference's CPU
  engine (`device_supported`); the planner refuses them here (ROADMAP A9).
  A decimal's division by a power of ten divides by a tensor, so it is
  IEEE-exact on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.expr.datetimes import civil_from_days
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops import decimal128 as d128
from spark_rapids_tpu_torch.ops import tzdb
from spark_rapids_tpu_torch.sqltypes import (
    BooleanType,
    DataType,
    DateType,
    DecimalType,
    DoubleType,
    FloatType,
    IntegralType,
    StringType,
    TimestampType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide
from spark_rapids_tpu_torch.sqltypes.datatypes import string as string_t
from spark_rapids_tpu_torch.sqltypes.datatypes import torch_dtype

_US_PER_DAY = 86_400_000_000
_CPU_ONLY = ("cast {} -> {} runs on the reference's CPU engine; the port "
             "has no CPU engine yet (ROADMAP A9)")


class Cast(Expression):
    """tz: the session time zone, stamped at resolution time; it governs
    timestamp <-> date and string conversions and is part of the key."""

    tz: str = "UTC"

    def __init__(self, child: Expression, to: DataType):
        super().__init__([child])
        self.to = to

    @property
    def dtype(self):
        return self.to

    def key(self):
        return ("cast", repr(self.to), self.tz, self.children[0].key())

    def device_supported(self) -> bool:
        """The reference's check: wide decimals from float or string, and
        wide decimals of scale > 18 to string, have no device lowering."""
        frm = self.children[0].dtype
        if is_wide(self.to) and isinstance(
                frm, (FloatType, DoubleType, StringType)):
            return False
        if (isinstance(self.to, StringType) and is_wide(frm)
                and frm.scale > 18):
            return False
        return True

    def can_fail(self) -> bool:
        """True when this cast can produce an error in ANSI mode (an
        invalid parse, an overflow)."""
        frm = self.children[0].dtype
        to = self.to
        if isinstance(frm, StringType) and not isinstance(to, StringType):
            return True
        if isinstance(frm, (FloatType, DoubleType)) and isinstance(
                to, IntegralType):
            return True
        if isinstance(frm, IntegralType) and isinstance(to, IntegralType):
            return _int_width(to) < _int_width(frm)
        return isinstance(to, DecimalType)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        frm, to = c.dtype, self.to
        if frm == to:
            return c
        if not self.device_supported():
            raise NotImplementedError(_CPU_ONLY.format(frm, to))
        if isinstance(frm, StringType):
            return _cast_from_string(c, to, self.tz)
        if isinstance(to, StringType):
            return _cast_to_string(c, self.tz)
        if isinstance(frm, BooleanType):
            # 0 or 1 unscaled into a decimal, as the reference casts it
            data = c.data.to(torch_dtype(to))
            if is_wide(to):
                data = d128.join(*d128.from_i64(data))
            return DeviceColumn(to, data, c.validity)
        if isinstance(to, BooleanType):
            nz = (c.data != 0).any(dim=1) if c.data.dim() == 2 else c.data != 0
            return DeviceColumn(to, nz, c.validity)
        if isinstance(frm, DateType) and isinstance(to, TimestampType):
            # local midnight in the session zone -> UTC instant
            local = c.data.to(torch.int64) * _US_PER_DAY
            if not tzdb.is_utc(self.tz):
                local = tzdb.local_to_utc(local, self.tz)
            return DeviceColumn(to, local, c.validity)
        if isinstance(frm, TimestampType) and isinstance(to, DateType):
            us = c.data
            if not tzdb.is_utc(self.tz):
                us = tzdb.utc_to_local(us, self.tz)
            d = torch.div(us, _US_PER_DAY, rounding_mode="floor")
            return DeviceColumn(to, d.to(torch.int32), c.validity)
        if isinstance(frm, DecimalType) or isinstance(to, DecimalType):
            return _cast_decimal(c, frm, to)
        if isinstance(frm, (FloatType, DoubleType)) and isinstance(
                to, IntegralType):
            # Java (int)/(long) of a float: truncate toward zero, saturate,
            # NaN -> 0
            f = c.data.to(torch.float64)
            info = torch.iinfo(torch_dtype(to))
            t = torch.clamp(torch.trunc(f), float(info.min), float(info.max))
            t = torch.where(torch.isnan(f), 0.0, t)
            return DeviceColumn(to, _float_to_int(t, torch_dtype(to)),
                                c.validity)
        # numeric widening and narrowing (wraps like Java), int -> float
        return DeviceColumn(to, c.data.to(torch_dtype(to)), c.validity)


def _float_to_int(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A saturated, truncated float64 as the integral type: exact below
    2^63; at the int64 edge, float64(INT64_MAX) rounds to 2^63, which
    jnp's astype saturates to INT64_MAX."""
    if dtype != torch.int64:
        return t.to(dtype)
    hi = t >= 9.2233720368547758e18
    return torch.where(hi, torch.iinfo(torch.int64).max,
                       torch.where(hi, 0.0, t).to(torch.int64))


def _pow10(k: int, device) -> torch.Tensor:
    """10.0 ** k as a float64 tensor: a division by it is IEEE-exact on
    the card, where one by a Python float becomes a multiply by its
    reciprocal."""
    return torch.tensor(10.0 ** k, dtype=torch.float64, device=device)


def _cast_decimal(c: DeviceColumn, frm: DataType, to: DataType
                  ) -> DeviceColumn:
    """The reference's `_cast_decimal`: narrow types elementwise in int64
    torch, a wide side through K31."""
    fs = frm.scale if isinstance(frm, DecimalType) else 0
    if c.data.dim() == 2 or is_wide(to):
        return _cast_decimal_wide(c, frm, to, fs)
    if isinstance(to, DecimalType):
        ts = to.scale
        limit = 10 ** min(18, to.precision)
        if isinstance(frm, (FloatType, DoubleType)):
            # HALF_UP (Spark's BigDecimal), not round-half-even
            x = c.data.to(torch.float64) * (10.0 ** ts)
            scaled = torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
            valid = c.validity & (torch.abs(scaled) < float(limit))
            data = torch.where(valid, scaled, 0.0).to(torch.int64)
            return DeviceColumn(to, data, valid)
        src = c.data.to(torch.int64)
        if ts >= fs:
            data = src * (10 ** (ts - fs))
        else:
            f = 10 ** (fs - ts)
            q = torch.abs(src) // f
            rem = torch.abs(src) - q * f
            q = q + (2 * rem >= f).to(torch.int64)  # HALF_UP
            data = torch.sign(src) * q
        return DeviceColumn(to, data, c.validity & (torch.abs(data) < limit))
    # decimal -> numeric
    if isinstance(to, (FloatType, DoubleType)):
        data = c.data.to(torch.float64) / _pow10(fs, c.data.device)
        return DeviceColumn(to, data.to(torch_dtype(to)), c.validity)
    src = c.data.to(torch.int64)
    q = torch.sign(src) * (torch.abs(src) // (10 ** fs))
    return DeviceColumn(to, q.to(torch_dtype(to)), c.validity)


def _cast_decimal_wide(c: DeviceColumn, frm: DataType, to: DataType,
                       fs: int) -> DeviceColumn:
    """The reference's `_cast_decimal_wide` over K31: a rescale with the
    precision (and for a narrow target the int64) test, or a wide decimal
    to double or to an integral."""
    if isinstance(to, DecimalType):
        if isinstance(frm, (FloatType, DoubleType)):
            raise NotImplementedError(_CPU_ONLY.format(frm, to))
        data, valid = d128.rescale_data(c.data, to.scale - fs, c.validity,
                                        to.precision, is_wide(to))
        return DeviceColumn(to, data, valid)
    if isinstance(to, (FloatType, DoubleType)):
        data = d128.to_double(c.data, fs)
        return DeviceColumn(to, data.to(torch_dtype(to)), c.validity)
    # integral: the fraction truncated (Spark's cast), wrapped like Java
    return DeviceColumn(to, d128.to_long(c.data, fs).to(torch_dtype(to)),
                        c.validity)


def _int_width(dt: DataType) -> int:
    return np.dtype(dt.np_dtype).itemsize


def _cast_from_string(c: DeviceColumn, to: DataType,
                      tz: str = "UTC") -> DeviceColumn:
    """String parsing (ops/stringcast.py, kernel K22); invalid input
    gives null."""
    from spark_rapids_tpu_torch.ops import stringcast as SC

    if isinstance(to, BooleanType):
        return SC.parse_bool(c, to)
    if isinstance(to, IntegralType):
        return SC.parse_long(c, to)
    if isinstance(to, (FloatType, DoubleType)):
        return SC.parse_double(c, to)
    if isinstance(to, DecimalType):
        return SC.parse_decimal(c, to)
    if isinstance(to, DateType):
        return SC.parse_date(c, to)
    if isinstance(to, TimestampType):
        out = SC.parse_timestamp(c, to)
        if not tzdb.is_utc(tz):
            # the parsed wall clock is in the session zone
            out = DeviceColumn(out.dtype, tzdb.local_to_utc(out.data, tz),
                               out.validity)
        return out
    raise TypeError(f"cast string -> {to} not supported on device")


def _cast_to_string(c: DeviceColumn, tz: str = "UTC") -> DeviceColumn:
    """Integral, boolean, date and timestamp -> UTF-8 byte matrix."""
    if isinstance(c.dtype, TimestampType):
        return _timestamp_to_string(c, tz)
    if isinstance(c.dtype, BooleanType):
        tmat = torch.zeros((2, 8), dtype=torch.uint8, device=c.data.device)
        tmat[0, :5] = torch.tensor(list(b"false"), dtype=torch.uint8)
        tmat[1, :4] = torch.tensor(list(b"true"), dtype=torch.uint8)
        data = tmat[c.data.to(torch.int64)]
        lengths = torch.where(c.data, 4, 5).to(torch.int32)
        return DeviceColumn(string_t, data, c.validity, lengths)
    if isinstance(c.dtype, DateType):
        return _date_to_string(c)
    if isinstance(c.dtype, IntegralType):
        return _int_to_string(c.data.to(torch.int64), c.validity)
    if isinstance(c.dtype, DecimalType):
        return _decimal_to_string(c)
    raise TypeError(f"cast {c.dtype} -> string not supported on device")


# ------------------------------------------------------ K24 str_format

def _format(mode: int, values: torch.Tensor, mb: int,
            codes: Optional[torch.Tensor] = None, days_input: bool = False,
            scale: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K24 launch: ([n, mb] uint8 text, int32 lengths). The hex mode
    (Hex, expr/mathexpr.py) and the decimal modes count their launches
    apart; the decimal modes take their scale as `scale` ([n, 2] limbs in
    the wide one)."""
    if mode == kernels.FORMAT_HEX and (days_input or mb < 16):
        raise ValueError(f"hex text takes int64 values and width >= 16, "
                         f"not width {mb}")
    dev = values.device
    values = values.contiguous()
    want = torch.int32 if days_input else torch.int64
    kernels.require(values, "values", want, dev,
                    ndim=2 if mode == kernels.FORMAT_DECIMAL128 else 1)
    if mode in (kernels.FORMAT_DECIMAL, kernels.FORMAT_DECIMAL128):
        ncodes = scale
    else:
        ncodes = 0 if codes is None else int(codes.shape[0])
    n = int(values.shape[0])
    out = torch.empty((n, mb), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _build.check(_build.lib().srtpu_str_format(
            mode, values.data_ptr(), int(days_input), n,
            None if codes is None else codes.data_ptr(), ncodes,
            out.data_ptr(), mb,
            lengths.data_ptr(), kernels.sm_count(values),
            kernels.stream_ptr(values)), "str_format")
        kernels.launches[_FORMAT_COUNTER.get(mode, "str_format")] += 1
    return out, lengths


#: K24's modes whose launches count apart
_FORMAT_COUNTER = {kernels.FORMAT_HEX: "str_format_hex",
                   kernels.FORMAT_DECIMAL: "str_format_decimal",
                   kernels.FORMAT_DECIMAL128: "str_format_decimal"}


_MAX_DIGITS = 20


def _digit(x: torch.Tensor, p: int) -> torch.Tensor:
    return ((x // (10 ** p)) % 10 + ord("0")).to(torch.uint8)


def _int_to_string_plain(v: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain PyTorch version of K24's integral mode: the reference's
    digit loop over |v| - 1 with a carry (INT64_MIN included)."""
    n = v.shape[0]
    neg = v < 0
    mag = torch.where(neg, -(v + 1), v)  # |v| - 1 for negatives
    carry = neg.to(torch.int64)
    digits = []
    rest = mag
    for _ in range(_MAX_DIGITS):
        d = rest % 10 + carry
        carry = (d >= 10).to(torch.int64)
        digits.append(d % 10)
        rest = rest // 10
    digs = torch.stack(digits, dim=1)  # [n, MAX], least significant first
    nd = torch.ones(n, dtype=torch.int32, device=v.device)
    for i in range(1, _MAX_DIGITS):
        nd = torch.where(digs[:, i] > 0, i + 1, nd)
    total_len = (nd + neg.to(torch.int32)).to(torch.int32)
    mb = 32
    pos = torch.arange(mb, dtype=torch.int32, device=v.device)[None, :]
    digit_idx = torch.clamp(total_len[:, None] - 1 - pos, 0,
                            _MAX_DIGITS - 1)
    dchar = torch.gather(digs, 1, digit_idx.to(torch.int64)) + ord("0")
    out = torch.where(neg[:, None] & (pos == 0), ord("-"), dchar)
    out = torch.where(pos < total_len[:, None], out, 0).to(torch.uint8)
    return out, total_len


def _int_to_string(v: torch.Tensor, validity: torch.Tensor) -> DeviceColumn:
    """Kernel K24 (integral mode): int64 -> decimal text, width 32."""
    if v.device.type == "cpu":
        data, lengths = _int_to_string_plain(v)
    else:
        data, lengths = _format(kernels.FORMAT_INT, v, 32)
    return DeviceColumn(string_t, data, validity, lengths)


def _date_to_string_plain(days: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain PyTorch version of K24's date mode: 'YYYY-MM-DD', each field
    digit by digit with flooring // and % (a year outside 0-9,999 prints
    as those give it)."""
    y, m, d = civil_from_days(days.to(torch.int64))
    n = days.shape[0]
    out = torch.zeros((n, 16), dtype=torch.uint8, device=days.device)
    cols = [_digit(y, 3), _digit(y, 2), _digit(y, 1), _digit(y, 0), ord("-"),
            _digit(m, 1), _digit(m, 0), ord("-"), _digit(d, 1), _digit(d, 0)]
    for i, col in enumerate(cols):
        out[:, i] = col
    return out, torch.full((n,), 10, dtype=torch.int32, device=days.device)


def _date_to_string(c: DeviceColumn) -> DeviceColumn:
    """Kernel K24 (date mode): int32 days -> 'YYYY-MM-DD', width 16."""
    if c.data.device.type == "cpu":
        data, lengths = _date_to_string_plain(c.data)
    else:
        data, lengths = _format(kernels.FORMAT_DATE, c.data.to(torch.int32),
                                16, days_input=True)
    return DeviceColumn(string_t, data, c.validity, lengths)


def _timestamp_to_string_plain(us: torch.Tensor) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Plain PyTorch version of K24's timestamp mode over local
    microseconds: 'YYYY-MM-DD HH:MM:SS[.ffffff]', trailing fraction zeros
    trimmed (Spark's cast-to-string format)."""
    days = torch.div(us, _US_PER_DAY, rounding_mode="floor")
    in_day = us - days * _US_PER_DAY
    y, m, d = civil_from_days(days)
    hh = in_day // 3_600_000_000
    mi = (in_day // 60_000_000) % 60
    ss = (in_day // 1_000_000) % 60
    frac = in_day % 1_000_000
    n = us.shape[0]
    out = torch.zeros((n, 32), dtype=torch.uint8, device=us.device)
    fixed = [_digit(y, 3), _digit(y, 2), _digit(y, 1), _digit(y, 0),
             ord("-"), _digit(m, 1), _digit(m, 0), ord("-"), _digit(d, 1),
             _digit(d, 0), ord(" "), _digit(hh, 1), _digit(hh, 0), ord(":"),
             _digit(mi, 1), _digit(mi, 0), ord(":"), _digit(ss, 1),
             _digit(ss, 0)]
    for i, col in enumerate(fixed):
        out[:, i] = col
    # the fraction: 6 digits with trailing zeros trimmed, none when 0
    trailing = torch.zeros(n, dtype=torch.int32, device=us.device)
    for z in range(1, 7):
        trailing = torch.where(frac % (10 ** z) == 0, z, trailing)
    has_frac = frac > 0
    ndig = torch.where(has_frac, 6 - trailing, 0)
    out[:, 19] = torch.where(has_frac, ord("."), 0).to(torch.uint8)
    for j in range(6):
        out[:, 20 + j] = torch.where(j < ndig, _digit(frac, 5 - j), 0).to(
            torch.uint8)
    lengths = (19 + torch.where(has_frac, ndig + 1, 0)).to(torch.int32)
    return out, lengths


def _timestamp_to_string(c: DeviceColumn, tz: str = "UTC") -> DeviceColumn:
    """Kernel K24 (timestamp mode), after K23 rebases the instants into the
    session zone: width 32."""
    us = c.data
    if not tzdb.is_utc(tz):
        us = tzdb.utc_to_local(us, tz)
    if us.device.type == "cpu":
        data, lengths = _timestamp_to_string_plain(us)
    else:
        data, lengths = _format(kernels.FORMAT_TIMESTAMP, us, 32)
    return DeviceColumn(string_t, data, c.validity, lengths)


def _decimal_to_string_plain(v: torch.Tensor, s: int) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K24's decimal mode (scale s > 0): the
    reference's whole part as integral text, a '-' before a whole part of
    0 under a negative value, '.', then s fraction digits; width 48."""
    f = 10 ** s
    mag = torch.abs(v)
    whole = torch.sign(v) * (mag // f)
    frac = mag % f
    wdata, wlen = _int_to_string_plain(whole)
    neg_zero = (whole == 0) & (v < 0)
    mb = 48
    wlen = wlen + neg_zero.to(torch.int32)
    pos = torch.arange(mb, dtype=torch.int32, device=v.device)[None, :]
    wsrc = torch.clamp(pos - neg_zero[:, None].to(torch.int32), 0,
                       int(wdata.shape[1]) - 1)
    padded = torch.nn.functional.pad(wdata, (0, mb - int(wdata.shape[1])))
    body = torch.gather(padded, 1, wsrc.to(torch.int64)).to(torch.int64)
    body = torch.where(neg_zero[:, None] & (pos == 0), ord("-"), body)
    out = torch.where(pos < wlen[:, None], body, 0)
    out = torch.where(pos == wlen[:, None], ord("."), out)
    fpos = pos - wlen[:, None] - 1
    fdig = (frac[:, None] // torch.pow(10, torch.clamp(
        s - 1 - fpos, 0, 18).to(torch.int64))) % 10 + ord("0")
    in_frac = (fpos >= 0) & (fpos < s)
    out = torch.where(in_frac, fdig, out).to(torch.uint8)
    return out, (wlen + 1 + s).to(torch.int32)


def _decimal_to_string(c: DeviceColumn) -> DeviceColumn:
    """Kernel K24 (decimal modes): a decimal's text, width 48 (a scale-0
    decimal of <= 18 digits prints as its integral, width 32)."""
    s = c.dtype.scale
    if c.data.dim() == 2:
        if c.data.device.type == "cpu":
            data, lengths = d128.decimal_string(*d128.split(c.data), s)
        else:
            data, lengths = _format(kernels.FORMAT_DECIMAL128, c.data, 48,
                                    scale=s)
        return DeviceColumn(string_t, data, c.validity, lengths)
    if s == 0:
        return _int_to_string(c.data.to(torch.int64), c.validity)
    v = c.data.to(torch.int64)
    if v.device.type == "cpu":
        data, lengths = _decimal_to_string_plain(v, s)
    else:
        data, lengths = _format(kernels.FORMAT_DECIMAL, v, 48, scale=s)
    return DeviceColumn(string_t, data, c.validity, lengths)
