"""String parsing: string -> long/int/double/bool/date/timestamp over the
padded byte-matrix layout — counterpart of
`spark_rapids_tpu/ops/stringcast.py`, with its semantics (non-ANSI:
invalid input gives null):

- leading and trailing bytes <= 0x20 are trimmed (Spark's trimAll);
- integral: [+-]?digits, overflow -> null; the magnitude is accumulated
  negative, so INT64_MIN parses, then checked against the target width;
- floating: [+-]?digits[.digits][eE[+-]digits], case-insensitive
  "infinity"/"inf"/"nan"; the value is mag * 10^half * 10^(e - half)
  with half = clip(e, -300, 300), in that order, as the reference
  computes it (not correctly rounded);
- decimal(p <= 18, s): the same mantissa (18 significant digits) shifted
  to the scale in exact int64: up (an overflow is null) or down with
  HALF_UP, null where |value| >= 10^p (a wider target runs on the
  reference's CPU engine: the planner refuses it);
- boolean: true/t/yes/y/1 and false/f/no/n/0, case-insensitive;
- date: y{1,7}[-m[-d]] with anything after ' ' or 'T' ignored; years
  past 9,999 are null and the day of month must round-trip;
- timestamp: date [ |T] h[h]:m[m][:s[s][.f{1,6}]], a wall clock the
  caller rebases from the session zone (expr/cast.py).

Each `parse_*` is a wrapper over kernel K22 (csrc/str_parse.cu: one
thread a row, the reference's per-byte state machine in registers); a
row stride of 0 (a string literal broadcast to the batch) is read as the
view it is. Its plain version, `parse_*_plain`, is the reference's body
in PyTorch over the whole matrix (`_token_bounds`, `_parse_mantissa`,
`_parse_uint_field`, `_find_char`, `_parse_date_fields`), which tensors
on the CPU take. Both write 0 under a null result. The decimal mode's
launches count apart ("str_parse_decimal").
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes.datatypes import torch_dtype

_I64_MIN = -(2 ** 63)


# ------------------------------------------------------ plain versions

def _pos(col: DeviceColumn) -> torch.Tensor:
    return torch.arange(col.data.shape[1], dtype=torch.int32,
                        device=col.data.device)[None, :]


def _token_bounds(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(first, last, nonempty): bounds of the whitespace-trimmed token.
    Trims every byte <= 0x20, matching Spark's trimAll."""
    ch = col.data
    mb = ch.shape[1]
    in_str = _pos(col) < col.lengths[:, None]
    not_ws = in_str & (ch > 0x20)
    any_ = not_ws.any(dim=1)
    not_ws = not_ws.to(torch.uint8)
    first = torch.where(any_, torch.argmax(not_ws, dim=1), 0).to(torch.int32)
    rev = torch.flip(not_ws, dims=[1])
    last = torch.where(any_, mb - 1 - torch.argmax(rev, dim=1), -1).to(
        torch.int32)
    return first, last, any_


def _char_at(ch: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(idx, 0, ch.shape[1] - 1).to(torch.int64)
    return torch.gather(ch, 1, safe[:, None])[:, 0]


def _lower(ch: torch.Tensor) -> torch.Tensor:
    is_upper = (ch >= ord("A")) & (ch <= ord("Z"))
    return torch.where(is_upper, ch + 32, ch)


def _matches_token(ch_low, first, last, word: bytes) -> torch.Tensor:
    """The trimmed token equals `word` (ch_low lowercased)."""
    ok = (last - first + 1) == len(word)
    for i, b in enumerate(word):
        ok = ok & (_char_at(ch_low, first + i) == b)
    return ok


def _sign(col: DeviceColumn, first: torch.Tensor):
    c0 = _char_at(col.data, first)
    has_sign = (c0 == ord("+")) | (c0 == ord("-"))
    return has_sign, c0 == ord("-")


def parse_long_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's integral mode."""
    ch = col.data
    n, mb = ch.shape
    first, last, nonempty = _token_bounds(col)
    has_sign, neg = _sign(col, first)
    dstart = first + has_sign.to(torch.int32)
    pos = _pos(col)
    in_dig = (pos >= dstart[:, None]) & (pos <= last[:, None])
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    all_digits = (~in_dig | is_digit).all(dim=1)
    ndig = last - dstart + 1
    # accumulate the NEGATIVE magnitude so Long.MIN parses without overflow
    val = torch.zeros(n, dtype=torch.int64, device=ch.device)
    ovf = torch.zeros(n, dtype=torch.bool, device=ch.device)
    for i in range(mb):
        d = ch[:, i].to(torch.int64) - ord("0")
        use = in_dig[:, i] & is_digit[:, i]
        # smallest safe val before *10 - d: ceil((MIN + d) / 10), computed
        # as floor((MIN + d + 9) / 10) so -MIN never overflows
        ceil_div = (_I64_MIN + d + 9) // 10
        ovf = ovf | (use & (val < ceil_div))
        val = torch.where(use, val * 10 - d, val)
    ovf = ovf | (~neg & (val == _I64_MIN))  # +9223372036854775808
    value = torch.where(neg, val, -val)
    valid = col.validity & nonempty & all_digits & (ndig >= 1) & ~ovf
    info = torch.iinfo(torch_dtype(to_dtype))
    if info.min != _I64_MIN:
        valid = valid & (value >= info.min) & (value <= info.max)
    value = torch.where(valid, value, 0)
    return DeviceColumn(to_dtype, value.to(torch_dtype(to_dtype)), valid)


def _parse_mantissa(col: DeviceColumn):
    """Shared float and decimal scanner. Returns (mant: int64 negative-accumulated
    magnitude capped at 18 significant digits, extra_int: digits beyond
    the cap before the dot, frac: fraction digits within the cap, exp,
    neg, syntax_ok, nonempty, first, last)."""
    ch = col.data
    n, mb = ch.shape
    dev = ch.device
    first, last, nonempty = _token_bounds(col)
    has_sign, neg = _sign(col, first)
    start = first + has_sign.to(torch.int32)

    def zeros(dtype):
        return torch.zeros(n, dtype=dtype, device=dev)

    mant = zeros(torch.int64)      # negative magnitude
    mant_digits = zeros(torch.int32)
    extra_int = zeros(torch.int32)
    frac_digits = zeros(torch.int32)
    exp_val = zeros(torch.int64)
    exp_neg = zeros(torch.bool)
    seen_digit = zeros(torch.bool)
    seen_dot = zeros(torch.bool)
    in_exp = zeros(torch.bool)
    exp_digit = zeros(torch.bool)
    err = zeros(torch.bool)

    for i in range(mb):
        c = ch[:, i]
        active = (i >= start) & (i <= last)
        is_d = (c >= ord("0")) & (c <= ord("9"))
        is_dot = c == ord(".")
        is_e = (c == ord("e")) | (c == ord("E"))
        is_sg = (c == ord("+")) | (c == ord("-"))
        d = c.to(torch.int64) - ord("0")

        dig_m = active & is_d & ~in_exp
        cap_ok = mant_digits < 18
        grow = dig_m & (cap_ok | (mant == 0))
        mant = torch.where(grow, mant * 10 - d, mant)
        mant_digits = torch.where(grow & ((mant != 0) | (d > 0) | seen_dot),
                                  mant_digits + 1, mant_digits)
        extra_int = torch.where(dig_m & ~grow & ~seen_dot, extra_int + 1,
                                extra_int)
        frac_digits = torch.where(grow & seen_dot, frac_digits + 1,
                                  frac_digits)
        seen_digit = seen_digit | dig_m

        err = err | (active & is_dot & (seen_dot | in_exp))
        seen_dot = seen_dot | (active & is_dot & ~in_exp)

        err = err | (active & is_e & (in_exp | ~seen_digit))
        if i > 0:
            prev_is_e = (ch[:, i - 1] == ord("e")) | (ch[:, i - 1] == ord("E"))
        else:
            prev_is_e = torch.zeros_like(is_e)
        err = err | (active & is_sg & ~(in_exp & prev_is_e) & (first != i))
        exp_neg = torch.where(active & is_sg & in_exp & prev_is_e,
                              c == ord("-"), exp_neg)
        in_exp = in_exp | (active & is_e)

        dig_e = active & is_d & in_exp
        exp_val = torch.where(dig_e, torch.clamp(exp_val * 10 + d,
                                                 max=100000), exp_val)
        exp_digit = exp_digit | dig_e

        known = is_d | is_dot | is_e | is_sg
        err = err | (active & ~known)

    err = err | (in_exp & ~exp_digit)
    syntax_ok = nonempty & ~err & seen_digit
    exp = torch.where(exp_neg, -exp_val, exp_val)
    return (mant, extra_int, frac_digits, exp, neg, syntax_ok, nonempty,
            first, last)


def parse_double_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's floating mode."""
    (mant, extra_int, frac, exp, neg, ok, nonempty, first, last) = \
        _parse_mantissa(col)
    ch_low = _lower(col.data)
    has_sign, _ = _sign(col, first)
    tfirst = first + has_sign.to(torch.int32)
    is_inf = (_matches_token(ch_low, tfirst, last, b"infinity")
              | _matches_token(ch_low, tfirst, last, b"inf"))
    is_nan = _matches_token(ch_low, tfirst, last, b"nan")
    e = exp + extra_int.to(torch.int64) - frac.to(torch.int64)
    mag = (-mant).to(torch.float64)
    e_f = e.to(torch.float64)
    # split the scale so 10**e stays finite for representable results
    half = torch.clamp(e_f, -300.0, 300.0)
    value = mag * torch.pow(10.0, half) * torch.pow(10.0, e_f - half)
    value = torch.where(neg, -value, value)
    inf = torch.where(neg, -torch.inf, torch.inf).to(torch.float64)
    value = torch.where(is_inf & nonempty, inf, value)
    value = torch.where(is_nan & nonempty, torch.nan, value)
    valid = col.validity & (ok | ((is_inf | is_nan) & nonempty))
    value = torch.where(valid, value, 0.0)
    return DeviceColumn(to_dtype, value.to(torch_dtype(to_dtype)), valid)


def parse_decimal_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's decimal mode: the reference's exact
    int64 steps, every product wrapping and every // flooring."""
    (mant, extra_int, frac, exp, neg, ok, _ne, _f, _l) = \
        _parse_mantissa(col)
    s = to_dtype.scale
    mag = -mant  # the positive magnitude, <= 18 digits
    # target = mag * 10^(exp + extra_int - frac + s)
    shift = exp + extra_int.to(torch.int64) - frac.to(torch.int64) + s
    limit = 10 ** min(18, to_dtype.precision)
    up = torch.clamp(shift, 0, 18)
    pow_up = torch.pow(10, up)
    grew = mag * pow_up
    ovf_up = (shift > 18) & (mag > 0)
    ovf_up = ovf_up | ((mag != 0) & (grew // torch.clamp(pow_up, min=1)
                                     != mag))
    pow_dn = torch.pow(10, torch.clamp(-shift, 0, 18))
    q = grew // torch.clamp(pow_dn, min=1)
    rem = grew - q * pow_dn
    q = q + (2 * rem >= pow_dn).to(torch.int64)
    q = torch.where(-shift > 18, 0, q)  # below 1 ulp of the scale
    scaled = torch.where(shift >= 0, grew, q)
    value = torch.where(neg, -scaled, scaled)
    valid = col.validity & ok & ~ovf_up & (torch.abs(scaled) < limit)
    return DeviceColumn(to_dtype, torch.where(valid, value, 0), valid)


_TRUE = (b"true", b"t", b"yes", b"y", b"1")
_FALSE = (b"false", b"f", b"no", b"n", b"0")


def parse_bool_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's boolean mode."""
    ch_low = _lower(col.data)
    first, last, nonempty = _token_bounds(col)
    is_t = torch.zeros(col.data.shape[0], dtype=torch.bool,
                       device=col.data.device)
    is_f = torch.zeros_like(is_t)
    for w in _TRUE:
        is_t = is_t | _matches_token(ch_low, first, last, w)
    for w in _FALSE:
        is_f = is_f | _matches_token(ch_low, first, last, w)
    valid = col.validity & nonempty & (is_t | is_f)
    return DeviceColumn(to_dtype, is_t & valid, valid)


def _parse_uint_field(ch, start, end, max_digits):
    """A digits-only field [start, end] -> (value, ok); empty is not ok."""
    n, mb = ch.shape
    pos = torch.arange(mb, dtype=torch.int32, device=ch.device)[None, :]
    in_f = (pos >= start[:, None]) & (pos <= end[:, None])
    is_d = (ch >= ord("0")) & (ch <= ord("9"))
    ok = (~in_f | is_d).all(dim=1)
    ndig = torch.clamp(end - start + 1, min=0)
    ok = ok & (ndig >= 1) & (ndig <= max_digits)
    val = torch.zeros(n, dtype=torch.int64, device=ch.device)
    for i in range(mb):
        use = in_f[:, i] & is_d[:, i]
        val = torch.where(use, val * 10 + (ch[:, i].to(torch.int64)
                                           - ord("0")), val)
    return val, ok


def _find_char(ch, first, last, byte, occurrence):
    """Position of the k-th `byte` in [first, last], else -1."""
    mb = ch.shape[1]
    pos = torch.arange(mb, dtype=torch.int32, device=ch.device)[None, :]
    hit = (ch == byte) & (pos >= first[:, None]) & (pos <= last[:, None])
    csum = torch.cumsum(hit.to(torch.int32), dim=1)
    want = hit & (csum == occurrence)
    return torch.where(want.any(dim=1),
                       torch.argmax(want.to(torch.uint8), dim=1), -1).to(
        torch.int32)


def _parse_date_fields(col: DeviceColumn):
    """Shared by date and timestamp: (days, ok, first, date_end, last),
    date_end the last byte of the date part."""
    from spark_rapids_tpu_torch.expr.datetimes import (
        civil_from_days,
        days_from_civil,
    )

    ch = col.data
    first, last, nonempty = _token_bounds(col)
    # the date part ends before ' ' or 'T' (the rest is ignored for dates)
    sp = _find_char(ch, first, last, ord(" "), 1)
    tt = _find_char(ch, first, last, ord("T"), 1)
    cut = torch.where((sp >= 0) & ((tt < 0) | (sp < tt)), sp, tt)
    date_end = torch.where(cut >= 0, cut - 1, last)

    d1 = _find_char(ch, first, date_end, ord("-"), 1)
    d2 = _find_char(ch, first, date_end, ord("-"), 2)
    y_end = torch.where(d1 >= 0, d1 - 1, date_end)
    y, ok_y = _parse_uint_field(ch, first, y_end, 7)
    m_end = torch.where(d2 >= 0, d2 - 1, date_end)
    m, ok_m = _parse_uint_field(ch, d1 + 1, m_end, 2)
    dd, ok_d = _parse_uint_field(ch, d2 + 1, date_end, 2)
    m = torch.where(d1 >= 0, m, 1)
    dd = torch.where(d2 >= 0, dd, 1)
    ok = (nonempty & ok_y & torch.where(d1 >= 0, ok_m, True)
          & torch.where(d2 >= 0, ok_d, True))
    ok = ok & (m >= 1) & (m <= 12) & (dd >= 1) & (dd <= 31) & (y <= 9999)
    days = days_from_civil(y, m, dd)
    # exact day-of-month validation by a round trip (leap years etc.)
    ry, rm, rd = civil_from_days(days)
    ok = ok & (ry == y) & (rm == m) & (rd == dd)
    return days, ok, first, date_end, last


def parse_date_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's date mode."""
    days, ok, _f, _de, _l = _parse_date_fields(col)
    valid = col.validity & ok
    return DeviceColumn(to_dtype, torch.where(valid, days, 0).to(
        torch.int32), valid)


def parse_timestamp_plain(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Plain PyTorch version of K22's timestamp mode: the wall clock of
    'date[ |T]h[h]:m[m][:s[s][.f{1,6}]]' (a bare date is midnight)."""
    ch = col.data
    days, ok, first, date_end, last = _parse_date_fields(col)
    has_time = date_end < last
    t_start = date_end + 2  # skip the ' ' or 'T'
    c1 = _find_char(ch, t_start, last, ord(":"), 1)
    c2 = _find_char(ch, t_start, last, ord(":"), 2)
    dot = _find_char(ch, t_start, last, ord("."), 1)
    h, ok_h = _parse_uint_field(ch, t_start,
                                torch.where(c1 >= 0, c1 - 1, last), 2)
    mi, ok_mi = _parse_uint_field(ch, c1 + 1,
                                  torch.where(c2 >= 0, c2 - 1, last), 2)
    s, ok_s = _parse_uint_field(ch, c2 + 1,
                                torch.where(dot >= 0, dot - 1, last), 2)
    f_raw, ok_f = _parse_uint_field(ch, dot + 1, last, 6)
    ndig_f = torch.clamp(last - dot, min=0)
    micros_frac = f_raw * (10 ** torch.clamp(6 - ndig_f, 0, 6).to(
        torch.int64))
    mi = torch.where(c1 >= 0, mi, 0)
    s = torch.where(c2 >= 0, s, 0)
    micros_frac = torch.where(dot >= 0, micros_frac, 0)
    time_ok = (ok_h & torch.where(c1 >= 0, ok_mi, True)
               & torch.where(c2 >= 0, ok_s, True)
               & torch.where(dot >= 0, ok_f & (c2 >= 0), True)
               & (h <= 23) & (mi <= 59) & (s <= 59))
    ok = ok & torch.where(has_time, time_ok, True)
    h = torch.where(has_time, h, 0)
    mi = torch.where(has_time, mi, 0)
    s = torch.where(has_time, s, 0)
    micros_frac = torch.where(has_time, micros_frac, 0)
    micros = (days.to(torch.int64) * 86_400_000_000 + h * 3_600_000_000
              + mi * 60_000_000 + s * 1_000_000 + micros_frac)
    valid = col.validity & ok
    return DeviceColumn(to_dtype, torch.where(valid, micros, 0), valid)


# ------------------------------------------------------- K22 str_parse

#: K22's output dtype by mode
_OUT_DTYPES = {kernels.PARSE_LONG: torch.int64,
               kernels.PARSE_DOUBLE: torch.float64,
               kernels.PARSE_BOOL: torch.bool,
               kernels.PARSE_DATE: torch.int32,
               kernels.PARSE_TIMESTAMP: torch.int64,
               kernels.PARSE_DECIMAL: torch.int64}


def _parse(mode: int, col: DeviceColumn, lo: int = 0, hi: int = 0):
    """One K22 launch: (values, validity). `lo`/`hi` bound the integral
    mode's target width, or give the decimal mode's scale and precision.
    A string literal's matrix is a view with row stride 0: the kernel
    reads its one row for every row."""
    data = col.data
    dev = data.device
    if data.stride(1) != 1:
        data = data.contiguous()
    if data.dtype != torch.uint8 or data.device.type != "cuda":
        raise TypeError(f"str_parse: data {data.dtype} on {data.device}")
    lengths = col.lengths.contiguous()
    validity = col.validity.contiguous()
    kernels.require(lengths, "lengths", torch.int32, dev)
    kernels.require(validity, "validity", torch.bool, dev)
    n, mb = int(data.shape[0]), int(data.shape[1])
    out = torch.empty(n, dtype=_OUT_DTYPES[mode], device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _build.check(_build.lib().srtpu_str_parse(
            mode, data.data_ptr(), int(data.stride(0)), lengths.data_ptr(),
            validity.data_ptr(), n, mb, int(lo), int(hi), out.data_ptr(),
            out_valid.data_ptr(), kernels.sm_count(lengths),
            kernels.stream_ptr(lengths)), "str_parse")
        kernels.launches["str_parse_decimal" if mode == kernels.PARSE_DECIMAL
                         else "str_parse"] += 1
    return out, out_valid


def parse_long(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (integral): string -> byte/short/int/long."""
    if col.data.device.type == "cpu":
        return parse_long_plain(col, to_dtype)
    info = torch.iinfo(torch_dtype(to_dtype))
    out, valid = _parse(kernels.PARSE_LONG, col, info.min, info.max)
    return DeviceColumn(to_dtype, out.to(torch_dtype(to_dtype)), valid)


def parse_double(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (floating): string -> float/double."""
    if col.data.device.type == "cpu":
        return parse_double_plain(col, to_dtype)
    out, valid = _parse(kernels.PARSE_DOUBLE, col)
    return DeviceColumn(to_dtype, out.to(torch_dtype(to_dtype)), valid)


def parse_decimal(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (decimal): string -> decimal(p <= 18, s) as int64."""
    if col.data.device.type == "cpu":
        return parse_decimal_plain(col, to_dtype)
    if to_dtype.precision > 18:
        raise ValueError(f"K22 parses decimals of at most 18 digits, not "
                         f"{to_dtype}")
    out, valid = _parse(kernels.PARSE_DECIMAL, col, to_dtype.scale,
                        to_dtype.precision)
    return DeviceColumn(to_dtype, out, valid)


def parse_bool(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (boolean)."""
    if col.data.device.type == "cpu":
        return parse_bool_plain(col, to_dtype)
    out, valid = _parse(kernels.PARSE_BOOL, col)
    return DeviceColumn(to_dtype, out, valid)


def parse_date(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (date): string -> int32 days."""
    if col.data.device.type == "cpu":
        return parse_date_plain(col, to_dtype)
    out, valid = _parse(kernels.PARSE_DATE, col)
    return DeviceColumn(to_dtype, out, valid)


def parse_timestamp(col: DeviceColumn, to_dtype) -> DeviceColumn:
    """Kernel K22 (timestamp): string -> int64 wall-clock microseconds."""
    if col.data.device.type == "cpu":
        return parse_timestamp_plain(col, to_dtype)
    out, valid = _parse(kernels.PARSE_TIMESTAMP, col)
    return DeviceColumn(to_dtype, out, valid)
