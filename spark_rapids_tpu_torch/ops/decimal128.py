"""128-bit decimal arithmetic — counterpart of
`spark_rapids_tpu/ops/decimal128.py` (the DecimalUtils /
Aggregation128Utils role).

A wide decimal column (precision > 18) holds its unscaled value as a
[cap, 2] int64 matrix: column 0 the high limb (signed), column 1 the low
64 bits of the two's-complement value as an int64 bit pattern. A narrow
one (precision <= 18) holds a scaled int64.

The plain versions (`add128` to `decimal_string`) mirror the reference
function by function in int64 torch: uint64 is carried in int64, whose
adds and multiplies wrap mod 2^64 as uint64's do, right shifts are masked
to act as logical ones, and unsigned compares flip the sign bits.

Two kernels carry them on the card, each wrapper beside its plain version:

- K31 (kernels/csrc/decimal128.cu): `add`, `multiply`, `rescale`,
  `average`, `negate`, `absolute`, `compare`, `to_double` and `to_long`,
  one mode each, one thread a row in unsigned __int128;
- K32 (kernels/csrc/seg_sum128.cu): `seg_sum128`, the segmented 128-bit
  sum with the count of the rows each sum took.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops import segmented

_M32 = 0xFFFFFFFF
_SIGN64 = -0x8000000000000000  # int64 min: flips to unsigned order
_POW10 = [10 ** i for i in range(39)]
_TWO64 = 18446744073709551616.0

Limbs = Tuple[torch.Tensor, torch.Tensor]


# ------------------------------------------------------- plain versions

def split(data: torch.Tensor) -> Limbs:
    """[n, 2] limb matrix -> (hi, lo) int64 vectors."""
    return data[:, 0], data[:, 1]


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=1)


def from_i64(x: torch.Tensor) -> Limbs:
    """Sign-extend an int64 unscaled value to 128 bits."""
    x = x.to(torch.int64)
    return x >> 63, x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by k in [1, 63]."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """a < b as uint64."""
    return (a ^ _SIGN64) < (b ^ _SIGN64)


def _i64(v: int) -> int:
    """A Python int's low 64 bits as an int64 value."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def add128(h1, l1, h2, l2) -> Limbs:
    """(h1, l1) + (h2, l2) mod 2^128."""
    lo = l1 + l2
    carry = _ult(lo, l1).to(torch.int64)
    return h1 + h2 + carry, lo


def neg128(hi, lo) -> Limbs:
    nh, nl = ~hi, ~lo
    lo2 = nl + 1
    carry = (nl == -1).to(torch.int64)  # +1 wrapped: all-ones low limb
    return nh + carry, lo2


def abs128(hi, lo):
    neg = hi < 0
    nh, nl = neg128(hi, lo)
    return torch.where(neg, nh, hi), torch.where(neg, nl, lo), neg


def mul_i64_i64(a: torch.Tensor, b: torch.Tensor) -> Limbs:
    """Full signed 64 x 64 -> 128-bit product (hi, lo int64)."""
    a0, a1 = a & _M32, _shr(a, 32)
    b0, b1 = b & _M32, _shr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _shr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | ((mid & _M32) << 32)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    # unsigned -> signed product adjustment
    zero = torch.zeros_like(a)
    hi = hi - torch.where(a < 0, b, zero) - torch.where(b < 0, a, zero)
    return hi, lo


def mul128_small(hi, lo, k: int) -> Limbs:
    """(hi, lo) * k mod 2^128 for a positive Python int k < 2^63."""
    ph, pl = mul_i64_i64(lo, torch.full_like(lo, k))
    # mul_i64_i64 took lo as signed; unsigned lo adds k * 2^64
    ph = ph + torch.where(lo < 0, k, 0)
    return ph + hi * k, pl


def cmp_unsigned(h1, l1, h2, l2) -> torch.Tensor:
    """-1 / 0 / 1 comparison of two unsigned 128-bit values."""
    gt = _ult(h2, h1) | ((h1 == h2) & _ult(l2, l1))
    lt = _ult(h1, h2) | ((h1 == h2) & _ult(l1, l2))
    return torch.where(gt, 1, torch.where(lt, -1, 0))


def shl1(hi, lo, bit) -> Limbs:
    """(hi, lo) << 1 | bit."""
    return (hi << 1) | _shr(lo, 63), (lo << 1) | bit


def divmod_u128_u64(hi, lo, d):
    """Unsigned (hi, lo) // d and its remainder for a divisor d in (0,
    2^63), a Python int or a per-row int64 vector: the reference's
    128-step restoring division."""
    d = torch.as_tensor(d, dtype=torch.int64, device=hi.device)
    d = d.expand(hi.shape)
    qh = torch.zeros_like(hi)
    ql = torch.zeros_like(hi)
    rem = torch.zeros_like(hi)
    for i in range(128):
        # numerator bit 127 - i, from hi for i < 64, else from lo
        src, pos = (hi, 63 - i) if i < 64 else (lo, 127 - i)
        bit = _shr(src, pos) & 1 if pos else src & 1
        rem = (rem << 1) | bit
        ge = ~_ult(rem, d)
        rem = torch.where(ge, rem - d, rem)
        qh, ql = shl1(qh, ql, ge.to(torch.int64))
    return qh, ql, rem


def div128_round_half_up(hi, lo, d) -> Limbs:
    """Signed (hi, lo) / d with HALF_UP rounding (Spark's BigDecimal); d
    a positive int64 vector or Python int."""
    ah, al, neg = abs128(hi, lo)
    qh, ql, rem = divmod_u128_u64(ah, al, d)
    d = torch.as_tensor(d, dtype=torch.int64, device=hi.device)
    up = (2 * rem >= d).to(torch.int64)
    qh2, ql2 = add128(qh, ql, torch.zeros_like(qh), up)
    nh, nl = neg128(qh2, ql2)
    return torch.where(neg, nh, qh2), torch.where(neg, nl, ql2)


def rescale(hi, lo, delta: int) -> Limbs:
    """Multiply (delta > 0) or divide HALF_UP (delta < 0) by 10^|delta|."""
    if delta == 0:
        return hi, lo
    if delta > 0:
        while delta > 0:
            step = min(delta, 18)
            hi, lo = mul128_small(hi, lo, _POW10[step])
            delta -= step
        return hi, lo
    delta = -delta
    # divide by up to 10^18 a step (fits below 2^63); HALF_UP only on the
    # last step (BigDecimal.setScale)
    ah, al, neg = abs128(hi, lo)
    while delta > 18:
        ah, al, _ = divmod_u128_u64(ah, al, _POW10[18])
        delta -= 18
    d = _POW10[delta]
    qh, ql, rem = divmod_u128_u64(ah, al, d)
    up = (2 * rem >= d).to(torch.int64)
    qh, ql = add128(qh, ql, torch.zeros_like(qh), up)
    nh, nl = neg128(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql)


def fits_precision(hi, lo, precision: int) -> torch.Tensor:
    """|value| < 10^precision (precision <= 38)."""
    ah, al, _ = abs128(hi, lo)
    limit = _POW10[precision]
    lh = torch.full_like(hi, limit >> 64)
    ll = torch.full_like(lo, _i64(limit))
    return cmp_unsigned(ah, al, lh, ll) < 0


def fits_i64(hi, lo) -> torch.Tensor:
    """True where the 128-bit value fits a signed int64."""
    return hi == (lo >> 63)


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """uint64 bits -> float64, correctly rounded (numpy's astype): the
    high half times 2^32 is exact, so the one add rounds once."""
    return (_shr(x, 32).to(torch.float64) * 4294967296.0
            + (x & _M32).to(torch.float64))


def to_f64(hi, lo) -> torch.Tensor:
    """The float64 value hi * 2^64 + (double)(uint64)lo, as the reference
    computes it (two roundings)."""
    return hi.to(torch.float64) * _TWO64 + _u64_to_f64(lo)


def seg_sum128_plain(hi, lo, valid, gid, cap: int) -> Limbs:
    """Plain PyTorch version of K32's sums: the reference's four 32-bit
    limb sums (K4's plain version) and their carry normalisation."""
    limbs = [lo & _M32, _shr(lo, 32), hi & _M32, _shr(hi, 32)]
    sums = segmented.seg_sum_count_plain(limbs, valid, gid, cap,
                                         with_count=False).sums
    c = torch.zeros_like(sums[0])
    out = []
    for s_ in sums:
        tot = s_ + c
        out.append(tot & _M32)
        c = _shr(tot, 32)
    return out[2] | (out[3] << 32), out[0] | (out[1] << 32)


def orderable_limbs(data: torch.Tensor):
    """[hi, lo'] key pair whose lexicographic signed order is the 128-bit
    signed order (lo's sign bit flipped to unsigned order)."""
    hi, lo = split(data)
    return [hi, lo ^ _SIGN64]


def widen(data: torch.Tensor, delta: int = 0) -> Limbs:
    """A narrow ([n] int64) or wide ([n, 2]) decimal's data -> (hi, lo),
    rescaled by delta digits (the reference's widen_column)."""
    hi, lo = split(data) if data.dim() == 2 else from_i64(data)
    if delta:
        hi, lo = rescale(hi, lo, delta)
    return hi, lo


def decimal_string(hi, lo, scale: int):
    """(hi, lo, scale <= 18) -> ([n, 48] uint8, int32 lengths): the text
    '-123.45' with exactly `scale` fraction digits."""
    ah, al, neg = abs128(hi, lo)
    chunks = []
    ch, cl = ah, al
    for _ in range(5):
        qh, ql, rem = divmod_u128_u64(ch, cl, 10 ** 9)
        chunks.append(rem)
        ch, cl = qh, ql
    n = hi.shape[0]
    dev = hi.device
    ndig = torch.ones(n, dtype=torch.int32, device=dev)
    for ci in range(5):
        for k in range(9):
            nz = chunks[ci] >= 10 ** k
            ndig = torch.where(nz, torch.clamp(ndig, min=ci * 9 + k + 1),
                               ndig)
    ndig = torch.clamp(ndig, min=scale + 1)  # "0.xx" needs a leading 0
    whole_len = ndig - scale
    chars = ndig + (1 if scale else 0)
    sign_len = neg.to(torch.int32)
    lengths = (sign_len + chars).to(torch.int32)
    mb = 48
    pos = torch.arange(mb, dtype=torch.int32, device=dev)[None, :]
    from_left = pos - sign_len[:, None]
    is_dot = (scale > 0) & (from_left == whole_len[:, None])
    after_dot = (scale > 0) & (from_left > whole_len[:, None])
    digit_fr = torch.where(after_dot, ndig[:, None] - from_left,
                           ndig[:, None] - 1 - from_left)
    digit = torch.zeros((n, mb), dtype=torch.int32, device=dev)
    for ci in range(5):
        for k in range(9):
            dv = ((chunks[ci] // (10 ** k)) % 10).to(torch.int32)
            digit = torch.where(digit_fr == ci * 9 + k, dv[:, None], digit)
    in_chars = (from_left >= 0) & (from_left < chars[:, None])
    out = torch.where(in_chars, digit + ord("0"), 0)
    out = torch.where(is_dot & in_chars, ord("."), out)
    out = torch.where((pos == 0) & neg[:, None], ord("-"), out)
    return out.to(torch.uint8), lengths


# ------------------------------------------- plain versions of K31's modes

def _valid_or_ones(valid: Optional[torch.Tensor], n: int, dev):
    return (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
            else valid)


def add_plain(a, a_shift: int, b, b_shift: int, valid, precision: int,
              subtract: bool = False):
    """Plain K31 add/subtract: both sides widened to the output scale."""
    lh, ll = widen(a, a_shift)
    rh, rl = widen(b, b_shift)
    if subtract:
        rh, rl = neg128(rh, rl)
    hi, lo = add128(lh, ll, rh, rl)
    ok = _valid_or_ones(valid, hi.shape[0], hi.device)
    return join(hi, lo), ok & fits_precision(hi, lo, precision)


def multiply_plain(a, b, valid, precision: int):
    hi, lo = mul_i64_i64(a.to(torch.int64), b.to(torch.int64))
    ok = _valid_or_ones(valid, hi.shape[0], hi.device)
    return join(hi, lo), ok & fits_precision(hi, lo, precision)


def _narrow_or_wide(hi, lo, ok, precision: int, out_wide: bool):
    if precision:
        ok = ok & fits_precision(hi, lo, precision)
    if out_wide:
        return join(hi, lo), ok
    return lo, ok & fits_i64(hi, lo)


def rescale_plain(a, delta: int, valid, precision: int, out_wide: bool):
    hi, lo = widen(a, delta)
    ok = _valid_or_ones(valid, hi.shape[0], hi.device)
    return _narrow_or_wide(hi, lo, ok, precision, out_wide)


def average_plain(s, count, up: int, precision: int, out_wide: bool):
    """Plain K31 average: the sum rescaled up, divided by max(count, 1)
    HALF_UP; valid where count > 0 and the result fits."""
    hi, lo = widen(s, up)
    qh, ql = div128_round_half_up(hi, lo, torch.clamp(count, min=1))
    return _narrow_or_wide(qh, ql, count > 0, precision, out_wide)


def negate_plain(a):
    return join(*neg128(*split(a)))


def absolute_plain(a):
    return join(*abs128(*split(a))[:2])


def compare_plain(a, b):
    """-1 / 0 / 1: the signed 128-bit order, over the orderable limbs."""
    ka, kb = orderable_limbs(a), orderable_limbs(b)
    lt = (ka[0] < kb[0]) | ((ka[0] == kb[0]) & (ka[1] < kb[1]))
    eq = (ka[0] == kb[0]) & (ka[1] == kb[1])
    return torch.where(lt, -1, torch.where(eq, 0, 1)).to(torch.int8)


def to_double_plain(a, scale: int):
    """to_f64, then a true division by 10.0 ** scale (a tensor divisor)."""
    p = torch.tensor(10.0 ** scale, dtype=torch.float64, device=a.device)
    return to_f64(*split(a)) / p


#: the largest scale `to_long` takes: the reference's second division by
#: 10^(scale - 18) needs an int64 divisor (ROADMAP C)
MAX_TO_LONG_SCALE = 36


def to_long_plain(a, scale: int):
    """The fraction truncated (two divisions past 10^18), the low limb."""
    _check_to_long_scale(scale)
    hi, lo = split(a)
    if scale:
        ah, al, neg = abs128(hi, lo)
        qh, ql, _ = divmod_u128_u64(ah, al, 10 ** min(scale, 18))
        if scale > 18:
            qh, ql, _ = divmod_u128_u64(qh, ql, 10 ** (scale - 18))
        nh, nl = neg128(qh, ql)
        lo = torch.where(neg, nl, ql)
    return lo


def _check_to_long_scale(scale: int) -> None:
    if scale > MAX_TO_LONG_SCALE:
        raise NotImplementedError(
            f"decimal(>18, {scale}) -> integral: the divisor 10^{scale - 18} "
            "exceeds int64, as in the reference (ROADMAP C)")


# ------------------------------------------------------- K31 decimal128

def _operand(x: Optional[torch.Tensor], name: str, dev) -> Tuple[
        Optional[torch.Tensor], int]:
    if x is None:
        return None, 0
    x = x.to(torch.int64).contiguous()
    kernels.require(x, name, torch.int64, dev, ndim=x.dim())
    if x.dim() == 2 and x.shape[1] != 2:
        raise ValueError(f"{name}: limbs of shape {tuple(x.shape)}")
    return x, int(x.dim() == 2)


def _launch(mode: int, a, a_shift: int = 0, b=None, b_shift: int = 0,
            valid=None, count=None, precision: int = 0,
            out_wide: bool = True, out_dtype=torch.int64,
            with_valid: bool = True):
    """One K31 launch: (out, out_valid or None)."""
    dev = a.device
    a, a_wide = _operand(a, "a", dev)
    b, b_wide = _operand(b, "b", dev)
    n = int(a.shape[0])
    if b is not None and b.shape[0] != n:
        raise ValueError("a and b differ in length")
    if valid is not None:
        valid = valid.contiguous()
        kernels.require(valid, "valid", torch.bool, dev)
    if count is not None:
        count = count.to(torch.int64).contiguous()
        kernels.require(count, "count", torch.int64, dev)
    shape = (n, 2) if out_wide and out_dtype == torch.int64 else (n,)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    out_valid = (torch.empty(n, dtype=torch.bool, device=dev)
                 if with_valid else None)
    if n:
        _build.check(_build.lib().srtpu_decimal128(
            mode, a.data_ptr(), a_wide, int(a_shift),
            None if b is None else b.data_ptr(), b_wide, int(b_shift),
            None if valid is None else valid.data_ptr(),
            None if count is None else count.data_ptr(), n, int(precision),
            int(out_wide), out.data_ptr(),
            None if out_valid is None else out_valid.data_ptr(),
            kernels.sm_count(a), kernels.stream_ptr(a)), "decimal128")
        kernels.launches["decimal128"] += 1
    return out, out_valid


def add(a, a_shift: int, b, b_shift: int, valid, precision: int,
        subtract: bool = False):
    """Kernel K31 (add, subtract): ([n, 2] rescale(a, a_shift) +/-
    rescale(b, b_shift), valid & |sum| < 10^precision). a and b are narrow
    ([n] int64) or wide ([n, 2]) data."""
    if a.device.type == "cpu":
        return add_plain(a, a_shift, b, b_shift, valid, precision, subtract)
    return _launch(kernels.D128_SUB if subtract else kernels.D128_ADD, a,
                   a_shift, b, b_shift, valid, precision=precision)


def multiply(a, b, valid, precision: int):
    """Kernel K31 (multiply): two int64 vectors -> ([n, 2] product,
    valid & |product| < 10^precision)."""
    if a.device.type == "cpu":
        return multiply_plain(a, b, valid, precision)
    return _launch(kernels.D128_MUL, a, 0, b, 0, valid,
                   precision=precision)


def rescale_data(a, delta: int, valid, precision: int = 0,
                 out_wide: bool = True):
    """Kernel K31 (rescale): narrow or wide data times 10^delta, or
    divided HALF_UP; valid & the precision test (none for precision 0),
    and for a narrow result the int64 test. Returns (data, valid)."""
    if a.device.type == "cpu":
        return rescale_plain(a, delta, valid, precision, out_wide)
    return _launch(kernels.D128_RESCALE, a, delta, valid=valid,
                   precision=precision, out_wide=out_wide)


def average(s, count, up: int, precision: int, out_wide: bool):
    """Kernel K31 (average): a wide sum rescaled up by `up`, divided by
    max(count, 1) with HALF_UP; valid where count > 0 and the result fits
    the precision (and for a narrow result an int64)."""
    if s.device.type == "cpu":
        return average_plain(s, count, up, precision, out_wide)
    return _launch(kernels.D128_AVG, s, up, count=count,
                   precision=precision, out_wide=out_wide)


def negate(a):
    """Kernel K31 (negate) of [n, 2] limbs."""
    if a.device.type == "cpu":
        return negate_plain(a)
    return _launch(kernels.D128_NEG, a, with_valid=False)[0]


def absolute(a):
    """Kernel K31 (abs) of [n, 2] limbs."""
    if a.device.type == "cpu":
        return absolute_plain(a)
    return _launch(kernels.D128_ABS, a, with_valid=False)[0]


def compare(a, b):
    """Kernel K31 (compare): int8 -1 / 0 / 1 of two [n, 2] limb
    matrices in signed 128-bit order."""
    if a.device.type == "cpu":
        return compare_plain(a, b)
    return _launch(kernels.D128_CMP, a, 0, b, 0, out_wide=False,
                   out_dtype=torch.int8, with_valid=False)[0]


def to_double(a, scale: int):
    """Kernel K31 (to double): [n, 2] limbs at `scale` -> float64."""
    if a.device.type == "cpu":
        return to_double_plain(a, scale)
    return _launch(kernels.D128_TO_F64, a, scale, out_wide=False,
                   out_dtype=torch.float64, with_valid=False)[0]


def to_long(a, scale: int):
    """Kernel K31 (to integral): [n, 2] limbs at `scale` -> the int64 of
    the value truncated toward zero (wrapped)."""
    if a.device.type == "cpu":
        return to_long_plain(a, scale)
    _check_to_long_scale(scale)
    return _launch(kernels.D128_TO_I64, a, scale, out_wide=False,
                   with_valid=False)[0]


# ------------------------------------------------------- K32 seg_sum128

def seg_sum128(data: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor,
               cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K32: ([cap, 2] sums mod 2^128, [cap] int64 counts) of the
    rows with `valid` and 0 <= gid < cap; data is wide ([n, 2]) or a
    narrow decimal's int64 (sign-extended)."""
    if valid.device.type == "cpu":
        hi, lo = widen(data)
        sh, sl = seg_sum128_plain(hi, lo, valid, gid, cap)
        cnt = segmented.seg_sum_count_plain([], valid, gid, cap).count
        return join(sh, sl), cnt
    dev = valid.device
    data = data.to(torch.int64).contiguous()
    kernels.require(data, "data", torch.int64, dev, ndim=data.dim())
    kernels.require(valid, "valid", torch.bool, dev)
    kernels.require(gid, "gid", torch.int32, dev)
    n = int(valid.shape[0])
    if data.shape[0] != n or gid.shape[0] != n or (
            data.dim() == 2 and data.shape[1] != 2):
        raise ValueError("data, valid and gid differ in length")
    out = torch.empty((cap, 2), dtype=torch.int64, device=dev)
    counts = torch.empty(cap, dtype=torch.int64, device=dev)
    scratch = torch.empty(cap * 5, dtype=torch.int64, device=dev)
    _build.check(_build.lib().srtpu_seg_sum128(
        data.data_ptr(), int(data.dim() == 1), valid.data_ptr(),
        gid.data_ptr(), n, cap, out.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), kernels.sm_count(valid),
        kernels.smem_optin(valid), kernels.stream_ptr(valid)), "seg_sum128")
    kernels.launches["seg_sum128"] += 1
    return out, counts
