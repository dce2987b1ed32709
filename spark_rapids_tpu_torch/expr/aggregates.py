"""Declarative aggregate functions with update / merge / evaluate phases —
counterpart of `spark_rapids_tpu/expr/aggregates.py`: Sum, Count,
Average, Min, Max, First, Last and AnyValue over every ported type,
decimals included; the moment family (variance, stddev, skewness,
kurtosis) and the bivariate one (covariance, corr) over power and cross
sums; bool_and and bool_or; collect_list and collect_set buffers,
count(DISTINCT), sum(DISTINCT), percentile and percentile_approx.

Decimals as the reference types them: sum(decimal(p, s)) is decimal(p +
10, s) and avg(decimal(p, s)) decimal(p + 4, s + 4), capped at 38 digits.
A narrow sum buffer (<= 18 digits) sums int64 in K4; a wide one ([n, 2]
limbs) sums in kernel K32 (ops/decimal128.py `seg_sum128`, with its
count), and a wide average's evaluate rescales and divides by the count
with HALF_UP in kernel K31 (`average`), then tests the precision. Min
and Max of a wide decimal are two K12 passes, over the high limb and then
over the low limb (sign bit flipped) of the rows tied on it.

- update: raw input values -> per-group partial buffers (segmented
  reductions: sums and counts in kernel K4, minima, maxima, bool_and/or
  and first positions in K12, the first rows' values through K8's
  gather),
- merge: partial buffers from many batches -> combined buffers,
- evaluate: buffers -> final value.

Two kernels of this slice live here beside their plain versions, as the
reference keeps the functions in this module:

- K25 (`rank_select`, `rank_interp`; kernels/csrc/rank_select.cu): the
  percentile aggregates' rank selection over rows sorted by (group,
  value) (K9 sorts them);
- K26 (`collect_rank`, `collect_scatter`; kernels/csrc/collect_scatter.cu):
  each kept row's rank within its group, with the set's duplicate test,
  and the scatter into a [groups, max_elems] array buffer.

`jittable=False` marks functions whose buffers are as wide as the largest
group (the collect family, count(DISTINCT), sum(DISTINCT), percentile):
their width is read on the host, as the reference's eager phases read
it, and the aggregate exec sizes their rows to the group count
(exec/operators.py). `binned_safe=False` marks functions whose update
needs contiguous sorted groups.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceColumn,
    gather_columns,
    gather_leaves,
)
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops import decimal128 as d128
from spark_rapids_tpu_torch.ops import segmented
from spark_rapids_tpu_torch.ops.common import KeySpec, pack_keys, sort_words
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    DataType,
    DecimalType,
    DoubleType,
    FloatType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    boolean,
    double,
    float_t,
    integer,
    is_wide,
    long,
    torch_dtype,
)


class AggregateFunction(Expression):
    """Base; children are the input expressions (if any).

    `jittable=False` marks functions whose update/merge outputs are as
    wide as the largest group (read on the host); `binned_safe=False`
    those whose update needs contiguous sorted segments, so the aggregate
    exec keeps the sorted grouping even over binnable keys;
    `zero_when_empty` those whose global result over no rows is 0 (the
    counts), where every other function's is null."""

    name: str = "agg"
    jittable: bool = True
    binned_safe: bool = True
    zero_when_empty: bool = False

    @property
    def input(self):
        return self.children[0] if self.children else None

    def buffer_types(self) -> List[DataType]:
        raise NotImplementedError

    def update(self, values: DeviceColumn, live, gid, cap
               ) -> List[DeviceColumn]:
        """Segmented partial aggregation over grouped input rows."""
        raise NotImplementedError

    def merge(self, buffers: List[DeviceColumn], live, gid, cap
              ) -> List[DeviceColumn]:
        """Combine partial buffers grouped by key."""
        raise NotImplementedError

    def evaluate(self, buffers: List[DeviceColumn]) -> DeviceColumn:
        raise NotImplementedError


def _sum_result_type(t: DataType) -> DataType:
    if isinstance(t, (FloatType, DoubleType)):
        return double
    if isinstance(t, DecimalType):
        # Spark: sum(decimal(p, s)) -> decimal(p + 10, s); past 18 digits
        # the buffer is [n, 2] limbs
        p = min(DecimalType.MAX_PRECISION, t.precision + 10)
        return DecimalType(p, t.scale)
    return long


def _ones(cnt: torch.Tensor) -> torch.Tensor:
    return torch.ones(cnt.shape, dtype=torch.bool, device=cnt.device)


class Sum(AggregateFunction):
    name = "sum"

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return _sum_result_type(self.children[0].dtype)

    def buffer_types(self):
        return [self.dtype, long]  # (sum, count_nonnull)

    def update(self, values, live, gid, cap):
        out_t = self.dtype
        valid = values.validity & live
        if is_wide(out_t):
            s, cnt = d128.seg_sum128(values.data, valid, gid, cap)
        else:
            data = values.data.to(torch_dtype(out_t))
            s, cnt = segmented.seg_sum_count(data, valid, gid, cap)
        return [DeviceColumn(out_t, s, cnt > 0),
                DeviceColumn(long, cnt, _ones(cnt))]

    def merge(self, buffers, live, gid, cap):
        cnt = segmented.seg_sum(buffers[1].data, live, gid, cap)
        buf = buffers[0]
        if buf.data.dim() == 2:
            s, _ = d128.seg_sum128(buf.data, buf.validity & live, gid, cap)
        else:
            s = segmented.seg_sum(buf.data, buf.validity & live, gid, cap)
        return [DeviceColumn(buf.dtype, s, cnt > 0),
                DeviceColumn(long, cnt, _ones(cnt))]

    def evaluate(self, buffers):
        return buffers[0]


class Count(AggregateFunction):
    """count(expr) skips nulls; count(*) counts rows (child=None)."""

    name = "count"
    zero_when_empty = True

    def __init__(self, child: Expression = None):
        super().__init__([child] if child is not None else [])

    @property
    def dtype(self):
        return long

    @property
    def nullable(self):
        return False

    def buffer_types(self):
        return [long]

    def update(self, values, live, gid, cap):
        valid = live if values is None else values.validity & live
        cnt = segmented.seg_count(valid, gid, cap)
        return [DeviceColumn(long, cnt, _ones(cnt))]

    def merge(self, buffers, live, gid, cap):
        cnt = segmented.seg_sum(buffers[0].data, live, gid, cap)
        return [DeviceColumn(long, cnt, _ones(cnt))]

    def evaluate(self, buffers):
        return buffers[0]


class Average(AggregateFunction):
    name = "avg"

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        # Spark: avg(decimal(p, s)) -> decimal(p + 4, s + 4); else double
        t = self.children[0].dtype
        if isinstance(t, DecimalType):
            m = DecimalType.MAX_PRECISION
            return DecimalType(min(m, t.precision + 4), min(m, t.scale + 4))
        return double

    def buffer_types(self):
        return [_sum_result_type(self.children[0].dtype), long]

    def update(self, values, live, gid, cap):
        return Sum(self.children[0]).update(values, live, gid, cap)

    def merge(self, buffers, live, gid, cap):
        return Sum(self.children[0]).merge(buffers, live, gid, cap)

    def evaluate(self, buffers):
        s, cnt = buffers
        out_t = self.dtype
        safe = cnt.data.clamp(min=1)
        if isinstance(out_t, DecimalType):
            up = out_t.scale - self.children[0].dtype.scale
            if s.data.dim() == 2:
                # K31: rescale, divide by the count HALF_UP, the precision
                data, valid = d128.average(s.data, cnt.data, up,
                                           out_t.precision, is_wide(out_t))
                return DeviceColumn(out_t, data, valid)
            num = s.data.to(torch.int64) * (10 ** up)
            q = torch.abs(num) // safe
            rem = torch.abs(num) - q * safe
            q = q + (2 * rem >= safe).to(torch.int64)
            return DeviceColumn(out_t, torch.sign(num) * q, cnt.data > 0)
        data = s.data.to(torch.float64) / safe.to(torch.float64)
        return DeviceColumn(out_t, data, cnt.data > 0)


class _MinMax(AggregateFunction):
    """Min and Max: one buffer, the extremum of the valid rows (K12's
    segmented min/max), valid where the group has one."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def buffer_types(self):
        return [self.dtype]

    def _seg(self, data, valid, gid, cap):
        raise NotImplementedError

    def _seg_any(self, data, valid, gid, cap):
        if data.dim() != 2:
            return self._seg(data, valid, gid, cap)
        # decimal(> 18): the extremum of the high limbs, then of the low
        # limbs (unsigned order) of the rows tied on it: two K12 passes
        hi, lo = d128.split(data)
        h = self._seg(hi.contiguous(), valid, gid, cap)
        idx = gid.to(torch.int64).clamp(0, cap - 1)
        tie = valid & (hi == h.index_select(0, idx))
        lo_o = self._seg((lo ^ d128._SIGN64).contiguous(), tie, gid, cap)
        return d128.join(h, lo_o ^ d128._SIGN64)

    def update(self, values, live, gid, cap):
        valid = values.validity & live
        r = self._seg_any(values.data, valid, gid, cap)
        cnt = segmented.seg_count(valid, gid, cap)
        return [DeviceColumn(self.dtype, r, cnt > 0)]

    def merge(self, buffers, live, gid, cap):
        valid = buffers[0].validity & live
        r = self._seg_any(buffers[0].data, valid, gid, cap)
        cnt = segmented.seg_count(valid, gid, cap)
        return [DeviceColumn(buffers[0].dtype, r, cnt > 0)]

    def evaluate(self, buffers):
        return buffers[0]


class Min(_MinMax):
    name = "min"

    def _seg(self, data, valid, gid, cap):
        return segmented.seg_min(data, valid, gid, cap)


class Max(_MinMax):
    name = "max"

    def _seg(self, data, valid, gid, cap):
        return segmented.seg_max(data, valid, gid, cap)




class First(AggregateFunction):
    """first(col[, ignorenulls]): over window frames (TpuWindowExec, kernel
    K17) and as a group-by aggregate, the value at each group's first
    admitted sorted position (K12's segmented min over positions, then
    K8's gather, as the reference's `_first`)."""

    name = "first"

    def __init__(self, child: Expression, ignore_nulls: bool = True):
        super().__init__([child])
        self.ignore_nulls = ignore_nulls

    @property
    def dtype(self):
        return self.children[0].dtype

    def key(self):
        return ("first", self.ignore_nulls, self.children[0].key())

    def buffer_types(self):
        return [self.dtype]

    _take_last = False  # Last takes a segmented max over positions

    def _first(self, values: DeviceColumn, valid, gid, cap):
        n = int(values.data.shape[0])
        pos = torch.arange(n, dtype=torch.int32, device=valid.device)
        if self._take_last:
            fp = segmented.seg_max(torch.where(valid, pos, -1), None, gid,
                                   cap)
            found = fp >= 0
        else:
            fp = segmented.seg_min(torch.where(valid, pos, n), None, gid,
                                   cap)
            found = fp < n
        safe = fp.clamp(0, n - 1)
        out = gather_columns([(values, safe)])[0]
        return out.replace(validity=found & out.validity, vrange=None)

    def _admitted(self, col: DeviceColumn, live):
        return live & col.validity if self.ignore_nulls else live

    def update(self, values, live, gid, cap):
        return [self._first(values, self._admitted(values, live), gid, cap)]

    def merge(self, buffers, live, gid, cap):
        return [self._first(buffers[0], self._admitted(buffers[0], live),
                            gid, cap)]

    def evaluate(self, buffers):
        return buffers[0]


class Last(First):
    """last(col[, ignorenulls]): First from the frame's or the group's
    other end."""

    name = "last"
    _take_last = True

    def key(self):
        return ("last", self.ignore_nulls, self.children[0].key())


class AnyValue(First):
    """any_value(col): any value of the group (registered as a First-family
    aggregate, as in the reference)."""

    name = "any_value"

    def key(self):
        return ("any_value", self.ignore_nulls, self.children[0].key())


# --------------------------------------------------------- moment family
#
# Variance, stddev, skewness and kurtosis over raw power sums (n, Σx,
# Σx², …): partial and merge are plain segmented additions (K4; the
# powers of one input in one launch).


def _merge_sums(buffers, live, gid, cap):
    """[count, sums...] buffers merged: the count in one K4 launch, every
    sum under its own validity in another."""
    cnt = segmented.seg_sum(buffers[0].data, live, gid, cap)
    sums = segmented.seg_sum_count_multi(
        [b.data for b in buffers[1:]], live, gid, cap,
        [b.validity for b in buffers[1:]], with_count=False).sums
    return ([DeviceColumn(long, cnt, _ones(cnt))]
            + [DeviceColumn(double, s, cnt > 0) for s in sums])


def _f(x: torch.Tensor, v: float) -> torch.Tensor:
    """A float64 scalar on x's device (jnp.maximum's scalar operand)."""
    return torch.tensor(v, dtype=torch.float64, device=x.device)


class _Moments(AggregateFunction):
    """Buffers: [n (long), Σx, Σx², … Σx^k (double)]."""

    n_powers = 2

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return double

    def buffer_types(self):
        return [long] + [double] * self.n_powers

    def update(self, values, live, gid, cap):
        valid = values.validity & live
        x = values.data.to(torch.float64)
        powers = [x]
        for _ in range(self.n_powers - 1):
            powers.append(powers[-1] * x)
        red = segmented.seg_sum_count_multi(powers, valid, gid, cap)
        cnt, sums = red.count, red.sums
        return ([DeviceColumn(long, cnt, _ones(cnt))]
                + [DeviceColumn(double, s, cnt > 0) for s in sums])

    def merge(self, buffers, live, gid, cap):
        return _merge_sums(buffers, live, gid, cap)

    @staticmethod
    def _m2(n, s1, s2):
        """Central second moment Σ(x-μ)² = Σx² - (Σx)²/n."""
        safe = torch.maximum(n, _f(n, 1.0))
        return s2 - s1 * s1 / safe

    def evaluate(self, buffers):
        raise NotImplementedError


class VariancePop(_Moments):
    name = "var_pop"

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        m2 = self._m2(n, buffers[1].data, buffers[2].data)
        data = torch.maximum(m2, _f(n, 0.0)) / torch.maximum(n, _f(n, 1.0))
        return DeviceColumn(double, data, n >= 1)


class VarianceSamp(_Moments):
    """var_samp: null for n < 2 (Spark 3's default,
    spark.sql.legacy.statisticalAggregate=false)."""

    name = "var_samp"

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        m2 = self._m2(n, buffers[1].data, buffers[2].data)
        data = (torch.maximum(m2, _f(n, 0.0))
                / torch.maximum(n - 1.0, _f(n, 1.0)))
        return DeviceColumn(double, data, n >= 2)


class StddevPop(VariancePop):
    name = "stddev_pop"

    def evaluate(self, buffers):
        v = super().evaluate(buffers)
        return DeviceColumn(double, torch.sqrt(v.data), v.validity)


class StddevSamp(VarianceSamp):
    name = "stddev_samp"

    def evaluate(self, buffers):
        v = super().evaluate(buffers)
        return DeviceColumn(double, torch.sqrt(v.data), v.validity)


class Skewness(_Moments):
    """skewness = sqrt(n)·m3 / m2^1.5 (null when n = 0 or m2 = 0)."""

    name = "skewness"
    n_powers = 3

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        s1, s2, s3 = (b.data for b in buffers[1:])
        safe = torch.maximum(n, _f(n, 1.0))
        mu = s1 / safe
        m2 = torch.maximum(s2 - s1 * mu, _f(n, 0.0))
        m3 = s3 - 3.0 * mu * s2 + 2.0 * mu * mu * s1
        den = torch.maximum(m2, _f(n, 1e-300)) ** 1.5
        data = torch.sqrt(safe) * m3 / den
        return DeviceColumn(double, data, (n >= 1) & (m2 > 0))


class Kurtosis(_Moments):
    """kurtosis (excess) = n·m4/m2² - 3 (null when n = 0 or m2 = 0)."""

    name = "kurtosis"
    n_powers = 4

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        s1, s2, s3, s4 = (b.data for b in buffers[1:])
        safe = torch.maximum(n, _f(n, 1.0))
        mu = s1 / safe
        m2 = torch.maximum(s2 - s1 * mu, _f(n, 0.0))
        m4 = (s4 - 4.0 * mu * s3 + 6.0 * mu * mu * s2
              - 3.0 * mu ** 3 * s1)
        den = torch.maximum(m2 * m2, _f(n, 1e-300))
        data = safe * m4 / den - 3.0
        return DeviceColumn(double, data, (n >= 1) & (m2 > 0))


# ------------------------------------------------------ bivariate family


class _Bivariate(AggregateFunction):
    """Two-input aggregates (corr, covar_*). A row counts only when BOTH
    inputs are non-null. Buffers: [n, Σx, Σy, Σxy] (+ Σx², Σy² for
    corr)."""

    extra_squares = False

    def __init__(self, x: Expression, y: Expression):
        super().__init__([x, y])

    @property
    def dtype(self):
        return double

    def buffer_types(self):
        return [long] + [double] * (5 if self.extra_squares else 3)

    def update(self, values, live, gid, cap):
        xc, yc = values
        valid = xc.validity & yc.validity & live
        x = xc.data.to(torch.float64)
        y = yc.data.to(torch.float64)
        vecs = [x, y, x * y]
        if self.extra_squares:
            vecs += [x * x, y * y]
        red = segmented.seg_sum_count_multi(vecs, valid, gid, cap)
        cnt, sums = red.count, red.sums
        return ([DeviceColumn(long, cnt, _ones(cnt))]
                + [DeviceColumn(double, s, cnt > 0) for s in sums])

    def merge(self, buffers, live, gid, cap):
        return _merge_sums(buffers, live, gid, cap)


class CovarPop(_Bivariate):
    name = "covar_pop"

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        sx, sy, sxy = (b.data for b in buffers[1:4])
        safe = torch.maximum(n, _f(n, 1.0))
        data = (sxy - sx * sy / safe) / safe
        return DeviceColumn(double, data, n >= 1)


class CovarSamp(_Bivariate):
    name = "covar_samp"

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        sx, sy, sxy = (b.data for b in buffers[1:4])
        safe = torch.maximum(n, _f(n, 1.0))
        data = (sxy - sx * sy / safe) / torch.maximum(n - 1.0, _f(n, 1.0))
        return DeviceColumn(double, data, n >= 2)


class Corr(_Bivariate):
    """Pearson correlation; null when n = 0 or either variance is 0."""

    name = "corr"
    extra_squares = True

    def evaluate(self, buffers):
        n = buffers[0].data.to(torch.float64)
        sx, sy, sxy, sxx, syy = (b.data for b in buffers[1:6])
        safe = torch.maximum(n, _f(n, 1.0))
        cov = sxy - sx * sy / safe
        vx = torch.maximum(sxx - sx * sx / safe, _f(n, 0.0))
        vy = torch.maximum(syy - sy * sy / safe, _f(n, 0.0))
        den = torch.sqrt(vx) * torch.sqrt(vy)
        data = cov / torch.maximum(den, _f(n, 1e-300))
        return DeviceColumn(double, data.clamp(-1.0, 1.0),
                            (n >= 1) & (den > 0))


# ----------------------------------------------------------- bool family


class _BoolReduce(AggregateFunction):
    """bool_and (a segmented min) and bool_or (a max) of the 0/1 values,
    K12."""

    _use_max = False

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return boolean

    def buffer_types(self):
        return [boolean]

    def _reduce(self, col: DeviceColumn, live, gid, cap):
        valid = col.validity & live
        x = col.data.to(torch.int32)
        seg = segmented.seg_max if self._use_max else segmented.seg_min
        r = seg(x, valid, gid, cap) > 0
        cnt = segmented.seg_count(valid, gid, cap)
        return [DeviceColumn(boolean, r, cnt > 0)]

    def update(self, values, live, gid, cap):
        return self._reduce(values, live, gid, cap)

    def merge(self, buffers, live, gid, cap):
        return self._reduce(buffers[0], live, gid, cap)

    def evaluate(self, buffers):
        return buffers[0]


class BoolAnd(_BoolReduce):
    name = "bool_and"


class BoolOr(_BoolReduce):
    name = "bool_or"
    _use_max = True


# ------------------------------------------------------------------ K26


def _elem_kind(dtype: torch.dtype) -> int:
    kind = kernels.ELEM_KINDS.get(dtype)
    if kind is None:
        raise TypeError(f"K26 collects 1-, 2-, 4- or 8-byte integers, "
                        f"floats or booleans, got {dtype}")
    return kind


def collect_rank_plain(vals: torch.Tensor, valid: torch.Tensor,
                       gid: torch.Tensor, nseg: int, dedup: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K26's rank: the reference's duplicate test
    (`_eq_nan_aware` against the sorted predecessor), a cumsum of the kept
    rows less its value at each group's first row, and a scatter-add of
    the counts."""
    n = int(vals.shape[0])
    dev = vals.device
    inr = (gid >= 0) & (gid < nseg)
    keep = valid & inr
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        first[1:] = gid[1:] != gid[:-1]
        if dedup:
            eq = vals[1:] == vals[:-1]
            if vals.dtype.is_floating_point:
                eq = eq | (torch.isnan(vals[1:]) & torch.isnan(vals[:-1]))
            same = torch.zeros(n, dtype=torch.bool, device=dev)
            same[1:] = ~first[1:] & eq & valid[:-1]
            keep = keep & ~same
    k = keep.to(torch.int64)
    excl = torch.cumsum(k, 0) - k
    slot = torch.where(inr, gid, nseg).to(torch.int64)
    base = torch.zeros(nseg + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(first, slot, nseg), excl)
    rank = torch.where(keep, excl - base[slot], -1).to(torch.int32)
    counts = torch.zeros(nseg + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, torch.where(keep, slot, nseg), k)
    return keep, rank, counts[:nseg].to(torch.int32)


def collect_rank(vals: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor,
                 nseg: int, dedup: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K26's rank: over rows whose gid runs are contiguous, keep[r]
    = valid[r] and 0 <= gid[r] < nseg (and, with `dedup`, r differs from
    its predecessor in the same group, NaN equal to NaN), rank[r] = kept
    rows before r in its group (-1 for a dropped row), counts[g] = kept
    rows of g. Returns (keep bool, rank int32, counts [nseg] int32)."""
    if vals.device.type == "cpu":
        return collect_rank_plain(vals, valid, gid, nseg, dedup)
    dev = vals.device
    kind = _elem_kind(vals.dtype)
    kernels.require(vals, "vals", vals.dtype, dev)
    kernels.require(valid, "valid", torch.bool, dev)
    kernels.require(gid, "gid", torch.int32, dev)
    n = int(vals.shape[0])
    if valid.shape[0] != n or gid.shape[0] != n or n >= 1 << 31:
        raise ValueError(f"K26 ranks 0..2^31-1 rows: vals {n}, valid "
                         f"{valid.shape[0]}, gid {gid.shape[0]}")
    if nseg < 1:
        raise ValueError(f"K26 needs at least one group, got {nseg}")
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(nseg, dtype=torch.int32, device=dev)
    tiles = -(-n // kernels.TILE_ROWS)
    scratch = torch.empty(nseg + 2 * tiles + 1, dtype=torch.int32,
                          device=dev)
    data = vals.view(torch.uint8) if vals.dtype == torch.bool else vals
    _build.check(_build.lib().srtpu_collect_rank(
        data.data_ptr(), kind, valid.data_ptr(), gid.data_ptr(), n, nseg,
        int(dedup), keep.data_ptr(), rank.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), kernels.sm_count(vals),
        kernels.stream_ptr(vals)), "collect_rank")
    kernels.launches["collect_rank"] += 1
    return keep, rank, counts


def collect_scatter_plain(vals, keep, rank, gid, counts, nseg: int,
                          me: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K26's scatter: the reference's
    `.at[gid, rank].set` into zeros (a spare cell takes the dropped
    rows) and the element-validity compare."""
    dev = vals.device
    cells = nseg * me
    ok = keep & (rank < me)
    idx = torch.where(ok, gid.to(torch.int64) * me + rank.to(torch.int64),
                      cells)
    out = torch.zeros(cells + 1, dtype=vals.dtype, device=dev)
    out[idx] = vals
    ev = (torch.arange(me, dtype=torch.int32, device=dev)[None, :]
          < counts[:, None])
    return out[:cells].reshape(nseg, me), ev


def collect_scatter(vals, keep, rank, gid, counts, nseg: int,
                    me: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K26's scatter: out[g, j] = the value of group g's kept row
    of rank j (0 past counts[g]) and ev[g, j] = j < counts[g], from
    `collect_rank`'s outputs. Returns (out [nseg, me], ev [nseg, me])."""
    if vals.device.type == "cpu":
        return collect_scatter_plain(vals, keep, rank, gid, counts, nseg,
                                     me)
    dev = vals.device
    _elem_kind(vals.dtype)
    kernels.require(vals, "vals", vals.dtype, dev)
    kernels.require(keep, "keep", torch.bool, dev)
    kernels.require(rank, "rank", torch.int32, dev)
    kernels.require(gid, "gid", torch.int32, dev)
    kernels.require(counts, "counts", torch.int32, dev)
    n = int(vals.shape[0])
    if (keep.shape[0] != n or rank.shape[0] != n or gid.shape[0] != n
            or counts.shape[0] != nseg or me < 1):
        raise ValueError("K26's scatter: rows, groups or width differ")
    out = torch.empty((nseg, me), dtype=vals.dtype, device=dev)
    ev = torch.empty((nseg, me), dtype=torch.bool, device=dev)
    data = vals.view(torch.uint8) if vals.dtype == torch.bool else vals
    _build.check(_build.lib().srtpu_collect_scatter(
        data.data_ptr(), vals.element_size(), keep.data_ptr(),
        rank.data_ptr(), gid.data_ptr(), n, counts.data_ptr(), nseg, me,
        out.data_ptr(), ev.data_ptr(), kernels.sm_count(vals),
        kernels.stream_ptr(vals)), "collect_scatter")
    kernels.launches["collect_scatter"] += 1
    return out, ev


# ------------------------------------------------------------------ K25


def rank_select_plain(svals: torch.Tensor, sgid: torch.Tensor,
                      weights: Optional[torch.Tensor],
                      live: Optional[torch.Tensor], nseg: int, K: int,
                      eps: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of K25's select: the reference's segment sum
    of the weights, running weights from a cumsum less each group's base,
    and per target a segment min of the hit positions (K passes), the
    weights as int64 so that every sum is exact. Only positions of
    positive weight can be hit, so the passes run over those alone. It
    writes every group, those past the largest id in sgid too, as the
    reference does."""
    npos = int(svals.shape[0])
    dev = svals.device
    w = weights if weights is not None else live.to(torch.int64)
    inr = (sgid >= 0) & (sgid < nseg)
    pos = torch.nonzero((w > 0) & inr).flatten()
    wp = w[pos]
    slot = sgid[pos].to(torch.int64)
    total = torch.zeros(nseg, dtype=torch.int64, device=dev).scatter_add_(
        0, slot, wp)
    cw = torch.cumsum(wp, 0)
    first = torch.ones(pos.shape[0], dtype=torch.bool, device=dev)
    first[1:] = slot[1:] != slot[:-1]
    base = torch.zeros(nseg, dtype=torch.int64, device=dev).scatter_(
        0, slot[first], (cw - wp)[first])
    incl = (cw - base[slot]).to(torch.float64)
    tot_d = total.to(torch.float64)
    outs = []
    for j in range(K):
        q = j / max(K - 1, 1)
        thr = q * tot_d - eps
        hit = incl >= thr[slot]
        p = torch.full((nseg,), npos, dtype=torch.int64, device=dev)
        p = p.scatter_reduce_(0, slot[hit], pos[hit], "amin")
        outs.append(svals[p.clamp(0, npos - 1)])
    return outs, total


def rank_select(svals: torch.Tensor, sgid: torch.Tensor,
                weights: Optional[torch.Tensor],
                live: Optional[torch.Tensor], nseg: int, K: int,
                eps: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Kernel K25's select over positions sorted by (group, value), sgid
    non-decreasing, with int64 weights >= 0 (or the 0/1 `live` mask), the
    positions of positive weight first in each group (`_sort_by_group`
    puts them there): each group's total weight and, for target j of K,
    the value at the first position of positive weight whose running
    weight within the group reaches (j / (K-1)) * total - eps
    (svals[npos-1] where none does). Groups past the largest id in sgid
    have no position and lie past the batch's group count: the kernel
    leaves their entries unwritten. Returns (K [nseg] float64 tensors,
    total [nseg] int64)."""
    if svals.device.type == "cpu":
        return rank_select_plain(svals, sgid, weights, live, nseg, K, eps)
    dev = svals.device
    kernels.require(svals, "svals", torch.float64, dev)
    kernels.require(sgid, "sgid", torch.int32, dev)
    npos = int(svals.shape[0])
    if (weights is None) == (live is None):
        raise ValueError("K25 takes exactly one of weights and live")
    w = weights if weights is not None else live
    kernels.require(w, "weights", torch.int64 if weights is not None
                    else torch.bool, dev)
    if (sgid.shape[0] != npos or w.shape[0] != npos or npos < 1
            or npos >= 1 << 31 or nseg < 1
            or not 1 <= K <= kernels.MAX_RANK_TARGETS):
        raise ValueError(f"K25 selects K in 1..{kernels.MAX_RANK_TARGETS} "
                         f"targets over 1..2^31-1 positions: K {K}, npos "
                         f"{npos}, nseg {nseg}")
    outs = torch.empty((K, nseg), dtype=torch.float64, device=dev)
    total = torch.empty(nseg, dtype=torch.int64, device=dev)
    _build.check(_build.lib().srtpu_rank_select(
        svals.data_ptr(), sgid.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if live is None else live.data_ptr(), npos, nseg, K,
        float(eps), outs.data_ptr(), total.data_ptr(),
        kernels.sm_count(svals), kernels.stream_ptr(svals)), "rank_select")
    kernels.launches["rank_select"] += 1
    return list(outs.unbind(0)), total


def rank_interp_plain(svals: torch.Tensor, lengths: torch.Tensor,
                      p: float) -> torch.Tensor:
    """Plain PyTorch version of K25's interpolation: the reference's
    floor/ceil ranks, clipped takes and linear interpolation."""
    me = int(svals.shape[1])
    rk = p * (lengths.to(torch.int64) - 1).clamp(min=0).to(torch.float64)
    lo = torch.floor(rk).to(torch.int64)
    hi = torch.ceil(rk).to(torch.int64)
    frac = rk - lo.to(torch.float64)
    vlo = svals.gather(1, lo.clamp(0, me - 1)[:, None])[:, 0]
    vhi = svals.gather(1, hi.clamp(0, me - 1)[:, None])[:, 0]
    return vlo + (vhi - vlo) * frac


def rank_interp(svals: torch.Tensor, lengths: torch.Tensor,
                p: float) -> torch.Tensor:
    """Kernel K25's interpolation: for each row of svals [rows, me]
    (sorted within the row), the value at rank p * (len - 1), linearly
    interpolated between its floor and ceiling ranks."""
    if svals.device.type == "cpu":
        return rank_interp_plain(svals, lengths, p)
    dev = svals.device
    kernels.require(svals, "svals", torch.float64, dev, ndim=2)
    kernels.require(lengths, "lengths", torch.int32, dev)
    rows, me = int(svals.shape[0]), int(svals.shape[1])
    if lengths.shape[0] != rows or me < 1:
        raise ValueError(f"K25 interpolates [rows, me >= 1] with one length "
                         f"a row: {tuple(svals.shape)}, "
                         f"{tuple(lengths.shape)}")
    out = torch.empty(rows, dtype=torch.float64, device=dev)
    _build.check(_build.lib().srtpu_rank_interp(
        svals.data_ptr(), lengths.data_ptr(), rows, me, float(p),
        out.data_ptr(), kernels.sm_count(svals), kernels.stream_ptr(svals)),
        "rank_interp")
    kernels.launches["rank_interp"] += 1
    return out


def _sort_by_group(gid: torch.Tensor, vals: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """K9's stable permutation ordering rows by (group, valid rows first,
    value), -0.0 tied with 0.0 and NaN above +inf (the reference's
    lexsort / lax.sort keys)."""
    ones = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
    dt = {torch.float64: double, torch.float32: float_t,
          torch.bool: boolean}.get(vals.dtype, long)
    words, _ = pack_keys(
        [KeySpec(DeviceColumn(integer, gid, ones), with_rank=False),
         KeySpec(DeviceColumn(dt, vals, valid), nulls_first=False,
                 normalize_zero=True)], ones)
    return sort_words(words)


def _sort_rows(vals: torch.Tensor) -> torch.Tensor:
    """Each row of vals [rows, me] float64 sorted ascending, NaN above
    +inf (the reference's jnp.sort(axis=1)): K9 over (row, value), one K8
    gather."""
    rows, me = int(vals.shape[0]), int(vals.shape[1])
    flat = vals.reshape(rows * me)
    row = (torch.arange(rows, dtype=torch.int32, device=vals.device)
           .repeat_interleave(me))
    perm = _sort_by_group(row, flat, torch.ones_like(row, dtype=torch.bool))
    return gather_leaves([flat], [perm])[0].reshape(rows, me)


# ------------------------------------------------- collect / exact sets
#
# collect_list/collect_set produce array buffers ([cap, max_elems] padded
# matrices). max_elems is the largest group, read on the host
# (jittable=False), as the reference's eager phases read it.


class CollectList(AggregateFunction):
    name = "collect_list"
    jittable = False
    binned_safe = False  # K26's ranks need contiguous sorted groups

    def __init__(self, child: Expression):
        super().__init__([child])

    def key(self):
        return (self.name, None, self.children[0].key())

    @property
    def dtype(self):
        return ArrayType(self.children[0].dtype, containsNull=False)

    @property
    def nullable(self):
        return False  # an empty array, never null (Spark's collect_list)

    def buffer_types(self):
        return [self.dtype]

    def _scatter(self, elem_dt, vals, valid, gid, cap, dedup=False):
        """Rows -> a [cap, me] array column (me = the largest group): K26's
        rank, one host read of the width, K26's scatter."""
        keep, rank, counts = collect_rank(vals, valid, gid, cap, dedup)
        me = max(int(counts.max()), 1) if cap else 1
        out, ev = collect_scatter(vals, keep, rank, gid, counts, cap, me)
        return DeviceColumn(
            ArrayType(elem_dt, False), out,
            torch.ones(cap, dtype=torch.bool, device=vals.device), counts,
            elem_validity=ev)

    def update(self, values, live, gid, cap):
        valid = values.validity & live
        return [self._scatter(values.dtype, values.data, valid, gid, cap)]

    def _merge_elements(self, buf, live, gid, cap, dedup: bool):
        """Flatten each group's row lists into element rows, then scatter
        them again by group (deduplicating for sets)."""
        n, me_in = int(buf.data.shape[0]), int(buf.data.shape[1])
        vals = buf.data.reshape(n * me_in)
        egid = gid[:, None].expand(n, me_in).reshape(n * me_in)
        within = torch.arange(me_in, dtype=torch.int32,
                              device=gid.device)[None, :]
        evalid = ((within < buf.lengths[:, None])
                  & live[:, None]).reshape(n * me_in)
        if buf.elem_validity is not None:
            evalid = evalid & buf.elem_validity.reshape(n * me_in)
        if dedup:
            # invalid (padding) elements sort to each group's end, so
            # equal valid values are adjacent for the duplicate test
            perm = _sort_by_group(egid, vals, evalid)
            vals, egid, evalid = gather_leaves([vals, egid, evalid],
                                               [perm] * 3)
        return self._scatter(buf.dtype.elementType, vals, evalid, egid, cap,
                             dedup)

    def merge(self, buffers, live, gid, cap):
        return [self._merge_elements(buffers[0], live, gid, cap,
                                     dedup=False)]

    def evaluate(self, buffers):
        return buffers[0]


class CollectSet(CollectList):
    """collect_set: the distinct values of each group. update drops a row
    equal to its predecessor in the group's sorted rows; merge does the
    same across the partials."""

    name = "collect_set"

    def update(self, values, live, gid, cap):
        valid = values.validity & live
        perm = _sort_by_group(gid, values.data, valid)
        svals, sgid, svalid = gather_leaves([values.data, gid, valid],
                                            [perm] * 3)
        return [self._scatter(values.dtype, svals, svalid, sgid, cap,
                              dedup=True)]

    def merge(self, buffers, live, gid, cap):
        return [self._merge_elements(buffers[0], live, gid, cap,
                                     dedup=True)]


class CountDistinct(AggregateFunction):
    """count(DISTINCT col): collect_set buffers, their element counts at
    evaluate."""

    name = "count_distinct"
    jittable = False
    binned_safe = False  # delegates to the collect_set buffer
    zero_when_empty = True

    def __init__(self, child: Expression):
        super().__init__([child])

    def key(self):
        return (self.name, None, self.children[0].key())

    @property
    def _set(self):
        # derived lazily: children are rebound during plan analysis
        return CollectSet(self.children[0])

    @property
    def dtype(self):
        return long

    @property
    def nullable(self):
        return False

    def buffer_types(self):
        return self._set.buffer_types()

    def update(self, values, live, gid, cap):
        return self._set.update(values, live, gid, cap)

    def merge(self, buffers, live, gid, cap):
        return self._set.merge(buffers, live, gid, cap)

    def evaluate(self, buffers):
        cnt = buffers[0].lengths.to(torch.int64)
        return DeviceColumn(long, cnt, _ones(cnt))


class SumDistinct(CountDistinct):
    """sum(DISTINCT col): each set buffer row summed by K4 over its
    flattened elements, the row index as the segment id."""

    name = "sum_distinct"
    zero_when_empty = False

    @property
    def dtype(self):
        return _sum_result_type(self.children[0].dtype)

    @property
    def nullable(self):
        return True

    def evaluate(self, buffers):
        buf = buffers[0]
        rows, me = int(buf.data.shape[0]), int(buf.data.shape[1])
        dev = buf.data.device
        out_t = self.dtype
        mask = (torch.arange(me, dtype=torch.int32, device=dev)[None, :]
                < buf.lengths[:, None]).reshape(rows * me)
        row = (torch.arange(rows, dtype=torch.int32, device=dev)
               .repeat_interleave(me))
        data = segmented.seg_sum(
            buf.data.reshape(rows * me).to(torch_dtype(out_t)), mask, row,
            rows)
        return DeviceColumn(out_t, data, buf.lengths > 0)


class Percentile(AggregateFunction):
    """Exact percentile with linear interpolation (Spark's `percentile`):
    collect_list buffers of the group's values; evaluate sorts each row
    (K9), then K25 interpolates at rank percentage * (n - 1)."""

    name = "percentile"
    jittable = False
    binned_safe = False  # collect_list buffers (sorted-gid ranks)

    def __init__(self, child: Expression, percentage: float,
                 accuracy: int = 10000):
        super().__init__([child])
        self.percentage = float(percentage)
        self.accuracy = int(accuracy)

    @property
    def _list(self):
        # derived lazily: children are rebound during plan analysis
        return CollectList(self.children[0])

    @property
    def dtype(self):
        return double

    def key(self):
        return (self.name, self.percentage, self.children[0].key())

    def buffer_types(self):
        return self._list.buffer_types()

    def update(self, values, live, gid, cap):
        return self._list.update(values, live, gid, cap)

    def merge(self, buffers, live, gid, cap):
        return self._list.merge(buffers, live, gid, cap)

    def evaluate(self, buffers):
        buf = buffers[0]
        me = int(buf.data.shape[1])
        cnt = buf.lengths
        mask = (torch.arange(me, dtype=torch.int32,
                             device=cnt.device)[None, :] < cnt[:, None])
        vals = torch.where(mask, buf.data.to(torch.float64),
                           _f(cnt, float("inf")))
        data = rank_interp(_sort_rows(vals), cnt, self.percentage)
        return DeviceColumn(double, data, cnt > 0)


class ApproxPercentile(Percentile):
    """approx_percentile as a bounded, mergeable quantile sketch (the
    reference's K equally spaced quantile points and a count a group, K
    from `accuracy`, capped at 128): update sorts the rows by (group,
    value) with K9 and K25 selects the K points; merge treats every
    partial's points as samples of weight n/K (K25 takes the weight n on
    the scale of K, so that its sums are exact), sorts them the same way
    and selects again; evaluate interpolates `percentage` over the
    points. jittable and binned_safe: update and merge sort by the group
    themselves."""

    name = "approx_percentile"
    jittable = True
    binned_safe = True

    def key(self):
        return (self.name, self.percentage, self.K, self.children[0].key())

    @property
    def K(self) -> int:
        return int(min(max(self.accuracy, 16), 128))

    def buffer_types(self):
        return [double] * self.K + [long]

    def _select(self, vals, gid, ok, weights, cap, scale):
        """Sort (group, value) with K9, gather with K8, select with K25."""
        key_v = torch.where(ok, vals, _f(vals, float("inf")))
        perm = _sort_by_group(gid, key_v, ok)
        leaves = [key_v, gid, ok if weights is None else weights]
        svals, sgid, sw = gather_leaves(leaves, [perm] * 3)
        return rank_select(svals, sgid, sw if weights is not None else None,
                           sw if weights is None else None, cap, self.K,
                           1e-12 * scale)

    def _columns(self, outs, n, cap):
        ok = n > 0
        cols = [DeviceColumn(double, o, ok) for o in outs]
        cols.append(DeviceColumn(long, n, torch.ones(
            cap, dtype=torch.bool, device=n.device)))
        return cols

    def update(self, values, live, gid, cap):
        valid = live & values.validity
        v = values.data.to(torch.float64)
        outs, total = self._select(v, gid, valid, None, cap, 1)
        return self._columns(outs, total, cap)

    def merge(self, buffers, live, gid, cap):
        K = self.K
        n_row = buffers[K].data
        row_ok = live & (n_row > 0) & buffers[0].validity
        rows = int(n_row.shape[0])
        flat = rows * K
        vals = torch.stack([b.data for b in buffers[:K]], dim=1).reshape(flat)
        gid_f = gid[:, None].expand(rows, K).reshape(flat)
        w_f = torch.where(row_ok, n_row, 0)[:, None].expand(
            rows, K).reshape(flat)
        outs, total = self._select(vals, gid_f, w_f > 0, w_f, cap, K)
        return self._columns(outs, total // K, cap)

    def evaluate(self, buffers):
        K = self.K
        n = buffers[K].data
        rk = self.percentage * (K - 1)
        lo = int(math.floor(rk))
        hi = int(math.ceil(rk))
        frac = rk - lo
        vlo = buffers[lo].data
        vhi = buffers[hi].data
        data = vlo + (vhi - vlo) * frac
        return DeviceColumn(double, data, n > 0)
