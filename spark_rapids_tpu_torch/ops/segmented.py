"""Sort-based grouping and segmented reductions — counterpart of
`spark_rapids_tpu/ops/segmented.py`.

`seg_sum_count_multi` is kernel K4 (kernels/csrc/seg_sum_count.cu): k <= 8
segmented sums a launch, each under its own mask and with its own count,
plus a row count, in one pass over the rows (a larger set takes launches
of at most 8); the moment and bivariate aggregates take their power and
cross sums from it (the reference's `seg_multi_sum`), `seg_count`,
`seg_sum` and `seg_sum_count` are its simple shapes, and the binned
aggregate's partial takes all its reductions from one launch. The reference's TPU
route (f32-chunk one-hot matmuls on the MXU) is a TPU limit and is not
copied: int64 sums are exact, float64 sums are exact up to summation
order.

`group_by` (the sorted path) packs its key words and sorts them with
kernel K9 (ops/common.py), derives the segment structure with K10
(`group_bounds`, kernels/csrc/group_bounds.cu) and gathers the batch with
K8; the binned path's bins become dense group positions through K11
(`dense_bin_perm`, kernels/csrc/dense_bin_perm.cu). `seg_min` and
`seg_max` are kernel K12 (kernels/csrc/seg_minmax.cu), which the window's
sort (ops/windowops.py `sort_for_window`) calls four times; `seg_first` is
a clipped take, K8's gather.
"""

from __future__ import annotations

import contextvars
import ctypes
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch, gather_leaves
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.common import (
    KeySpec,
    pack_keys,
    rows_equal_adjacent,
    sort_words,
)

_I32_MAX = 0x7FFFFFFF


class GroupedBatch(NamedTuple):
    """Sorted-by-key view of a batch with segment structure."""

    sorted_batch: ColumnBatch   # rows permuted so groups are contiguous
    gid: torch.Tensor           # [cap] int32 segment id per sorted row
    live: torch.Tensor          # [cap] bool live mask in sorted order
    num_groups: torch.Tensor    # 0-d int32
    first_pos: torch.Tensor     # [cap] int32: sorted position of each
    #                             group's first row (by gid)


# The binned (sort-free) grouping path produces gids in row order, not
# sorted. K4 reads this to choose its route: unsorted ids privatise bins
# per block in shared memory; sorted ids (and bins too many for shared
# memory) fold runs of equal ids in registers and add each run's totals
# once a block. A ContextVar, as in the reference.
_SORTED_GIDS = contextvars.ContextVar("srtpu_torch_sorted_gids",
                                      default=True)


@contextmanager
def unsorted_gids():
    tok = _SORTED_GIDS.set(False)
    try:
        yield
    finally:
        _SORTED_GIDS.reset(tok)


class SegSums(NamedTuple):
    """K4's outputs: per value vector its sums (and, when asked, how many
    rows each sum took), and the segmented count of the valid rows."""

    sums: List[torch.Tensor]                     # k x [num_segments]
    value_counts: Optional[List[torch.Tensor]]   # k x [num_segments] int64
    count: Optional[torch.Tensor]                # [num_segments] int64


def seg_sum_count_plain(values: Sequence[torch.Tensor], valid: torch.Tensor,
                        gid: torch.Tensor, num_segments: int,
                        masks: Optional[Sequence[Optional[torch.Tensor]]]
                        = None, with_count: bool = True,
                        value_counts: bool = False) -> SegSums:
    """Plain PyTorch version of K4: scatter-adds of the masked rows (ids
    outside [0, num_segments) are dropped, as segment_sum drops them)."""
    inr = valid & (gid >= 0) & (gid < num_segments)
    idx = torch.where(inr, gid, 0).to(torch.int64)
    masks = list(masks) if masks is not None else [None] * len(values)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(num_segments, dtype=x.dtype,
                           device=x.device).scatter_add_(0, idx, x)

    sums, vcounts = [], []
    for v, m in zip(values, masks):
        use = inr if m is None else inr & m
        sums.append(scatter(torch.where(use, v, torch.zeros_like(v))))
        vcounts.append(scatter(use.to(torch.int64)))
    count = scatter(inr.to(torch.int64)) if with_count else None
    return SegSums(sums, vcounts if value_counts else None, count)


#: value vectors one K4 launch sums (kMaxK in csrc/seg_sum_count.cu)
K4_MAX_VECTORS = 8


def seg_sum_count_multi(values: Sequence[torch.Tensor], valid: torch.Tensor,
                        gid: torch.Tensor, num_segments: int,
                        masks: Optional[Sequence[Optional[torch.Tensor]]]
                        = None, with_count: bool = True,
                        value_counts: bool = False) -> SegSums:
    """Kernel K4, in one pass over the rows with `valid` and
    0 <= gid < num_segments: the segmented sums of k value vectors (all
    int64 or all float64; at most 8 a launch, a larger set in launches of
    8), each over the rows its mask admits (`masks[j]`, None for all of
    them), with `value_counts` the number of rows each sum took, and with
    `with_count` the count of the rows."""
    if valid.device.type == "cpu":
        return seg_sum_count_plain(values, valid, gid, num_segments, masks,
                                   with_count, value_counts)
    k = len(values)
    masks = list(masks) if masks is not None else [None] * k
    if k > K4_MAX_VECTORS:
        m = K4_MAX_VECTORS
        parts = [_seg_sum_count_launch(
            values[lo:lo + m], valid, gid, num_segments, masks[lo:lo + m],
            with_count and lo == 0, value_counts)
            for lo in range(0, k, m)]
        return SegSums(
            [s for p in parts for s in p.sums],
            [c for p in parts for c in p.value_counts]
            if value_counts else None, parts[0].count)
    return _seg_sum_count_launch(values, valid, gid, num_segments, masks,
                                 with_count, value_counts)


def seg_sum_route(k: int, num_segments: int, sorted_ids: bool,
                  smem_optin: int) -> str:
    """K4's route (csrc/seg_sum_count.cu launch): "shared" (private bins
    in shared memory) for unsorted ids whose k sums, k value counts and
    row count a bin, 8 bytes each, fit the `smem_optin` bytes a block may
    take; else "runs" (runs of equal ids folded in registers)."""
    if sorted_ids or num_segments * (16 * k + 8) > smem_optin:
        return "runs"
    return "shared"


def _seg_sum_count_launch(values, valid, gid, num_segments, masks,
                          with_count, value_counts) -> SegSums:
    """One K4 launch over at most K4_MAX_VECTORS value vectors."""
    dev = valid.device
    k = len(values)
    if len(masks) != k:
        raise ValueError(f"{len(masks)} masks for {k} value vectors")
    n = valid.shape[0]
    kernels.require(valid, "valid", torch.bool, dev)
    kernels.require(gid, "gid", torch.int32, dev)
    dtype = values[0].dtype if values else torch.int64
    if dtype not in (torch.int64, torch.float64):
        raise TypeError(f"K4 sums int64 or float64, got {dtype}")
    for v, m in zip(values, masks):
        kernels.require(v, "values", dtype, dev)
        if m is not None:
            kernels.require(m, "masks", torch.bool, dev)
    if any(x.shape[0] != n for x in [gid, *values,
                                     *[m for m in masks if m is not None]]):
        raise ValueError("values, masks, valid and gid differ in length")
    sums = (torch.empty((k, num_segments), dtype=dtype, device=dev)
            if k else None)
    vcounts = (torch.empty((k, num_segments), dtype=torch.int64, device=dev)
               if k and value_counts else None)
    count = (torch.empty(num_segments, dtype=torch.int64, device=dev)
             if with_count else None)
    vptrs = (ctypes.c_void_p * K4_MAX_VECTORS)(
        *[v.data_ptr() for v in values])
    mptrs = (ctypes.c_void_p * K4_MAX_VECTORS)(
        *[None if m is None else m.data_ptr() for m in masks])
    runs = seg_sum_route(k, num_segments, _SORTED_GIDS.get(),
                         kernels.smem_optin(valid)) == "runs"
    _build.check(_build.lib().srtpu_seg_sum_count(
        int(dtype == torch.float64), k, vptrs, mptrs, valid.data_ptr(),
        gid.data_ptr(), n, num_segments, _ptr(sums), _ptr(vcounts),
        _ptr(count), int(not runs), kernels.sm_count(valid),
        kernels.stream_ptr(valid)), "seg_sum_count")
    kernels.launches["seg_sum_count"] += 1
    if runs:
        kernels.launches["seg_sum_count_runs"] += 1
    sums_l = [] if sums is None else list(sums.unbind(0))
    vcounts_l = [] if vcounts is None else list(vcounts.unbind(0))
    return SegSums(sums_l, vcounts_l if value_counts else None, count)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def seg_count(valid: torch.Tensor, gid: torch.Tensor,
              cap: int) -> torch.Tensor:
    return seg_sum_count_multi([], valid, gid, cap).count


def seg_sum(values: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor,
            cap: int) -> torch.Tensor:
    return seg_sum_count_multi([values], valid, gid, cap,
                               with_count=False).sums[0]


def seg_sum_count(values: torch.Tensor, valid: torch.Tensor,
                  gid: torch.Tensor, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(segmented sum, segmented count) of the same masked rows, in one
    pass over them."""
    out = seg_sum_count_multi([values], valid, gid, cap)
    return out.sums[0], out.count


# ------------------------------------------------------------------ K12

#: K12's value types (SegType in kernels/csrc/seg_minmax.cu)
_SEG_TYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
             torch.float64: 3}
#: a float type's integer twin, for the order-preserving keys
_FLOAT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
_CANONICAL_NAN = {torch.float32: 0x7FC00000, torch.float64: 0x7FF8000000000000}


def _minmax_ident(dtype: torch.dtype, is_max: bool):
    """The reference's identity: -inf/+inf, or the integer min/max."""
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _float_keys(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Integer keys whose signed order is the float order jax's
    segment_min/max keep on the CPU: -0.0 below 0.0, and NaN absorbing
    (the smallest key for a minimum, the largest for a maximum)."""
    ity = _FLOAT_BITS[x.dtype]
    info = torch.iinfo(ity)
    b = x.view(ity)
    k = b ^ ((b >> (info.bits - 1)) & info.max)
    return torch.where(torch.isnan(x),
                       torch.full_like(k, info.max if is_max else info.min),
                       k)


def _float_unkeys(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_float_keys`; a NaN key becomes the canonical NaN."""
    info = torch.iinfo(k.dtype)
    b = k ^ ((k >> (info.bits - 1)) & info.max)
    nan = (k == info.max) | (k == info.min)
    b = torch.where(nan, torch.full_like(b, _CANONICAL_NAN[dtype]), b)
    return b.view(dtype)


def seg_minmax_plain(values: torch.Tensor, valid: Optional[torch.Tensor],
                     gid: torch.Tensor, cap: int,
                     is_max: bool) -> torch.Tensor:
    """Plain PyTorch version of K12: the reference's where(valid, values,
    ident) and a scatter-min (-max) over [0, cap), ids outside it dropped
    (a spare slot `cap` takes them and is cut off); floats reduce as K12
    does, over their order-preserving integer keys."""
    ident = _minmax_ident(values.dtype, is_max)
    masked = values if valid is None else torch.where(
        valid, values, torch.full_like(values, ident))
    inr = (gid >= 0) & (gid < cap)
    idx = torch.where(inr, gid, cap).to(torch.int64)
    reduce = "amax" if is_max else "amin"
    if values.dtype.is_floating_point:
        keys = _float_keys(masked, is_max)
        ikey = _float_keys(torch.full((1,), ident, dtype=values.dtype,
                                      device=values.device), is_max)
        out = ikey.expand(cap + 1).clone().scatter_reduce_(0, idx, keys,
                                                           reduce)
        return _float_unkeys(out[:cap].contiguous(), values.dtype)
    out = torch.full((cap + 1,), ident, dtype=values.dtype,
                     device=values.device).scatter_reduce_(0, idx, masked,
                                                           reduce)
    return out[:cap].contiguous()


def _seg_minmax(values: torch.Tensor, valid: Optional[torch.Tensor],
                gid: torch.Tensor, cap: int, is_max: bool) -> torch.Tensor:
    """Kernel K12: out[s] = min (max) over rows with gid s of
    (valid ? value : ident), ident where no row names s, for rows whose gid
    lies in [0, cap). `valid` None means every row. Sorted gid (the
    default, `_SORTED_GIDS`) takes the kernel's run-wise path, unsorted
    gid one atomic a row."""
    if values.device.type == "cpu":
        return seg_minmax_plain(values, valid, gid, cap, is_max)
    dev = values.device
    kind = _SEG_TYPE.get(values.dtype)
    if kind is None:
        raise TypeError(f"K12 reduces int32, int64, float32 or float64, "
                        f"got {values.dtype}")
    kernels.require(values, "values", values.dtype, dev)
    kernels.require(gid, "gid", torch.int32, dev)
    n = int(values.shape[0])
    if valid is not None:
        kernels.require(valid, "valid", torch.bool, dev)
    if gid.shape[0] != n or (valid is not None and valid.shape[0] != n):
        raise ValueError("values, valid and gid differ in length")
    if cap < 1:
        raise ValueError(f"K12 needs at least one segment, got {cap}")
    out = torch.empty(cap, dtype=values.dtype, device=dev)
    _build.check(_build.lib().srtpu_seg_minmax(
        kind, int(is_max), values.data_ptr(), _ptr(valid), gid.data_ptr(),
        n, cap, out.data_ptr(), int(_SORTED_GIDS.get()),
        kernels.sm_count(values), kernels.stream_ptr(values)), "seg_minmax")
    kernels.launches["seg_minmax"] += 1
    return out


def seg_min(values: torch.Tensor, valid: Optional[torch.Tensor],
            gid: torch.Tensor, cap: int) -> torch.Tensor:
    return _seg_minmax(values, valid, gid, cap, is_max=False)


def seg_max(values: torch.Tensor, valid: Optional[torch.Tensor],
            gid: torch.Tensor, cap: int) -> torch.Tensor:
    return _seg_minmax(values, valid, gid, cap, is_max=True)


def seg_first(values: torch.Tensor,
              first_pos_valid: torch.Tensor) -> torch.Tensor:
    """First (by sorted position) value per segment: the caller supplies
    per-group positions; they are clipped into range, as jnp.take clips
    (K8's gather in its clamp mode)."""
    return gather_leaves([values], [first_pos_valid.to(torch.int32)],
                         clamp=True)[0]


def dense_bin_perm_plain(occupied: torch.Tensor,
                         cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K11: the reference's cumsum plus a scatter
    whose unoccupied bins write to a spare slot `cap` that is sliced off
    (its mode="drop"), and the occupied count as int32."""
    dense = torch.cumsum(occupied.to(torch.int32), 0, dtype=torch.int32) - 1
    target = torch.where(occupied, dense, cap).to(torch.int64)
    out = torch.zeros(cap + 1, dtype=torch.int32, device=occupied.device)
    out[target] = torch.arange(cap, dtype=torch.int32,
                               device=occupied.device)
    return out[:cap], occupied.sum().to(torch.int32)


def dense_bin_perm(occupied: torch.Tensor,
                   cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K11: (gather permutation mapping dense group position j ->
    the j-th occupied bin, positions past the count holding 0; the count
    of occupied bins, a 0-dim int32 tensor)."""
    if occupied.device.type == "cpu":
        return dense_bin_perm_plain(occupied, cap)
    dev = occupied.device
    kernels.require(occupied, "occupied", torch.bool, dev)
    if occupied.shape[0] != cap:
        raise ValueError(f"occupied has {occupied.shape[0]} bins, cap {cap}")
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    tiles = -(-cap // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_dense_bin_perm(
        occupied.data_ptr(), cap, out.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), 0, kernels.stream_ptr(occupied)),
        "dense_bin_perm")
    kernels.launches["dense_bin_perm"] += 1
    return out, count


class GroupBounds(NamedTuple):
    """K10's outputs: the segment structure of rows in sorted order."""

    gid: torch.Tensor          # [n] int32
    live: torch.Tensor         # [n] bool, sorted order
    num_groups: torch.Tensor   # 0-d int32
    first_pos: torch.Tensor    # [n] int32


def group_bounds_plain(words: torch.Tensor, perm: torch.Tensor,
                       live: torch.Tensor) -> GroupBounds:
    """Plain PyTorch version of K10: the reference's takes of the key
    words, adjacent-row equality, cumsum and segment_min."""
    cap = int(perm.shape[0])
    p64 = perm.to(torch.int64)
    sorted_keys = [w.index_select(0, p64) for w in words.unbind(0)]
    live_s = live.index_select(0, p64)
    eq = rows_equal_adjacent(sorted_keys)
    boundary = live_s & ~eq
    gid = (torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32)
           - 1).clamp(0, cap - 1)
    num_groups = boundary.sum().to(torch.int32)
    pos = torch.arange(cap, dtype=torch.int32, device=perm.device)
    first_pos = torch.full((cap,), _I32_MAX, dtype=torch.int32,
                           device=perm.device).scatter_reduce_(
        0, gid.to(torch.int64), torch.where(live_s, pos, cap), "amin")
    return GroupBounds(gid, live_s, num_groups, first_pos)


def group_bounds(words: torch.Tensor, perm: torch.Tensor,
                 live: torch.Tensor) -> GroupBounds:
    """Kernel K10: for rows sorted by `perm` over key words [nwords, n]
    int64, the segment id of each sorted row, the sorted live mask, the
    number of groups and each group's first sorted position (INT32_MAX
    past the groups, as segment_min leaves an empty segment)."""
    if perm.device.type == "cpu":
        return group_bounds_plain(words, perm, live)
    dev = perm.device
    kernels.require(words, "words", torch.int64, dev, ndim=2)
    kernels.require(perm, "perm", torch.int32, dev)
    kernels.require(live, "live", torch.bool, dev)
    nwords, n = int(words.shape[0]), int(words.shape[1])
    if perm.shape[0] != n or live.shape[0] != n or n == 0:
        raise ValueError(f"words {tuple(words.shape)}, perm "
                         f"{tuple(perm.shape)} and live {tuple(live.shape)} "
                         "differ")
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    live_s = torch.empty(n, dtype=torch.bool, device=dev)
    num_groups = torch.empty((), dtype=torch.int32, device=dev)
    first_pos = torch.empty(n, dtype=torch.int32, device=dev)
    tiles = -(-n // kernels.TILE_ROWS)
    scratch = torch.empty(((n + 15) // 16) * 4 + 2 * tiles,
                          dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_group_bounds(
        words.data_ptr(), nwords, n, perm.data_ptr(), live.data_ptr(),
        gid.data_ptr(), live_s.data_ptr(), num_groups.data_ptr(),
        first_pos.data_ptr(), scratch.data_ptr(), kernels.stream_ptr(perm)),
        "group_bounds")
    kernels.launches["group_bounds"] += 1
    return GroupBounds(gid, live_s, num_groups, first_pos)


def group_by(batch: ColumnBatch, key_idxs: Sequence[int],
             live: Optional[torch.Tensor] = None) -> GroupedBatch:
    cap = batch.capacity
    device = batch.device
    if live is None:
        live = batch.live_mask()
    if not key_idxs:
        # global aggregation: every live row in segment 0
        zeros = torch.zeros(cap, dtype=torch.int32, device=device)
        return GroupedBatch(batch, zeros, live,
                            torch.ones((), dtype=torch.int32, device=device),
                            zeros)
    # grouping is a single-batch equality context: encoded keys group on
    # their codes; float keys fold -0.0 into 0.0
    words, _ = pack_keys([KeySpec(batch.columns[i], codes_ok=True,
                                  normalize_zero=True) for i in key_idxs],
                         live)
    perm = sort_words(words)
    gb = group_bounds(words, perm, live)
    sorted_batch = batch.gather(perm, batch.num_rows)
    return GroupedBatch(sorted_batch, gb.gid, gb.live, gb.num_groups,
                        gb.first_pos)
