"""Sort-based grouping and segmented reductions — counterpart of
`spark_rapids_tpu/ops/segmented.py`.

`seg_sum_count_multi` is kernel K4 (kernels/csrc/seg_sum_count.cu): k <= 4
segmented sums, each under its own mask and with its own count, plus a row
count, in one pass over the rows; `seg_count`, `seg_sum` and
`seg_sum_count` are its three simple shapes, and the binned aggregate's
partial takes all its reductions from one launch. The reference's TPU
route (f32-chunk one-hot matmuls on the MXU) is a TPU limit and is not
copied: int64 sums are exact, float64 sums are exact up to summation
order.

`group_by` (the sorted path) packs its key words and sorts them with
kernel K9 (ops/common.py), derives the segment structure with K10
(`group_bounds`, kernels/csrc/group_bounds.cu) and gathers the batch with
K8; the binned path's bins become dense group positions through K11
(`dense_bin_perm`, kernels/csrc/dense_bin_perm.cu). `seg_min` is not on
any ported path and stays plain torch (B2b in the port's kernel table).
"""

from __future__ import annotations

import contextvars
import ctypes
from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
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
# sorted. K4 reads this to choose its strategy: unsorted ids privatise
# bins per block in shared memory; sorted ids hit few bins per block and
# add straight into device memory. A ContextVar, as in the reference.
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


def seg_sum_count_multi(values: Sequence[torch.Tensor], valid: torch.Tensor,
                        gid: torch.Tensor, num_segments: int,
                        masks: Optional[Sequence[Optional[torch.Tensor]]]
                        = None, with_count: bool = True,
                        value_counts: bool = False) -> SegSums:
    """Kernel K4, in one pass over the rows with `valid` and
    0 <= gid < num_segments: the segmented sums of k <= 4 value vectors
    (all int64 or all float64), each over the rows its mask admits
    (`masks[j]`, None for all of them), with `value_counts` the number of
    rows each sum took, and with `with_count` the count of the rows."""
    if valid.device.type == "cpu":
        return seg_sum_count_plain(values, valid, gid, num_segments, masks,
                                   with_count, value_counts)
    dev = valid.device
    k = len(values)
    if k > 4:
        raise ValueError(f"K4 sums at most 4 vectors, got {k}")
    masks = list(masks) if masks is not None else [None] * k
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
    vptrs = (ctypes.c_void_p * 4)(*[v.data_ptr() for v in values])
    mptrs = (ctypes.c_void_p * 4)(
        *[None if m is None else m.data_ptr() for m in masks])
    _build.check(_build.lib().srtpu_seg_sum_count(
        int(dtype == torch.float64), k, vptrs, mptrs, valid.data_ptr(),
        gid.data_ptr(), n, num_segments, _ptr(sums), _ptr(vcounts),
        _ptr(count), int(not _SORTED_GIDS.get()), kernels.sm_count(valid),
        kernels.smem_optin(valid), kernels.stream_ptr(valid)),
        "seg_sum_count")
    kernels.launches["seg_sum_count"] += 1
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


def seg_min(values: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor,
            cap: int) -> torch.Tensor:
    if values.dtype.is_floating_point:
        ident = float("inf")
    else:
        ident = torch.iinfo(values.dtype).max
    masked = torch.where(valid, values, torch.full_like(values, ident))
    return torch.full((cap,), ident, dtype=values.dtype,
                      device=values.device).scatter_reduce_(
        0, gid.to(torch.int64), masked, "amin")


def dense_bin_perm_plain(occupied: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain PyTorch version of K11: the reference's cumsum plus a scatter
    whose unoccupied bins write to a spare slot `cap` that is sliced off
    (its mode="drop")."""
    dense = torch.cumsum(occupied.to(torch.int32), 0, dtype=torch.int32) - 1
    target = torch.where(occupied, dense, cap).to(torch.int64)
    out = torch.zeros(cap + 1, dtype=torch.int32, device=occupied.device)
    out[target] = torch.arange(cap, dtype=torch.int32,
                               device=occupied.device)
    return out[:cap]


def dense_bin_perm(occupied: torch.Tensor, cap: int) -> torch.Tensor:
    """Kernel K11: gather permutation mapping dense group position j -> the
    j-th occupied bin (positions past num_groups hold 0)."""
    if occupied.device.type == "cpu":
        return dense_bin_perm_plain(occupied, cap)
    dev = occupied.device
    kernels.require(occupied, "occupied", torch.bool, dev)
    if occupied.shape[0] != cap:
        raise ValueError(f"occupied has {occupied.shape[0]} bins, cap {cap}")
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    tiles = -(-cap // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_dense_bin_perm(
        occupied.data_ptr(), cap, out.data_ptr(), scratch.data_ptr(),
        kernels.stream_ptr(occupied)), "dense_bin_perm")
    kernels.launches["dense_bin_perm"] += 1
    return out


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
