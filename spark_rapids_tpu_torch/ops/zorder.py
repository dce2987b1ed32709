"""Z-order (Morton) clustering keys — counterpart of
`spark_rapids_tpu/ops/zorder.py`: maps several columns onto a
space-filling curve, so that range filters on any of them prune files
once a table is sorted by the curve (Delta's OPTIMIZE ZORDER BY).

Each column is ranked by a sort (`column_ranks`: K9's key words and
stable sort, then K14's inverse permutation, the reference's
`.at[perm].set(arange)`); the top bits of the ranks interleave
round-robin into one int64 key (`interleave_bits`, kernel K36,
kernels/csrc/zorder.cu); the batch sorts by (dead row, key) through K9
and gathers through K8 (`zorder_sort`).

What the reference computes, kept here:
- a rank is a row's POSITION in the column's stable sort order (nulls
  first, dead rows last), not a dense rank: tied values get consecutive
  ranks in row order (the reference's docstring says "dense rank");
- the rank width comes from the batch's capacity:
  max(1, (capacity - 1).bit_length()) bits;
- the top use = min(rank_bits, max(1, 63 // n)) bits of each of n ranks
  survive; bit b of column c lands at position b * n + c, and a position
  of 64 or more gives nothing (XLA shifts it out; column 63 of n >= 64
  lands on the sign bit).

Ranks are int32 here (the reference's are int64): a capacity is at most
2^31 rows.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.common import orderable_keys, sort_permutation
from spark_rapids_tpu_torch.ops.windowops import inverse_permutation


def column_ranks(batch: ColumnBatch, ordinal: int) -> torch.Tensor:
    """[capacity] int32: each row's position in the column's stable sort
    order (nulls first); dead rows rank last."""
    live = batch.live_mask()
    col = batch.columns[ordinal]
    keys = orderable_keys(col, True, True, live)
    perm = sort_permutation(keys, batch.capacity)
    return inverse_permutation(perm)


def _widths(n: int, rank_bits: int):
    use = min(rank_bits, max(1, 63 // n))
    return use, max(0, rank_bits - use)


def interleave_bits_plain(ranks: List[torch.Tensor],
                          rank_bits: int) -> torch.Tensor:
    """Plain PyTorch version of K36: the reference's double loop in
    int64."""
    n = len(ranks)
    use, shift = _widths(n, rank_bits)
    z = torch.zeros(ranks[0].shape, dtype=torch.int64,
                    device=ranks[0].device)
    for b in range(use):
        for c, r in enumerate(ranks):
            pos = b * n + c
            if pos >= 64:
                continue  # XLA shifts a bit this far out to 0
            bit = ((r.to(torch.int64) >> shift) >> b) & 1
            z = z | (bit << pos)
    return z


def interleave_bits(ranks: List[torch.Tensor],
                    rank_bits: int) -> torch.Tensor:
    """Kernel K36 (`ops/zorder.py:34`): the int64 Morton key of the top
    bits of n [rows] int32 rank vectors on one device, the ranks spanning
    [0, 2^rank_bits)."""
    first = ranks[0]
    if first.device.type == "cpu":
        return interleave_bits_plain(ranks, rank_bits)
    dev = first.device
    n_rows = int(first.shape[0])
    for k, r in enumerate(ranks):
        kernels.require(r, f"ranks[{k}]", torch.int32, dev)
        if int(r.shape[0]) != n_rows:
            raise ValueError(f"ranks[{k}]: {r.shape[0]} rows, expected "
                             f"{n_rows}")
    use, shift = _widths(len(ranks), rank_bits)
    if shift > 62:
        raise ValueError(f"rank_bits {rank_bits}: ranks are int32")
    # the columns' addresses, which the launch takes by value
    ptrs = (ctypes.c_void_p * len(ranks))(*[r.data_ptr() for r in ranks])
    out = torch.empty(n_rows, dtype=torch.int64, device=dev)
    _build.check(_build.lib().srtpu_zorder_interleave(
        ctypes.cast(ptrs, ctypes.c_void_p), len(ranks), n_rows, use, shift,
        out.data_ptr(), kernels.sm_count(first), kernels.stream_ptr(first)),
        "zorder_interleave")
    kernels.launches["zorder_interleave"] += 1
    return out


def zorder_sort(batch: ColumnBatch, ordinals: List[int]) -> ColumnBatch:
    """The batch sorted along the Morton curve of the given columns (live
    rows first, ties in row order)."""
    ranks = [column_ranks(batch, i) for i in ordinals]
    z = interleave_bits(ranks, max(1, (batch.capacity - 1).bit_length()))
    dead = (~batch.live_mask()).to(torch.int64)
    perm = sort_permutation([dead, z], batch.capacity)
    return batch.gather(perm, batch.num_rows)
