"""Filter compaction — counterpart of `spark_rapids_tpu/ops/filterops.py`.

`compact_perm` is kernel K1 (kernels/csrc/compact_perm.cu): a stable
partition of the keep mask, kept rows first; the batch then gathers by
the permutation and carries the kept count as its row count. `slice_head`
(LIMIT) moves no data.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
from spark_rapids_tpu_torch.kernels import build as _build


def compact_perm_plain(keep: torch.Tensor,
                       cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the reference's cumsum plus inverse
    scatter. Returns (perm [cap] int32, n_keep 0-d int32)."""
    k32 = keep.to(torch.int32)
    n_keep = k32.sum().to(torch.int32)
    pos_keep = torch.cumsum(k32, 0, dtype=torch.int32) - 1
    pos_drop = n_keep + torch.cumsum(1 - k32, 0, dtype=torch.int32) - 1
    positions = torch.where(keep, pos_keep, pos_drop)
    # positions is a bijection on [0, cap): invert it by scatter
    perm = torch.empty(cap, dtype=torch.int32, device=keep.device)
    perm[positions.to(torch.int64)] = torch.arange(
        cap, dtype=torch.int32, device=keep.device)
    return perm, n_keep


def compact_perm(keep: torch.Tensor,
                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition gather permutation: rows with keep land first in
    row order, dropped rows after. Returns (perm [cap] int32, n_keep 0-d
    int32, left on the device); out = batch.gather(perm, n_keep)."""
    if keep.device.type == "cpu":
        return compact_perm_plain(keep, cap)
    kernels.require(keep, "keep", torch.bool, keep.device)
    if keep.shape[0] != cap:
        raise ValueError(f"keep has {keep.shape[0]} rows, cap is {cap}")
    perm = torch.empty(cap, dtype=torch.int32, device=keep.device)
    n_keep = torch.empty((), dtype=torch.int32, device=keep.device)
    tiles = -(-cap // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles, dtype=torch.int32, device=keep.device)
    _build.check(_build.lib().srtpu_compact_perm(
        keep.data_ptr(), cap, perm.data_ptr(), n_keep.data_ptr(),
        scratch.data_ptr(), kernels.stream_ptr(keep)), "compact_perm")
    kernels.launches["compact_perm"] += 1
    return perm, n_keep


def compact(batch: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    """Keep rows where `keep` (and logically live); preserves order."""
    keep = keep & batch.live_mask()
    perm, new_rows = compact_perm(keep, batch.capacity)
    return batch.gather(perm, new_rows)


def slice_head(batch: ColumnBatch, n: int) -> ColumnBatch:
    """LIMIT n: logical truncation only — no data movement (a row count
    left on the device stays there)."""
    nr = batch.num_rows
    new_rows = (min(nr, int(n)) if isinstance(nr, int)
                else nr.clamp(max=int(n)).to(torch.int32))
    return ColumnBatch(batch.schema, batch.columns, new_rows)
