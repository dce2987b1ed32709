"""On-device partitioning for the shuffle — counterpart of
`hash_partition_ids` and `partition_by_ids` in
`spark_rapids_tpu/ops/partition.py`.

Rows get a partition id (murmur3 Pmod, as CPU Spark assigns them: kernel
K6), then a stable sort by id puts each partition in one contiguous row
range, dead rows last, with the live rows counted per partition (kernel
K7, kernels/csrc/partition_by_ids.cu). The map side of the exchange keeps
the sorted batch plus the offsets the counts give; `split_to_slices`
cuts a batch into one batch per partition the same way. Round-robin
partitioning (`round_robin_partition`) computes each live row's
partition, (row + start) % n, inside the same counting sort (kernel K28,
a mode of K7) and reads no id tensor.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    next_capacity,
    row_mask,
)
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.common import sort_permutation_plain
from spark_rapids_tpu_torch.ops.hashing import murmur3_pmod


class PartitionedBatch(NamedTuple):
    batch: ColumnBatch      # rows grouped by partition id, dead rows last
    counts: torch.Tensor    # [num_partitions] int32 rows per partition


def hash_partition_ids(batch: ColumnBatch, key_idxs: Sequence[int],
                       num_partitions: int) -> torch.Tensor:
    cols = [batch.columns[i] for i in key_idxs]
    return murmur3_pmod(cols, num_partitions)


def partition_perm_plain(pid: torch.Tensor, num_rows, num_partitions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7: the reference's stable sort of
    key = live ? pid : num_partitions, and a segment sum of the live rows
    by clipped pid."""
    cap = int(pid.shape[0])
    live = row_mask(cap, num_rows, pid.device)
    key = torch.where(live, pid, num_partitions).to(torch.int64)
    perm = sort_permutation_plain([key], cap)
    idx = pid.clamp(0, num_partitions - 1).to(torch.int64)
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=pid.device).scatter_add_(
        0, idx, live.to(torch.int32))
    return perm, counts


def partition_perm(pid: torch.Tensor, num_rows: Union[int, torch.Tensor],
                   num_partitions: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K7: (perm [cap] int32, counts [num_partitions] int32). A live
    row's pid must lie in [0, num_partitions) on the card."""
    if pid.device.type == "cpu":
        return partition_perm_plain(pid, num_rows, num_partitions)
    dev = pid.device
    kernels.require(pid, "pid", torch.int32, dev)
    n = int(pid.shape[0])
    nrows_dev, nrows_host = None, 0
    if isinstance(num_rows, torch.Tensor):
        nrows_dev = num_rows.to(torch.int32)
        kernels.require(nrows_dev, "num_rows", torch.int32, dev, ndim=0)
    else:
        nrows_host = int(num_rows)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(num_partitions, dtype=torch.int32, device=dev)
    tiles = -(-n // 1024)
    scratch = torch.empty(2 * (num_partitions + 1) * tiles + 1,
                          dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_partition_by_ids(
        pid.data_ptr(), n,
        None if nrows_dev is None else nrows_dev.data_ptr(), nrows_host,
        num_partitions, perm.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), kernels.stream_ptr(pid)), "partition_by_ids")
    kernels.launches["partition_by_ids"] += 1
    return perm, counts


def partition_by_ids(batch: ColumnBatch, pid: torch.Tensor,
                     num_partitions: int) -> PartitionedBatch:
    perm, counts = partition_perm(pid, batch.num_rows, num_partitions)
    return PartitionedBatch(batch.gather(perm, batch.num_rows), counts)


def round_robin_perm_plain(cap: int, num_rows, num_partitions: int,
                           start: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K28: the reference's pid = (arange(cap) +
    start) % n, then K7's plain version."""
    device = (num_rows.device if isinstance(num_rows, torch.Tensor)
              else torch.device("cpu"))
    pid = ((torch.arange(cap, dtype=torch.int64, device=device) + start)
           % num_partitions).to(torch.int32)
    return partition_perm_plain(pid, num_rows, num_partitions)


def round_robin_perm(cap: int, num_rows: Union[int, torch.Tensor],
                     num_partitions: int, start: int = 0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K28: K7's (perm, counts) for pid = (row + start) %
    num_partitions, computed inside the kernel. `device` is the batch's
    (num_rows may be a host int)."""
    device = torch.device(device) if device is not None else (
        num_rows.device if isinstance(num_rows, torch.Tensor)
        else torch.device("cpu"))
    if device.type == "cpu":
        return round_robin_perm_plain(cap, num_rows, num_partitions, start)
    perm = torch.empty(cap, dtype=torch.int32, device=device)
    dev = perm.device
    nrows_dev, nrows_host = None, 0
    if isinstance(num_rows, torch.Tensor):
        nrows_dev = num_rows.to(device=dev, dtype=torch.int32)
        kernels.require(nrows_dev, "num_rows", torch.int32, dev, ndim=0)
    else:
        nrows_host = int(num_rows)
    counts = torch.empty(num_partitions, dtype=torch.int32, device=dev)
    tiles = -(-cap // 1024)
    scratch = torch.empty(2 * (num_partitions + 1) * tiles + 1,
                          dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_round_robin_partition(
        cap, None if nrows_dev is None else nrows_dev.data_ptr(), nrows_host,
        num_partitions, int(start), perm.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), kernels.stream_ptr(perm)),
        "round_robin_partition")
    kernels.launches["round_robin_partition"] += 1
    return perm, counts


def round_robin_partition(batch: ColumnBatch, num_partitions: int,
                          start: int = 0) -> PartitionedBatch:
    """The reference's round_robin_partition (GpuRoundRobinPartitioning):
    live row i goes to partition (i + start) % num_partitions."""
    perm, counts = round_robin_perm(batch.capacity, batch.num_rows,
                                    num_partitions, start, batch.device)
    return PartitionedBatch(batch.gather(perm, batch.num_rows), counts)


def hash_partition(batch: ColumnBatch, key_idxs: Sequence[int],
                   num_partitions: int) -> PartitionedBatch:
    pid = hash_partition_ids(batch, key_idxs, num_partitions)
    return partition_by_ids(batch, pid, num_partitions)


# Distinct from the shuffle's seed-42 partitioning so re-partitioning
# data that already went through an exchange is non-degenerate.
SUB_PARTITION_SEED = 1091


def split_to_slices(batch: ColumnBatch, key_idxs: Sequence[int],
                    num_partitions: int,
                    seed: int) -> List[Optional[ColumnBatch]]:
    """Key-hash split into per-partition device batches (None for empty
    parts) — the sub-partitioning of an oversized final aggregate."""
    cols = [batch.columns[i] for i in key_idxs]
    pid = murmur3_pmod(cols, num_partitions, seed)
    pb = partition_by_ids(batch, pid, num_partitions)
    offs = np.concatenate(
        [[0], np.cumsum(pb.counts.cpu().numpy().astype(np.int64))])
    out: List[Optional[ColumnBatch]] = []
    for k in range(num_partitions):
        lo, hi = int(offs[k]), int(offs[k + 1])
        if hi <= lo:
            out.append(None)
            continue
        cap = next_capacity(hi - lo)
        idx = (torch.arange(cap, dtype=torch.int32, device=batch.device)
               + lo).clamp(0, batch.capacity - 1)
        out.append(pb.batch.gather(idx, hi - lo))
    return out
