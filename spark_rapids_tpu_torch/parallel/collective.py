"""The mesh engine's collectives — counterpart of
`spark_rapids_tpu/parallel/collective.py`.

The reference moves a shuffle between the shards of one shard_map'd
program with `lax.all_to_all` over a `jax.sharding.Mesh` axis. In the
port a mesh is an ordered list of torch devices (`parallel/mesh_exec.py`)
and a sharded batch is the list of its shards' `ColumnBatch`es, one a
mesh position; a collective takes that list and returns a new one, in one
process that drives every device (as one JAX process drives every chip of
a 1D mesh).

- `all_to_all_batch`: row i of shard s moves to shard pids[s][i]. The send
  side is kernel K37 (`exchange_slots`, kernels/csrc/exchange_slots.cu):
  each live row's FIFO rank within its destination, the source row and
  live mark of every [n_dest, slot] send slot, the send counts and the
  overflow flag, exactly as the reference's one-hot cumsum ranks them.
  One K8 launch (a launch per 32 leaves) then writes every leaf of the
  shard into its blocks, zeroing the dead slots. Where a destination sits
  on the source's device, the blocks are written straight into the
  destination's [n_src, slot] receive buffer: nothing is copied between
  devices. Where it does not, they land in a send buffer that
  `Tensor.copy_` moves to the destination device (a peer copy). The
  receive side compacts as the reference does: slot j of source s is live
  iff j < recv_counts[s], then K1 and K8.
- `all_gather_batch`: every shard's live rows on every device, concatenated
  in shard order (K1 and K8), made once a device and shared by the shards
  on it; `gather_to_one` keeps them on shard 0 only.

Rows past a destination's slot are dropped and flagged, so callers size
slots with `slot_capacity` and retry with a larger one when a flag is
set. Encoded columns move their codes only; each device keeps one copy of
the dictionary, shared by every shard on it. Multi-process transport
(NCCL through `torch.distributed`) and the reference's ICI byte tape,
which feeds the transfer ledger, are not ported yet (ROADMAP A16, A17);
`stats` counts the collectives and the bytes they write.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar import encoding as _enc
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_compacted,
    gather_leaves,
    pad_trailing,
    row_mask,
)
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops import filterops

#: collectives run and bytes written into their receive buffers since the
#: last `reset_stats()`
stats: Dict[str, int] = {"all_to_all": 0, "all_gather": 0, "bytes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def slot_capacity(shard_capacity: int, n_devices: int,
                  skew_factor: int = 4) -> int:
    """Static per-destination slot size: expected rows/dest times a skew
    allowance, rounded up to a power of two, capped at shard capacity."""
    expected = max(1, shard_capacity // max(1, n_devices))
    slot = 1
    while slot < expected * skew_factor:
        slot <<= 1
    return min(slot, shard_capacity)


class SendSlots(NamedTuple):
    src_row: torch.Tensor    # [n_dest * slot] int32: the row in each slot
    live: torch.Tensor       # [n_dest * slot] bool: slot holds a row
    counts: torch.Tensor     # [n_dest] int32: min(rows to dest, slot)
    overflow: torch.Tensor   # 0-d bool: some destination passed its slot


def exchange_slots_plain(pid: torch.Tensor, num_rows, n_dest: int,
                         slot: int) -> SendSlots:
    """Plain PyTorch version of K37: the reference's ranks from a cumsum
    over a one-hot of dest = live ? pid : n_dest, its segment sum of the
    live rows, and its scatter of row i to [dest, rank] that drops dead
    rows and ranks past the slot."""
    cap = int(pid.shape[0])
    dev = pid.device
    live = row_mask(cap, num_rows, dev)
    dest = torch.where(live, pid.to(torch.int64), n_dest)
    counts_all = torch.zeros(n_dest + 1, dtype=torch.int64,
                             device=dev).scatter_add_(
        0, dest.clamp(0, n_dest), live.to(torch.int64))
    dclip = dest.clamp(0, n_dest - 1)
    # the one-hot destination-major, so each cumsum runs along a row
    onehot = dest[None, :] == torch.arange(n_dest, device=dev)[:, None]
    cums = torch.cumsum(onehot.to(torch.int32), 1, dtype=torch.int32)
    rank = torch.gather(cums, 0, dclip[None, :])[0].to(torch.int64) - 1
    overflow = (torch.where(live, rank, 0) >= slot).any()
    counts = counts_all[:n_dest].clamp(max=slot).to(torch.int32)
    # dropped rows (dead, or ranked past the slot) land in one spare slot
    ok = live & (rank < slot)
    flat = torch.where(ok, dclip * slot + rank, n_dest * slot)
    src_row = torch.zeros(n_dest * slot + 1, dtype=torch.int32,
                          device=dev).scatter_(
        0, flat, torch.arange(cap, dtype=torch.int32, device=dev))
    src_row = src_row[:-1]
    slot_live = (torch.arange(slot, device=dev)[None, :]
                 < counts[:, None]).reshape(-1)
    return SendSlots(src_row, slot_live, counts, overflow)


def exchange_slots(pid: torch.Tensor, num_rows: Union[int, torch.Tensor],
                   n_dest: int, slot: int) -> SendSlots:
    """Kernel K37: the send slots of one shard. pid [cap] int32, each live
    row's in [0, n_dest) on the card; num_rows a host int or a 0-d device
    tensor (read by the kernel: no host sync)."""
    if pid.device.type == "cpu":
        return exchange_slots_plain(pid, num_rows, n_dest, slot)
    dev = pid.device
    kernels.require(pid, "pid", torch.int32, dev)
    n = int(pid.shape[0])
    nrows_dev, nrows_host = None, 0
    if isinstance(num_rows, torch.Tensor):
        nrows_dev = num_rows.to(torch.int32)
        kernels.require(nrows_dev, "num_rows", torch.int32, dev, ndim=0)
    else:
        nrows_host = int(num_rows)
    src_row = torch.empty(n_dest * slot, dtype=torch.int32, device=dev)
    live = torch.empty(n_dest * slot, dtype=torch.bool, device=dev)
    counts = torch.empty(n_dest, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    tiles = -(-n // 1024)
    scratch = torch.empty(2 * (n_dest + 1) * tiles + 1, dtype=torch.int32,
                          device=dev)
    _build.check(_build.lib().srtpu_exchange_slots(
        pid.data_ptr(), n,
        None if nrows_dev is None else nrows_dev.data_ptr(), nrows_host,
        n_dest, slot, src_row.data_ptr(), live.data_ptr(),
        counts.data_ptr(), overflow.data_ptr(), scratch.data_ptr(),
        kernels.stream_ptr(pid)), "exchange_slots")
    kernels.launches["exchange_slots"] += 1
    return SendSlots(src_row, live, counts, overflow)


def _exchange_column(col: DeviceColumn, leaves: Sequence[torch.Tensor],
                     device: torch.device) -> DeviceColumn:
    """`col`'s exchanged leaves as a column on `device`: an encoded
    column moved its codes only and takes the device's copy of its
    dictionary (the reference holds the dictionary back the same way)."""
    out = col.with_leaves(list(leaves))
    enc = col.encoding
    if enc is not None and enc.data.device != device:
        out = out.replace(encoding=_enc.device_dictionary(enc.dict_id,
                                                          device))
    return out


def _aligned_columns(shards: Sequence[ColumnBatch]
                     ) -> List[List[DeviceColumn]]:
    """Each shard's columns with one dictionary a column across shards (a
    column whose shards' dictionaries differ decodes) and every leaf's
    trailing axes padded to the widest shard's, so every shard's rows fit
    one receive buffer."""
    out = [list(b.columns) for b in shards]
    for ci in range(len(shards[0].columns)):
        cols = [cs[ci] for cs in out]
        if any(c.encoding is not None for c in cols):
            cols = _enc.align_encodings(cols)
        leaves = [c.leaves() for c in cols]
        widths = [tuple(max(int(ls[li].shape[ax]) for ls in leaves)
                        for ax in range(1, leaves[0][li].dim()))
                  for li in range(len(leaves[0]))]
        for s, (c, ls) in enumerate(zip(cols, leaves)):
            out[s][ci] = c.with_leaves([pad_trailing(x, w)
                                        for x, w in zip(ls, widths)])
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a == b


def all_to_all_batch(shards: Sequence[ColumnBatch],
                     pids: Sequence[torch.Tensor], n_dest: int, slot: int
                     ) -> Tuple[List[ColumnBatch], List[torch.Tensor]]:
    """Exchange rows so that live row i of shard s lands on shard
    pids[s][i] (one list entry a mesh position: n_dest shards). Returns
    (the received shards, each source's overflow flag left on its device).
    A received shard's capacity is n_src * slot, its rows in source order,
    each source's in row order; rows past a destination's slot are
    dropped and raise that source's flag."""
    n_src = len(shards)
    if n_dest != n_src:
        raise ValueError(f"{n_src} shards exchange over {n_dest}")
    cols = _aligned_columns(shards)
    template = cols[0]
    leaf_meta = [(x.dtype, tuple(x.shape[1:]))
                 for c in template for x in c.leaves()]
    devs = [b.device for b in shards]
    recv = [[torch.empty((n_src * slot,) + shape, dtype=dt, device=dev)
             for dt, shape in leaf_meta] for dev in devs]
    counts, flags = [], []
    for s, (b, pid) in enumerate(zip(shards, pids)):
        send = exchange_slots(pid, b.num_rows, n_dest, slot)
        counts.append(send.counts)
        flags.append(send.overflow)
        srcs = [x for c in cols[s] for x in c.leaves()]
        block = slice(s * slot, (s + 1) * slot)
        if all(_same_device(d, b.device) for d in devs):
            # every block straight into its receive buffer: one K8 entry a
            # (destination, leaf), each by its slots' rows and live marks
            idx = [send.src_row[d * slot:(d + 1) * slot]
                   for d in range(n_dest)]
            mask = [send.live[d * slot:(d + 1) * slot]
                    for d in range(n_dest)]
            gather_leaves([x for _ in range(n_dest) for x in srcs],
                          [idx[d] for d in range(n_dest) for _ in srcs],
                          [mask[d] for d in range(n_dest) for _ in srcs],
                          outs=[recv[d][j][block] for d in range(n_dest)
                                for j in range(len(srcs))])
            continue
        sent = gather_leaves(srcs, [send.src_row] * len(srcs),
                             [send.live] * len(srcs))
        for d in range(n_dest):
            for j, x in enumerate(sent):
                recv[d][j][block].copy_(x[d * slot:(d + 1) * slot],
                                        non_blocking=True)
    out = []
    for d, dev in enumerate(devs):
        rc = torch.stack([c[d].to(dev, non_blocking=True) for c in counts])
        pos = torch.arange(slot, dtype=torch.int32, device=dev)
        live = (pos[None, :] < rc[:, None]).reshape(-1)
        perm, total = filterops.compact_perm(live, n_src * slot)
        leaves = iter(recv[d])
        got = [_exchange_column(c, [next(leaves) for _ in c.leaves()], dev)
               for c in template]
        out.append(ColumnBatch(shards[0].schema, got,
                               n_src * slot).gather(perm, total))
    stats["all_to_all"] += 1
    stats["bytes"] += 4 * n_src * n_dest + n_dest * sum(
        x.numel() * x.element_size() for x in recv[0])
    return out, flags


def move_batch(batch: ColumnBatch, device: torch.device) -> ColumnBatch:
    """`batch` on `device` (itself when it is there already): every leaf
    and a device row count copied, an encoded column taking the device's
    copy of its dictionary."""
    if batch.device == device:
        return batch
    cols = [_exchange_column(c, [x.to(device, non_blocking=True)
                                 for x in c.leaves()], device)
            for c in batch.columns]
    nr = batch.num_rows
    if isinstance(nr, torch.Tensor):
        nr = nr.to(device, non_blocking=True)
    return ColumnBatch(batch.schema, cols, nr)


def _gather_on(shards: Sequence[ColumnBatch],
               device: torch.device) -> ColumnBatch:
    """Every shard's live rows in shard order on `device`, compacted to
    the front of a batch of capacity sum(capacities) (K1 and K8)."""
    got = concat_compacted([move_batch(x, device) for x in shards])
    if len(shards) > 1:
        stats["bytes"] += got.device_size_bytes()
    return got


def all_gather_batch(shards: Sequence[ColumnBatch]) -> List[ColumnBatch]:
    """Every shard's live rows on every shard: the broadcast-build
    transport. The batch is made once a device and shared by every shard
    on it."""
    by_dev: Dict[torch.device, ColumnBatch] = {}
    for b in shards:
        if b.device not in by_dev:
            by_dev[b.device] = _gather_on(shards, b.device)
    stats["all_gather"] += 1
    return [by_dev[b.device] for b in shards]


def gather_to_one(shards: Sequence[ColumnBatch]) -> List[ColumnBatch]:
    """Single-partition exchange: every live row moves to shard 0; the
    other shards end up logically empty (their own batches with no
    rows)."""
    first = _gather_on(shards, shards[0].device)
    stats["all_gather"] += 1
    return [first] + [ColumnBatch(b.schema, b.columns, 0)
                      for b in shards[1:]]
