"""Mesh-distributed execution — counterpart of
`spark_rapids_tpu/parallel/mesh_exec.py`.

The reference runs a query stage as one shard_map'd XLA program over a
`jax.sharding.Mesh`. The port's mesh is an ordered list of torch devices,
one a shard, over the one axis `AXIS`; one process drives them all, and a
sharded batch is the list of its shards' batches (`collective.py`).
Several shards may share a device: on the CPU every shard does (the
counterpart of the reference tests' virtual host devices), and
`make_mesh(4, devices=[cuda0] * 4)` puts four shards on one card.

`make_distributed_agg` is the flagship stage: local partial aggregate, a
key-hash all-to-all (K6, K37, K8), final merge. 2D and multi-host meshes
(`make_host_mesh`) are not ported yet (ROADMAP A16).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import encoding as _enc
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch, _concat_columns
from spark_rapids_tpu_torch.ops.hashing import murmur3_pmod
from spark_rapids_tpu_torch.parallel.collective import (
    _exchange_column,
    all_to_all_batch,
    move_batch,
)

AXIS = "data"


class Mesh:
    """A one-dimensional mesh: the device of each shard, in shard order,
    over the axis AXIS."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]

    def __repr__(self):
        return f"Mesh({AXIS}: {[str(d) for d in self.devices]})"


def make_host_mesh(groups) -> Mesh:
    raise NotImplementedError(
        "2D (hosts x chips) and multi-host meshes are not ported yet "
        "(ROADMAP A16)")


def total_shards(mesh: Mesh) -> int:
    return len(mesh.devices)


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """Mesh over the first n visible GPUs, or over the first n entries of
    an explicit device list (a device may repeat: its shards share it)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
    return Mesh(devs)


def replicate_dictionary(mesh: Mesh, dict_id: str
                         ) -> Dict[torch.device, object]:
    """One copy of an interned dictionary a device of the mesh, shared by
    every shard on it."""
    return {d: _enc.device_dictionary(dict_id, d)
            for d in dict.fromkeys(mesh.devices)}


def shard_batch(mesh: Mesh, batch: ColumnBatch) -> List[ColumnBatch]:
    """Split a batch into the mesh's shards: capacity must divide evenly
    by the shard count; rows are contiguous, so shard s holds
    clip(rows - s * shard_cap, 0, shard_cap) live rows. A shard on the
    batch's own device is a view; an encoded column takes its device's
    copy of the dictionary."""
    n = total_shards(mesh)
    if batch.capacity % n:
        raise ValueError(f"capacity {batch.capacity} over {n} shards")
    shard_cap = batch.capacity // n
    rows = batch.row_count()
    per_shard = np.clip(rows - np.arange(n) * shard_cap, 0, shard_cap)
    out = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * shard_cap, (s + 1) * shard_cap
        cols = [_exchange_column(
            c, [x[lo:hi].to(dev, non_blocking=True) for x in c.leaves()],
            dev) for c in batch.columns]
        out.append(ColumnBatch(batch.schema, cols, int(per_shard[s])))
    return out


def read_counts(shards: Sequence[ColumnBatch],
                flags: Sequence = ()) -> Tuple[List[int], bool]:
    """(each shard's row count, whether any flag is set) from one
    device-to-host read: the counts left on the devices and the device
    flags (Python bools are read as they are) go over together."""
    dev = shards[0].device
    vals = []
    for b in shards:
        nr = b.num_rows
        vals.append(nr.reshape(1).to(dev, torch.int32) if isinstance(
            nr, torch.Tensor) else torch.full((1,), int(nr),
                                              dtype=torch.int32, device=dev))
    host_flag = any(f for f in flags if isinstance(f, bool))
    dev_flags = [f for f in flags if isinstance(f, torch.Tensor)]
    vals += [f.reshape(1).to(dev, torch.int32) for f in dev_flags]
    host = fetch_host(torch.cat(vals))
    counts = [int(c) for c in host[:len(shards)]]
    return counts, host_flag or bool(host[len(shards):].any())


def gather_result(out: Sequence[ColumnBatch],
                  counts: Optional[Sequence[int]] = None) -> ColumnBatch:
    """Collect a sharded result into one batch on the first shard's
    device: shard s contributes its first counts[s] rows (read from the
    devices in one go when not given). The batch's capacity is its row
    count, so a download moves the live rows only."""
    if counts is None:
        counts, _ = read_counts(out)
    dev = out[0].device
    pieces = [move_batch(b, dev) for b in out]
    total = int(sum(counts))
    cols = [_concat_columns([(b.columns[ci], c)
                             for b, c in zip(pieces, counts)],
                            total, total, f.dataType)
            for ci, f in enumerate(out[0].schema.fields)]
    return ColumnBatch(out[0].schema, cols, total)


def fetch_host(x: torch.Tensor) -> np.ndarray:
    """A tensor on this host in full (single process only: the
    reference's cross-process allgather is ROADMAP A16)."""
    return x.cpu().numpy()


def make_distributed_agg(mesh: Mesh, template: ColumnBatch,
                         partial_fn: Callable[[ColumnBatch], ColumnBatch],
                         final_fn: Callable[[ColumnBatch], ColumnBatch],
                         key_ordinals: List[int], slot: int):
    """The distributed aggregate step over the mesh: partial_fn on each
    shard, the key-hash all-to-all, final_fn on each shard. partial_fn
    and final_fn are the single-shard phase functions of
    TpuHashAggregateExec. `template` is the sharded input's batch (the
    reference traces its shapes; eager PyTorch needs none)."""
    n = total_shards(mesh)

    def run(shards: List[ColumnBatch]) -> List[ColumnBatch]:
        """Execute; raises TpuSplitAndRetryOOM if any destination slot
        overflowed (one read of the flags)."""
        from spark_rapids_tpu_torch.exec.fused import TpuSplitAndRetryOOM

        parts = [partial_fn(b) for b in shards]
        pids = [murmur3_pmod([p.columns[i] for i in key_ordinals], n)
                for p in parts]
        exchanged, flags = all_to_all_batch(parts, pids, n, slot)
        out = [final_fn(b) for b in exchanged]
        _, overflow = read_counts(out, flags)
        if overflow:
            raise TpuSplitAndRetryOOM(
                f"all_to_all slot capacity {slot} overflowed; re-run with "
                "a larger slot or smaller shards")
        return out

    return run
