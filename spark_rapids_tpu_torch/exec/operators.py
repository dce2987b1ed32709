"""Physical operators — counterpart of `spark_rapids_tpu/exec/operators.py`
for the port's slice: the cached-relation source, the parquet scan
(PERFILE), filter, project, the hash aggregate in complete, partial and
final modes, and the hash shuffle exchange with device-resident blocks.

The hash aggregate keeps the reference's two grouping paths:
- binned (`_partial_binned`): when every group key is an integer column
  or dictionary codes with a static `vrange`, each row's bin id is
  computed elementwise and the reductions run straight in bin space
  (kernel K4, unsorted ids; one launch for a Sum/Average/count(*)
  aggregate), with no sort at all; q5's `region` codes take this path;
- sorted (`segmented.group_by`): sort by orderable keys, segment
  boundaries, then the same reductions over sorted ids. Merges of
  partial buffers always take it.

The exchange's map side partitions each batch on the device (murmur3
partition ids, kernel K6; a stable counting sort by id, K7; one batch
gather, K8) and keeps the sorted batch plus per-partition offsets in the
shuffle manager; the reduce side takes its row range out of every block
and concatenates them. The reference's spill-backed parking, retry and
semaphore discipline are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import encoding as _encoding
from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_batches,
    gather_columns,
    next_capacity,
)
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec.base import (
    PhysicalPlan,
    conf_device,
    new_task_context,
)
from spark_rapids_tpu_torch.expr.aggregates import (
    AggregateFunction,
    Average,
    Count,
    Sum,
)
from spark_rapids_tpu_torch.expr.core import Alias, EvalContext
from spark_rapids_tpu_torch.io import readers
from spark_rapids_tpu_torch.ops import filterops, partition, segmented
from spark_rapids_tpu_torch.shuffle.manager import get_shuffle_manager
from spark_rapids_tpu_torch.sqltypes import StringType, StructField, StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import long, torch_dtype


def _conf_get(conf, entry, default):
    return conf.get(entry) if conf is not None else default


# ---------------------------------------------------------------- sources

class TpuCachedRelationExec(PhysicalPlan):
    """Source over a device-resident cache entry (exec/relation_cache.py):
    one partition per cached part. The parts keep the fused engine's
    narrowed integer columns; this per-operator path widens them back to
    their logical types (`vrange` kept), while the fused engine reads the
    parts as they are and widens inside its chains."""

    def __init__(self, entry, schema=None, conf=None):
        super().__init__([], schema if schema is not None else entry.schema,
                         conf)
        self.entry = entry

    @property
    def num_partitions(self):
        return max(1, self.entry.num_parts())

    def execute_partition(self, pid, ctx):
        from spark_rapids_tpu_torch.exec.fused import widen_traced

        if pid < self.entry.num_parts():
            yield widen_traced(self.entry.device_part(pid))


class TpuFileScanExec(PhysicalPlan):
    """Parquet scan with the PERFILE strategy: one read task per file,
    row-capped at spark.rapids.sql.reader.batchSizeRows, each table
    uploaded with `arrow_to_device`. String columns are read as parquet
    DICTIONARY arrays (spark.rapids.tpu.encoded.*), so they upload as
    codes plus one interned dictionary. AUTO resolves to PERFILE here;
    COALESCING and MULTITHREADED, pushed row-group pruning (the Filter
    above the scan stays exact without it) and hive-partitioned layouts
    are not ported yet (ROADMAP A10)."""

    def __init__(self, fmt: str, paths: List[str], schema, conf,
                 pushed_columns: Optional[List[str]] = None,
                 pushed_filters=None, options: Optional[dict] = None):
        super().__init__([], schema, conf)
        if fmt != "parquet":
            raise NotImplementedError(
                f"{fmt} scans are not ported yet (ROADMAP A14)")
        strategy = _conf_get(conf, rc.PARQUET_READER_TYPE, "AUTO")
        if strategy not in ("AUTO", "PERFILE"):
            raise NotImplementedError(
                f"the {strategy} parquet reader is not ported yet "
                "(ROADMAP A10); use PERFILE")
        self.fmt = fmt
        self.paths = paths
        self.pushed_columns = pushed_columns
        self.pushed_filters = pushed_filters or None
        self.options = options or {}
        self._batch_rows = _conf_get(conf, rc.MAX_READER_BATCH_SIZE_ROWS,
                                      1 << 20)
        self._read_dict = (conf is None
                           or (conf.get(rc.ENCODED_ENABLED)
                               and conf.get(rc.ENCODED_READ_DICTIONARY)))
        self._tasks = [[f] for f in readers.expand_paths(
            paths, ".parquet")] or [[]]

    @property
    def num_partitions(self):
        return max(1, len(self._tasks))

    def _dict_columns(self, cols) -> Optional[List[str]]:
        if not self._read_dict:
            return None
        out = [f.name for f in self.schema.fields
               if isinstance(f.dataType, StringType)
               and (cols is None or f.name in cols)]
        return out or None

    def _host_tables(self, files):
        """The Arrow tables of one read task (the fused engine uploads them
        narrowed)."""
        cols = self.pushed_columns
        return readers.read_parquet_task(
            files, cols, self._batch_rows,
            read_dictionary=self._dict_columns(cols))

    def execute_partition(self, pid, ctx):
        if pid >= len(self._tasks) or not self._tasks[pid]:
            return
        device = conf_device(self.conf)
        for table in self._host_tables(self._tasks[pid]):
            yield arrow_to_device(table, device=device)


# ------------------------------------------------------- project / filter

class TpuProjectExec(PhysicalPlan):
    def __init__(self, exprs: List[Alias], child, schema, conf=None):
        super().__init__([child], schema, conf)
        self.exprs = exprs

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        ctx = EvalContext(batch)
        # bare column selections pass encoded columns through undecoded
        cols = [_encoding.eval_preserving(e, ctx) for e in self.exprs]
        return ColumnBatch(self.schema, cols, batch.num_rows)

    def execute_partition(self, pid, ctx):
        for batch in self.children[0].execute_partition(pid, ctx):
            yield self._run(batch)


class TpuFilterExec(PhysicalPlan):
    def __init__(self, condition, child, conf=None):
        super().__init__([child], child.schema, conf)
        self.condition = condition

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        pred = self.condition.eval(EvalContext(batch))
        return filterops.compact(batch, pred.data & pred.validity)

    def execute_partition(self, pid, ctx):
        for batch in self.children[0].execute_partition(pid, ctx):
            yield self._run(batch)


# -------------------------------------------------------------- aggregate

def _buffer_schema(grouping: List[Alias], aggs: List[Alias]) -> StructType:
    fields = [StructField(g.name, g.dtype, True) for g in grouping]
    for a in aggs:
        fn: AggregateFunction = a.children[0]
        for j, bt in enumerate(fn.buffer_types()):
            fields.append(StructField(f"{a.name}#buf{j}", bt, True))
    return StructType(fields)


class TpuHashAggregateExec(PhysicalPlan):
    """mode='partial' emits [keys..., buffers...] per input partition;
    mode='final' consumes them after the exchange and emits
    [keys..., results...]; mode='complete' does both in one step.

    The planner chooses complete only over a single-partition child, as
    the reference's does. A complete aggregate built by hand over many
    partitions (slice 1's `q5.q5_plan`) drains every child partition
    into its one output partition. Pending buffers are merged early
    (`_merge_buffers`) once their rows pass 2 * target_rows
    (spark.rapids.sql.batchSizeRows); a final merge over more than
    target_rows groups re-partitions the buffers by key and finalises
    each piece (`_finalize_partitioned`)."""

    #: default of spark.rapids.sql.batchSizeRows when built without conf
    target_rows = 1 << 20

    def __init__(self, mode: str, grouping: List[Alias], aggs: List[Alias],
                 child, conf=None):
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"aggregate mode {mode!r}")
        self.mode = mode
        self.grouping = grouping
        self.aggs = aggs
        out_schema = (_buffer_schema(grouping, aggs) if mode == "partial"
                      else StructType(
                          [StructField(g.name, g.dtype, True)
                           for g in grouping]
                          + [StructField(a.name, a.dtype, True)
                             for a in aggs]))
        super().__init__([child], out_schema, conf)
        if conf is not None:
            self.target_rows = conf.get(rc.BATCH_SIZE_ROWS)

    @property
    def num_partitions(self):
        if self.mode == "complete":
            return 1
        return self.children[0].num_partitions

    # --- phases ---

    @staticmethod
    def _bin_ranges(work: ColumnBatch, nkeys: int):
        """Static per-key (lo, hi) value bounds when EVERY group key is an
        integer column carrying a vrange and the bin count fits the
        capacity — enables the sort-free `_partial_binned`."""
        if nkeys == 0:
            return None
        ranges, total = [], 1
        for i in range(nkeys):
            c = work.columns[i]
            vr = c.vrange
            if (vr is None or c.data.dim() != 1
                    or c.data.dtype.is_floating_point
                    or c.data.dtype == torch.bool):
                return None
            total *= vr[1] - vr[0] + 2
            if total > min(work.capacity, 1 << 20):
                return None
            ranges.append(vr)
        return ranges

    def _partial(self, batch: ColumnBatch, live=None) -> ColumnBatch:
        """Partial aggregation of the rows `live` admits (default: the
        batch's live rows; the fused engine passes its pending filter
        mask)."""
        nkeys = len(self.grouping)
        # grouping + agg inputs into a working batch; eval_preserving
        # keeps encoded group keys as codes (their vrange then rides the
        # binned path)
        ctx = EvalContext(batch)
        work_cols = [_encoding.eval_preserving(g, ctx)
                     for g in self.grouping]
        input_groups = [[e.eval(ctx) for e in a.children[0].children]
                        for a in self.aggs]
        fields = [StructField(g.name, g.dtype, True) for g in self.grouping]
        concrete = [c for grp in input_groups for c in grp]
        for i, c in enumerate(concrete):
            fields.append(StructField(f"in{i}", c.dtype, True))
        work = ColumnBatch(StructType(fields), work_cols + concrete,
                           batch.num_rows)
        if not work.columns:
            # global COUNT(*): group the source batch so capacity and the
            # live mask come from the real data
            work = batch
        ranges = self._bin_ranges(work, nkeys)
        if ranges is not None:
            return self._partial_binned(work, ranges, input_groups, live)
        g = segmented.group_by(work, list(range(nkeys)), live)
        cap = work.capacity
        out_cols = self._keys_prefix(g, nkeys, cap)
        ci = nkeys
        for a, grp in zip(self.aggs, input_groups):
            vals = g.sorted_batch.columns[ci] if grp else None
            ci += len(grp)
            out_cols.extend(a.children[0].update(vals, g.live, g.gid, cap))
        return ColumnBatch(_buffer_schema(self.grouping, self.aggs),
                           out_cols, g.num_groups)

    def _partial_binned(self, work: ColumnBatch, ranges, input_groups,
                        live=None) -> ColumnBatch:
        """Sort-free partial aggregation entirely in BIN space: one
        elementwise pass gives each row its bin id, K4 reduces over the
        (unsorted) ids, and the group keys are decoded analytically from
        the bin index (bin = sum((value - lo + 1) * stride), 0 = null)."""
        nkeys = len(self.grouping)
        cap = work.capacity
        device = work.device
        if live is None:
            live = work.live_mask()
        gid64 = torch.zeros(cap, dtype=torch.int64, device=device)
        stride = 1
        for i, (lo, hi) in enumerate(ranges):
            c = work.columns[i]
            code = torch.where(c.validity, c.data.to(torch.int64) - lo + 1, 0)
            gid64 = gid64 + code * stride
            stride *= hi - lo + 2
        bcap = next_capacity(stride)
        gid = gid64.clamp(0, bcap - 1).to(torch.int32)
        with segmented.unsorted_gids():
            out_cols: List[DeviceColumn] = []
            idx = torch.arange(bcap, dtype=torch.int64, device=device)
            stride_i = 1
            for ki, (lo, hi) in enumerate(ranges):
                base = hi - lo + 2
                code = (idx // stride_i) % base
                stride_i *= base
                col = work.columns[ki]
                # lo-1 decodes the null bin, so the bound includes it; an
                # encoded key's analytic decode is its code, and the
                # dictionary rides along
                out_cols.append(DeviceColumn(
                    col.dtype, (code - 1 + lo).to(col.data.dtype), code > 0,
                    vrange=(lo - 1, hi), encoding=col.encoding))
            fast = self._binned_all_sums(input_groups, live, gid, bcap,
                                         work, nkeys)
            if fast is not None:
                counts, agg_cols = fast
                out_cols.extend(agg_cols)
            else:
                counts = segmented.seg_count(live, gid, bcap)
                ci = nkeys
                for a, grp in zip(self.aggs, input_groups):
                    vals = work.columns[ci] if grp else None
                    ci += len(grp)
                    out_cols.extend(a.children[0].update(vals, live, gid,
                                                         bcap))
        occupied = counts > 0
        num_groups = occupied.sum().to(torch.int32)
        # bins -> dense group positions (front-compacted like the sorted
        # path's segment-id outputs)
        perm = segmented.dense_bin_perm(occupied, bcap)
        return ColumnBatch(_buffer_schema(self.grouping, self.aggs),
                           gather_columns([(c, perm) for c in out_cols]),
                           num_groups)

    def _binned_all_sums(self, input_groups, live, gid, bcap, work, ci0):
        """Every reduction of a Sum/Average/count(*) aggregate plus the
        bin occupancy from ONE K4 launch: each summed column is a value
        vector under its own validity mask (its count is the rows the sum
        took), and the occupancy count over `live` is count(*). Returns
        (occupancy counts, buffer columns), or None when the shape does
        not qualify (another function, count(expr), sums of mixed types or
        more than four columns): the per-function update loop then runs."""
        slots = []     # per aggregate: index of its value vector, or None
        vec_of = {}    # work column index -> value vector index
        values, masks, out_types = [], [], []
        ci = ci0
        for a, grp in zip(self.aggs, input_groups):
            fn = a.children[0]
            if isinstance(fn, (Sum, Average)):
                if ci not in vec_of:
                    col = work.columns[ci]
                    out_t = fn.buffer_types()[0]
                    vec_of[ci] = len(values)
                    values.append(col.data.to(torch_dtype(out_t)))
                    masks.append(col.validity)
                    out_types.append(out_t)
                slots.append(vec_of[ci])
            elif isinstance(fn, Count) and not grp:
                slots.append(None)
            else:
                return None
            ci += len(grp)
        if len(values) > 4 or len({v.dtype for v in values}) > 1:
            return None
        red = segmented.seg_sum_count_multi(values, live, gid, bcap, masks,
                                            value_counts=True)
        ones = torch.ones(bcap, dtype=torch.bool, device=gid.device)
        out_cols: List[DeviceColumn] = []
        for j in slots:
            if j is None:
                out_cols.append(DeviceColumn(long, red.count, ones))
            else:
                cnt = red.value_counts[j]
                out_cols += [DeviceColumn(out_types[j], red.sums[j], cnt > 0),
                             DeviceColumn(long, cnt, ones)]
        return red.count, out_cols

    @staticmethod
    def _keys_prefix(g, nkeys: int, cap: int) -> List[DeviceColumn]:
        """Group key columns: the first row of each segment, in one
        gather. It keeps an encoded key's dictionary; plain keys drop
        vrange, as in the reference."""
        safe = g.first_pos.clamp(0, cap - 1)
        out_cols = gather_columns([(g.sorted_batch.columns[ki], safe)
                                   for ki in range(nkeys)])
        return [c.replace(vrange=None)
                if c.encoding is None and c.vrange is not None else c
                for c in out_cols]

    def _merge(self, batch: ColumnBatch, final: bool) -> ColumnBatch:
        """Sorted merge of partial buffers; `final` evaluates the results,
        otherwise the merged buffers come back (`_merge_buffers`)."""
        nkeys = len(self.grouping)
        g = segmented.group_by(batch, list(range(nkeys)))
        cap = batch.capacity
        out_cols = self._keys_prefix(g, nkeys, cap)
        ci = nkeys
        for a in self.aggs:
            fn: AggregateFunction = a.children[0]
            nb = len(fn.buffer_types())
            bufs = [g.sorted_batch.columns[ci + j] for j in range(nb)]
            ci += nb
            merged = fn.merge(bufs, g.live, g.gid, cap)
            if final:
                out_cols.append(fn.evaluate(merged))
            else:
                out_cols.extend(merged)
        schema = (self.schema if final
                  else _buffer_schema(self.grouping, self.aggs))
        return ColumnBatch(schema, out_cols, g.num_groups)

    def _merge_final(self, batch: ColumnBatch) -> ColumnBatch:
        return self._merge(batch, final=True)

    def _merge_buffers(self, batch: ColumnBatch) -> ColumnBatch:
        return self._merge(batch, final=False)

    def _inputs(self, pid, ctx):
        child = self.children[0]
        if self.mode != "complete":
            yield from child.execute_partition(pid, ctx)
            return
        for cpid in range(child.num_partitions):
            yield from child.execute_partition(cpid, ctx)

    def execute_partition(self, pid, ctx):
        pending: List[ColumnBatch] = []
        pending_rows = 0
        for batch in self._inputs(pid, ctx):
            part = batch if self.mode == "final" else self._partial(batch)
            pending.append(part)
            pending_rows += part.capacity
            if len(pending) > 1 and pending_rows > 2 * self.target_rows:
                compacted = self._merge_buffers(concat_batches(pending))
                pending = [compacted]
                # one exact sync per compaction, as the reference
                pending_rows = compacted.row_count()
        if not pending:
            if not self.grouping and self.mode != "partial":
                raise NotImplementedError(
                    "global aggregation over empty input is not ported "
                    "yet (ROADMAP A8)")
            return
        merged = concat_batches(pending)
        if self.mode == "partial":
            yield self._merge_buffers(merged)
        elif self.grouping and merged.row_count() > max(self.target_rows, 1):
            yield from self._finalize_partitioned(merged)
        else:
            yield self._merge_final(merged)

    def _finalize_partitioned(self, merged: ColumnBatch):
        """High-cardinality final merge: re-partition the buffers by key
        hash (a seed other than the shuffle's) and finalise each piece."""
        nparts = max(2, -(-merged.row_count() // max(self.target_rows, 1)))
        key_idx = list(range(len(self.grouping)))
        for piece in partition.split_to_slices(
                merged, key_idx, nparts, seed=partition.SUB_PARTITION_SEED):
            if piece is not None:
                yield self._merge_final(piece)


# --------------------------------------------------------------- exchange

class TpuShuffleExchangeExec(PhysicalPlan):
    """Hash (or single-partition) exchange with device-resident blocks —
    the reference's DEVICE shuffle mode. ICI (the mesh transport, ROADMAP
    A16) raises; MULTITHREADED (the default) and CACHE_ONLY, whose host
    blocks are not ported (ROADMAP A13), run this mode too, and the
    DataFrame records the substitution in last_execution["fallbacks"].

    The map stage runs once, on the first reduce task or when adaptive
    execution materialises it: each child partition is one map task
    whose batches are partitioned on the device and staged in the
    shuffle manager as (sorted batch, offsets), then committed (the
    first commit of a map task wins). A reduce task takes its row range
    out of every block and concatenates the pieces; blocks are released
    when the last reduce partition has been read."""

    def __init__(self, child, key_exprs: Optional[List], num_partitions,
                 conf=None):
        super().__init__([child], child.schema, conf)
        if conf is not None and conf.get(rc.SHUFFLE_MODE) == "ICI":
            raise NotImplementedError(
                "the ICI (mesh) shuffle is not ported yet (ROADMAP A16)")
        if not key_exprs and num_partitions > 1:
            raise NotImplementedError(
                "round-robin partitioning is not ported yet (ROADMAP B10b)")
        self.key_exprs = key_exprs
        self._nparts = max(1, num_partitions)
        self._shuffle_id = None
        self._map_done = False
        self._fetches_left = self._nparts

    @property
    def num_partitions(self):
        return self._nparts

    def _partition_batch(self, batch: ColumnBatch):
        """(batch sorted by reduce partition, counts per partition)."""
        ctx = EvalContext(batch)
        key_cols = [e.eval(ctx) for e in self.key_exprs]
        fields = list(batch.schema.fields) + [
            StructField(f"__k{i}", c.dtype, True)
            for i, c in enumerate(key_cols)]
        work = ColumnBatch(StructType(fields), batch.columns + key_cols,
                           batch.num_rows)
        kidx = list(range(len(batch.columns),
                          len(batch.columns) + len(key_cols)))
        pid = partition.hash_partition_ids(work, kidx, self._nparts)
        # the key columns were only needed for the ids: gather the batch
        pb = partition.partition_by_ids(batch, pid, self._nparts)
        return pb.batch, pb.counts

    def _map_task(self, mgr, cpid: int, attempt: int) -> None:
        """One map-task attempt over child partition cpid: stage its
        partitioned blocks under (cpid, attempt)."""
        tctx = new_task_context(self.conf)
        for batch in self.children[0].execute_partition(cpid, tctx):
            if self._nparts == 1:
                offs = np.array([0, batch.row_count()], np.int64)
                mgr.put(self._shuffle_id, cpid, attempt, batch, offs)
                continue
            sorted_batch, counts = self._partition_batch(batch)
            offs = np.concatenate(
                [[0], np.cumsum(counts.cpu().numpy().astype(np.int64))])
            mgr.put(self._shuffle_id, cpid, attempt, sorted_batch, offs)

    def _run_map_stage(self, ctx) -> None:
        if self._map_done:
            return
        mgr = get_shuffle_manager()
        self._shuffle_id = mgr.new_shuffle_id()
        try:
            for cpid in range(self.children[0].num_partitions):
                try:
                    self._map_task(mgr, cpid, 0)
                except BaseException:
                    mgr.discard_attempt(self._shuffle_id, cpid, 0)
                    raise
                mgr.commit_map_output(self._shuffle_id, cpid, 0)
        except BaseException:
            mgr.remove_shuffle(self._shuffle_id)
            raise
        self._map_done = True

    def partition_sizes(self) -> List[int]:
        """Bytes per reduce partition of the materialised map output."""
        return get_shuffle_manager().partition_sizes(self._shuffle_id,
                                                     self._nparts)

    def _fetch_device(self, pid) -> List[ColumnBatch]:
        """This partition's row range out of every block. The reference
        gathers each range (a traced program needs static shapes); here a
        range is a view, and the concat that follows does the one copy."""
        mgr = get_shuffle_manager()
        pieces = []
        for b, offs in mgr.blocks(self._shuffle_id):
            lo, hi = int(offs[pid]), int(offs[pid + 1])
            if hi > lo:
                pieces.append(b.slice_rows(lo, hi))
        self._fetches_left -= 1
        if self._fetches_left <= 0:
            mgr.remove_shuffle(self._shuffle_id)
        return pieces

    def execute_partition(self, pid, ctx):
        self._run_map_stage(ctx)
        pieces = self._fetch_device(pid)
        if not pieces:
            return
        merged = concat_batches(pieces)
        max_rows = _conf_get(self.conf, rc.BATCH_SIZE_ROWS, 1 << 20)
        total = merged.row_count()
        if total <= max_rows:
            yield merged
            return
        for off in range(0, total, max_rows):
            count = min(max_rows, total - off)
            cap = next_capacity(count)
            idx = (torch.arange(cap, dtype=torch.int32, device=merged.device)
                   + off).clamp(0, merged.capacity - 1)
            yield merged.gather(idx, count)
