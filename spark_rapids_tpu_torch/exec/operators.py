"""Physical operators — counterpart of `spark_rapids_tpu/exec/operators.py`
for the port's slice: the in-memory source with its upload, the
cached-relation source, the parquet and Delta scan (PERFILE), filter,
project, the hash aggregate in complete, partial and final modes, the
hash, round-robin and range shuffle exchanges with device-resident
blocks, the union, the out-of-core sort, the local limit, the window in
the reference planner's four modes (whole partition, halo, running, u2u)
and the generator (explode and posexplode of array columns).

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
partition ids, kernel K6, or for the range exchange a binary search of
sampled bounds, K2; a stable counting sort by id, K7, which computes a
round-robin exchange's ids itself, K28; one batch gather, K8) and keeps the sorted batch plus per-partition offsets in the shuffle
manager; the reduce side yields its row range of every block as a batch
of its own (a view). The reference's reduce side concatenates those
ranges first; here every consumer that needs one batch concatenates what
it reads (the aggregate, the window), and the sort takes each range as
one sorted run that it merges with the others (kernel K13) instead of
re-sorting a concatenation. The reference's spill-backed parking, retry
and semaphore discipline are not ported yet (ROADMAP A10): the sort's
runs and the window's input are plain device batches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import encoding as _encoding
from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_batches,
    gather_columns,
    gather_leaves,
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
    CollectList,
    CollectSet,
    Count,
    CountDistinct,
    First,
    Last,
    Max,
    Min,
    StddevPop,
    StddevSamp,
    Sum,
    VariancePop,
    VarianceSamp,
)
from spark_rapids_tpu_torch.expr.core import Alias, EvalContext
from spark_rapids_tpu_torch.io import readers
from spark_rapids_tpu_torch.ops import (
    filterops,
    joinops,
    partition,
    segmented,
    sortops,
)
from spark_rapids_tpu_torch.ops.common import sort_words
from spark_rapids_tpu_torch.shuffle.manager import get_shuffle_manager
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    StringType,
    StructField,
    StructType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide, long, torch_dtype


def _conf_get(conf, entry, default):
    return conf.get(entry) if conf is not None else default


# ---------------------------------------------------------------- sources

class LocalRelationExec(PhysicalPlan):
    """An in-memory Arrow table (createDataFrame), one partition on the
    host; `ArrowToDeviceExec` above it uploads it."""

    is_tpu = False

    def __init__(self, table: pa.Table, schema, conf=None):
        super().__init__([], schema, conf)
        self.table = table

    def execute_partition(self, pid, ctx):
        yield self.table


class ArrowToDeviceExec(PhysicalPlan):
    """Host Arrow tables -> device batches on the plan's device (the
    GpuRowToColumnarExec role). The reference's device admission (the
    task semaphore) is not ported yet (ROADMAP A10)."""

    def __init__(self, child, conf=None):
        super().__init__([child], child.schema, conf)

    def host_tables(self):
        """Every partition's host tables, in order (the fused engine
        uploads them narrowed)."""
        child = self.children[0]
        for pid in range(child.num_partitions):
            yield from child.execute_partition(pid, new_task_context(
                self.conf))

    def execute_partition(self, pid, ctx):
        device = conf_device(self.conf)
        for table in self.children[0].execute_partition(pid, ctx):
            yield arrow_to_device(table, device=device)


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
    codes plus one interned dictionary. A Delta table with deletion
    vectors or column mapping scans with fmt "delta": each file is one
    table read through `lakehouse.delta.read_data_file` (its deleted rows
    dropped, its columns renamed). AUTO resolves to PERFILE here;
    COALESCING and MULTITHREADED, pushed row-group pruning (the Filter
    above the scan stays exact without it) and hive-partitioned layouts
    are not ported yet (ROADMAP A10)."""

    def __init__(self, fmt: str, paths: List[str], schema, conf,
                 pushed_columns: Optional[List[str]] = None,
                 pushed_filters=None, options: Optional[dict] = None):
        super().__init__([], schema, conf)
        if fmt not in ("parquet", "delta"):
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
        if self.fmt == "delta":
            from spark_rapids_tpu_torch.lakehouse.delta import read_data_file

            ctx = self.options["delta_ctx"]
            return iter([read_data_file(ctx, f, cols) for f in files])
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


# --------------------------------------------------------------- generate

class TpuGenerateExec(PhysicalPlan):
    """explode / posexplode over the padded array layout (the reference's
    TpuGenerateExec, GpuGenerateExec.scala): a count pass, one host read
    of the element total for the output capacity, then K3's gather maps
    (row, element) and one K8 launch that moves the pass-through leaves
    by row and the element leaves ([cap, max_elems] data and validity, an
    array<string> cube's [max_bytes] rows and byte counts) by the
    flattened index row * max_elems + element."""

    def __init__(self, pass_through: List[Alias], gen_alias: Alias,
                 position: bool, child, conf=None):
        from spark_rapids_tpu_torch.sqltypes.datatypes import integer

        fields = [StructField(a.name, a.dtype, a.nullable)
                  for a in pass_through]
        if position:
            fields.append(StructField("pos", integer, False))
        fields.append(StructField(gen_alias.name, gen_alias.dtype, True))
        super().__init__([child], StructType(fields), conf)
        self.pass_through = pass_through
        self.gen_alias = gen_alias
        self.position = position

    def _counts(self, batch: ColumnBatch):
        ectx = EvalContext(batch)
        arr = self.gen_alias.children[0].children[0].eval(ectx)
        counts = torch.where(batch.live_mask() & arr.validity, arr.lengths,
                             torch.zeros_like(arr.lengths)).to(torch.int32)
        return ectx, arr, counts

    def _explode_to_cap(self, batch: ColumnBatch, out_cap: int, pre=None):
        """Explode into a static capacity: (batch, overflow), the overflow
        a 0-d device bool (total > out_cap). The adaptive engine passes
        the exact capacity and its count pass's results in `pre`; the
        fused engine a static one, retried larger on overflow."""
        from spark_rapids_tpu_torch.sqltypes.datatypes import integer

        ectx, arr, counts = pre if pre is not None else self._counts(batch)
        lo = torch.zeros_like(counts)
        pi, ei, total = joinops.expand_gather_maps(lo, counts, out_cap)
        overflow = total > out_cap
        me = int(arr.data.shape[1])
        flat = (pi.to(torch.int64) * me
                + ei.to(torch.int64).clamp(0, me - 1)).to(torch.int32)
        passed = [a.eval(ectx) for a in self.pass_through]
        elems = [arr.data.reshape((-1,) + tuple(arr.data.shape[2:])),
                 arr.elem_validity.reshape(-1)]
        if arr.elem_lengths is not None:
            elems.append(arr.elem_lengths.reshape(-1))
        srcs, idxs = [], []
        for c in passed:
            srcs += c.leaves()
            idxs += [pi] * len(c.leaves())
        got = gather_leaves(srcs + elems, idxs + [flat] * len(elems))
        cols, at = [], 0
        for c in passed:
            k = len(c.leaves())
            cols.append(c.with_leaves(got[at:at + k]))
            at += k
        if self.position:
            cols.append(DeviceColumn(integer, ei, torch.ones(
                out_cap, dtype=torch.bool, device=pi.device)))
        vals, ev = got[at], got[at + 1]
        # an array<string> element becomes a padded string row
        cols.append(DeviceColumn(
            self.gen_alias.dtype, vals, ev,
            got[at + 2] if arr.elem_lengths is not None else None))
        return ColumnBatch(self.schema, cols,
                           total.clamp(max=out_cap)), overflow

    def _explode_batch(self, batch: ColumnBatch) -> ColumnBatch:
        pre = self._counts(batch)
        total = int(pre[2].sum().item())
        out, _ = self._explode_to_cap(batch, next_capacity(max(total, 1)),
                                      pre=pre)
        out._host_rows = total
        return out

    def execute_partition(self, pid, ctx):
        for batch in self.children[0].execute_partition(pid, ctx):
            out = self._explode_batch(batch)
            if out.row_count() > 0:
                yield out


# -------------------------------------------------------------- aggregate

def _buffer_schema(grouping: List[Alias], aggs: List[Alias]) -> StructType:
    fields = [StructField(g.name, g.dtype, True) for g in grouping]
    for a in aggs:
        fn: AggregateFunction = a.children[0]
        for j, bt in enumerate(fn.buffer_types()):
            fields.append(StructField(f"{a.name}#buf{j}", bt, True))
    return StructType(fields)


def _inputs_at(cols: List[DeviceColumn], ci: int, k: int):
    """An aggregate's input columns from position ci: None for none
    (count(*)), the column for one, a list for two or more (corr,
    covar)."""
    if k == 0:
        return None
    if k == 1:
        return cols[ci]
    return [cols[ci + j] for j in range(k)]


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
    each piece (`_finalize_partitioned`).

    An aggregate holding a non-jittable function (collect_list/set,
    count(DISTINCT), sum(DISTINCT), percentile: buffers as wide as the
    largest group) takes the reference's eager path: its partial and
    merges read the group count on the host and size every buffer to
    `next_capacity(num_groups)` rows, where the reference keeps the
    batch's row capacity (an array buffer of 2^20 rows by ~520 elements
    would take 4.4 GB a partial; the answers are the same). Such
    functions are not `binned_safe`, so they take the sorted grouping."""

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
        #: a function's buffers are as wide as its largest group: size
        #: the buffers' rows to the group count, read on the host
        self.eager = any(not a.children[0].jittable for a in aggs)

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
        if ranges is not None and all(a.children[0].binned_safe
                                      for a in self.aggs):
            return self._partial_binned(work, ranges, input_groups, live)
        g = segmented.group_by(work, list(range(nkeys)), live)
        cap = self._buffer_rows(g, work.capacity)
        out_cols = self._keys_prefix(g, nkeys, work.capacity, cap)
        ci = nkeys
        for a, grp in zip(self.aggs, input_groups):
            vals = _inputs_at(g.sorted_batch.columns, ci, len(grp))
            ci += len(grp)
            out_cols.extend(a.children[0].update(vals, g.live, g.gid, cap))
        return ColumnBatch(_buffer_schema(self.grouping, self.aggs),
                           out_cols, g.num_groups)

    def _buffer_rows(self, g, capacity: int) -> int:
        """Rows of the buffers a grouping gives: the batch's capacity, or
        on the eager path the capacity bucket of its group count (one
        host read)."""
        if not self.eager:
            return capacity
        return next_capacity(int(g.num_groups))

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
                    vals = _inputs_at(work.columns, ci, len(grp))
                    ci += len(grp)
                    out_cols.extend(a.children[0].update(vals, live, gid,
                                                         bcap))
        # bins -> dense group positions (front-compacted like the sorted
        # path's segment-id outputs) and the group count
        perm, num_groups = segmented.dense_bin_perm(counts > 0, bcap)
        return ColumnBatch(_buffer_schema(self.grouping, self.aggs),
                           gather_columns([(c, perm) for c in out_cols]),
                           num_groups)

    def _binned_all_sums(self, input_groups, live, gid, bcap, work, ci0):
        """Every reduction of a Sum/Average/count(*) aggregate plus the
        bin occupancy from ONE K4 launch: each summed column is a value
        vector under its own validity mask (its count is the rows the sum
        took), and the occupancy count over `live` is count(*). Returns
        (occupancy counts, buffer columns), or None when the shape does
        not qualify (another function, count(expr), a decimal(> 18) sum
        buffer, sums of mixed types or more than eight columns): the
        per-function update loop then runs."""
        slots = []     # per aggregate: index of its value vector, or None
        vec_of = {}    # work column index -> value vector index
        values, masks, out_types = [], [], []
        ci = ci0
        for a, grp in zip(self.aggs, input_groups):
            fn = a.children[0]
            if isinstance(fn, (Sum, Average)):
                if is_wide(fn.buffer_types()[0]):
                    return None  # K32 sums the limbs, in the update loop
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
        if (len(values) > segmented.K4_MAX_VECTORS
                or len({v.dtype for v in values}) > 1):
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
    def _keys_prefix(g, nkeys: int, cap: int,
                     rows: Optional[int] = None) -> List[DeviceColumn]:
        """Group key columns: the first row of each of the first `rows`
        segments (all of them by default), in one gather. It keeps an
        encoded key's dictionary; plain keys drop vrange, as in the
        reference."""
        safe = g.first_pos[:rows].clamp(0, cap - 1)
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
        cap = self._buffer_rows(g, batch.capacity)
        out_cols = self._keys_prefix(g, nkeys, batch.capacity, cap)
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
                # global aggregation over empty input -> one default row
                yield self._empty_global_result()
            return
        merged = concat_batches(pending)
        if self.mode == "partial":
            yield self._merge_buffers(merged)
        elif self.grouping and merged.row_count() > max(self.target_rows, 1):
            yield from self._finalize_partitioned(merged)
        else:
            yield self._merge_final(merged)

    def _empty_global_result(self) -> ColumnBatch:
        """The reference's `_empty_global_result`: count and
        count(DISTINCT) 0, collect_list/set an empty array, every other
        aggregate null."""
        dev = conf_device(self.conf)
        cap = 1024
        cols = []
        for a in self.aggs:
            dt = a.dtype
            fn = a.children[0]
            if fn.zero_when_empty:
                cols.append(DeviceColumn(
                    long, torch.zeros(cap, dtype=torch.int64, device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev)))
            elif isinstance(dt, ArrayType):
                cols.append(DeviceColumn(
                    dt, torch.zeros((cap, 1), dtype=torch_dtype(
                        dt.elementType), device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev),
                    torch.zeros(cap, dtype=torch.int32, device=dev),
                    elem_validity=torch.zeros((cap, 1), dtype=torch.bool,
                                              device=dev)))
            elif isinstance(dt, StringType):
                cols.append(DeviceColumn(
                    dt, torch.zeros((cap, 8), dtype=torch.uint8, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev),
                    torch.zeros(cap, dtype=torch.int32, device=dev)))
            else:
                cols.append(DeviceColumn(
                    dt, torch.zeros(cap, dtype=torch_dtype(dt), device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev)))
        return ColumnBatch(self.schema, cols, 1)

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
    the reference's DEVICE shuffle mode. Under ICI the mesh engine
    (parallel/plan_compiler.py) runs the plan and lowers the exchange to
    an all-to-all; a plan it hands back runs here. MULTITHREADED (the
    default), CACHE_ONLY, and ICI on a plan handed back, whose host blocks
    are not ported (ROADMAP A13), run this mode too, and the DataFrame
    records the substitution in last_execution["fallbacks"].

    The map stage runs once, on the first reduce task or when adaptive
    execution materialises it: each child partition is one map task
    whose batches are partitioned on the device and staged in the
    shuffle manager as (sorted batch, offsets), then committed (the
    first commit of a map task wins). A reduce task yields its row range
    of every block as a batch of its own (a view, split at
    batchSizeRows); blocks are released when the last reduce partition
    has been read."""

    #: partitions by sampled key ranges, not by key hash
    _ranged = False

    def __init__(self, child, key_exprs: Optional[List], num_partitions,
                 conf=None):
        super().__init__([child], child.schema, conf)
        self.key_exprs = key_exprs
        #: the conf's DEVICE mode, which the reference's adaptive skew
        #: split and partition pruning skip (every mode keeps its blocks
        #: on the device here)
        self._device_mode = (conf is not None
                             and conf.get(rc.SHUFFLE_MODE) == "DEVICE")
        self._nparts = max(1, num_partitions)
        self._shuffle_id = None
        self._map_done = False
        self._fetches_left = self._nparts

    @property
    def num_partitions(self):
        return self._nparts

    def _partition_batch(self, batch: ColumnBatch):
        """(batch sorted by reduce partition, counts per partition): by a
        hash of the keys, or round-robin without keys (K28)."""
        if not self.key_exprs:
            pb = partition.round_robin_partition(batch, self._nparts)
            return pb.batch, pb.counts
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

    def peek_partition(self, pid) -> List[ColumnBatch]:
        """This partition's row range out of every block, without counting
        as its read (the adaptive engine inspecting a build side)."""
        mgr = get_shuffle_manager()
        return [b.slice_rows(int(offs[pid]), int(offs[pid + 1]))
                for b, offs in mgr.blocks(self._shuffle_id)
                if int(offs[pid + 1]) > int(offs[pid])]

    def _fetch_device(self, pid) -> List[ColumnBatch]:
        """This partition's row range out of every block. The reference
        gathers each range (a traced program needs static shapes) and
        concatenates them; here a range is a view, and the consumer
        decides whether to concatenate."""
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
        max_rows = _conf_get(self.conf, rc.BATCH_SIZE_ROWS, 1 << 20)
        for piece in self._fetch_device(pid):
            total = piece.row_count()
            for off in range(0, total, max_rows):
                yield (piece if total <= max_rows else
                       piece.slice_rows(off, min(off + max_rows, total)))


class TpuRangeShuffleExchangeExec(TpuShuffleExchangeExec):
    """Sample-based range exchange (GpuRangePartitioner.scala): the map
    stage holds every child batch, samples each batch's sort keys at the
    reference's positions ((i * capacity) // s_n for s_n = min(64,
    capacity)), sorts the samples (K9) and takes num_partitions - 1 bounds
    among the live ones, then gives each row the number of bounds at or
    below its key (the upper bound of K2's search) as its partition and
    partitions the batch (K7, K8). Partition p holds the p-th key range,
    so per-partition sorts concatenate into the total order. The map
    stage is one attempt (the sampling spans every child partition), as
    in the reference; its blocks are device batches, not spill-backed
    (ROADMAP A10)."""

    _ranged = True

    def __init__(self, child, orders, num_partitions, conf=None,
                 samples_per_batch: int = 64):
        super().__init__(child, None, num_partitions, conf)
        self.orders = orders
        self._samples = samples_per_batch

    def _bounds(self, parked: List[ColumnBatch], npt: int) -> torch.Tensor:
        """[W, npt - 1] key words of the partition bounds."""
        samples = []
        for b in parked:
            keys = sortops.order_keys(b, self.orders)
            s_n = min(self._samples, b.capacity)
            pos = (torch.arange(s_n, dtype=torch.int64, device=keys.device)
                   * b.capacity) // s_n
            samples.append(keys.index_select(1, pos))
        samples = torch.cat(samples, dim=1)
        total_s = int(samples.shape[1])
        perm = sort_words(samples)
        skeys = gather_leaves(list(samples.unbind(0)),
                              [perm] * samples.shape[0])
        # dead or garbage sample rows carry the leading null rank 2
        live_ct = (skeys[0] < 2).sum()
        j = ((torch.arange(1, npt, dtype=torch.int64, device=perm.device)
              * live_ct) // npt).clamp(0, total_s - 1).to(torch.int32)
        return torch.stack(gather_leaves(skeys, [j] * len(skeys)))

    def _run_map_stage(self, ctx) -> None:
        if self._map_done:
            return
        mgr = get_shuffle_manager()
        self._shuffle_id = mgr.new_shuffle_id()
        npt = self._nparts
        try:
            tctx = new_task_context(self.conf)
            parked = [b for cpid in range(self.children[0].num_partitions)
                      for b in self.children[0].execute_partition(cpid,
                                                                  tctx)]
            bounds = self._bounds(parked, npt) if parked and npt > 1 \
                else None
            for b in parked:
                if bounds is None:
                    mgr.put(self._shuffle_id, 0, 0, b,
                            np.array([0, b.row_count()], np.int64))
                    continue
                keys = sortops.order_keys(b, self.orders)
                ones = torch.ones(b.capacity, dtype=torch.bool,
                                  device=keys.device)
                lo, cnt = joinops.probe_bounds(
                    list(bounds.unbind(0)), keys,
                    torch.tensor(npt - 1, dtype=torch.int32,
                                 device=keys.device), ones, npt - 1)
                pb = partition.partition_by_ids(b, lo + cnt, npt)
                offs = np.concatenate(
                    [[0], np.cumsum(pb.counts.cpu().numpy()
                                    .astype(np.int64))])
                mgr.put(self._shuffle_id, 0, 0, pb.batch, offs)
            mgr.commit_map_output(self._shuffle_id, 0, 0)
        except BaseException:
            mgr.remove_shuffle(self._shuffle_id)
            raise
        self._map_done = True


# ------------------------------------------------------------------ union

class UnionExec(PhysicalPlan):
    """Partition-concatenating union (GpuUnionExec): the children's
    partitions follow one another."""

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def execute_partition(self, pid, ctx):
        for c in self.children:
            if pid < c.num_partitions:
                yield from c.execute_partition(pid, ctx)
                return
            pid -= c.num_partitions


# ------------------------------------------------------------------- sort

class TpuSortExec(PhysicalPlan):
    """Out-of-core sort (GpuSortExec.scala:151-633): sort each input batch
    into a run (K9, K8), then merge runs pairwise in order with the
    no-resort merge (K13), so ties keep the earlier run's rows first at
    every level. There is no spill catalog yet (ROADMAP A10): the runs are
    plain device batches. With `chunk_rows` the merged run is emitted in
    bounded chunks (the batched window modes' input)."""

    def __init__(self, orders, child, conf=None,
                 chunk_rows: Optional[int] = None):
        super().__init__([child], child.schema, conf)
        self.orders = orders
        self.chunk_rows = chunk_rows

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        return sortops.sort_batch(batch, self.orders)

    def execute_partition(self, pid, ctx):
        runs = [self._run(b)
                for b in self.children[0].execute_partition(pid, ctx)]
        if not runs:
            return
        while len(runs) > 1:
            nxt = []
            for i in range(0, len(runs) - 1, 2):
                out_cap = next_capacity(runs[i].row_count()
                                        + runs[i + 1].row_count())
                nxt.append(sortops.merge_sorted(runs[i], runs[i + 1],
                                                self.orders, out_cap))
            if len(runs) % 2:
                nxt.append(runs[-1])
            runs = nxt
        out = runs[0]
        if self.chunk_rows is None:
            yield out
            return
        total = out.row_count()
        for lo in range(0, total, self.chunk_rows):
            count = min(self.chunk_rows, total - lo)
            cap = next_capacity(count)
            idx = (torch.arange(cap, dtype=torch.int32, device=out.device)
                   + lo).clamp(0, out.capacity - 1)
            yield out.gather(idx, count)


class TpuLocalLimitExec(PhysicalPlan):
    def __init__(self, n, child, conf=None):
        super().__init__([child], child.schema, conf)
        self.n = n

    def execute_partition(self, pid, ctx):
        remaining = self.n
        for batch in self.children[0].execute_partition(pid, ctx):
            if remaining <= 0:
                return
            out = filterops.slice_head(batch, remaining)
            remaining -= out.row_count()
            yield out


# ----------------------------------------------------------------- window

def window_streaming_mode(window_exprs: List[Alias]) -> Optional[str]:
    """The reference's streaming strategy for specs the bounded-halo path
    can't chunk (GpuRunningWindowExec.scala,
    GpuUnboundedToUnboundedAggWindowExec.scala):

    - "running": every expression is row_number/rank/dense_rank or a
      sum/min/max/count over ROWS UNBOUNDED PRECEDING..CURRENT ROW of
      fixed-width, non-wide inputs, over fixed-width keys;
    - "u2u": every expression is an aggregate over the WHOLE partition
      (unbounded..unbounded, or no frame and no order), never first/last
      (order-sensitive: the two passes see chunk-arrival order).

    None -> the whole-partition evaluation, also for an aggregate that is
    not jittable (buffers as wide as the largest group)."""
    from spark_rapids_tpu_torch.expr import windows as we

    spec = window_exprs[0].children[0].spec

    def fixed_width(e):
        return (getattr(e.dtype, "np_dtype", None) is not None
                and not isinstance(e.dtype, StringType))

    fixed_width_keys = all(fixed_width(e) for e in (
        list(spec.partitions) + [o.expr for o in spec.orders]))
    kinds = set()
    for a in window_exprs:
        wexpr = a.children[0]
        fn = wexpr.function
        frame = wexpr.spec.frame
        if isinstance(fn, (we.RowNumber, we.Rank, we.DenseRank)):
            kinds.add("running")
            continue
        if not isinstance(fn, AggregateFunction) or not fn.jittable:
            return None
        if isinstance(fn, First):
            # first/last are ORDER-sensitive; the two-pass aggregate
            # sees chunk-arrival order, not the spec's ORDER BY
            return None
        whole = (frame is not None and frame.lower is None
                 and frame.upper is None) or (
            frame is None and not wexpr.spec.orders)
        if whole:
            kinds.add("u2u")
            continue
        if (isinstance(fn, (Sum, Min, Max, Count))
                and frame is not None and frame.frame_type == "rows"
                and frame.lower is None and frame.upper == 0
                and not is_wide(fn.dtype)
                and all(fixed_width(c) and not is_wide(c.dtype)
                        for c in fn.children)):
            kinds.add("running")
            continue
        return None
    if kinds == {"running"}:
        return "running" if fixed_width_keys else None
    if kinds == {"u2u"}:
        return "u2u"
    return None


def window_halo(window_exprs: List[Alias]) -> Optional[int]:
    """Rows of context a chunked window evaluation needs on each side, or
    None when the spec is not chunkable (ranking / running / unbounded /
    RANGE frames): ROWS frames with finite bounds, and lead/lag."""
    from spark_rapids_tpu_torch.expr import windows as we

    halo = 0
    for a in window_exprs:
        wexpr = a.children[0]
        fn = wexpr.function
        frame = wexpr.spec.frame
        if isinstance(fn, we.Lead):  # Lag subclasses Lead
            halo = max(halo, abs(fn.offset))
            continue
        if isinstance(fn, we.WindowFunction):
            return None
        if (frame is None or frame.frame_type != "rows"
                or frame.lower is None or frame.upper is None):
            return None
        halo = max(halo, abs(frame.lower), abs(frame.upper))
    return halo


def _frame_variance(fn, cnt: torch.Tensor, s1: torch.Tensor,
                    s2: torch.Tensor) -> DeviceColumn:
    """var_pop / var_samp (stddev: their square roots) of a frame from its
    count and sums of x and x^2, as the reference's window evaluates
    them."""
    n = cnt.to(torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64, device=n.device)
    m2 = torch.clamp(s2 - s1 * (s1 / torch.maximum(n, one)), min=0.0)
    if isinstance(fn, VarianceSamp):
        d = m2 / torch.maximum(n - 1.0, one)
        v = cnt >= 2
    else:
        d = m2 / torch.maximum(n, one)
        v = cnt >= 1
    if isinstance(fn, (StddevPop, StddevSamp)):
        d = torch.sqrt(d)
    return DeviceColumn(fn.dtype, d, v)


def _float_minmax(a: torch.Tensor, b: torch.Tensor,
                  is_max: bool) -> torch.Tensor:
    """jnp.minimum / jnp.maximum on the CPU backend: NaN if either is NaN
    (the canonical NaN), and -0.0 below 0.0 in either argument order;
    integers as they are."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)
    ka = segmented._float_keys(a, True)
    kb = segmented._float_keys(b, True)
    pick_b = (kb > ka) if is_max else (kb < ka)
    out = torch.where(pick_b, b, a)
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def _row_select(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Rows of a where cond, else of b (byte matrices padded to one
    width)."""
    if a.dim() == 2:
        w = max(int(a.shape[1]), int(b.shape[1]))
        a = torch.nn.functional.pad(a, (0, w - int(a.shape[1])))
        b = torch.nn.functional.pad(b, (0, w - int(b.shape[1])))
        return torch.where(cond[:, None], a, b)
    return torch.where(cond, a, b.to(a.dtype))


class TpuWindowExec(PhysicalPlan):
    """Window operator (GpuWindowExec analog): one sorted pass per
    (partitionBy, orderBy) spec (ops/windowops.py `sort_for_window`: K9,
    K10, K12) evaluates every function: one K14 launch for the rank family
    and the prefix-sum frames (sum, count, avg), K16 for each min/max
    frame, K15 for RANGE bounds, and one K17 launch with one K8 gather for
    first/last frames and lead/lag. Every result lands at its input row:
    input rows are preserved and the window columns appended.

    Modes, as the reference's planner picks them:
    - whole partition (the default): the reduce partition's batches
      concatenated and evaluated at once;
    - presorted with `halo` H (bounded ROWS frames and lead/lag; the child
      is a chunked TpuSortExec on the partition and order keys): each
      sorted chunk is evaluated with H rows of the previous chunk before
      it and H of the next after it, and its own rows sliced out (K8);
    - "running" (ranks and running sum/count/min/max; the same chunked
      child): each chunk is evaluated alone and the prefix that continues
      the previous chunk's partition is fixed up from a carry of 1-row
      device tensors, with no host read a chunk;
    - "u2u" (aggregates over whole partitions): a partial aggregate a
      chunk, folded every spark.rapids.sql.window.unboundedFoldEvery
      chunks, a final aggregate, then each chunk probes its partition's
      result (K9's build, K2's search over null-safe keys). The chunks
      wait in a Python list, as the sort's runs do, until ROADMAP A10
      brings the spill catalog.

    Variance and stddev frames take K14's frame count and sums of x and
    x^2 (three outputs of its one evaluation launch). collect_list and
    collect_set over bounded ROWS frames are K33's (`frame_collect`),
    array columns of the frame's width."""

    def __init__(self, window_exprs: List[Alias], child, conf=None,
                 presorted: bool = False, halo: Optional[int] = None,
                 mode: Optional[str] = None):
        base = child.schema
        extra = [StructField(a.name, a.dtype, True) for a in window_exprs]
        super().__init__([child], StructType(list(base.fields) + extra),
                         conf)
        self.window_exprs = window_exprs
        self.presorted = presorted
        self.halo = halo
        self.mode = mode
        self.spec0 = window_exprs[0].children[0].spec

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        from spark_rapids_tpu_torch import kernels
        from spark_rapids_tpu_torch.expr import windows as we
        from spark_rapids_tpu_torch.ops import windowops as W

        ctx = EvalContext(batch)
        spec0 = self.spec0
        part_cols = [p.eval(ctx) for p in spec0.partitions]
        order_cols = [(o.expr.eval(ctx), o.ascending, o.nulls_first)
                      for o in spec0.orders]
        sw = W.sort_for_window(batch, part_cols, order_cols)
        inv = W.inverse_permutation(sw.perm)
        has_order = bool(spec0.orders)
        prefixes, frames = {}, {}

        def prefix(col: Optional[DeviceColumn], dtype, count: bool):
            """K14's prefix of a column's values (or of its valid rows,
            a count), read through the sort permutation; each once. A
            float64 prefix restarts at each partition."""
            key = (id(col), dtype, count)
            if key not in prefixes:
                vals = None if count else col.data.to(dtype)
                prefixes[key] = W.window_prefix(
                    vals, None if col is None else col.validity, sw.live,
                    sw.perm, dtype,
                    sw.seg_start if dtype == torch.float64 else None)
            return prefixes[key]

        def frame_of(wexpr):
            """Each distinct frame once (K15 for RANGE offsets)."""
            fr = wexpr.spec.frame
            key = None if fr is None else fr.key()
            if key not in frames:
                order = ((order_cols[0][0], order_cols[0][2])
                         if order_cols else None)
                frames[key] = W.frame_of(fr, has_order, sw, order)
            return frames[key]

        ranks = {we.RowNumber: kernels.WIN_ROW_NUMBER,
                 we.Rank: kernels.WIN_RANK,
                 we.DenseRank: kernels.WIN_DENSE_RANK,
                 we.PercentRank: kernels.WIN_PERCENT_RANK,
                 we.CumeDist: kernels.WIN_CUME_DIST}
        # per output: ("eval", request index) | ("col", column) |
        # ("pick", pick index, input column, default column or None)
        slots, reqs, picks = [], [], []
        inputs = {}

        def input_of(fn):
            key = fn.input.key()
            if key not in inputs:
                inputs[key] = fn.input.eval(ctx)
            return inputs[key]

        for alias in self.window_exprs:
            wexpr = alias.children[0]
            fn = wexpr.function
            if type(fn) in ranks or isinstance(fn, we.NTile):
                kind = ranks.get(type(fn), kernels.WIN_NTILE)
                slots.append(("eval", len(reqs)))
                reqs.append(W.WinRequest(
                    kind, buckets=fn.n if isinstance(fn, we.NTile) else 0))
            elif isinstance(fn, we.Lead):  # Lag subclasses Lead
                slots.append(("pick", len(picks), input_of(fn),
                              None if fn.default is None
                              else fn.default.eval(ctx)))
                picks.append(W.Pick(kernels.PICK_SHIFT, offset=fn.offset))
            elif isinstance(fn, First):  # Last subclasses First
                inp = input_of(fn)
                last = isinstance(fn, Last)
                if fn.ignore_nulls:
                    kind = (kernels.PICK_LAST_VALID if last
                            else kernels.PICK_FIRST_VALID)
                    pcnt = prefix(inp, torch.int64, True)
                else:
                    kind = kernels.PICK_LAST if last else kernels.PICK_FIRST
                    pcnt = None
                slots.append(("pick", len(picks), inp, None))
                picks.append(W.Pick(kind, frame_of(wexpr), pcnt=pcnt))
            elif isinstance(fn, (Min, Max)):
                inp = input_of(fn)
                d, v = W.frame_minmax_eval(
                    inp.data, inp.validity, sw, frame_of(wexpr),
                    isinstance(fn, Max), prefix(inp, torch.int64, True),
                    perm=sw.perm, inv=inv)
                slots.append(("col", DeviceColumn(wexpr.dtype, d, v)))
            elif isinstance(fn, CollectList):  # CollectSet subclasses it
                # K33 over the bounded ROWS frame (the planner refuses any
                # other), at each row's input position; never null
                inp = input_of(fn)
                fr = wexpr.spec.frame
                d, ev, lens = W.frame_collect(
                    inp.data, inp.validity, sw, fr.lower, fr.upper,
                    isinstance(fn, CollectSet))
                slots.append(("col", DeviceColumn(
                    wexpr.dtype, d, torch.ones_like(inp.validity), lens,
                    elem_validity=ev)))
            elif isinstance(fn, (VariancePop, VarianceSamp)):
                # moments over frames from K14's prefix frames of x and
                # x^2 and its count (StddevPop/Samp subclass these), as
                # the reference's whole-partition evaluation
                fr = frame_of(wexpr)
                inp = input_of(fn)
                sq_key = ("x^2", fn.input.key())
                if sq_key not in inputs:
                    x = inp.data.to(torch.float64)
                    inputs[sq_key] = inp.replace(data=x * x)
                pcnt = prefix(inp, torch.int64, True)
                slots.append(("var", len(reqs), fn))
                reqs += [W.WinRequest(kernels.WIN_COUNT, fr, pcnt=pcnt),
                         W.WinRequest(kernels.WIN_SUM_F64, fr,
                                      prefix(inp, torch.float64, False),
                                      pcnt),
                         W.WinRequest(kernels.WIN_SUM_F64, fr,
                                      prefix(inputs[sq_key], torch.float64,
                                             False), pcnt)]
            elif isinstance(fn, (Count, Sum, Average)):
                fr = frame_of(wexpr)
                inp = input_of(fn) if fn.input is not None else None
                pcnt = prefix(inp, torch.int64, True)
                slots.append(("eval", len(reqs)))
                if isinstance(fn, Count):
                    reqs.append(W.WinRequest(kernels.WIN_COUNT, fr,
                                             pcnt=pcnt))
                elif isinstance(fn, Average):
                    reqs.append(W.WinRequest(
                        kernels.WIN_AVG, fr,
                        prefix(inp, torch.float64, False), pcnt))
                else:
                    acc = torch_dtype(wexpr.dtype)
                    kind = (kernels.WIN_SUM_F64 if acc == torch.float64
                            else kernels.WIN_SUM_I64)
                    reqs.append(W.WinRequest(kind, fr,
                                             prefix(inp, acc, False), pcnt))
            else:
                raise NotImplementedError(
                    f"window function {type(fn).__name__} is not ported "
                    "yet (ROADMAP A12)")
        evals = W.window_eval(sw, reqs, sw.perm, inv) if reqs else []
        picked = W.frame_pick(sw, picks, sw.perm, inv) if picks else []
        # every picked leaf in one K8 launch
        srcs, idxs = [], []
        for slot in slots:
            if slot[0] == "pick":
                leaves = slot[2].leaves()
                srcs += leaves
                idxs += [picked[slot[1]][0]] * len(leaves)
        gathered = iter(gather_leaves(srcs, idxs) if srcs else [])
        new_cols = []
        for alias, slot in zip(self.window_exprs, slots):
            dt = alias.children[0].dtype
            if slot[0] == "eval":
                d, v = evals[slot[1]]
                new_cols.append(DeviceColumn(dt, d, v))
            elif slot[0] == "var":
                new_cols.append(_frame_variance(
                    slot[2], *[evals[slot[1] + i][0] for i in range(3)]))
            elif slot[0] == "col":
                new_cols.append(slot[1])
            else:
                _, k, inp, default = slot
                has = picked[k][1]
                col = inp.with_leaves([next(gathered)
                                       for _ in inp.leaves()])
                col = col.replace(dtype=dt, validity=col.validity & has,
                                  vrange=None)
                if default is not None:
                    col = col.replace(
                        data=_row_select(has, col.data, default.data),
                        validity=torch.where(has, col.validity,
                                             default.validity),
                        lengths=None if col.lengths is None else
                        torch.where(has, col.lengths, default.lengths))
                new_cols.append(col)
        return ColumnBatch(self.schema, list(batch.columns) + new_cols,
                           batch.num_rows)

    def execute_partition(self, pid, ctx):
        if self.presorted and self.halo is not None:
            yield from self._execute_batched(pid, ctx)
            return
        if self.mode == "running":
            yield from self._execute_running(pid, ctx)
            return
        if self.mode == "u2u":
            yield from self._execute_u2u(pid, ctx)
            return
        pending = list(self.children[0].execute_partition(pid, ctx))
        if not pending:
            return
        merged = concat_batches(pending) if len(pending) > 1 \
            else pending[0]
        yield self._run(merged)

    # --- bounded-frame batched path (GpuBatchedBoundedWindowExec role) ---

    @staticmethod
    def _slice_rows(batch: ColumnBatch, start: int, count: int
                    ) -> ColumnBatch:
        """Rows [start, start + count) at a capacity bucket (one K8
        gather)."""
        cap = next_capacity(count)
        idx = (torch.arange(cap, dtype=torch.int32, device=batch.device)
               + start).clamp(0, batch.capacity - 1)
        return batch.gather(idx, count)

    def _window_chunk(self, prefix: Optional[ColumnBatch],
                      chunk: ColumnBatch,
                      suffix: Optional[ColumnBatch]) -> ColumnBatch:
        """Evaluate one sorted chunk with halo context and slice out the
        chunk's own rows. Input order is sorted order (the child is a
        chunked TpuSortExec), so row positions survive the window's own
        sort: K9's sort is stable."""
        parts = [p for p in (prefix, chunk, suffix) if p is not None]
        merged = concat_batches(parts) if len(parts) > 1 else parts[0]
        out = self._run(merged)
        start = prefix.row_count() if prefix is not None else 0
        return self._slice_rows(out, start, chunk.row_count())

    def _execute_batched(self, pid, ctx):
        h = max(self.halo, 1)
        prefix: Optional[ColumnBatch] = None  # last h rows seen
        pending: Optional[ColumnBatch] = None  # chunk awaiting suffix
        for batch in self.children[0].execute_partition(pid, ctx):
            if pending is not None:
                suffix = self._slice_rows(batch, 0,
                                          min(h, batch.row_count()))
                yield self._window_chunk(prefix, pending, suffix)
                joined = (concat_batches([prefix, pending])
                          if prefix is not None else pending)
                tail_n = min(h, joined.row_count())
                prefix = self._slice_rows(joined, joined.row_count() - tail_n,
                                          tail_n)
            pending = batch
        if pending is not None:
            yield self._window_chunk(prefix, pending, None)

    # --- running-window streaming path (GpuRunningWindowExec role) ---

    def _running_plan(self) -> List[str]:
        """Per window expression, how the carried state adjusts the
        in-chunk value."""
        from spark_rapids_tpu_torch.expr import windows as we

        plan = []
        for a in self.window_exprs:
            fn = a.children[0].function
            if isinstance(fn, we.RowNumber):
                plan.append("rownum")
            elif isinstance(fn, we.DenseRank):
                plan.append("dense")
            elif isinstance(fn, we.Rank):
                plan.append("rank")
            elif isinstance(fn, Count):
                plan.append("count")
            elif isinstance(fn, Sum):
                plan.append("sum")
            elif isinstance(fn, Min):
                plan.append("min")
            else:
                assert isinstance(fn, Max), fn
                plan.append("max")
        return plan

    @staticmethod
    def _rows_eq(col: DeviceColumn, ref_data: torch.Tensor,
                 ref_valid: torch.Tensor) -> torch.Tensor:
        """Per-row null-safe equality of a key column against a 1-row
        carried reference (null == null, and NaN == NaN: partition
        membership uses the sort's total order, where NaNs group)."""
        d = col.data
        if d.dim() == 2:
            eq = (d == ref_data).all(dim=1)
        else:
            r = ref_data.reshape(())
            eq = d == r
            if d.dtype.is_floating_point:
                eq = eq | (torch.isnan(d) & torch.isnan(r))
        rv = ref_valid.reshape(())
        return (~col.validity & ~rv) | (col.validity & rv & eq)

    def _running_fix(self, out: ColumnBatch, carry: dict):
        """Adjust the prefix of a sorted chunk that continues the carried
        partition, then refresh the carry from the chunk's last row. All
        state stays on the device (1-row tensors); elementwise torch, as
        the reference's fix-up is elementwise exec code."""
        ctx = EvalContext(out)
        spec = self.spec0
        nbase = len(self.schema.fields) - len(self.window_exprs)
        live = out.live_mask()
        nr = out.num_rows
        if isinstance(nr, torch.Tensor):
            has = nr.reshape(()) > 0
            last = (nr.to(torch.int64) - 1).clamp(min=0).reshape(1)
        else:  # a host count: no copy to the card
            has = nr > 0
            last = torch.full((1,), max(nr - 1, 0), dtype=torch.int64,
                              device=out.device)

        def at_last(x):
            return x.index_select(0, last)

        pcols = [p.eval(ctx) for p in spec.partitions]
        ocols = [o.expr.eval(ctx) for o in spec.orders]
        mask = live & carry["live"].reshape(())
        for i, c in enumerate(pcols):
            mask = mask & self._rows_eq(c, carry[f"pk{i}"],
                                        carry[f"pkv{i}"])
        peer = mask
        for j, c in enumerate(ocols):
            peer = peer & self._rows_eq(c, carry[f"ok{j}"],
                                        carry[f"okv{j}"])

        plan = self._running_plan()
        n_carry = carry["n"].reshape(())
        new_cols = list(out.columns)
        for i, kind in enumerate(plan):
            col = out.columns[nbase + i]
            cvs = carry[f"v{i}"].reshape(())
            cvvs = carry[f"vv{i}"].reshape(())
            dt = col.data.dtype
            if kind == "rownum":
                col = col.replace(data=torch.where(
                    mask, col.data + n_carry, col.data).to(dt))
            elif kind == "rank":
                shifted = col.data + n_carry
                d = torch.where(peer, cvs.to(shifted.dtype), shifted)
                col = col.replace(data=torch.where(mask, d, col.data).to(dt))
            elif kind == "dense":
                # the chunk's first distinct order-group continues the
                # carried group iff the first masked row is a peer (the
                # reference's any(peer & (cumsum(mask) == 1)): peer rows
                # are masked rows)
                first = mask.to(torch.int32).argmax().reshape(1)
                first_peer = peer.index_select(0, first).reshape(())
                off = cvs - first_peer.to(cvs.dtype)
                col = col.replace(data=torch.where(
                    mask, col.data + off, col.data).to(dt))
            elif kind == "count":
                col = col.replace(data=torch.where(
                    mask & cvvs, col.data + cvs.to(dt), col.data))
            else:  # sum / min / max with a null-skipping combine
                both = mask & cvvs & col.validity
                c_only = mask & cvvs & ~col.validity
                cv = cvs.to(dt).expand_as(col.data)
                if kind == "sum":
                    comb = col.data + cv
                else:
                    comb = _float_minmax(col.data, cv, kind == "max")
                d = torch.where(both, comb, torch.where(c_only, cv,
                                                        col.data))
                col = col.replace(data=d,
                                  validity=col.validity | (mask & cvvs))
            new_cols[nbase + i] = col
        fixed = ColumnBatch(out.schema, new_cols, out.num_rows)

        # refresh the carry from the FIXED chunk's last row

        def keep(new, old):
            if isinstance(has, bool):
                return new if has else old
            return torch.where(has, new, old)

        nc = dict(carry)
        nc["live"] = keep(torch.ones_like(carry["live"]), carry["live"])
        for i, c in enumerate(pcols):
            nc[f"pk{i}"] = keep(at_last(c.data), carry[f"pk{i}"])
            nc[f"pkv{i}"] = keep(at_last(c.validity), carry[f"pkv{i}"])
        for j, c in enumerate(ocols):
            nc[f"ok{j}"] = keep(at_last(c.data), carry[f"ok{j}"])
            nc[f"okv{j}"] = keep(at_last(c.validity), carry[f"okv{j}"])
        # rows so far in the last row's partition
        in_last = live
        for c in pcols:
            in_last = in_last & self._rows_eq(c, at_last(c.data),
                                              at_last(c.validity))
        cnt = in_last.sum().to(torch.int64)
        cont = at_last(mask).reshape(())  # last row still in the carry's
        nc["n"] = keep((cnt + torch.where(cont, n_carry,
                                          torch.zeros_like(n_carry)))
                       .reshape(1), carry["n"])
        for i in range(len(plan)):
            col = fixed.columns[nbase + i]
            nc[f"v{i}"] = keep(at_last(col.data), carry[f"v{i}"])
            nc[f"vv{i}"] = keep(at_last(col.validity), carry[f"vv{i}"])
        return fixed, nc

    def _running_init_carry(self, batch: ColumnBatch) -> dict:
        """Zero carry matching the chunk's key and value shapes."""
        ctx = EvalContext(batch)
        spec = self.spec0
        nbase = len(self.schema.fields) - len(self.window_exprs)
        dev = batch.device
        carry = {"live": torch.zeros(1, dtype=torch.bool, device=dev),
                 "n": torch.zeros(1, dtype=torch.int64, device=dev)}

        def z(c):
            return (torch.zeros((1,) + tuple(c.data.shape[1:]),
                                dtype=c.data.dtype, device=dev),
                    torch.zeros(1, dtype=torch.bool, device=dev))

        for i, p in enumerate(spec.partitions):
            carry[f"pk{i}"], carry[f"pkv{i}"] = z(p.eval(ctx))
        for j, o in enumerate(spec.orders):
            carry[f"ok{j}"], carry[f"okv{j}"] = z(o.expr.eval(ctx))
        for i in range(len(self.window_exprs)):
            f = self.schema.fields[nbase + i]
            carry[f"v{i}"] = torch.zeros(1, dtype=torch_dtype(f.dataType),
                                         device=dev)
            carry[f"vv{i}"] = torch.zeros(1, dtype=torch.bool, device=dev)
        return carry

    def _execute_running(self, pid, ctx):
        """Sorted chunks plus the carried per-partition scan state: device
        residency stays O(chunk) while ranks and running frames stay
        exact across chunk boundaries."""
        carry = None
        for batch in self.children[0].execute_partition(pid, ctx):
            if carry is None:
                carry = self._running_init_carry(batch)
            out, carry = self._running_fix(self._run(batch), carry)
            yield out

    # --- unbounded-to-unbounded two-pass path ---

    @staticmethod
    def _null_safe_keys(batch: ColumnBatch, key_cols):
        """Append [IsNull marker, zero-filled value] per key column so null
        partitions probe-match their own group (the join probe drops null
        keys; zero-filling invalid rows plus the marker makes every key
        column non-null while keeping keys distinct). -> (work batch, key
        ordinals)."""
        from spark_rapids_tpu_torch.sqltypes.datatypes import boolean

        cols = list(batch.columns)
        fields = list(batch.schema.fields)
        idxs = []
        for k, c in enumerate(key_cols):
            ones = torch.ones(c.capacity, dtype=torch.bool, device=c.device)
            isn = DeviceColumn(boolean, ~c.validity, ones)
            vb = c.validity[:, None] if c.data.dim() == 2 else c.validity
            coal = c.replace(
                data=torch.where(vb, c.data, torch.zeros_like(c.data)),
                validity=ones,
                lengths=None if c.lengths is None
                else torch.where(c.validity, c.lengths, 0))
            idxs.append(len(cols))
            cols.append(isn)
            fields.append(StructField(f"__wn{k}", boolean, False))
            idxs.append(len(cols))
            cols.append(coal)
            fields.append(StructField(f"__wv{k}", c.dtype, False))
        return (ColumnBatch(StructType(fields), cols, batch.num_rows),
                idxs)

    def _execute_u2u(self, pid, ctx):
        """Two passes (GpuUnboundedToUnboundedAggWindowExec role): (1) keep
        the chunks while folding per-chunk partition partials into one
        bounded buffer batch; (2) finalize the aggregates and re-scan the
        kept chunks, each row looking up its partition's result (null-safe
        key probe). The chunks wait in a Python list until ROADMAP A10's
        spill catalog can park them."""
        spec = self.spec0
        grouping = [Alias(p, f"__wk{i}")
                    for i, p in enumerate(spec.partitions)]
        aggs = [Alias(a.children[0].function, a.name)
                for a in self.window_exprs]
        child = self.children[0]
        agg = TpuHashAggregateExec("partial", grouping, aggs, child,
                                   self.conf)
        fold_every = _conf_get(self.conf, rc.WINDOW_U2U_FOLD, 8)
        parked: List[ColumnBatch] = []
        pend_parts: List[ColumnBatch] = []
        partials = None

        def fold_partials():
            """Fold pending per-chunk partials into the buffer batch,
            every fold_every chunks, so the concat's host sync and the
            whole-buffer re-merge amortize."""
            nonlocal partials
            if not pend_parts:
                return
            bs = ([] if partials is None else [partials]) + pend_parts
            partials = agg._merge_buffers(concat_batches(bs))
            pend_parts.clear()

        for batch in child.execute_partition(pid, ctx):
            parked.append(batch)
            pend_parts.append(agg._partial(batch))
            if len(pend_parts) >= fold_every:
                fold_partials()
        if not parked:
            return
        fold_partials()
        # a final-mode twin evaluates buffers -> results (its schema is the
        # result layout; the partial's is the buffer layout)
        agg_f = TpuHashAggregateExec("final", grouping, aggs, child,
                                     self.conf)
        final = agg_f._merge_final(partials)   # [keys, results]
        nk = len(grouping)
        build = None
        if nk:
            fwork, fidx = self._null_safe_keys(
                final, [final.columns[i] for i in range(nk)])
            build = joinops.build_side(fwork, fidx)
        while parked:
            b = parked.pop(0)
            if nk:
                ctx2 = EvalContext(b)
                key_cols = [g.children[0].eval(ctx2) for g in grouping]
                pwork, pidx = self._null_safe_keys(b, key_cols)
                lo, counts = joinops.probe_ranges(build, pwork, pidx)
                safe = lo.clamp(0, build.batch.capacity - 1)
                src = build.batch
                matched = counts > 0
            else:
                # one global partition: broadcast row 0
                safe = torch.zeros(b.capacity, dtype=torch.int32,
                                   device=b.device)
                src = final
                matched = torch.ones(b.capacity, dtype=torch.bool,
                                     device=b.device)
            res = gather_columns([(src.columns[nk + i], safe)
                                  for i in range(len(self.window_exprs))])
            res = [c.replace(validity=c.validity & matched) for c in res]
            yield ColumnBatch(self.schema, list(b.columns) + res,
                              b.num_rows)
