"""Physical operators — counterpart of `spark_rapids_tpu/exec/operators.py`
for the cached-relation source, filter, project and the hash aggregate.

The hash aggregate keeps the reference's two grouping paths:
- binned (`_partial_binned`): when every group key is an integer column
  or dictionary codes with a static `vrange`, each row's bin id is
  computed elementwise and the reductions run straight in bin space
  (kernel K4, unsorted ids; one launch for a Sum/Average/count(*)
  aggregate), with no sort at all; q5's `region` codes take this path;
- sorted (`segmented.group_by`): sort by orderable keys, segment
  boundaries, then the same reductions over sorted ids. The merge of
  partial buffers always takes it.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar import encoding as _encoding
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_batches,
    next_capacity,
)
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.expr.aggregates import (
    AggregateFunction,
    Average,
    Count,
    Sum,
)
from spark_rapids_tpu_torch.expr.core import Alias, EvalContext
from spark_rapids_tpu_torch.ops import filterops, segmented
from spark_rapids_tpu_torch.sqltypes import StructField, StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import long, torch_dtype


class TpuCachedRelationExec(PhysicalPlan):
    """Source over a device-resident cache entry (exec/relation_cache.py):
    one partition per cached part."""

    def __init__(self, entry):
        super().__init__([], entry.schema)
        self.entry = entry

    @property
    def num_partitions(self):
        return max(1, self.entry.num_parts())

    def execute_partition(self, pid, ctx):
        if pid < self.entry.num_parts():
            yield self.entry.device_part(pid)


class TpuProjectExec(PhysicalPlan):
    def __init__(self, exprs: List[Alias], child, schema):
        super().__init__([child], schema)
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
    def __init__(self, condition, child):
        super().__init__([child], child.schema)
        self.condition = condition

    def _run(self, batch: ColumnBatch) -> ColumnBatch:
        pred = self.condition.eval(EvalContext(batch))
        return filterops.compact(batch, pred.data & pred.validity)

    def execute_partition(self, pid, ctx):
        for batch in self.children[0].execute_partition(pid, ctx):
            yield self._run(batch)


def _buffer_schema(grouping: List[Alias], aggs: List[Alias]) -> StructType:
    fields = [StructField(g.name, g.dtype, True) for g in grouping]
    for a in aggs:
        fn: AggregateFunction = a.children[0]
        for j, bt in enumerate(fn.buffer_types()):
            fields.append(StructField(f"{a.name}#buf{j}", bt, True))
    return StructType(fields)


class TpuHashAggregateExec(PhysicalPlan):
    """mode='complete': partial aggregation of every input batch, then one
    sorted merge and final evaluation, emitting [keys..., results...].

    The reference plans complete mode only over a single-partition child;
    the port's plans are built by hand without an exchange, so complete
    mode here is ONE output partition that drains every child partition
    (q5: 8 cached parts -> 8 binned partials -> one merge). Partial and
    final modes come with the exchange in a later slice. Partials are
    merged early (`_merge_buffers`) once their capacity passes
    2 * target_rows, as the reference does, without its spill parking."""

    #: partial capacity that triggers an early merge (the reference's
    #: default spark.rapids.sql.batchSizeRows)
    target_rows = 1 << 20

    def __init__(self, mode: str, grouping: List[Alias], aggs: List[Alias],
                 child):
        if mode != "complete":
            raise NotImplementedError(
                f"{mode} aggregation is not ported yet (complete only)")
        self.mode = mode
        self.grouping = grouping
        self.aggs = aggs
        out_schema = StructType(
            [StructField(g.name, g.dtype, True) for g in grouping]
            + [StructField(a.name, a.dtype, True) for a in aggs])
        super().__init__([child], out_schema)

    @property
    def num_partitions(self):
        return 1

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

    def _partial(self, batch: ColumnBatch) -> ColumnBatch:
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
            return self._partial_binned(work, ranges, input_groups)
        g = segmented.group_by(work, list(range(nkeys)))
        cap = work.capacity
        out_cols = self._keys_prefix(g, nkeys, cap)
        ci = nkeys
        for a, grp in zip(self.aggs, input_groups):
            vals = g.sorted_batch.columns[ci] if grp else None
            ci += len(grp)
            out_cols.extend(a.children[0].update(vals, g.live, g.gid, cap))
        return ColumnBatch(_buffer_schema(self.grouping, self.aggs),
                           out_cols, g.num_groups)

    def _partial_binned(self, work: ColumnBatch, ranges,
                        input_groups) -> ColumnBatch:
        """Sort-free partial aggregation entirely in BIN space: one
        elementwise pass gives each row its bin id, K4 reduces over the
        (unsorted) ids, and the group keys are decoded analytically from
        the bin index (bin = sum((value - lo + 1) * stride), 0 = null)."""
        nkeys = len(self.grouping)
        cap = work.capacity
        device = work.device
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
                           [c.gather(perm) for c in out_cols], num_groups)

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
        """Group key columns: the first row of each segment. Gather keeps
        an encoded key's dictionary; plain keys drop vrange, as in the
        reference."""
        safe = g.first_pos.clamp(0, cap - 1)
        out_cols = []
        for ki in range(nkeys):
            out = g.sorted_batch.columns[ki].gather(safe)
            if out.encoding is None and out.vrange is not None:
                out = out.replace(vrange=None)
            out_cols.append(out)
        return out_cols

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

    def execute_partition(self, pid, ctx):
        pending: List[ColumnBatch] = []
        pending_rows = 0
        child = self.children[0]
        for cpid in range(child.num_partitions):
            for batch in child.execute_partition(cpid, ctx):
                part = self._partial(batch)
                pending.append(part)
                pending_rows += part.capacity
                if len(pending) > 1 and pending_rows > 2 * self.target_rows:
                    compacted = self._merge_buffers(concat_batches(pending))
                    pending = [compacted]
                    # one exact sync per compaction, as the reference
                    pending_rows = compacted.row_count()
        if not pending:
            if not self.grouping:
                raise NotImplementedError(
                    "global aggregation over empty input is not ported yet")
            return
        yield self._merge_final(concat_batches(pending))
