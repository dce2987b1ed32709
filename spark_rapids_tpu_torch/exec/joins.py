"""Join operators — counterpart of the inner equi-join path of
`spark_rapids_tpu/exec/joins.py`: `_DeviceJoinBase` (key preparation,
build table, the bloom prefilter, the unconditioned fast path) and
`TpuBroadcastHashJoinExec`, whose build table is made once and shared by
every probe partition.

The per-partition flow: the bloom prefilter (kernel K5; on by default,
spark.rapids.sql.join.bloomFilter.enabled) tests every probe row against
the build keys' filter and, only when rows provably miss, compacts the
probe batch; K2 finds each probe row's build range, the host reads the
match total (the sync that picks the output capacity), K3 expands the
ranges into gather maps, and one K8 launch gathers both sides. Outer,
semi, anti and conditional joins and the shuffled join are not ported
yet (ROADMAP A13).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    concat_batches,
    gather_columns,
    next_capacity,
)
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.expr.core import (
    BoundReference,
    EvalContext,
    Expression,
)
from spark_rapids_tpu_torch.ops import bloom, filterops, joinops
from spark_rapids_tpu_torch.sqltypes import StructField, StructType


class _DeviceJoinBase(PhysicalPlan):
    """Shared device equi-join machinery over gather maps."""

    def __init__(self, left, right, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], schema, conf=None):
        if join_type != "inner":
            raise NotImplementedError(
                f"{join_type} join is not ported yet (inner only; ROADMAP "
                "A13)")
        super().__init__([left, right], schema, conf)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self._bloom_cache = None

    def _prepare_keys(self, batch: ColumnBatch, keys):
        """(batch_with_keys, key_ordinals): plain column refs use the batch
        as is; computed keys are evaluated and appended as temp columns."""
        if all(isinstance(k, BoundReference) for k in keys):
            return batch, [k.ordinal for k in keys]
        ctx = EvalContext(batch)
        kcols = [k.eval(ctx) for k in keys]
        fields = list(batch.schema.fields) + [
            StructField(f"__jk{i}", c.dtype, True)
            for i, c in enumerate(kcols)]
        work = ColumnBatch(StructType(fields), list(batch.columns) + kcols,
                           batch.num_rows)
        n0 = len(batch.columns)
        return work, list(range(n0, n0 + len(keys)))

    def _build_table(self, right: ColumnBatch) -> joinops.BuildTable:
        work_r, rk = self._prepare_keys(right, self.right_keys)
        bt = joinops.build_side(work_r, rk)
        if len(bt.batch.columns) != len(right.columns):
            # strip temp key columns from the (sorted) build batch
            bt = joinops.BuildTable(
                ColumnBatch(right.schema,
                            bt.batch.columns[:len(right.columns)],
                            bt.batch.num_rows),
                bt.keys, bt.valid_bound)
        return bt

    def _bloom_prefilter(self, left: ColumnBatch,
                         right: ColumnBatch) -> ColumnBatch:
        """Build-side bloom filter applied to the probe side before the
        probe: provably-absent keys drop and the probe batch re-buckets
        to a smaller capacity. The filter is built once per build batch
        and paid only when the probe capacity is at least 4x the build
        rows; the host reads how many live rows it keeps (K5 counts them
        in the same launch) and compacts only when some dropped."""
        if self.conf is not None and not self.conf.get(rc.JOIN_BLOOM_FILTER):
            return left
        build_rows = right.row_count()
        if build_rows == 0 or left.capacity < 4 * build_rows:
            return left
        cached = self._bloom_cache
        if cached is not None and cached[0] is right:
            bits = cached[1]
        else:
            work_r, rk = self._prepare_keys(right, self.right_keys)
            bits = bloom.build([work_r.columns[i] for i in rk],
                               right.live_mask(), bloom.size_for(build_rows))
            self._bloom_cache = (right, bits)
        work_l, lk = self._prepare_keys(left, self.left_keys)
        keep, kept = bloom.might_contain_count(
            bits, [work_l.columns[i] for i in lk], left.num_rows)
        rows = left.row_count()
        n = int(kept.item())
        if n == rows:
            return left  # nothing provably absent: skip the compaction
        reduced = filterops.compact(left, keep)
        cap2 = next_capacity(n)
        if cap2 >= left.capacity:
            return reduced
        return ColumnBatch(reduced.schema,
                           [c.truncate(cap2) for c in reduced.columns], n)

    def _fast_equi_join(self, left: ColumnBatch, bt: joinops.BuildTable,
                        lo, counts) -> ColumnBatch:
        # the one host sync: the match total picks the output capacity
        total = int(counts.sum().item())
        cap_out = next_capacity(total)
        pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap_out)
        right = bt.batch
        # K3 keeps bi in [0, build capacity), so no clip is needed; both
        # sides gather in one launch
        cols = gather_columns([(c, pi) for c in left.columns]
                              + [(c, bi) for c in right.columns])
        out_schema = StructType(list(left.schema.fields)
                                + list(right.schema.fields))
        return ColumnBatch(out_schema, cols, total)

    def _join_batches(self, left_batches: List[ColumnBatch],
                      right: Optional[ColumnBatch],
                      prepared_bt: joinops.BuildTable
                      ) -> Optional[ColumnBatch]:
        if not left_batches or right is None:
            return None
        left = (left_batches[0] if len(left_batches) == 1
                else concat_batches(left_batches))
        left = self._bloom_prefilter(left, right)
        work_l, lk = self._prepare_keys(left, self.left_keys)
        lo, counts = joinops.probe_ranges(prepared_bt, work_l, lk)
        return self._fast_equi_join(left, prepared_bt, lo, counts)


class TpuBroadcastHashJoinExec(_DeviceJoinBase):
    """Equi-join with the (small) right side materialised ONCE and its
    sorted build table shared by every probe partition; no exchange on
    either side."""

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 schema, conf=None):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         schema, conf)
        self._bt_lock = threading.Lock()
        self._build: Optional[ColumnBatch] = None
        self._bt: Optional[joinops.BuildTable] = None
        self._built = False

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def _broadcast_build_table(self, ctx):
        """(build batch, prepared build table), or (None, None) for an
        empty build side; made once per node."""
        with self._bt_lock:
            if not self._built:
                rchild = self.children[1]
                batches = [b for rp in range(rchild.num_partitions)
                           for b in rchild.execute_partition(rp, ctx)]
                if batches:
                    self._build = concat_batches(batches)
                    self._bt = self._build_table(self._build)
                self._built = True
            return self._build, self._bt

    def execute_partition(self, pid, ctx):
        build, bt = self._broadcast_build_table(ctx)
        if build is None:
            return  # inner join against an empty build side
        left_batches = list(self.children[0].execute_partition(pid, ctx))
        out = self._join_batches(left_batches, build, bt)
        if out is not None:
            yield out
