"""Join operators — counterpart of the inner equi-join path of
`spark_rapids_tpu/exec/joins.py`: `_DeviceJoinBase` (key preparation,
build table, the unconditioned fast path) and `TpuBroadcastHashJoinExec`,
whose build table is made once and shared by every probe partition.

The per-partition flow: K2 finds each probe row's build range, the host
reads the match total (the one sync the join needs, to pick the output
capacity), K3 expands the ranges into gather maps, and both sides gather.
Outer, semi, anti and conditional joins, the shuffled join and the bloom
prefilter are not ported yet.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    concat_batches,
    next_capacity,
)
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.expr.core import (
    BoundReference,
    EvalContext,
    Expression,
)
from spark_rapids_tpu_torch.ops import joinops
from spark_rapids_tpu_torch.sqltypes import StructField, StructType


class _DeviceJoinBase(PhysicalPlan):
    """Shared device equi-join machinery over gather maps."""

    def __init__(self, left, right, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], schema):
        if join_type != "inner":
            raise NotImplementedError(
                f"{join_type} join is not ported yet (inner only)")
        super().__init__([left, right], schema)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)

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

    def _fast_equi_join(self, left: ColumnBatch, bt: joinops.BuildTable,
                        lo: torch.Tensor, counts: torch.Tensor
                        ) -> ColumnBatch:
        # the one host sync: the match total picks the output capacity
        total = int(counts.sum().item())
        cap_out = next_capacity(total)
        pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap_out)
        right = bt.batch
        lcols = [c.gather(pi) for c in left.columns]
        bi = bi.clamp(0, right.capacity - 1)
        rcols = [c.gather(bi) for c in right.columns]
        out_schema = StructType(list(left.schema.fields)
                                + list(right.schema.fields))
        return ColumnBatch(out_schema, lcols + rcols, total)

    def _join_batches(self, left_batches: List[ColumnBatch],
                      prepared_bt: joinops.BuildTable
                      ) -> Optional[ColumnBatch]:
        if not left_batches:
            return None
        left = concat_batches(left_batches)
        work_l, lk = self._prepare_keys(left, self.left_keys)
        lo, counts = joinops.probe_ranges(prepared_bt, work_l, lk)
        return self._fast_equi_join(left, prepared_bt, lo, counts)


class TpuBroadcastHashJoinExec(_DeviceJoinBase):
    """Equi-join with the (small) right side materialised ONCE and its
    sorted build table shared by every probe partition; no exchange on
    either side."""

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 schema):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         schema)
        self._bt_lock = threading.Lock()
        self._bt: Optional[joinops.BuildTable] = None
        self._build_empty = False

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def _broadcast_build_table(self, ctx) -> Optional[joinops.BuildTable]:
        with self._bt_lock:
            if self._bt is None and not self._build_empty:
                rchild = self.children[1]
                batches = [b for rp in range(rchild.num_partitions)
                           for b in rchild.execute_partition(rp, ctx)]
                if batches:
                    self._bt = self._build_table(concat_batches(batches))
                else:
                    self._build_empty = True
            return self._bt

    def execute_partition(self, pid, ctx):
        bt = self._broadcast_build_table(ctx)
        if bt is None:
            return  # inner join against an empty build side
        left_batches = list(self.children[0].execute_partition(pid, ctx))
        out = self._join_batches(left_batches, bt)
        if out is not None:
            yield out
