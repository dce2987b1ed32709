"""The helpers of `spark_rapids_tpu/parallel/plan_compiler.py` that the
fused single-chip engine (exec/fused.py) uses, under the reference's
names: `concat_traced` and `shard_equi_join`. `_plan_key` is not ported:
it keys compiled XLA programs, which eager PyTorch does not have. The
mesh executor around them is not ported yet (ROADMAP A16).
"""

from __future__ import annotations

from typing import Optional, Tuple

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    concat_compacted,
    gather_columns,
    next_capacity,
)
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.ops import joinops
from spark_rapids_tpu_torch.sqltypes import StructType


#: concat at the sum of the capacities, live rows compacted to the front,
#: with no host sync
concat_traced = concat_compacted


def shard_equi_join(node: J._DeviceJoinBase, left: ColumnBatch,
                    right: ColumnBatch, out_cap: int
                    ) -> Tuple[Optional[ColumnBatch], bool]:
    """Equi-join of two batches whose output may hold at most `out_cap`
    rows (the reference's static capacity). Returns (batch, overflow):
    overflow means the pairs exceed out_cap (the batch is then None) and
    the caller retries with a larger expansion factor, as in the
    reference.

    Eager PyTorch needs no static capacity, so the output is sized from
    the match total, which costs one host sync: next_capacity(total)
    rows, never more than out_cap. The port's joins are inner and
    unconditioned (other types raise when planned, ROADMAP A13)."""
    bt = node._build_table(right)
    work_l, lk = node._prepare_keys(left, node.left_keys)
    lo, counts = joinops.probe_ranges(bt, work_l, lk)
    total = int(counts.sum().item())
    if total > out_cap:
        return None, True
    cap = min(out_cap, next_capacity(total))
    pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap)
    cols = gather_columns([(c, pi) for c in left.columns]
                          + [(c, bi) for c in bt.batch.columns])
    schema = StructType(list(node.children[0].schema.fields)
                        + list(node.children[1].schema.fields))
    return ColumnBatch(schema, cols, total), False
