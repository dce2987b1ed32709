"""The helpers of `spark_rapids_tpu/parallel/plan_compiler.py` that the
fused single-chip engine (exec/fused.py) uses, under the reference's
names: `concat_traced` and `shard_equi_join` (every join type, with or
without a condition). `_plan_key` is not ported: it keys compiled XLA
programs, the join's own key among them, which eager PyTorch does not
have. The mesh executor around them, its full-join lowering included, is
not ported yet (ROADMAP A16).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    concat_compacted,
    next_capacity,
)
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.expr.core import EvalContext
from spark_rapids_tpu_torch.ops import filterops, joinops
from spark_rapids_tpu_torch.sqltypes import StructType


#: concat at the sum of the capacities, live rows compacted to the front,
#: with no host sync
concat_traced = concat_compacted


def shard_equi_join(node: J._DeviceJoinBase, left: ColumnBatch,
                    right: ColumnBatch, out_cap: int
                    ) -> Tuple[Optional[ColumnBatch], bool]:
    """A join of two whole batches, of any type, with or without a
    condition, whose expanded output may hold at most `out_cap` rows (the
    reference's static capacity). Returns (batch, overflow): overflow
    means the rows exceed out_cap (the batch is then None) and the caller
    retries with a larger expansion factor, as in the reference.

    The same gather-map algorithm as the join operators (exec/joins.py).
    Eager PyTorch needs no static capacity, so the output is sized from
    the match total, which costs one host sync: next_capacity(total) rows,
    never more than out_cap. Both sides are in hand, so dictionary-encoded
    string keys compare codes (re-encoded by K29 when the dictionaries
    differ)."""
    jt = node.join_type
    lsch = node.children[0].schema
    rsch = node.children[1].schema
    lkeys, rkeys = node._encoded_key_rewrite(left, right)
    bt = node._build_table(right, keys=rkeys)
    work_l, lk = node._prepare_keys(left, lkeys)
    lo, counts = joinops.probe_ranges(bt, work_l, lk)

    if node.condition is None:
        if jt == "left_semi":
            return filterops.compact(left, counts > 0), False
        if jt == "left_anti":
            return filterops.compact(left, counts == 0), False
        if jt == "existence":
            return node._exists_batch(left, counts > 0), False
        outer = jt in ("left", "full")
        eff = counts
        if outer:
            eff = torch.where(left.live_mask() & (counts == 0), 1,
                              counts).to(torch.int32)
        total = int(eff.sum().item())
        if total > out_cap:
            return None, True
        pi, bi, _ = joinops.expand_gather_maps(
            lo, eff, min(out_cap, next_capacity(total)))
        out_schema = StructType(list(lsch.fields) + list(rsch.fields))
        out = ColumnBatch(out_schema, node._gather_expanded(
            left, bt.batch, pi, bi, counts, outer), total)
        if jt == "full":
            matched_b = node._matched_build_mask(bt, lo, counts)
            un_b = filterops.compact(bt.batch, ~matched_b)
            out = concat_traced([out, node._left_nulls_batch(lsch, un_b)])
        return out, False

    # a conditional join: materialise the candidate pairs, evaluate the
    # condition over them, derive the type from the survivors
    total = int(counts.sum().item())
    if total > out_cap:
        return None, True
    cap = min(out_cap, next_capacity(max(total, 1)))
    pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap)
    pair_live = torch.arange(cap, dtype=torch.int32, device=pi.device) < total
    pair_batch = node._gather_pairs(left, bt.batch, pi, bi, total)
    pred = node.condition.eval(EvalContext(pair_batch))
    ok = pair_live & pred.data & pred.validity
    matched_l = joinops.probe_marks(pi, ok, left.capacity)
    if jt == "left_semi":
        return filterops.compact(left, matched_l), False
    if jt == "left_anti":
        return filterops.compact(left, ~matched_l), False
    if jt == "existence":
        return node._exists_batch(left, matched_l), False
    perm, n_pairs = filterops.compact_perm(ok, cap)
    survivors = pair_batch.gather(perm, n_pairs)
    if jt in ("inner", "cross"):
        return survivors, False
    parts = [survivors]
    if jt in ("left", "full"):
        left_un = filterops.compact(left, ~matched_l)
        parts.append(node._right_nulls_batch(left_un, rsch))
    if jt == "full":
        matched_b = joinops.build_marks(bi, ok, bt.batch.capacity)
        right_un = filterops.compact(bt.batch, ~matched_b)
        parts.append(node._left_nulls_batch(lsch, right_un))
    out = concat_traced(parts)
    return ColumnBatch(node.schema, out.columns, out.num_rows), False
