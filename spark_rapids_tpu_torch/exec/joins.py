"""Join operators — counterpart of `spark_rapids_tpu/exec/joins.py`:
`_DeviceJoinBase` (key preparation, the build table, the bloom
prefilter, the encoded-key rewrite, the empty-side rules, the
unconditioned fast paths and the candidate-pair engine that derives
every join type from a survivor mask), `TpuShuffledHashJoinExec` with its
key-hash sub-partition split, `TpuBroadcastHashJoinExec`, whose build
table is made once and shared by every probe partition, and
`TpuBroadcastNestedLoopJoinExec` for cross and condition-only joins.
Join types: inner, cross, left, full, left_semi, left_anti and existence
(right is planned as a swapped left, plan/overrides.py).

The per-partition flow of a hash join: the bloom prefilter (kernel K5;
inner and left_semi only) tests every probe row against the build keys'
filter and compacts the probe batch when rows provably miss; K2 finds
each probe row's build range, the host reads the match total (the sync
that picks the output capacity), K3 expands the ranges into gather maps
and one K8 launch gathers both sides. Semi, anti and existence joins
need no expansion when unconditioned. A condition is evaluated over the
gathered candidate pairs; the probe rows some surviving pair names
(K27's probe marks) decide semi, anti, existence and the left padding,
the build rows they name (K27's build marks) the full join's padding.
The unconditioned full join finds its unmatched build rows from the
probe ranges alone (K27's coverage). Dictionary-encoded string keys
compare codes, re-encoded through K29 when the two sides' dictionaries
differ.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_batches,
    empty_like_schema,
    gather_columns,
    gather_leaves,
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
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean


def remap_refs(expr: Expression, fn) -> Expression:
    """Rewrite every BoundReference ordinal through fn(ordinal)."""

    def rewrite(node):
        if isinstance(node, BoundReference):
            return BoundReference(fn(node.ordinal), node.dtype,
                                  node.nullable)
        return node

    return expr.transform(rewrite)


def swap_condition(cond: Expression, n_left: int,
                   n_right: int) -> Expression:
    """Remap a condition bound to [left|right] ordinals onto the swapped
    [right|left] layout."""
    return remap_refs(
        cond, lambda o: o + n_right if o < n_left else o - n_left)


class _DeviceJoinBase(PhysicalPlan):
    """Shared device join machinery over candidate-pair gather maps."""

    def __init__(self, left, right, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression], schema, conf=None):
        super().__init__([left, right], schema, conf)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self._bloom_cache = None

    # --- helpers ---

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

    def _pair_schema(self) -> StructType:
        lsch = self.children[0].schema
        rsch = self.children[1].schema
        return StructType(list(lsch.fields) + list(rsch.fields))

    def _left_nulls_batch(self, lsch, right_batch: ColumnBatch
                          ) -> ColumnBatch:
        """All-null left columns + the given right rows."""
        nulls = empty_like_schema(lsch, right_batch.capacity,
                                  right_batch.device)
        schema = StructType(list(lsch.fields)
                            + list(right_batch.schema.fields))
        return ColumnBatch(schema, nulls.columns + right_batch.columns,
                           right_batch.num_rows)

    def _right_nulls_batch(self, left_batch: ColumnBatch, rsch
                           ) -> ColumnBatch:
        nulls = empty_like_schema(rsch, left_batch.capacity,
                                  left_batch.device)
        schema = StructType(list(left_batch.schema.fields)
                            + list(rsch.fields))
        return ColumnBatch(schema, left_batch.columns + nulls.columns,
                           left_batch.num_rows)

    def _exists_batch(self, left: ColumnBatch, matched) -> ColumnBatch:
        col = DeviceColumn(boolean, matched,
                           torch.ones(left.capacity, dtype=torch.bool,
                                      device=left.device))
        return ColumnBatch(self.schema, list(left.columns) + [col],
                           left.num_rows)

    # --- the pair engine ---

    def _gather_pairs(self, left: ColumnBatch, build: ColumnBatch,
                      pi, bi, num_rows) -> ColumnBatch:
        cols = gather_columns([(c, pi) for c in left.columns]
                              + [(c, bi) for c in build.columns],
                              clamp=True)
        return ColumnBatch(self._pair_schema(), cols, num_rows)

    def _finish_from_pairs(self, left: ColumnBatch, build: ColumnBatch,
                           pi, bi, ok, total_cap: int,
                           pair_batch: Optional[ColumnBatch] = None,
                           jt_override: Optional[str] = None
                           ) -> ColumnBatch:
        """Derive any join type from candidate pairs (pi, bi) and the
        surviving-pair mask ok (condition AND key equality AND live).
        `pair_batch` reuses the pairs the condition was evaluated over.
        `jt_override` lets the nested-loop join run a full join as a left
        join per probe chunk while it keeps the build marks itself."""
        jt = jt_override or self.join_type
        lsch = self.children[0].schema
        rsch = self.children[1].schema
        matched_l = joinops.probe_marks(pi, ok, left.capacity)
        if jt == "left_semi":
            return filterops.compact(left, matched_l)
        if jt == "left_anti":
            return filterops.compact(left, ~matched_l)
        if jt == "existence":
            return self._exists_batch(left, matched_l)
        # survivors to the front, in pair order
        perm, n_pairs = filterops.compact_perm(ok, total_cap)
        if pair_batch is None:
            # compose the compaction into the maps: one gather of the
            # columns instead of two
            spi, sbi = gather_leaves([pi, bi], [perm, perm])
            pair_batch = self._gather_pairs(left, build, spi, sbi, n_pairs)
        else:
            pair_batch = pair_batch.gather(perm, n_pairs)
        if jt in ("inner", "cross"):
            return pair_batch
        # outer padding
        parts = [pair_batch]
        if jt in ("left", "full"):
            left_un = filterops.compact(left, ~matched_l)
            if left_un.row_count() > 0:
                parts.append(self._right_nulls_batch(left_un, rsch))
        if jt == "full":
            matched_b = joinops.build_marks(bi, ok, build.capacity)
            right_un = filterops.compact(build, ~matched_b)
            if right_un.row_count() > 0:
                parts.append(self._left_nulls_batch(lsch, right_un))
        out = concat_batches(parts) if len(parts) > 1 else parts[0]
        return ColumnBatch(self.schema, out.columns, out.num_rows)

    def _conditional_equi_join(self, left: ColumnBatch,
                               bt: joinops.BuildTable,
                               lo, counts) -> ColumnBatch:
        # the one host sync: the candidate total picks the pair capacity
        total = int(counts.sum().item())
        cap = next_capacity(max(total, 1))
        pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap)
        ok = torch.arange(cap, dtype=torch.int32, device=pi.device) < total
        pair_batch = None
        if self.condition is not None:
            pair_batch = self._gather_pairs(left, bt.batch, pi, bi, total)
            pred = self.condition.eval(EvalContext(pair_batch))
            ok = ok & pred.data & pred.validity
        return self._finish_from_pairs(left, bt.batch, pi, bi, ok, cap,
                                       pair_batch=pair_batch)

    # --- unconditioned fast paths (no pair materialisation) ---

    def _fast_equi_join(self, left: ColumnBatch, bt: joinops.BuildTable,
                        lo, counts) -> ColumnBatch:
        jt = self.join_type
        lsch = self.children[0].schema
        rsch = self.children[1].schema
        if jt == "left_semi":
            return filterops.compact(left, counts > 0)
        if jt == "left_anti":
            return filterops.compact(left, counts == 0)
        if jt == "existence":
            return self._exists_batch(left, counts > 0)
        outer = jt in ("left", "full")
        eff_counts = counts
        if outer:
            # an unmatched live probe row takes one slot of its own
            eff_counts = torch.where(left.live_mask() & (counts == 0),
                                     1, counts).to(torch.int32)
        # the host syncs: the totals pick the output capacity
        total = int(eff_counts.sum().item())
        extra = 0
        matched_build = None
        if jt == "full":
            matched_build = self._matched_build_mask(bt, lo, counts)
            extra = int((~matched_build
                         & bt.batch.live_mask()).sum().item())
        cap_out = next_capacity(total + extra)
        pi, bi, _ = joinops.expand_gather_maps(lo, eff_counts, cap_out)
        out_schema = StructType(list(lsch.fields) + list(rsch.fields))
        out = ColumnBatch(out_schema,
                          self._gather_expanded(left, bt.batch, pi, bi,
                                                counts, outer), total)
        if jt == "full" and extra > 0:
            unmatched_right = filterops.compact(bt.batch, ~matched_build)
            pad = self._left_nulls_batch(lsch, unmatched_right)
            out = concat_batches([out, pad])
        return out

    def _gather_expanded(self, left: ColumnBatch, right: ColumnBatch, pi,
                         bi, counts, outer: bool) -> List[DeviceColumn]:
        """Both sides' columns along K3's maps in one K8 launch. An outer
        join's unmatched probe row (count 0, expanded to one slot) takes
        null build columns: its bi is its search position, possibly the
        build capacity, so the gather clips, and the row's unmatched flag
        rides the launch as one more leaf."""
        if not outer:
            # K3 keeps a matched bi in [0, build capacity): no clip
            return gather_columns([(c, pi) for c in left.columns]
                                  + [(c, bi) for c in right.columns])
        nl = len(left.columns)
        un = counts == 0
        cols = gather_columns([(c, pi) for c in left.columns]
                              + [(DeviceColumn(boolean, un, un), pi)]
                              + [(c, bi) for c in right.columns],
                              clamp=True)
        row_un = cols[nl].data
        return cols[:nl] + [c.replace(validity=c.validity & ~row_un)
                            for c in cols[nl + 1:]]

    def _matched_build_mask(self, bt: joinops.BuildTable, lo, counts):
        """Build rows some probe range covers (K27's coverage)."""
        return joinops.build_coverage(lo, counts, bt.batch.capacity)

    # --- encoded keys and the empty-side rules shared by hash joins ---

    def _encoded_key_rewrite(self, left: ColumnBatch, right: ColumnBatch):
        """When BOTH sides of an equi-key are dictionary-encoded columns,
        compare codes instead of decoded strings: the same dictionary
        compares as is, another one re-encodes the build side into the
        probe's code space (CodesOf, K29). Only when the host dictionary
        was evicted do the keys decode. Returns (left_keys,
        right_keys)."""
        from spark_rapids_tpu_torch.columnar import encoding as enc

        lkeys = list(self.left_keys)
        rkeys = list(self.right_keys)
        for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
            if not (isinstance(lk, BoundReference)
                    and isinstance(rk, BoundReference)):
                continue
            le = left.columns[lk.ordinal].encoding
            re_ = right.columns[rk.ordinal].encoding
            if le is None or re_ is None:
                continue
            if (re_.dict_id != le.dict_id
                    and enc.remap_table(re_.dict_id, le.dict_id) is None):
                continue  # host dictionary evicted: decode fallback
            lkeys[i] = enc.CodesOf(lk, le.dict_id)
            rkeys[i] = enc.CodesOf(rk, le.dict_id)
        return lkeys, rkeys

    def _join_batches(self, left_batches: List[ColumnBatch],
                      right_batches: List[ColumnBatch],
                      prepared_bt: Optional[joinops.BuildTable] = None
                      ) -> Optional[ColumnBatch]:
        jt = self.join_type
        if not left_batches and jt in ("inner", "left", "left_semi",
                                       "left_anti", "existence"):
            return None
        if not right_batches and jt in ("inner", "left_semi"):
            return None
        lsch = self.children[0].schema
        rsch = self.children[1].schema
        left = concat_batches(left_batches) if left_batches else None
        right = concat_batches(right_batches) if right_batches else None
        if left is None:
            # (a key-hash piece of the sub-partition split may be empty on
            # both sides: nothing to pad)
            if jt in ("right", "full") and right is not None:
                return self._left_nulls_batch(lsch, right)
            return None
        if right is None:
            if jt == "left_anti":
                return left
            if jt == "existence":
                return self._exists_batch(
                    left, torch.zeros(left.capacity, dtype=torch.bool,
                                      device=left.device))
            if jt in ("left", "full"):
                return self._right_nulls_batch(left, rsch)
            return None
        lkeys, rkeys = self.left_keys, self.right_keys
        if prepared_bt is None:
            # a shared prepared build table was sorted on the original
            # keys; the codes rewrite applies only when this call builds
            # its own table from both sides in hand
            lkeys, rkeys = self._encoded_key_rewrite(left, right)
        bt = (prepared_bt if prepared_bt is not None
              else self._build_table(right, keys=rkeys))
        left = self._bloom_prefilter(left, right)
        work_l, lk = self._prepare_keys(left, lkeys)
        lo, counts = joinops.probe_ranges(bt, work_l, lk)
        if self.condition is None:
            return self._fast_equi_join(left, bt, lo, counts)
        return self._conditional_equi_join(left, bt, lo, counts)

    def _bloom_prefilter(self, left: ColumnBatch,
                         right: ColumnBatch) -> ColumnBatch:
        """Build-side bloom filter applied to the probe side before the
        probe, for the joins where a missing probe row yields nothing
        (inner, left_semi): provably-absent keys drop and the probe batch
        re-buckets to a smaller capacity. The filter is built once per
        build batch and paid only when the probe capacity is at least 4x
        the build rows; the host reads how many live rows it keeps (K5
        counts them in the same launch) and compacts only when some
        dropped."""
        if self.join_type not in ("inner", "left_semi"):
            return left
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

    def _build_table(self, right: ColumnBatch,
                     keys=None) -> joinops.BuildTable:
        rsch = self.children[1].schema
        work_r, rk = self._prepare_keys(
            right, keys if keys is not None else self.right_keys)
        bt = joinops.build_side(work_r, rk)
        if len(bt.batch.columns) != len(right.columns):
            # strip temp key columns from the (sorted) build batch
            bt = joinops.BuildTable(
                ColumnBatch(rsch, bt.batch.columns[:len(right.columns)],
                            bt.batch.num_rows),
                bt.keys, bt.valid_bound)
        return bt


class TpuShuffledHashJoinExec(_DeviceJoinBase):
    """Partitioned equi-join; the children are co-partitioned by key (the
    planner inserts the exchanges), the right side builds. A build side
    over spark.rapids.sql.batchSizeBytes splits both sides into K
    co-partitioned pieces by a key hash of another seed
    (GpuSubPartitionHashJoin), each joined on its own."""

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 schema, conf=None, condition: Optional[Expression] = None):
        super().__init__(left, right, join_type, left_keys, right_keys,
                         condition, schema, conf)

    def _build_size_target(self) -> int:
        return (self.conf.get(rc.BATCH_SIZE_BYTES) if self.conf is not None
                else 1 << 30)

    def _hash_split(self, batch: ColumnBatch, keys, nparts: int
                    ) -> List[Optional[ColumnBatch]]:
        """Split one batch into nparts key-hash co-partitions, seeded
        apart from the shuffle so the split is not degenerate after an
        exchange."""
        from spark_rapids_tpu_torch.ops import partition as P

        work, kidx = self._prepare_keys(batch, keys)
        parts = P.split_to_slices(work, kidx, nparts,
                                  seed=P.SUB_PARTITION_SEED)
        if len(work.columns) != len(batch.columns):
            n0 = len(batch.columns)
            parts = [p.select(list(range(n0))) if p is not None else None
                     for p in parts]
        return parts

    def execute_partition(self, pid, ctx):
        right_batches = list(self.children[1].execute_partition(pid, ctx))
        left_batches = list(self.children[0].execute_partition(pid, ctx))
        build_bytes = sum(b.device_size_bytes() for b in right_batches)
        target = self._build_size_target()
        if build_bytes > target and left_batches and right_batches:
            nparts = max(2, -(-build_bytes // target))
            right = concat_batches(right_batches)
            left = concat_batches(left_batches)
            rparts = self._hash_split(right, self.right_keys, nparts)
            lparts = self._hash_split(left, self.left_keys, nparts)
            for lp, rp in zip(lparts, rparts):
                out = self._join_batches([lp] if lp is not None else [],
                                         [rp] if rp is not None else [])
                if out is not None:
                    yield out
            return
        out = self._join_batches(left_batches, right_batches)
        if out is not None:
            yield out


class _BroadcastBuildMixin:
    """Materialises the build (right) side once, shared by every probe
    partition. Subclasses call _init_broadcast() in __init__."""

    def _init_broadcast(self):
        self._bcast_lock = threading.Lock()
        self._bcast_batches: Optional[List[ColumnBatch]] = None

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def _broadcast_build(self, ctx) -> List[ColumnBatch]:
        """[the concatenated build batch], or [] for an empty build."""
        with self._bcast_lock:
            if self._bcast_batches is None:
                rchild = self.children[1]
                batches = [b for rp in range(rchild.num_partitions)
                           for b in rchild.execute_partition(rp, ctx)]
                self._bcast_batches = ([concat_batches(batches)]
                                       if batches else [])
            return self._bcast_batches


class TpuBroadcastHashJoinExec(_BroadcastBuildMixin, _DeviceJoinBase):
    """Equi-join with the (small) right side materialised once and its
    sorted build table shared by every probe partition; no exchange on
    either side. Not valid for a full join (build-side match tracking
    would span partitions): the planner takes it for inner, left,
    left_semi, left_anti and existence."""

    def __init__(self, left, right, join_type, left_keys, right_keys,
                 schema, conf=None, condition: Optional[Expression] = None):
        if join_type == "full":
            raise ValueError("a broadcast build cannot do a full join")
        super().__init__(left, right, join_type, left_keys, right_keys,
                         condition, schema, conf)
        self._init_broadcast()
        self._bt: Optional[joinops.BuildTable] = None

    def _broadcast_build_table(self, ctx):
        """(build batches, prepared build table or None), made once per
        node."""
        batches = self._broadcast_build(ctx)
        with self._bcast_lock:
            if batches and self._bt is None:
                self._bt = self._build_table(batches[0])
            return batches, self._bt

    def execute_partition(self, pid, ctx):
        build, bt = self._broadcast_build_table(ctx)
        left_batches = list(self.children[0].execute_partition(pid, ctx))
        out = self._join_batches(left_batches, build, prepared_bt=bt)
        if out is not None:
            yield out


class TpuBroadcastNestedLoopJoinExec(_BroadcastBuildMixin, _DeviceJoinBase):
    """Cross and condition-only joins: expand the full candidate pair set
    (probe x broadcast build) as gather maps (K3), evaluate the condition
    over the gathered pairs and derive the join type from the survivor
    mask (GpuBroadcastNestedLoopJoinExecBase, GpuCartesianProductExec).
    The planner puts a full join's probe side on one partition, so the
    build marks stay local."""

    def __init__(self, left, right, join_type, schema, conf=None,
                 condition: Optional[Expression] = None):
        super().__init__(left, right, join_type, [], [], condition, schema,
                         conf)
        self._init_broadcast()
        self._nlj_matched_build: Optional[torch.Tensor] = None

    def _nlj_chunk(self, left: ColumnBatch, right: ColumnBatch
                   ) -> Optional[ColumnBatch]:
        """Join one probe chunk against the whole build side. A full join
        runs as a left join and ORs its build marks (K27) into
        self._nlj_matched_build; execute_partition pads the unmatched
        build rows once after every chunk."""
        jt = self.join_type
        n_l = left.row_count()
        n_r = right.row_count()
        total = n_l * n_r
        cap = next_capacity(max(total, 1))
        counts = torch.where(left.live_mask(), n_r, 0).to(torch.int32)
        lo = torch.zeros(left.capacity, dtype=torch.int32,
                         device=left.device)
        pi, bi, _ = joinops.expand_gather_maps(lo, counts, cap)
        ok = torch.arange(cap, dtype=torch.int64, device=pi.device) < total
        pair_batch = None
        if self.condition is not None:
            pair_batch = self._gather_pairs(left, right, pi, bi, total)
            pred = self.condition.eval(EvalContext(pair_batch))
            ok = ok & pred.data & pred.validity
        jt_override = None
        if jt == "full":
            self._nlj_matched_build = joinops.build_marks(
                bi, ok, right.capacity, out=self._nlj_matched_build)
            jt_override = "left"
        return self._finish_from_pairs(left, right, pi, bi, ok, cap,
                                       pair_batch=pair_batch,
                                       jt_override=jt_override)

    def execute_partition(self, pid, ctx):
        build = self._broadcast_build(ctx)
        left_batches = list(self.children[0].execute_partition(pid, ctx))
        jt = self.join_type
        lsch = self.children[0].schema
        rsch = self.children[1].schema
        if not left_batches:
            if jt == "full" and build:
                yield self._left_nulls_batch(lsch, build[0])
            return
        left = concat_batches(left_batches)
        if not build:
            if jt == "left_anti":
                yield left
            elif jt == "existence":
                yield self._exists_batch(
                    left, torch.zeros(left.capacity, dtype=torch.bool,
                                      device=left.device))
            elif jt in ("left", "full"):
                yield self._right_nulls_batch(left, rsch)
            return
        right = build[0]
        self._nlj_matched_build = torch.zeros(
            right.capacity, dtype=torch.bool, device=right.device)
        # the reference reserves the pair set's bytes and splits the probe
        # side in half on an out-of-memory error; the spill runtime that
        # does that is not ported (ROADMAP A10), so each probe chunk runs
        # whole
        out = self._nlj_chunk(left, right)
        if out is not None:
            yield out
        if jt == "full":
            unmatched = filterops.compact(
                right, ~self._nlj_matched_build & right.live_mask())
            if unmatched.row_count() > 0:
                yield self._left_nulls_batch(lsch, unmatched)
