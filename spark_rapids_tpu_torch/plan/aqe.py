"""Adaptive query execution — counterpart of `spark_rapids_tpu/plan/aqe.py`.

The exchanges are stage barriers that materialise their map output into
the shuffle manager, so the AQE loop runs as in the reference:

1. find READY exchanges (no unmaterialised exchange beneath them; build
   sides of joins first, so a small build can cancel the probe-side
   shuffle before it runs),
2. materialise one map stage,
3. re-plan the remainder with the observed output statistics:
   - broadcast promotion: a shuffled hash join whose build side
     materialised under spark.sql.autoBroadcastJoinThreshold becomes a
     broadcast hash join, and the probe side's exchange, if it has not
     run yet, is cancelled (its child feeds the join directly);
   - dynamic partition pruning of a hive-partitioned probe scan by the
     build side's distinct keys;
   - partition coalescing: a materialised hash exchange whose reduce
     partitions are tiny collapses adjacent partitions into fewer reduce
     tasks (a range exchange is left as it is); the two sides of a
     shuffled join coalesce only together, with one shared grouping;
   - the skew split: a probe partition far above the median is read as
     row slices, each joined against a re-read of its build partition,
4. repeat until no exchange is pending, then run the final stage.

Decisions are recorded (`decisions`) in the reference's words. The
reference takes the skew split and pruning only off host-serialised
shuffle blocks; the port keeps every mode's blocks on the device and
decides as the reference does for the same spark.rapids.shuffle.mode. The
port's scans read no hive-partitioned layouts (ROADMAP A10), so pruning
finds no partitioned scan to prune there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch, concat_batches
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, new_task_context


class CoalescedShuffleReadExec(PhysicalPlan):
    """AQE coalesced read over a materialised exchange: reduce task i
    drains the exchange's partitions in groups[i]."""

    def __init__(self, ex: ops.TpuShuffleExchangeExec,
                 groups: List[List[int]], conf):
        super().__init__([ex], ex.schema, conf)
        self.groups = groups

    @property
    def num_partitions(self):
        return max(1, len(self.groups))

    def execute_partition(self, pid, ctx):
        if pid >= len(self.groups):
            return
        for sub in self.groups[pid]:
            yield from self.children[0].execute_partition(sub, ctx)

    def _node_string(self):
        return (f"CoalescedShuffleReadExec {len(self.groups)} <- "
                f"{self.children[0].num_partitions}")


class SkewSliceShuffleReadExec(PhysicalPlan):
    """One side of a skew-split join (OptimizeSkewedJoin).
    `specs[i] = (src_pid, j, k)`: output partition i reads source
    partition src_pid; the probe side takes row slice j of k, the build
    side re-reads the whole partition for every slice. Both sides share
    one spec list, so the join's pid pairing stays aligned."""

    def __init__(self, ex: ops.TpuShuffleExchangeExec,
                 specs: List[Tuple[int, int, int]], slice_rows: bool, conf):
        super().__init__([ex], ex.schema, conf)
        self.specs = specs
        self.slice_rows = slice_rows

    @property
    def num_partitions(self):
        return max(1, len(self.specs))

    def execute_partition(self, pid, ctx):
        if pid >= len(self.specs):
            return
        src, j, k = self.specs[pid]
        ex = self.children[0]
        if not self.slice_rows or k == 1:
            yield from ex.execute_partition(src, ctx)
            return
        # probe slice: rows [n*j/k, n*(j+1)/k) of the partition's pieces
        ex._run_map_stage(ctx)
        pieces = ex._fetch_device(src)
        if not pieces:
            return
        whole = concat_batches(pieces)
        n = whole.row_count()
        lo, hi = (n * j) // k, (n * (j + 1)) // k
        if hi > lo:
            yield whole.slice_rows(lo, hi)

    def _node_string(self):
        splits = sum(1 for _, _, k in self.specs if k > 1)
        role = "probe-slices" if self.slice_rows else "build-replays"
        return (f"SkewSliceShuffleReadExec {len(self.specs)} parts "
                f"({splits} {role})")


class AdaptiveQueryExecutor:
    """Stage-by-stage execution with stats-driven re-planning."""

    #: the largest materialised build side pruning inspects
    _DPP_MAX_BUILD = 64 << 20

    def __init__(self, conf):
        self.conf = conf
        self.decisions: List[str] = []
        self._stats: Dict[int, List[int]] = {}  # id(ex) -> bytes/part
        self._join_fed: set = set()
        self._dpp_done: set = set()
        self._target = (conf.get(rc.BATCH_SIZE_BYTES)
                        if conf is not None else 1 << 30)
        thr = (conf.get(rc.BROADCAST_THRESHOLD)
               if conf is not None else 10 << 20)
        self._bcast_threshold = thr if thr is not None else -1

    # --- plan walking ---

    def _walk(self, node: PhysicalPlan, fn) -> None:
        fn(node)
        for c in node.children:
            self._walk(c, fn)

    def _exchanges(self, plan) -> List[ops.TpuShuffleExchangeExec]:
        found: List[ops.TpuShuffleExchangeExec] = []

        def fn(n):
            if isinstance(n, ops.TpuShuffleExchangeExec):
                found.append(n)

        self._walk(plan, fn)
        return found

    def _ready(self, plan) -> List[ops.TpuShuffleExchangeExec]:
        """Unmaterialised exchanges with no unmaterialised exchange in
        their subtrees, build (join right) sides first."""
        unmat = [e for e in self._exchanges(plan) if not e._map_done]

        def has_unmat_below(e):
            return any(x is not e and not x._map_done
                       for x in self._exchanges(e))

        ready = [e for e in unmat if not has_unmat_below(e)]
        build_sides = set()

        def mark(n):
            if isinstance(n, (J.TpuShuffledHashJoinExec,
                              J.TpuBroadcastHashJoinExec)):
                for e in self._exchanges(n.children[1]):
                    build_sides.add(id(e))

        self._walk(plan, mark)
        return sorted(ready, key=lambda e: 0 if id(e) in build_sides else 1)

    # --- rewrites ---

    def _mark_join_fed(self, plan: PhysicalPlan) -> None:
        """Exchanges feeding a shuffled hash join must not coalesce on
        their own: both sides share one partitioning and the join pairs
        them by pid. They coalesce only together, with one grouping."""
        self._join_fed = set()

        def mark(n):
            if isinstance(n, J.TpuShuffledHashJoinExec):
                for c in n.children:
                    cur = c
                    while (cur is not None and not isinstance(
                            cur, ops.TpuShuffleExchangeExec)):
                        cur = (cur.children[0] if len(cur.children) == 1
                               else None)
                    if cur is not None:
                        self._join_fed.add(id(cur))

        self._walk(plan, mark)

    def _grouping(self, sizes: List[int]) -> Optional[List[List[int]]]:
        """Contiguous partition groups targeting batchSizeBytes, or None
        when coalescing would not reduce the partition count."""
        total = sum(sizes)
        if not total or total / len(sizes) >= self._target // 8:
            return None
        groups: List[List[int]] = []
        cur: List[int] = []
        acc = 0
        for rp, s in enumerate(sizes):
            cur.append(rp)
            acc += s
            if acc >= self._target:
                groups.append(cur)
                cur, acc = [], 0
        if cur:
            groups.append(cur)
        return groups if len(groups) < len(sizes) else None

    def _rewrite(self, node: PhysicalPlan) -> PhysicalPlan:
        if isinstance(node, (CoalescedShuffleReadExec,
                             SkewSliceShuffleReadExec)):
            return node  # already adapted; never double-wrap
        node.children = [self._rewrite(c) for c in node.children]
        if isinstance(node, J.TpuShuffledHashJoinExec):
            right = node.children[1]
            # the build exchange may already be coalesce-wrapped
            right_ex = (right.children[0]
                        if isinstance(right, CoalescedShuffleReadExec)
                        else right)
            if (isinstance(right_ex, ops.TpuShuffleExchangeExec)
                    and right_ex._map_done):
                self._try_dpp(node, right_ex)
            if (self._bcast_threshold >= 0
                    and isinstance(right_ex, ops.TpuShuffleExchangeExec)
                    and right_ex._map_done
                    and node.join_type != "full"):
                total = sum(self._stats.get(id(right_ex), [1 << 62]))
                if total <= self._bcast_threshold:
                    left = node.children[0]
                    cancelled = ""
                    if (isinstance(left, ops.TpuShuffleExchangeExec)
                            and not left._map_done):
                        left = left.children[0]
                        cancelled = " (probe-side exchange cancelled)"
                    self.decisions.append(
                        f"broadcast promotion: build side {total >> 10} "
                        f"KiB <= threshold{cancelled}")
                    return J.TpuBroadcastHashJoinExec(
                        left, right, node.join_type, node.left_keys,
                        node.right_keys, node.schema, node.conf,
                        node.condition)
            self._coalesce_join_sides(node)
            self._try_skew_split(node)
        # a range exchange's partitions are the sort's key ranges: the
        # reference never coalesces them
        if (isinstance(node, ops.TpuShuffleExchangeExec)
                and not isinstance(node, ops.TpuRangeShuffleExchangeExec)
                and node._map_done and node.num_partitions > 1
                and id(node) not in self._join_fed
                and id(node) in self._stats):
            groups = self._grouping(self._stats[id(node)])
            if groups is not None:
                self.decisions.append(
                    f"coalesced {node.num_partitions} shuffle "
                    f"partitions -> {len(groups)}")
                return CoalescedShuffleReadExec(node, groups, self.conf)
        return node

    @staticmethod
    def _plain_exchange(n) -> bool:
        return (isinstance(n, ops.TpuShuffleExchangeExec)
                and not isinstance(n, ops.TpuRangeShuffleExchangeExec))

    def _coalesce_join_sides(self, node: J.TpuShuffledHashJoinExec) -> None:
        """Coalesce both sides of a shuffled join with one grouping (sizes
        summed pairwise), keeping their partitions paired. Only when both
        sides are materialised exchanges of one width."""
        lc, rc2 = node.children
        if not (self._plain_exchange(lc) and self._plain_exchange(rc2)
                and lc._map_done and rc2._map_done
                and lc.num_partitions == rc2.num_partitions
                and lc.num_partitions > 1
                and id(lc) in self._stats and id(rc2) in self._stats):
            return
        sizes = [a + b for a, b in zip(self._stats[id(lc)],
                                       self._stats[id(rc2)])]
        groups = self._grouping(sizes)
        if groups is None:
            return
        self.decisions.append(
            f"coalesced both join sides {lc.num_partitions} shuffle "
            f"partitions -> {len(groups)} (shared grouping)")
        node.children = [CoalescedShuffleReadExec(lc, groups, self.conf),
                         CoalescedShuffleReadExec(rc2, groups, self.conf)]

    def _try_skew_split(self, node: J.TpuShuffledHashJoinExec) -> None:
        """Split skewed probe partitions into row slices, each joined
        against a re-read of the whole build partition (Spark's
        OptimizeSkewedJoin). Only the join types whose result is per probe
        row survive the build's duplication (inner, left, semi, anti)."""
        if node.join_type not in ("inner", "left", "left_semi",
                                  "left_anti"):
            return
        if self.conf is not None and not self.conf.get(
                rc.SKEW_JOIN_ENABLED):
            return
        lc, rc2 = node.children
        if not (self._plain_exchange(lc)
                and isinstance(rc2, ops.TpuShuffleExchangeExec)
                and lc._map_done and rc2._map_done
                and not lc._device_mode and not rc2._device_mode
                and lc.num_partitions == rc2.num_partitions
                and lc.num_partitions > 1
                and id(lc) in self._stats):
            return
        sizes = self._stats[id(lc)]
        if not any(sizes):
            return
        # the lower median over every partition, zeros included: with one
        # hot partition the median must be small, or the hot partition
        # would be its own median
        med = sorted(sizes)[(len(sizes) - 1) // 2]
        factor = (self.conf.get(rc.SKEW_JOIN_FACTOR)
                  if self.conf is not None else 5)
        threshold = (self.conf.get(rc.SKEW_JOIN_THRESHOLD)
                     if self.conf is not None else 256 << 20)
        specs: List[Tuple[int, int, int]] = []
        split_info = []
        for p, s in enumerate(sizes):
            if s > max(factor * med, threshold):
                k = min(max(2, -(-s // max(self._target, 1))), 64)
                split_info.append((p, k))
                specs.extend((p, j, k) for j in range(k))
            else:
                specs.append((p, 0, 1))
        if not split_info:
            return
        self.decisions.append(
            "skew split: " + ", ".join(
                f"partition {p} -> {k} slices" for p, k in split_info))
        # every spec reads its source partition once: the blocks are
        # released after the last of those reads
        for ex in (lc, rc2):
            ex._fetches_left += len(specs) - ex.num_partitions
        node.children = [
            SkewSliceShuffleReadExec(lc, specs, True, self.conf),
            SkewSliceShuffleReadExec(rc2, specs, False, self.conf)]

    # --- dynamic partition pruning ---

    def _try_dpp(self, node: J.TpuShuffledHashJoinExec,
                 right_ex: ops.TpuShuffleExchangeExec) -> None:
        """Prune the probe side's partitioned scan with the materialised
        build side's distinct join-key values (GpuFileSourceScanExec's
        dynamic partition pruning). Only when the probe path from the join
        to the scan is filters and exchanges (so the key ordinals resolve
        to scan columns), the scan is hive-partitioned on the key, and the
        build output is small enough to inspect."""
        from spark_rapids_tpu_torch.expr.core import BoundReference

        if right_ex._device_mode:
            return
        total = sum(self._stats.get(id(right_ex), [1 << 62]))
        if total > self._DPP_MAX_BUILD:
            return
        child = node.children[0]
        cur = child
        while isinstance(cur, (ops.TpuShuffleExchangeExec,
                               ops.TpuFilterExec)):
            cur = cur.children[0]
        if not (isinstance(cur, ops.TpuFileScanExec)
                and getattr(cur, "_part_spec", None)):
            return
        scan = cur
        if id(scan) in self._dpp_done:
            return
        part_names = {n for n, _ in scan._part_spec[0]}
        for i, lk in enumerate(node.left_keys):
            if not isinstance(lk, BoundReference):
                continue
            if lk.ordinal >= len(child.schema.names):
                continue
            name = child.schema.names[lk.ordinal]
            if name not in part_names:
                continue
            vals = self._collect_build_keys(right_ex, node.right_keys[i])
            if vals is None:
                continue
            dropped = scan.prune_partitions(name, vals)
            self._dpp_done.add(id(scan))
            if dropped:
                self.decisions.append(
                    f"dynamic partition pruning on {name}: {dropped} files "
                    "skipped")

    def _collect_build_keys(self, ex: ops.TpuShuffleExchangeExec,
                            key_expr) -> Optional[set]:
        """The distinct non-null values of key_expr over the materialised
        build side (read without consuming it), or None when the key does
        not evaluate."""
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            device_to_arrow,
        )
        from spark_rapids_tpu_torch.expr.core import EvalContext
        from spark_rapids_tpu_torch.sqltypes import StructField, StructType

        out = set()
        for rp in range(ex.num_partitions):
            for b in ex.peek_partition(rp):
                try:
                    col = key_expr.eval(EvalContext(b))
                except Exception:
                    return None
                t = device_to_arrow(ColumnBatch(
                    StructType([StructField("k", key_expr.dtype, True)]),
                    [col], b.num_rows))
                out.update(t.column(0).to_pylist())
        out.discard(None)
        return out

    # --- the stage loop ---

    def execute(self, phys: PhysicalPlan) -> pa.Table:
        plan = phys
        ctx = new_task_context(self.conf)
        while True:
            ready = self._ready(plan)
            if not ready:
                break
            # one stage at a time, build sides first: a probe-side
            # exchange must not run while a build chain is pending, or its
            # stats can no longer cancel or prune the probe
            ex = ready[0]
            ex._run_map_stage(ctx)
            self._stats[id(ex)] = ex.partition_sizes()
            self._mark_join_fed(plan)
            plan = self._rewrite(plan)
        return plan.collect()
