"""Adaptive query execution — counterpart of `spark_rapids_tpu/plan/aqe.py`
for the port's slice.

The exchanges are stage barriers that materialise their map output into
the shuffle manager, so the AQE loop runs as in the reference:

1. find READY exchanges (no unmaterialised exchange beneath them; build
   sides of joins first),
2. materialise one map stage,
3. re-plan the remainder with the observed output statistics: a
   materialised exchange whose reduce partitions are tiny collapses
   adjacent partitions into fewer reduce tasks (the coalesced read),
4. repeat until no exchange is pending, then run the final stage.

Decisions are recorded (`decisions`) in the reference's words. Broadcast
promotion, shared coalescing of both join sides, skew splits and dynamic
partition pruning act on shuffled joins, which the port does not have
yet (ROADMAP A13).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import pyarrow as pa

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, new_task_context
from spark_rapids_tpu_torch.exec.joins import TpuBroadcastHashJoinExec


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


class AdaptiveQueryExecutor:
    """Stage-by-stage execution with stats-driven re-planning."""

    def __init__(self, conf):
        self.conf = conf
        self.decisions: List[str] = []
        self._stats: Dict[int, List[int]] = {}  # id(ex) -> bytes/part
        self._target = (conf.get(rc.BATCH_SIZE_BYTES)
                        if conf is not None else 1 << 30)

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
            if isinstance(n, TpuBroadcastHashJoinExec):
                for e in self._exchanges(n.children[1]):
                    build_sides.add(id(e))

        self._walk(plan, mark)
        return sorted(ready, key=lambda e: 0 if id(e) in build_sides else 1)

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
        if isinstance(node, CoalescedShuffleReadExec):
            return node  # already adapted; never double-wrap
        node.children = [self._rewrite(c) for c in node.children]
        if (isinstance(node, ops.TpuShuffleExchangeExec)
                and node._map_done and node.num_partitions > 1
                and id(node) in self._stats):
            groups = self._grouping(self._stats[id(node)])
            if groups is not None:
                self.decisions.append(
                    f"coalesced {node.num_partitions} shuffle "
                    f"partitions -> {len(groups)}")
                return CoalescedShuffleReadExec(node, groups, self.conf)
        return node

    def execute(self, phys: PhysicalPlan) -> pa.Table:
        plan = phys
        ctx = new_task_context(self.conf)
        while True:
            ready = self._ready(plan)
            if not ready:
                break
            # one stage at a time, build sides first
            ex = ready[0]
            ex._run_map_stage(ctx)
            self._stats[id(ex)] = ex.partition_sizes()
            plan = self._rewrite(plan)
        return plan.collect()
