"""TpuOverrides — the planner, counterpart of
`spark_rapids_tpu/plan/overrides.py` for the port's slice.

It tags every logical node with the reasons it cannot run on the device
(`PlanMeta`, the RapidsMeta role) and converts the tree to physical
operators, inserting what execution needs: the partial -> hash exchange
-> final split around a multi-partition aggregate, and the broadcast
choice for an equi-join whose build side is estimated small.

The reference converts an untaggable node to its CPU operator; the port
has no CPU engine (`exec/cpu_eval.py` is not ported), so such a node,
and every node type outside the slice (scan, cached relation, filter,
project, inner equi-join, aggregate), raises NotImplementedError naming
the ROADMAP item that ports it. Nothing ever runs on the CPU in place of
the device.
"""

from __future__ import annotations

from typing import List, Tuple

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.joins import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.expr import BoundReference
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.typesig import (
    expr_unsupported_reasons,
    key_type_supported,
    type_supported,
)

#: logical nodes outside the slice, by the ROADMAP item that ports them
_NOT_PORTED = {
    "LocalRelation": "A9 (createDataFrame)",
    "Range": "A9 (spark.range)",
    "Sort": "A11", "Window": "A11", "Limit": "A11",
    "Generate": "A12", "Expand": "A12", "Sample": "A12",
    "Union": "A13", "Repartition": "A13",
    "MapInPandas": "A15", "GroupedMapInPandas": "A15",
    "CoGroupedMapInPandas": "A15",
}


class PlanMeta:
    """Tagging record for one logical node (RapidsMeta analog)."""

    def __init__(self, node: L.LogicalPlan):
        self.node = node
        self.reasons: List[str] = []
        self.children: List[PlanMeta] = []

    @property
    def can_run_on_device(self) -> bool:
        return not self.reasons

    def cannot_run(self, reason: str):
        self.reasons.append(reason)

    def explain(self, indent: int = 0, only_not_on_device=True) -> str:
        tag = ("*" if self.can_run_on_device else
               "!NOT_ON_TPU " + "; ".join(self.reasons))
        lines = []
        if not only_not_on_device or not self.can_run_on_device:
            lines.append("  " * indent + f"{type(self.node).__name__} {tag}")
        for c in self.children:
            sub = c.explain(indent + 1, only_not_on_device)
            if sub:
                lines.append(sub)
        return "\n".join(ln for ln in lines if ln)


class TpuOverrides:
    def __init__(self, conf: rc.RapidsConf):
        self.conf = conf
        self.metas: List[PlanMeta] = []

    # ----- tagging -----

    def _exprs(self, meta: PlanMeta, exprs) -> None:
        for e in exprs:
            for r in expr_unsupported_reasons(e, self.conf):
                meta.cannot_run(r)

    def tag(self, node: L.LogicalPlan) -> PlanMeta:
        meta = PlanMeta(node)
        if not self.conf.get(rc.SQL_ENABLED):
            meta.cannot_run("spark.rapids.sql.enabled is false")
        op_name = type(node).__name__
        if not self.conf.exec_enabled(op_name):
            meta.cannot_run(f"{op_name} disabled via spark.rapids.sql.exec."
                            f"{op_name}=false")
        if self.conf.get(rc.CPU_ORACLE_ENABLED):
            meta.cannot_run("cpu-oracle session")
        elif isinstance(node, L.Project):
            self._exprs(meta, node.exprs)
        elif isinstance(node, L.Filter):
            self._exprs(meta, [node.condition])
        elif isinstance(node, L.Aggregate):
            self._exprs(meta, node.grouping + node.aggregates)
            for g in node.grouping:
                r = key_type_supported(g.dtype)
                if r:
                    meta.cannot_run(r)
        elif isinstance(node, L.Join):
            self._exprs(meta, node.left_keys + node.right_keys)
            for e in node.left_keys + node.right_keys:
                r = key_type_supported(e.dtype)
                if r:
                    meta.cannot_run(r)
            if node.condition is not None:
                meta.cannot_run("join conditions beyond equi-keys are not "
                                "ported yet (ROADMAP A13)")
            if node.join_type != "inner":
                meta.cannot_run(f"{node.join_type} joins are not ported "
                                "yet (ROADMAP A13)")
        elif isinstance(node, L.FileScan):
            if node.fmt != "parquet":
                meta.cannot_run(f"{node.fmt} scans are not ported yet "
                                "(ROADMAP A14)")
            elif not self.conf.get(rc.PARQUET_READ_ENABLED):
                meta.cannot_run("parquet reads disabled via "
                                "spark.rapids.sql.format.parquet.read."
                                "enabled=false")
            for f in node.schema.fields:
                r = type_supported(f.dataType)
                if r:
                    meta.cannot_run(f"column {f.name!r}: {r}")
        elif type(node).__name__ in _NOT_PORTED:
            meta.cannot_run(f"{op_name} is not ported yet (ROADMAP "
                            f"{_NOT_PORTED[op_name]})")
        # CachedRelation: the entry IS device batches, nothing to tag
        meta.children = [self.tag(c) for c in node.children]
        self.metas.append(meta)
        return meta

    # ----- conversion -----

    def apply(self, plan: L.LogicalPlan) -> Tuple[PhysicalPlan, PlanMeta]:
        meta = self.tag(plan)
        phys = self._convert(meta)
        explain_mode = self.conf.get(rc.EXPLAIN)
        if explain_mode != "NONE":
            txt = meta.explain(only_not_on_device=explain_mode
                               == "NOT_ON_GPU")
            if txt:
                print(txt)
        return phys, meta

    def _convert(self, meta: PlanMeta) -> PhysicalPlan:
        node = meta.node
        conf = self.conf
        if not meta.can_run_on_device:
            raise NotImplementedError(
                f"{type(node).__name__} cannot run on the device and the "
                "port has no CPU engine: " + "; ".join(meta.reasons))
        if isinstance(node, L.CachedRelation):
            return ops.TpuCachedRelationExec(node.entry, node.schema, conf)
        if isinstance(node, L.FileScan):
            return ops.TpuFileScanExec(
                node.fmt, node.paths, node.schema, conf,
                pushed_columns=node.schema.names,
                pushed_filters=getattr(node, "pushed_filters", None),
                options=node.options)
        children = [self._convert(c) for c in meta.children]
        if isinstance(node, L.Project):
            return ops.TpuProjectExec(node.exprs, children[0], node.schema,
                                      conf)
        if isinstance(node, L.Filter):
            return ops.TpuFilterExec(node.condition, children[0], conf)
        if isinstance(node, L.Aggregate):
            return self._convert_aggregate(node, children[0])
        if isinstance(node, L.Join):
            return self._convert_join(node, children)
        raise NotImplementedError(f"logical node {type(node).__name__}")

    def _convert_aggregate(self, node: L.Aggregate,
                           child: PhysicalPlan) -> PhysicalPlan:
        conf = self.conf
        if child.num_partitions == 1:
            return ops.TpuHashAggregateExec(
                "complete", node.grouping, node.aggregates, child, conf)
        partial = ops.TpuHashAggregateExec(
            "partial", node.grouping, node.aggregates, child, conf)
        if node.grouping:
            key_refs = [BoundReference(i, g.dtype)
                        for i, g in enumerate(node.grouping)]
            exchange = ops.TpuShuffleExchangeExec(
                partial, key_refs, conf.get(rc.SHUFFLE_PARTITIONS), conf)
        else:
            exchange = ops.TpuShuffleExchangeExec(partial, None, 1, conf)
        return ops.TpuHashAggregateExec(
            "final", node.grouping, node.aggregates, exchange, conf)

    def _convert_join(self, node: L.Join,
                      children: List[PhysicalPlan]) -> PhysicalPlan:
        conf = self.conf
        left, right = children
        if not node.left_keys:
            raise NotImplementedError(
                "joins without equi-keys are not ported yet (ROADMAP A13)")
        threshold = conf.get(rc.BROADCAST_THRESHOLD)
        est = L.estimate_size_bytes(node.children[1])
        if threshold >= 0 and est is not None and est <= threshold:
            return TpuBroadcastHashJoinExec(
                left, right, node.join_type, node.left_keys,
                node.right_keys, node.schema, conf)
        raise NotImplementedError(
            "the shuffled hash join (a build side over "
            "spark.sql.autoBroadcastJoinThreshold) is not ported yet "
            "(ROADMAP A13)")


def plan_query(logical: L.LogicalPlan, conf: rc.RapidsConf
               ) -> Tuple[PhysicalPlan, PlanMeta]:
    return TpuOverrides(conf).apply(logical)
