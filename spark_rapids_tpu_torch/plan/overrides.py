"""TpuOverrides — the planner, counterpart of
`spark_rapids_tpu/plan/overrides.py` for the port's slice.

It tags every logical node with the reasons it cannot run on the device
(`PlanMeta`, the RapidsMeta role) and converts the tree to physical
operators, inserting what execution needs: the partial -> hash exchange
-> final split around a multi-partition aggregate, the join strategy
(a broadcast hash join when the build side is estimated under
spark.sql.autoBroadcastJoinThreshold and the type allows it, else a
shuffled hash join over key exchanges; a broadcast nested-loop join
without keys or for cross; a right join as a swapped left join plus a
reordering project), the union, the repartition exchange, the sample-based
range exchange below a global sort over many partitions, the
TakeOrderedAndProject fusion of a limit over a global sort, and the hash
exchange on the partition keys below a window with the choice of its
evaluation mode.

The reference converts an untaggable node to its CPU operator; the port
has no CPU engine (`exec/cpu_eval.py` is not ported), so such a node,
and every node type outside the slice (scan, cached relation, filter,
project, join, union, repartition, aggregate, sort, window, limit,
generate), raises
NotImplementedError naming the ROADMAP item that ports it. Nothing ever
runs on the CPU in place of the device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.joins import (
    TpuBroadcastHashJoinExec,
    TpuBroadcastNestedLoopJoinExec,
    TpuShuffledHashJoinExec,
    swap_condition,
)
from spark_rapids_tpu_torch.expr import aggregates as AGG
from spark_rapids_tpu_torch.expr import Alias, BoundReference, Max, Min
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.typesig import (
    PORTED_EXPRESSIONS,
    expr_unsupported_reasons,
    key_type_supported,
    sort_key_type_supported,
    type_supported,
)
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    MapType,
    NumericType,
    StringType,
    StructType,
)

#: the aggregates the reference's window evaluates on the device (its
#: `supported_aggs`); collect frames are checked apart
_WINDOW_AGGS = (AGG.Sum, AGG.Count, AGG.Min, AGG.Max, AGG.Average,
                AGG.First, AGG.VariancePop, AGG.VarianceSamp)

#: torch dtypes whose group-by min/max K12 reduces
_K12_TYPES = (torch.int32, torch.int64, torch.float32, torch.float64)

#: logical nodes outside the slice, by the ROADMAP item that ports them
_NOT_PORTED = {
    "LocalRelation": "A9 (createDataFrame)",
    "Range": "A9 (spark.range)",
    "Expand": "A12", "Sample": "A12",
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
            self._tag_aggregates(node, meta)
        elif isinstance(node, L.Join):
            self._exprs(meta, node.left_keys + node.right_keys)
            for e in node.left_keys + node.right_keys:
                r = key_type_supported(e.dtype)
                if r:
                    meta.cannot_run(r)
            if node.condition is not None:
                self._exprs(meta, [node.condition])
        elif isinstance(node, L.Repartition):
            self._exprs(meta, node.keys or [])
        elif isinstance(node, L.Sort):
            for o in node.orders:
                self._exprs(meta, [o.expr])
                r = sort_key_type_supported(o.expr.dtype)
                if r:
                    meta.cannot_run(r)
        elif isinstance(node, L.Window):
            self._tag_window(node, meta)
        elif isinstance(node, L.Generate):
            # the pass-through columns and the generator's input, as the
            # reference tags them
            self._exprs(meta, list(node.pass_through)
                        + [node.gen_alias.children[0].children[0]])
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

    def _tag_aggregates(self, node: L.Aggregate, meta: PlanMeta) -> None:
        """The reference's aggregate checks: the moment, bivariate and
        percentile families need numeric input; collect and distinct over
        string, array or decimal(> 18) input run on the reference's CPU
        engine (ROADMAP A9 here). And min/max of a type K12 does not
        reduce; decimals outside sum, avg, min, max, count, first, last
        and any_value are not ported (A3)."""
        from spark_rapids_tpu_torch.sqltypes import DecimalType
        from spark_rapids_tpu_torch.sqltypes.datatypes import (
            is_wide,
            torch_dtype,
        )

        for a in node.aggregates:
            fn = a.children[0]
            if (isinstance(fn, (AGG.CollectList, AGG.CountDistinct))
                    and fn.input is not None
                    and (isinstance(fn.input.dtype, (StringType, ArrayType))
                         or is_wide(fn.input.dtype))):
                meta.cannot_run(
                    f"{fn.name} over {fn.input.dtype} input runs on the "
                    "reference's CPU engine; the port has no CPU engine "
                    "yet (ROADMAP A9)")
            elif (not isinstance(fn, (AGG.Sum, AGG.Average, Min, Max,
                                      AGG.Count, AGG.First))
                  and any(isinstance(e.dtype, DecimalType)
                          for e in fn.children)):
                meta.cannot_run(
                    f"{fn.name} over decimal input is not ported yet "
                    "(ROADMAP A3: decimals outside the arithmetic, "
                    "comparisons, casts and aggregates)")
            if isinstance(fn, (AGG._Moments, AGG._Bivariate,
                               AGG.Percentile)):
                for e in fn.children:
                    if not isinstance(e.dtype, NumericType):
                        meta.cannot_run(f"{fn.name} requires numeric input")

        def walk(e):
            if isinstance(e, (Min, Max)):
                dt = e.input.dtype
                if (getattr(dt, "np_dtype", None) is None
                        or isinstance(dt, StringType)
                        or torch_dtype(dt) not in _K12_TYPES):
                    meta.cannot_run(f"group-by {e.name} of {dt} is not "
                                    "ported yet (ROADMAP A12)")
            for c in e.children:
                walk(c)

        for a in node.aggregates:
            walk(a)

    def _tag_window(self, node: L.Window, meta: PlanMeta) -> None:
        """The reference's window checks (its `_tag_window`): ranking and
        offset functions need ORDER BY; partition, order, input and
        default expressions must be ported; string min/max is refused;
        RANGE offsets need exactly one ascending numeric ORDER BY key;
        collect frames take bounded ROWS frames of flat elements
        (`_tag_window_collect`), and an aggregate
        the reference's window does not evaluate on its device (skewness,
        corr, count(DISTINCT), ...) runs on its CPU engine. Where the
        reference plans its CPU
        window instead, the port raises with the reference's reason and
        the ROADMAP item that will port it."""
        from spark_rapids_tpu_torch.expr import windows as we

        for f in node.children[0].schema.fields:
            if isinstance(f.dataType, StructType):
                meta.cannot_run(
                    f"struct payload column {f.name!r}: the reference's "
                    "device window has no struct lowering and runs it on "
                    "its CPU engine; the port has no CPU engine yet "
                    "(ROADMAP A9)")
        for a in node.window_exprs:
            wexpr = a.children[0]
            self._exprs(meta, list(wexpr.spec.partitions)
                        + [o.expr for o in wexpr.spec.orders])
            for e in (list(wexpr.spec.partitions)
                      + [o.expr for o in wexpr.spec.orders]):
                r = key_type_supported(e.dtype)
                if r:
                    meta.cannot_run(r)
            fn = wexpr.function
            if isinstance(fn, we.WindowFunction):
                if fn.needs_order and not wexpr.spec.orders:
                    meta.cannot_run(
                        f"{type(fn).__name__} requires ORDER BY")
                if isinstance(fn, we.Lead):
                    self._exprs(meta, fn.children)
                    self._window_decimal(fn, meta)
            elif isinstance(fn, AGG.CollectList):  # CollectSet too
                self._tag_window_collect(wexpr, fn, meta)
            elif not isinstance(fn, PORTED_EXPRESSIONS):
                meta.cannot_run(f"window function {type(fn).__name__} is "
                                "not ported yet (ROADMAP A12)")
            elif not isinstance(fn, _WINDOW_AGGS):
                meta.cannot_run(
                    f"window function {type(fn).__name__} has no device "
                    "implementation; the reference runs it on its CPU "
                    "engine, which is not ported yet (ROADMAP A9)")
            else:
                if fn.input is not None:
                    self._exprs(meta, [fn.input])
                    self._window_decimal(fn, meta)
                    if isinstance(fn.input.dtype, (ArrayType, MapType)):
                        meta.cannot_run(
                            f"window {type(fn).__name__} over "
                            f"{fn.input.dtype.simpleString} runs on the "
                            "reference's CPU engine; the port has no CPU "
                            "engine yet (ROADMAP A9)")
                if (isinstance(fn, (Min, Max))
                        and isinstance(fn.input.dtype, StringType)):
                    meta.cannot_run(
                        "string min/max over window frames runs on the "
                        "reference's CPU window, which is not ported yet "
                        "(ROADMAP A9, exec/cpu_eval.py)")
            frame = wexpr.spec.frame
            if (frame is not None and frame.frame_type == "range"
                    and (frame.lower not in (None, 0)
                         or frame.upper not in (None, 0))):
                orders = wexpr.spec.orders
                if (len(orders) != 1 or not orders[0].ascending
                        or not isinstance(orders[0].expr.dtype,
                                          NumericType)):
                    meta.cannot_run(
                        "RANGE frame offsets need one ascending numeric "
                        "ORDER BY key on device; the reference's CPU "
                        "window is not ported yet (ROADMAP A9, "
                        "exec/cpu_eval.py)")

    @staticmethod
    def _window_decimal(fn, meta: PlanMeta) -> None:
        """A decimal(> 18) window aggregate runs on the reference's CPU
        engine (A9); the port's windows take no decimal input yet (A3)."""
        from spark_rapids_tpu_torch.sqltypes import DecimalType
        from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide

        dts = [c.dtype for c in fn.children]
        if any(is_wide(dt) for dt in dts):
            meta.cannot_run(
                "decimal(>18) window aggregation runs on the reference's "
                "CPU engine; the port has no CPU engine yet (ROADMAP A9)")
        elif any(isinstance(dt, DecimalType) for dt in dts):
            meta.cannot_run(
                f"window {type(fn).__name__} over decimal input is not "
                "ported yet (ROADMAP A3: decimal windows)")

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
        if isinstance(node, L.Limit):
            smeta = meta.children[0]
            if isinstance(smeta.node, L.Sort) and smeta.node.global_sort:
                # TakeOrderedAndProject fusion (GpuOverrides.scala:4084):
                # per-partition sort+limit, gather, final sort+limit —
                # never materializes more than n rows per partition
                inner = self._convert(smeta.children[0])
                return self._take_ordered(node.n, smeta.node.orders, inner)
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
        if isinstance(node, L.Sort):
            return self._convert_sort(node, children[0])
        if isinstance(node, L.Window):
            return self._convert_window(node, children[0])
        if isinstance(node, L.Generate):
            return ops.TpuGenerateExec(node.pass_through, node.gen_alias,
                                       node.position, children[0], conf)
        if isinstance(node, L.Limit):
            return self._convert_limit(node, children[0])
        if isinstance(node, L.Union):
            return ops.UnionExec(children, node.schema, conf)
        if isinstance(node, L.Repartition):
            # no coalesce wrap: the exchange's reduce side already slices
            # its blocks at batchSizeRows
            return ops.TpuShuffleExchangeExec(children[0], node.keys,
                                              node.num_partitions, conf)
        raise NotImplementedError(f"logical node {type(node).__name__}")

    def _tag_window_collect(self, wexpr, fn, meta: PlanMeta) -> None:
        """The reference's window-collect checks: bounded ROWS frames of a
        span <= 1,024 (K33's output width is the frame's span) over flat
        scalar elements; what it refuses runs on its CPU engine (A9)."""
        self._exprs(meta, [fn.input])
        self._window_decimal(fn, meta)
        frame = wexpr.spec.frame
        if not (frame is not None and frame.frame_type == "rows"
                and frame.lower is not None and frame.upper is not None):
            meta.cannot_run(
                "window collect over unbounded frames runs on the "
                "reference's CPU engine (the device output width is the "
                "static frame span); the port has no CPU engine yet "
                "(ROADMAP A9)")
        elif int(frame.upper) - int(frame.lower) + 1 > 1024:
            meta.cannot_run(
                "window collect frame span > 1024 runs on the reference's "
                "CPU engine; the port has no CPU engine yet (ROADMAP A9)")
        elif isinstance(fn.input.dtype, (StringType, ArrayType, MapType)):
            meta.cannot_run(
                "window collect of string/array/map elements runs on the "
                "reference's CPU engine; the port has no CPU engine yet "
                "(ROADMAP A9)")

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
        shuffle_parts = conf.get(rc.SHUFFLE_PARTITIONS)
        join_type = node.join_type
        left_keys, right_keys = node.left_keys, node.right_keys
        condition = node.condition
        n_l = len(node.children[0].schema.fields)
        n_r = len(node.children[1].schema.fields)
        build_logical = node.children[1]
        swapped = join_type == "right"
        if swapped:
            # right outer = swapped left outer + a reordering project
            left, right = right, left
            left_keys, right_keys = right_keys, left_keys
            join_type = "left"
            build_logical = node.children[0]
            if condition is not None:
                condition = swap_condition(condition, n_l, n_r)
        exec_schema = (self._swapped_schema(left, right) if swapped
                       else node.schema)
        if not left_keys or join_type == "cross":
            joined = self._nested_loop_join(left, right, join_type,
                                            condition, exec_schema)
        else:
            joined = self._hash_join(left, right, join_type, left_keys,
                                     right_keys, condition, exec_schema,
                                     build_logical, shuffle_parts)
        if not swapped:
            return joined
        # the swapped layout is [orig-right fields | orig-left fields];
        # reorder back to node.schema = [left | right]
        sw = joined.schema
        reorder = [Alias(BoundReference(n_r + i, sw.fields[n_r + i].dataType,
                                        True), sw.fields[n_r + i].name)
                   for i in range(n_l)]
        reorder += [Alias(BoundReference(i, sw.fields[i].dataType, True),
                          sw.fields[i].name)
                    for i in range(n_r)]
        return ops.TpuProjectExec(reorder, joined, node.schema, conf)

    @staticmethod
    def _swapped_schema(left, right) -> StructType:
        from spark_rapids_tpu_torch.sqltypes import StructField

        return StructType(
            [StructField(f.name, f.dataType, True)
             for f in left.schema.fields]
            + [StructField(f.name, f.dataType, f.nullable)
               for f in right.schema.fields])

    def _hash_join(self, left, right, join_type, left_keys, right_keys,
                   condition, exec_schema, build_logical, shuffle_parts):
        conf = self.conf
        threshold = conf.get(rc.BROADCAST_THRESHOLD)
        est = L.estimate_size_bytes(build_logical)
        broadcastable = (threshold >= 0 and est is not None
                         and est <= threshold
                         and join_type in ("inner", "left", "left_semi",
                                           "left_anti", "existence"))
        if broadcastable:
            return TpuBroadcastHashJoinExec(
                left, right, join_type, left_keys, right_keys, exec_schema,
                conf, condition=condition)
        if not (left.num_partitions == 1 and right.num_partitions == 1):
            left = ops.TpuShuffleExchangeExec(left, left_keys,
                                              shuffle_parts, conf)
            right = ops.TpuShuffleExchangeExec(right, right_keys,
                                               shuffle_parts, conf)
        return TpuShuffledHashJoinExec(
            left, right, join_type, left_keys, right_keys, exec_schema,
            conf, condition=condition)

    def _nested_loop_join(self, left, right, join_type, condition,
                          exec_schema):
        if join_type == "full":
            # build-match tracking must be partition-local
            left = self._single(left)
        return TpuBroadcastNestedLoopJoinExec(
            left, right, join_type, exec_schema, self.conf,
            condition=condition)

    def _single(self, plan: PhysicalPlan) -> PhysicalPlan:
        if plan.num_partitions == 1:
            return plan
        return ops.TpuShuffleExchangeExec(plan, None, 1, self.conf)

    def _take_ordered(self, n: int, orders,
                      child: PhysicalPlan) -> PhysicalPlan:
        conf = self.conf
        local = ops.TpuLocalLimitExec(
            n, ops.TpuSortExec(orders, child, conf), conf)
        if local.num_partitions > 1:
            local = ops.TpuLocalLimitExec(
                n, ops.TpuSortExec(
                    orders,
                    ops.TpuShuffleExchangeExec(local, None, 1, conf),
                    conf), conf)
        return local

    def _convert_sort(self, node: L.Sort,
                      child: PhysicalPlan) -> PhysicalPlan:
        conf = self.conf
        if node.global_sort and child.num_partitions > 1:
            # distributed global sort: sample-based range exchange, then
            # per-partition out-of-core sort; partition order == global
            # order (GpuRangePartitioner.scala + GpuSortExec.scala)
            child = ops.TpuRangeShuffleExchangeExec(
                child, node.orders, conf.get(rc.SHUFFLE_PARTITIONS), conf)
        return ops.TpuSortExec(node.orders, child, conf)

    def _convert_window(self, node: L.Window,
                        child: PhysicalPlan) -> PhysicalPlan:
        """The reference's choice of window mode: the bounded-halo batched
        path, the "running" and "u2u" streaming paths, or the
        whole-partition evaluation."""
        conf = self.conf
        spec = node.window_exprs[0].children[0].spec
        if child.num_partitions > 1:
            if spec.partitions:
                child = ops.TpuShuffleExchangeExec(
                    child, spec.partitions,
                    conf.get(rc.SHUFFLE_PARTITIONS), conf)
            else:
                child = ops.TpuShuffleExchangeExec(child, None, 1, conf)
        halo = ops.window_halo(node.window_exprs)
        chunk_rows = conf.get(rc.BATCH_SIZE_ROWS)
        if halo is not None and halo > chunk_rows // 2:
            # the batched path peeks at most one following chunk for the
            # suffix halo; wider frames take the whole-partition path
            halo = None

        def chunked_sort_child():
            orders = ([L.SortOrder(p, True) for p in spec.partitions]
                      + list(spec.orders))
            return ops.TpuSortExec(orders, child, conf,
                                   chunk_rows=chunk_rows)

        if halo is not None and (spec.partitions or spec.orders):
            return ops.TpuWindowExec(node.window_exprs,
                                     chunked_sort_child(), conf,
                                     presorted=True, halo=halo)
        mode = (ops.window_streaming_mode(node.window_exprs)
                if conf.get(rc.WINDOW_STREAMING) else None)
        if mode == "running" and spec.orders:
            return ops.TpuWindowExec(node.window_exprs,
                                     chunked_sort_child(), conf,
                                     presorted=True, mode="running")
        if mode == "u2u":
            return ops.TpuWindowExec(node.window_exprs, child, conf,
                                     mode="u2u")
        return ops.TpuWindowExec(node.window_exprs, child, conf)

    def _convert_limit(self, node: L.Limit,
                       child: PhysicalPlan) -> PhysicalPlan:
        conf = self.conf
        local = ops.TpuLocalLimitExec(node.n, child, conf)
        if local.num_partitions > 1:
            local = ops.TpuLocalLimitExec(
                node.n, ops.TpuShuffleExchangeExec(local, None, 1, conf),
                conf)
        return local


def plan_query(logical: L.LogicalPlan, conf: rc.RapidsConf
               ) -> Tuple[PhysicalPlan, PlanMeta]:
    return TpuOverrides(conf).apply(logical)
