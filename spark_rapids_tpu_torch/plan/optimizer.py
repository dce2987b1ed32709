"""Logical optimizations: scan column pruning + parquet predicate
pushdown (the reference gets these from Spark's optimizer + its own
row-group filtering, GpuParquetScan.scala:556; standalone we run a small
rewrite pass before physical planning).

A copy of `spark_rapids_tpu/plan/optimizer.py` over the port's logical
plan and expressions, so both packages' physical trees agree node for
node.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.expr import (
    BoundReference,
    EqualTo,
    GreaterThan,
    GreaterThanOrEqual,
    LessThan,
    LessThanOrEqual,
    Literal,
)
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.sqltypes import StructType

_CMP_OPS = {EqualTo: "=", LessThan: "<", LessThanOrEqual: "<=",
            GreaterThan: ">", GreaterThanOrEqual: ">="}
_FLIP = {"=": "=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    new_children = [optimize(c) for c in plan.children]
    plan = _with_children(plan, new_children)
    # the reference's expand_struct_keys (plan/struct_keys.py) rewrites
    # struct-typed keys; the port has no struct columns to rewrite
    plan = _push_filters(plan)
    plan = _prune_scan_columns(plan)
    return plan


def _with_children(plan: L.LogicalPlan, children) -> L.LogicalPlan:
    if all(a is b for a, b in zip(plan.children, children)) and \
            len(plan.children) == len(children):
        return plan
    node = copy.copy(plan)
    node.children = list(children)
    return node


# ------------------------------------------------- predicate pushdown

def _split_conjuncts(e: Expression) -> List[Expression]:
    from spark_rapids_tpu_torch.expr import And

    if isinstance(e, And):
        return (_split_conjuncts(e.children[0]) +
                _split_conjuncts(e.children[1]))
    return [e]


def _filter_tuple(e: Expression, schema: StructType
                  ) -> Optional[Tuple[str, str, object]]:
    """BoundReference <cmp> Literal -> a pyarrow filter tuple. SQL
    comparisons are null-rejecting, matching pyarrow filter semantics,
    so pushdown never changes results."""
    op = _CMP_OPS.get(type(e))
    if op is None:
        return None
    a, b = e.children
    if isinstance(a, BoundReference) and isinstance(b, Literal):
        if b.value is None:
            return None
        return (schema.names[a.ordinal], op, b.value)
    if isinstance(b, BoundReference) and isinstance(a, Literal):
        if a.value is None:
            return None
        return (schema.names[b.ordinal], _FLIP[op], a.value)
    return None


def _push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    if not (isinstance(plan, L.Filter) and
            isinstance(plan.children[0], L.FileScan) and
            plan.children[0].fmt == "parquet"):
        return plan
    scan: L.FileScan = plan.children[0]
    tuples = []
    for conj in _split_conjuncts(plan.condition):
        t = _filter_tuple(conj, scan.schema)
        if t is not None:
            tuples.append(t)
    if not tuples:
        return plan
    new_scan = copy.copy(scan)
    new_scan.pushed_filters = (getattr(scan, "pushed_filters", None) or
                               []) + tuples
    # the Filter stays (pushdown is row-group pruning, not exact)
    return _with_children(plan, [new_scan])


# --------------------------------------------------- column pruning

def _remap(e: Expression, mapping) -> Expression:
    def fn(node):
        if isinstance(node, BoundReference):
            return BoundReference(mapping[node.ordinal], node.dtype,
                                  node.nullable)
        return node

    return e.transform(fn)


def _prune(scan: L.FileScan, needed: List[int]):
    """-> (new_scan, old_ordinal -> new_ordinal) or None if no gain."""
    if scan.fmt == "hivetext":
        # positional headerless format: the parser needs the full file
        # schema (every line carries every field anyway)
        return None
    if len(needed) >= len(scan.schema.fields) or not needed:
        return None
    fields = [scan.schema.fields[i] for i in sorted(needed)]
    new_scan = copy.copy(scan)
    new_scan._schema = StructType(fields)
    mapping = {old: new for new, old in enumerate(sorted(needed))}
    return new_scan, mapping


def _prune_scan_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    # Project/Aggregate over (optional Filter over) FileScan
    if isinstance(plan, L.Project):
        top_exprs = plan.exprs
    elif isinstance(plan, L.Aggregate):
        top_exprs = plan.grouping + plan.aggregates
    else:
        return plan
    child = plan.children[0]
    filt: Optional[L.Filter] = None
    if isinstance(child, L.Filter) and isinstance(child.children[0],
                                                  L.FileScan):
        filt = child
        scan = child.children[0]
    elif isinstance(child, L.FileScan):
        scan = child
    else:
        return plan
    needed = set()
    for e in top_exprs:
        needed.update(e.references())
    if filt is not None:
        needed.update(filt.condition.references())
    pruned = _prune(scan, sorted(needed))
    if pruned is None:
        return plan
    new_scan, mapping = pruned
    bottom: L.LogicalPlan = new_scan
    if filt is not None:
        bottom = L.Filter(_remap(filt.condition, mapping), new_scan)
    if isinstance(plan, L.Project):
        return L.Project([_remap(e, mapping) for e in plan.exprs],
                         bottom)
    return L.Aggregate([_remap(g, mapping) for g in plan.grouping],
                       [_remap(a, mapping) for a in plan.aggregates],
                       bottom)
