"""Partial-aggregation pushdown through fused lookup joins — a copy of
`spark_rapids_tpu/exec/agg_pushdown.py` with its imports rewritten to the
port's modules.

The q5/star-schema hot shape is

    fact -> filter -> JOIN dim (many-to-one) -> group by dim.attr

Executed literally, the join gathers every dim column onto millions of
fact rows and the aggregate then groups millions of rows by a (often
string) dimension attribute — both costs scale with |fact|. But when
the join is the fused engine's LOOKUP join (unique build keys, enforced
by its overflow flag — exec/fused.py _is_lookup_join), the dim
attributes are a FUNCTION of the join key, so the aggregate can run in
two stages:

    fact -> filter -> partial agg BY JOIN KEY  (binned reductions)
         -> lookup join of the ~|dim| buffer rows
         -> merge buffers BY dim.attr

The join and the dim-attribute grouping now touch thousands of buffer
rows instead of millions of fact rows. The reference has no equivalent
rewrite (Spark's eager-aggregation rule is off by default and
spark-rapids inherits the literal plan).

Correctness:
- build-key uniqueness is the lookup join's existing bet: duplicate
  keys trip the overflow flag, the run retries, and the retry skips
  both the lookup lowering and this rewrite;
- mid filters/projects between join and aggregate split by provenance:
  probe-pure expressions inline below the pre-aggregate (same rows),
  build-pure expressions run after the join on buffer rows (build
  attributes are constant per join-key group under uniqueness);
- order-sensitive aggregates (first/last/any_value) and variable-width
  ones (collect, count(DISTINCT), sum(DISTINCT), percentile: not
  jittable) are excluded, as the reference's gate excludes them;
- a mixed probe+build expression anywhere disables the rewrite.
"""

from __future__ import annotations

import copy
from typing import List, Optional

from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.expr import Alias, BoundReference, First
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.sqltypes import StructField, StructType


class MergeTail:
    """Synthesized chain terminator: per-part buffer merge of the
    pushed-down aggregate over the joined buffer batch, keyed on the
    batch's key prefix. The cross-part step stays with the blocking
    lowering: the downstream FINAL aggregate (partial mode) or the
    merge-final program emit_blocking builds for a complete-mode
    aggregate (exec/fused.py)."""

    def __init__(self, agg: ops.TpuHashAggregateExec):
        self.agg = agg


def _inline(e: Expression, mapping: List[Optional[Expression]]
            ) -> Optional[Expression]:
    """Rebuild `e` substituting each BoundReference by mapping[ordinal]
    (None entries poison the result -> returns None)."""
    if isinstance(e, BoundReference):
        m = mapping[e.ordinal]
        return copy.copy(m) if m is not None else None
    if not e.children:
        return e
    kids = []
    for c in e.children:
        k = _inline(c, mapping)
        if k is None:
            return None
        kids.append(k)
    ne = copy.copy(e)
    ne.children = kids
    return ne


def _ref(i: int, field) -> BoundReference:
    return BoundReference(i, field.dataType, field.nullable)


def rewrite_chain(nodes: list) -> Optional[list]:
    """nodes: bottom-up exec-order fused chain. If the tail matches
    [lookup-join, filters/projects..., partial/complete agg], return
    the pushed-down replacement chain; else None. (Synthesized nodes
    inherit the aggregate node's conf; the enable/ANSI gates live in
    the caller, exec/fused.py `push_on`.)"""
    ag = nodes[-1]
    if not isinstance(ag, ops.TpuHashAggregateExec):
        return None
    if ag.mode not in ("partial", "complete"):
        return None
    fns = [a.children[0] for a in ag.aggs]
    if any(not f.jittable or isinstance(f, First) for f in fns):
        return None
    join_idx = [i for i, n in enumerate(nodes[:-1])
                if isinstance(n, J.TpuBroadcastHashJoinExec)]
    if not join_idx:
        return None
    ji = join_idx[-1]
    lj = nodes[ji]
    if lj.condition is not None or lj.join_type not in ("inner", "left"):
        return None
    mids = nodes[ji + 1:-1]
    # (the reference also skips TpuCoalesceBatchesExec here; the port's
    # planner emits none)
    if not all(isinstance(m, (ops.TpuFilterExec, ops.TpuProjectExec))
               for m in mids):
        return None

    probe = lj.children[0]
    build = lj.children[1]
    pfields = list(probe.schema.fields)
    bfields = list(build.schema.fields)
    L = len(pfields)
    # provenance of each current-schema column: an expr over the probe
    # schema, or an expr over a build-ordinal namespace, or neither
    probe_map: List[Optional[Expression]] = \
        [_ref(i, f) for i, f in enumerate(pfields)] + [None] * len(bfields)
    build_map: List[Optional[Expression]] = \
        [None] * L + [_ref(j, f) for j, f in enumerate(bfields)]
    stage_a_filters: List[Expression] = []
    stage_b_filters: List[Expression] = []  # over build-ordinal space

    for m in mids:
        if isinstance(m, ops.TpuFilterExec):
            pe = _inline(m.condition, probe_map)
            if pe is not None:
                stage_a_filters.append(pe)
                continue
            be = _inline(m.condition, build_map)
            if be is None:
                return None
            stage_b_filters.append(be)
            continue
        # project: remap provenance per alias
        pm2, bm2 = [], []
        for a in m.exprs:
            e = a.children[0]
            pm2.append(_inline(e, probe_map))
            bm2.append(_inline(e, build_map))
        probe_map, build_map = pm2, bm2

    # aggregate inputs must be probe-pure
    aggs_a: List[Alias] = []
    for a in ag.aggs:
        fn = a.children[0]
        kids = []
        for c in fn.children:
            k = _inline(c, probe_map)
            if k is None:
                return None
            kids.append(k)
        fn2 = copy.copy(fn)
        fn2.children = kids
        aggs_a.append(Alias(fn2, a.name))

    # grouping exprs: probe-pure ride the pre-aggregate; build-pure
    # re-evaluate on the joined buffer batch
    grp_kind: List[tuple] = []  # ("p", idx into extra pgs) | ("b", expr)
    pgs: List[Expression] = []
    for g in ag.grouping:
        e = g.children[0]
        pe = _inline(e, probe_map)
        if pe is not None:
            grp_kind.append(("p", len(pgs)))
            pgs.append(pe)
            continue
        be = _inline(e, build_map)
        if be is None:
            return None
        grp_kind.append(("b", be))

    conf_ = ag.conf
    nk = len(lj.left_keys)

    # ---- stage A: probe-side filters + partial agg by join keys ----
    rep: list = list(nodes[:ji])
    for cond in stage_a_filters:
        rep.append(ops.TpuFilterExec(cond, probe, conf_))
    grouping_a = ([Alias(k, f"__pk{i}")
                   for i, k in enumerate(lj.left_keys)] +
                  [Alias(e, f"__pg{i}") for i, e in enumerate(pgs)])
    agg_a = ops.TpuHashAggregateExec("partial", grouping_a, aggs_a,
                                     probe, conf_)
    # shrink overflow of the synthesized pre-agg means the PUSHDOWN bet
    # lost (too many distinct probe keys), not a plan capacity problem:
    # the fused executor routes it to its own flag (PushdownOverflow)
    agg_a._pushdown_synth = True
    rep.append(agg_a)

    # ---- stage B: lookup join of the buffer rows, then merge ----
    afields = list(agg_a.schema.fields)
    lkeys_b = [_ref(i, afields[i]) for i in range(nk)]
    rb_fields = ([StructField(f.name, f.dataType, True) for f in bfields]
                 if lj.join_type == "left"
                 else bfields)  # left joins null-extend the build side
    join_schema = StructType(afields + rb_fields)
    lj_b = J.TpuBroadcastHashJoinExec(
        agg_a, build, lj.join_type, lkeys_b, list(lj.right_keys),
        join_schema, conf_)
    rep.append(lj_b)
    na = len(afields)

    def shift(e: Expression) -> Expression:
        if isinstance(e, BoundReference):
            return BoundReference(e.ordinal + na, e.dtype, e.nullable)
        ne = copy.copy(e)
        ne.children = [shift(c) for c in e.children]
        return ne

    for cond in stage_b_filters:
        rep.append(ops.TpuFilterExec(shift(cond), lj_b, conf_))

    # reorder joined schema to the merge layout [keys..., buffers...]
    proj_exprs: List[Alias] = []
    for g, kind in zip(ag.grouping, grp_kind):
        if kind[0] == "p":
            pos = nk + kind[1]
            proj_exprs.append(Alias(_ref(pos, afields[pos]), g.name))
        else:
            proj_exprs.append(Alias(shift(kind[1]), g.name))
    for i in range(nk + len(pgs), na):
        proj_exprs.append(Alias(_ref(i, afields[i]), afields[i].name))
    proj_schema = StructType(
        [f for f in _merge_layout(ag)])
    proj_b = ops.TpuProjectExec(proj_exprs, lj_b, proj_schema, conf_)
    rep.append(proj_b)
    rep.append(MergeTail(ag))
    return rep


def _merge_layout(ag: ops.TpuHashAggregateExec):
    """[grouping fields..., buffer fields...] — the layout
    _merge_buffers/_merge_final expect."""
    return ops._buffer_schema(ag.grouping, ag.aggs).fields
