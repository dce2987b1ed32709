"""The fused single-chip engine — counterpart of
`spark_rapids_tpu/exec/fused.py`.

The reference compiles a whole query into a few XLA programs: one per
scan-side chain of operators (filter, project, lookup join, partial
aggregate) run on every part, and one per blocking operator that
concatenates the parts on the device. Eager PyTorch has no programs to
compile, so the port keeps what the engine does, not how it is compiled:

- a filter is a PENDING MASK over the chain's rows: the partial
  aggregate consumes it as its live mask, so scan -> filter -> project
  -> partial aggregate moves no rows at all;
- a broadcast equi-join with unique build keys is a row-preserving
  LOOKUP (each probe row gathers its one build match); a probe row with
  two matches loses that bet (`LookupUniquenessLost`) and the query runs
  again with the join expanded as a blocking operator;
- an aggregate above a lookup join is PUSHED DOWN through it
  (exec/agg_pushdown.py): the probe side pre-aggregates by the join keys,
  the join moves buffer rows, and more distinct keys than the group
  capacity lose that bet (`PushdownOverflow`);
- uploads are NARROWED: integer columns ship at the width their values
  need with a quantized `vrange`, in capacity buckets of 1/16 octave,
  and widen back at the head of each chain;
- partial aggregates SHRINK to the group capacity; more groups set the
  capacity flag and the query runs again with the capacity quadrupled
  and the expansion doubled;
- the flags stay on the device until ONE host read at the end of the
  run, which also fetches a small result (`device_to_arrow_fused`).

Not ported: the XLA program machinery (cached_jit, compile caches,
program keys, variant accounting), the HBM budget gates, the OOM/chaos
ladder and the plain-parquet device scan (ROADMAP A10). An error on the
card propagates. Lowerings exist for the operators the port's planner
emits (scan, cached relation, filter, project, hash aggregate, hash
exchange, broadcast join); any other node raises `FusedCompileError`
and the session falls back to the per-operator engines.

The one structural change: the expanded join sizes its output from the
match total, which costs one host sync, instead of allocating the
reference's static `expansion x input capacity` (2^28 rows for bench's
dupjoin); the overflow rule against that static capacity is kept.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    _HostColumn,
    _primitive_np,
    _upload,
    column_from_arrow,
    device_to_arrow_fused,
    schema_from_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    empty_like_schema,
    gather_columns,
    next_capacity,
)
from spark_rapids_tpu_torch.exec import agg_pushdown
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, conf_device
from spark_rapids_tpu_torch.expr.core import EvalContext
from spark_rapids_tpu_torch.ops import filterops, joinops
from spark_rapids_tpu_torch.sqltypes import StringType
from spark_rapids_tpu_torch.sqltypes.datatypes import torch_dtype

# capacity granularity for scan uploads
_UPLOAD_ALIGN = 1 << 16


class FusedCompileError(NotImplementedError):
    """Plan has no fused single-chip lowering (caller falls back to the
    per-operator engines)."""


class TpuSplitAndRetryOOM(RuntimeError):
    """A fused capacity overflowed; the run retries with larger factors.
    (The reference's runtime error of this name; the port's runtime error
    hierarchy is ROADMAP A10.)"""


class LookupUniquenessLost(Exception):
    """The lookup-join lowering's unique-build-key bet failed (a probe
    row saw >1 matches). Internal to the fused retry loop: the re-run
    keeps the same capacity factors but lowers joins via the expanded
    blocking path."""


class PushdownOverflow(Exception):
    """The agg-pushdown bet failed to fit: the probe side has more
    distinct join keys than the group capacity, so the pre-aggregate
    would not shrink. Internal to the fused retry loop: the re-run
    keeps the same factors but skips the pushdown rewrite."""


def _check_host_flags(host: np.ndarray, n_ovf: int,
                      n_uniq: int = 0, n_push: int = 0) -> None:
    """host = [capacity | uniqueness | pushdown]. Capacity overflow wins
    (a retried run re-checks everything on the full data), then the
    lookup-uniqueness and pushdown re-lowering retries. (The reference's
    ANSI error vectors follow; the port rejects ANSI mode at the session,
    ROADMAP A7.)"""
    if bool(np.any(host[:n_ovf])):
        raise TpuSplitAndRetryOOM(
            "fused capacity overflow; re-running larger")
    if bool(np.any(host[n_ovf:n_ovf + n_uniq])):
        raise LookupUniquenessLost(
            "duplicate build keys; re-lowering joins expanded")
    if bool(np.any(host[n_ovf + n_uniq:n_ovf + n_uniq + n_push])):
        raise PushdownOverflow(
            "probe join-key cardinality exceeds group capacity; "
            "re-running without agg pushdown")


# ----------------------------------------------------- narrowed upload

_NARROW_STEPS = {
    np.dtype(np.int64): (np.int32, np.int16),
    np.dtype(np.int32): (np.int16,),
}


def _quantize_range(lo: int, hi: int):
    """Power-of-two envelope of an observed [lo, hi] so refills of the
    same column land on the same vrange."""
    hi_q = (1 << int(max(hi, 0)).bit_length()) - 1
    lo_q = 0 if lo >= 0 else -(1 << int(-lo).bit_length())
    return lo_q, hi_q


def _narrow(vals: np.ndarray):
    """-> (vals possibly narrowed, quantized (lo, hi) or None)."""
    if vals.size == 0 or not np.issubdtype(vals.dtype, np.integer):
        return vals, None
    lo, hi = int(vals.min()), int(vals.max())
    vrange = _quantize_range(lo, hi)
    for cand in reversed(_NARROW_STEPS.get(vals.dtype, ())):
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            return vals.astype(cand), vrange
    return vals, vrange


def bucket_capacity(n: int) -> int:
    """Padded-shape bucket for scan uploads: one of 16 steps per
    power-of-two octave (padding at most 12.5 %); below 2^20 rows the
    _UPLOAD_ALIGN floor dominates."""
    n = max(int(n), 1)
    step = max(1 << max(int(n - 1).bit_length() - 4, 0), _UPLOAD_ALIGN)
    return -(-n // step) * step


def upload_narrowed(table: pa.Table, bucket: bool = True,
                    device=None) -> ColumnBatch:
    """pyarrow Table -> device ColumnBatch with integer columns shipped
    at their observed width (widened back by `widen_traced`), in one
    pinned host-to-device copy as arrow_to_device does. Capacity: the
    1/16-octave bucket, or with `bucket` off (shape bucketing disabled)
    the next multiple of _UPLOAD_ALIGN."""
    from spark_rapids_tpu_torch import resolve_device

    device = resolve_device(device)
    table = table.combine_chunks()
    n = table.num_rows
    cap = (bucket_capacity(n) if bucket else
           max(_UPLOAD_ALIGN, -(-max(n, 1) // _UPLOAD_ALIGN) * _UPLOAD_ALIGN))
    schema = schema_from_arrow(table.schema)
    host_cols = []
    for i, field in enumerate(schema.fields):
        col = table.column(i)
        arr = (col.chunk(0) if col.num_chunks else
               pa.array([], type=table.schema.field(i).type))
        dt = field.dataType
        if pa.types.is_dictionary(arr.type) and not isinstance(
                dt, StringType):
            arr = arr.dictionary_decode()
        np_dt = getattr(dt, "np_dtype", None)
        if (np_dt is not None
                and np.issubdtype(np.dtype(np_dt), np.integer)
                and not isinstance(dt, StringType)):
            vals, validity = _primitive_np(arr, np_dt)
            vals, vrange = _narrow(np.ascontiguousarray(vals))
            host_cols.append(_HostColumn(dt, vals, validity, vrange=vrange))
            continue
        host_cols.append(column_from_arrow(arr, field, device))
    leaves = [leaf for hc in host_cols for leaf in hc.leaves()]
    dev = iter(_upload(leaves, cap, device))
    cols = []
    for hc in host_cols:
        data, validity = next(dev), next(dev)
        lengths = next(dev) if hc.lengths is not None else None
        cols.append(DeviceColumn(hc.dtype, data, validity, lengths,
                                 vrange=hc.vrange, encoding=hc.encoding))
    return ColumnBatch(schema, cols, n)


def widen_traced(batch: ColumnBatch) -> ColumnBatch:
    """Inverse of the narrowed upload: restore each integer column's
    logical dtype (vrange kept)."""
    cols = []
    changed = False
    for c, f in zip(batch.columns, batch.schema.fields):
        want = torch_dtype(f.dataType) if getattr(
            f.dataType, "np_dtype", None) is not None else None
        if (want is not None and c.encoding is None and c.data.dim() == 1
                and c.data.dtype != want
                and not c.data.dtype.is_floating_point
                and c.data.dtype != torch.bool):
            c = c.replace(data=c.data.to(want))
            changed = True
        cols.append(c)
    return ColumnBatch(batch.schema, cols, batch.num_rows) if changed \
        else batch


def shrink_traced(batch: ColumnBatch, cap2: int):
    """Cut a front-compacted batch to a smaller capacity (views). The
    cut is exact unless the row count exceeds cap2, reported by the
    returned overflow flag (a 0-d device bool, or False)."""
    if cap2 >= batch.capacity:
        return batch, False
    nr = batch.num_rows
    if isinstance(nr, int):
        ovf, rows = nr > cap2, min(nr, cap2)
    else:
        ovf, rows = nr > cap2, nr.clamp(max=cap2)
    cols = [c.truncate(cap2) for c in batch.columns]
    return ColumnBatch(batch.schema, cols, rows), ovf


# --------------------------------------------------------- the executor

_SOURCE_TYPES = (ops.TpuFileScanExec, ops.TpuCachedRelationExec)

#: node types with no fused lowering yet, and the ROADMAP item that
#: ports them
_UNPORTED = {
    "TpuSortExec": "A11", "TpuWindowExec": "A11", "TpuLocalLimitExec": "A11",
    "TpuGenerateExec": "A12", "TpuExpandExec": "A12",
    "TpuShuffledHashJoinExec": "A13",
}


class _Flags:
    """The run's flags: 0-d device bools (read in the one host sync at
    the end) or host bools (already known)."""

    def __init__(self):
        self.kinds: Dict[str, List] = {"ovf": [], "uniq": [], "push": []}

    def add(self, kind: str, flag) -> None:
        if flag is not False:
            self.kinds[kind].append(flag)

    def device_array(self, device) -> torch.Tensor:
        out = []
        for kind in ("ovf", "uniq", "push"):
            fl = self.kinds[kind]
            dev = [f.reshape(1) for f in fl if isinstance(f, torch.Tensor)]
            host = any(f is True for f in fl)
            v = torch.zeros(1, dtype=torch.bool, device=device) if not dev \
                else torch.cat(dev).any().reshape(1)
            out.append(v | host)
        return torch.cat(out)


class FusedSingleChipExecutor:
    """Run one physical plan on the fused single-chip engine."""

    def __init__(self, conf=None):
        from spark_rapids_tpu_torch.config import rapids_conf as rc

        self.conf = conf

        def c(entry):
            return conf.get(entry) if conf is not None else entry.default

        self._expansion = c(rc.FUSED_EXPANSION)
        self._group_cap = c(rc.FUSED_GROUP_CAP)
        self._max_expansion = c(rc.FUSED_MAX_EXPANSION)
        self._fetch_fused_bytes = c(rc.FUSED_SINGLE_SYNC_FETCH_BYTES)
        self._agg_pushdown = c(rc.FUSED_AGG_PUSHDOWN)
        self._lookup_conf = c(rc.FUSED_LOOKUP_JOIN)
        self._shape_buckets = c(rc.FUSED_SHAPE_BUCKETS)
        self.device = conf_device(conf)
        #: the factors and lowerings the last run settled on:
        #: (expansion, group_cap, use_lookup, use_pushdown)
        self.last_settled = None
        self._src_parts: Optional[Dict[int, List[ColumnBatch]]] = None
        self._rewrite_memo: Dict[tuple, Optional[list]] = {}

    # --- source preparation (once; survives retries) ---

    def _collect_sources(self, node: PhysicalPlan,
                         out: List[PhysicalPlan]) -> None:
        if isinstance(node, _SOURCE_TYPES) or not node.is_tpu:
            out.append(node)
            return
        for c in node.children:
            self._collect_sources(c, out)

    def _scan_parts(self, scan: ops.TpuFileScanExec) -> List[ColumnBatch]:
        tasks = [t for t in scan._tasks if t]
        if not tasks:
            return [empty_like_schema(scan.schema, 1024, self.device)]

        def one(task):
            return [upload_narrowed(t, bucket=self._shape_buckets,
                                    device=self.device)
                    for t in scan._host_tables(task)]

        if len(tasks) == 1:
            groups = [one(tasks[0])]
        else:
            with ThreadPoolExecutor(max_workers=min(8, len(tasks))) as pool:
                groups = list(pool.map(one, tasks))
        return [b for g in groups for b in g]

    def _prepare(self, phys: PhysicalPlan,
                 root_may_be_source: bool = False
                 ) -> Dict[int, List[ColumnBatch]]:
        sources: List[PhysicalPlan] = []
        self._collect_sources(phys, sources)
        if any(s is phys for s in sources):
            # a device source root is meaningful when materializing parts
            # (the relation cache); a bare scan query is not fused
            if not (root_may_be_source and phys.is_tpu):
                raise FusedCompileError("plan root is a host operator")
        parts: Dict[int, List[ColumnBatch]] = {}
        for s in sources:
            if isinstance(s, ops.TpuCachedRelationExec):
                ps = s.entry.device_parts()
            elif isinstance(s, ops.TpuFileScanExec):
                ps = self._scan_parts(s)
            else:
                raise FusedCompileError(
                    f"{type(s).__name__} source has no fused lowering")
            parts[id(s)] = ps
        self._src_parts = parts
        return parts

    # --- validation walk (no device work) ---

    def _validate(self, node: PhysicalPlan) -> None:
        if isinstance(node, _SOURCE_TYPES) or not node.is_tpu:
            return
        name = type(node).__name__
        if name in _UNPORTED:
            raise FusedCompileError(
                f"{name} has no fused lowering yet (ROADMAP "
                f"{_UNPORTED[name]})")
        if not isinstance(node, (
                ops.TpuProjectExec, ops.TpuFilterExec,
                ops.TpuHashAggregateExec, ops.TpuShuffleExchangeExec,
                J.TpuBroadcastHashJoinExec)):
            raise FusedCompileError(f"{name} has no fused lowering")
        for c in node.children:
            self._validate(c)

    # --- entry points ---

    def execute_parts(self, phys: PhysicalPlan) -> List[ColumnBatch]:
        """Run the plan but keep its output as device batches (no host
        collect) — the relation cache's materializer. Source narrowing and
        vrange metadata survive into the parts."""
        return self.execute(phys, as_parts=True)

    def execute(self, phys: PhysicalPlan, as_parts: bool = False):
        self._validate(phys)
        self._premater_cached(phys)
        self._rewrite_memo = {}
        try:
            self._prepare(phys, root_may_be_source=as_parts)
            out, self.last_settled = self._run_with_retry(phys, as_parts)
            return out
        finally:
            self._src_parts = None
            self._rewrite_memo = {}

    def _premater_cached(self, node: PhysicalPlan) -> None:
        if isinstance(node, ops.TpuCachedRelationExec):
            node.entry.materialize()
            return
        for c in node.children:
            self._premater_cached(c)

    def _run_with_retry(self, phys: PhysicalPlan, as_parts: bool):
        """One settled run under the retry loop; returns (result,
        (expansion, group_cap, use_lookup, use_pushdown)) at the settings
        that succeeded. Capacity overflow doubles the expansion and
        quadruples the group capacity; a lost bet only flips its
        lowering."""
        expansion, group_cap = self._expansion, self._group_cap
        use_lookup = use_pushdown = True
        while True:
            try:
                return (self._run(phys, expansion, group_cap,
                                  as_parts=as_parts, use_lookup=use_lookup,
                                  use_pushdown=use_pushdown),
                        (expansion, group_cap, use_lookup, use_pushdown))
            except LookupUniquenessLost:
                use_lookup = False
            except PushdownOverflow:
                use_pushdown = False
            except TpuSplitAndRetryOOM:
                if expansion >= self._max_expansion:
                    raise
                expansion *= 2
                group_cap *= 4

    def _is_per_partition(self, node: PhysicalPlan) -> bool:
        if isinstance(node, (ops.TpuProjectExec, ops.TpuFilterExec)):
            return True
        return (isinstance(node, ops.TpuHashAggregateExec)
                and node.mode == "partial")

    def _is_lookup_join(self, node: PhysicalPlan,
                        use_lookup: bool) -> bool:
        """Broadcast inner equi-joins lower as a row-preserving lookup
        inside the per-partition chain while the unique-build-key bet
        holds (see the module docstring). The port's joins are inner and
        unconditioned (ROADMAP A13)."""
        return (isinstance(node, J.TpuBroadcastHashJoinExec)
                and self._lookup_conf and use_lookup)

    # --- one run ---

    def _run(self, phys: PhysicalPlan, expansion: int, group_cap: int,
             as_parts: bool = False, use_lookup: bool = True,
             use_pushdown: bool = True):
        from spark_rapids_tpu_torch.parallel.plan_compiler import (
            concat_traced,
            shard_equi_join,
        )

        flags = _Flags()
        push_on = use_pushdown and self._agg_pushdown
        src_parts = self._src_parts

        def chain_traced(nodes, batch, builds=()):
            """Apply a bottom-up list of per-partition operators to one
            part; filters ride as a pending mask that the partial
            aggregate consumes as its live mask."""
            b = widen_traced(batch)
            mask = None  # pending filter predicate over b's rows
            builds = list(builds)

            def materialized(b, mask):
                return b if mask is None else filterops.compact(b, mask)

            def visible(b, mask):
                return b.live_mask() if mask is None \
                    else mask & b.live_mask()

            def lookup_join(nd, b, mask, bt):
                """Row-preserving inner join-as-gather: probe rows keep
                their positions; no match lands in the pending mask."""
                work_l, lk = nd._prepare_keys(b, nd.left_keys)
                lo, counts = joinops.probe_ranges(bt, work_l, lk)
                # a visible probe row with >1 matches loses the bet
                flags.add("uniq", ((counts > 1) & visible(b, mask)).any())
                matched = counts > 0
                safe = lo.clamp(0, bt.batch.capacity - 1)
                rcols = gather_columns([(c, safe)
                                        for c in bt.batch.columns])
                rcols = [c.replace(validity=c.validity & matched)
                         for c in rcols]
                b = ColumnBatch(nd.schema, list(b.columns) + rcols,
                                b.num_rows)
                mask = matched if mask is None else mask & matched
                return b, mask

            for nd in nodes:
                if isinstance(nd, J.TpuBroadcastHashJoinExec):
                    b, mask = lookup_join(nd, b, mask, builds.pop(0))
                elif isinstance(nd, ops.TpuFilterExec):
                    pred = nd.condition.eval(EvalContext(b))
                    m = pred.data & pred.validity
                    mask = m if mask is None else mask & m
                elif isinstance(nd, ops.TpuProjectExec):
                    b = nd._run(b)  # row-preserving; mask stays aligned
                elif isinstance(nd, agg_pushdown.MergeTail):
                    # the pushdown's terminator: merge the joined buffer
                    # rows of this part; the cross-part merge is blocking
                    b, mask = materialized(b, mask), None
                    b = nd.agg._merge_buffers(b)
                else:  # partial aggregate: consumes the mask as `live`
                    b = nd._partial(b, live=visible(b, mask))
                    mask = None
                    b, o = shrink_traced(b, group_cap)
                    # the synthesized pre-aggregate not fitting loses the
                    # pushdown bet; the plan's own capacities are fine
                    flags.add("push" if getattr(nd, "_pushdown_synth",
                                                False) else "ovf", o)
            return materialized(b, mask)

        def emit_parts(node: PhysicalPlan) -> List[ColumnBatch]:
            if id(node) in src_parts:
                return src_parts[id(node)]
            if isinstance(node, ops.TpuShuffleExchangeExec):
                # single chip: every partition is already co-resident
                return emit_parts(node.children[0])
            if chainable(node):
                nodes, cur = collect_chain(node)
                if use_lookup and push_on:
                    rep = rewrite_memo(nodes)
                    if rep is not None:
                        nodes = rep
                return run_chain(nodes, emit_parts(cur))
            return [emit_blocking(node)]

        def chainable(n):
            return (self._is_per_partition(n)
                    or self._is_lookup_join(n, use_lookup))

        def collect_chain(node):
            """The chainable span below `node` (inclusive) in execution
            order, and the non-chainable node under it."""
            chain = [node]
            cur = node.children[0]
            while chainable(cur) and id(cur) not in src_parts:
                chain.append(cur)
                cur = cur.children[0]
            return list(reversed(chain)), cur

        def rewrite_memo(nodes):
            key = tuple(id(n) for n in nodes)
            if key not in self._rewrite_memo:
                self._rewrite_memo[key] = agg_pushdown.rewrite_chain(nodes)
            return self._rewrite_memo[key]

        def run_chain(nodes, base):
            # lookup-join build sides are concatenated and sorted ONCE
            builds = [build_table(n) for n in nodes
                      if isinstance(n, J.TpuBroadcastHashJoinExec)]
            return [chain_traced(nodes, b, builds) for b in base]

        def build_table(jn: PhysicalPlan):
            cb = concat_traced(concat_inputs(emit_parts(jn.children[1])))
            return jn._build_table(cb)

        def concat_inputs(parts):
            return [widen_traced(p) for p in parts]

        def emit_blocking(node: PhysicalPlan) -> ColumnBatch:
            if isinstance(node, ops.TpuHashAggregateExec):
                mode = node.mode
                if mode == "complete" and use_lookup and push_on:
                    # a complete aggregate over one partition: the
                    # pushdown still applies, the blocking step only
                    # merge-finalizes
                    nodes, cur = collect_chain(node)
                    rep = rewrite_memo(nodes) if len(nodes) > 1 else None
                    if rep is not None:
                        parts = run_chain(rep, emit_parts(cur))
                        cb = concat_traced(concat_inputs(parts))
                        out, o = shrink_traced(node._merge_final(cb),
                                               group_cap)
                        flags.add("ovf", o)
                        return out
                cb = concat_traced(concat_inputs(
                    emit_parts(node.children[0])))
                if mode == "complete":
                    cb = node._partial(cb)
                out, o = shrink_traced(node._merge_final(cb), group_cap)
                flags.add("ovf", o)
                return out
            if isinstance(node, J.TpuBroadcastHashJoinExec):
                lb = concat_traced(concat_inputs(
                    emit_parts(node.children[0])))
                rb = concat_traced(concat_inputs(
                    emit_parts(node.children[1])))
                out_cap = next_capacity(
                    expansion * max(lb.capacity, rb.capacity))
                out, overflow = shard_equi_join(node, lb, rb, out_cap)
                if overflow:
                    raise TpuSplitAndRetryOOM(
                        "fused join output exceeds its capacity; "
                        "re-running larger")
                return out
            raise FusedCompileError(type(node).__name__)

        parts = emit_parts(phys)
        if as_parts:
            # one host sync for every flag; parts stay on the device
            _check_host_flags(flags.device_array(self.device).cpu().numpy(),
                              1, 1, 1)
            return parts
        result = (concat_traced(concat_inputs(parts)) if len(parts) > 1
                  else widen_traced(parts[0]))
        flag_arr = flags.device_array(self.device)
        if result.device_size_bytes() <= self._fetch_fused_bytes:
            # small result: ONE device-to-host copy for rows, flags and
            # data
            table, host_flags = device_to_arrow_fused(result, flag_arr)
            _check_host_flags(host_flags, 1, 1, 1)
            return table
        _check_host_flags(flag_arr.cpu().numpy(), 1, 1, 1)
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            device_to_arrow,
        )

        return device_to_arrow(result)
