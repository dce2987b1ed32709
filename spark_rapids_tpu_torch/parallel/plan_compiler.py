"""Planner-driven mesh execution — counterpart of
`spark_rapids_tpu/parallel/plan_compiler.py`.

The helpers the fused single-chip engine (exec/fused.py) uses keep the
reference's names: `concat_traced` and `shard_equi_join` (every join type,
with or without a condition). `_plan_key` is not ported: it keys compiled
XLA programs, which eager PyTorch does not have.

`MeshQueryExecutor` runs the SAME planner output that the single-chip
engines run over a one-dimensional mesh (`spark.rapids.tpu.mesh=N`, or
`spark.rapids.shuffle.mode=ICI` for a mesh over every local device). The
reference compiles the plan into one shard_map'd program; the port walks
it eagerly, each node turning the list of its child's shards into its
own:

- project, filter and the aggregate's phases run on each shard;
- a hash exchange, a shuffled join's co-partitioning and an aggregate's
  partial-to-final hand-off are a key-hash all-to-all (K6, K37, K8, K1);
  a single-partition exchange gathers to shard 0; a broadcast join's
  build side is all-gathered;
- file scans ingest per shard (each shard decodes its own files, with one
  union dictionary a string column), other sources are collected once
  and split.

Data-dependent sizes keep the reference's discipline: each all-to-all
slot and join expansion has a capacity from the expansion factor, the
overflow flags are OR'd on the device and read once an execution, and an
overflow re-runs the plan with the factor doubled, up to 256. A node with
no mesh lowering raises MeshCompileError and the session falls back to
the single-chip engines with the reason recorded. What the reference
lowers and the port does not yet (sort and ORDER BY, window, generate,
union, limit, the static collect widths, 2D and multi-host meshes, chip
and host loss, chaos retries) raises NotImplementedError naming ROADMAP
A16: falling back would run another engine than the reference does
without saying so.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar import encoding as _enc
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    arrow_to_device,
    column_from_arrow,
    device_to_arrow_fused,
    upload_columns,
)
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    concat_compacted,
    next_capacity,
)
from spark_rapids_tpu_torch.config import rapids_conf as rc
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import operators as ops
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.expr.aggregates import CollectList, CountDistinct
from spark_rapids_tpu_torch.expr.core import EvalContext
from spark_rapids_tpu_torch.ops import filterops, joinops
from spark_rapids_tpu_torch.ops.hashing import murmur3_pmod
from spark_rapids_tpu_torch.parallel import collective, mesh_exec
from spark_rapids_tpu_torch.sqltypes import StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import to_arrow_type


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


# --------------------------------------------------------- the mesh engine

AXIS = mesh_exec.AXIS

#: what the reference lowers over the mesh and the port does not yet
_NOT_PORTED = "is not ported to the mesh engine yet (ROADMAP A16)"


class MeshCompileError(NotImplementedError):
    """Plan contains an operator with no mesh lowering (the caller falls
    back to the single-chip engines)."""


_SOURCE_TYPES = (ops.LocalRelationExec, ops.TpuFileScanExec,
                 ops.ArrowToDeviceExec, ops.TpuCachedRelationExec)

_SUPPORTED = (ops.TpuProjectExec, ops.TpuFilterExec,
              ops.TpuHashAggregateExec, ops.TpuShuffleExchangeExec,
              ops.TpuSortExec, ops.TpuLocalLimitExec, ops.UnionExec,
              ops.TpuWindowExec, ops.TpuGenerateExec,
              J.TpuShuffledHashJoinExec, J.TpuBroadcastHashJoinExec)


def plan_bears_exchange(phys: PhysicalPlan) -> bool:
    """True when executing this plan on a mesh would move rows between
    shards: explicit exchanges and the operators whose mesh lowering
    makes one (a shuffled join's co-partitioning, an aggregate's
    partial-to-final hand-off, a global sort, a window)."""

    def walk(n: PhysicalPlan) -> bool:
        if isinstance(n, (ops.TpuShuffleExchangeExec,
                          ops.TpuHashAggregateExec,
                          ops.TpuSortExec,
                          ops.TpuWindowExec,
                          J.TpuShuffledHashJoinExec)):
            return True
        return any(walk(c) for c in n.children)

    return walk(phys)


def _has_exchange(phys: PhysicalPlan) -> bool:
    return (isinstance(phys, ops.TpuShuffleExchangeExec)
            or any(_has_exchange(c) for c in phys.children))


class MeshQueryExecutor:
    """Run one physical plan over a one-dimensional mesh of shards.

    `last_stats` describes the last execution: the shards, the expansion
    factor it settled on and its retries, the all-to-all slots, and the
    collectives run with the bytes they wrote."""

    def __init__(self, mesh: mesh_exec.Mesh, conf):
        self.mesh = mesh
        self.conf = conf
        self.n = mesh_exec.total_shards(mesh)
        self._expansion = max(1, int(conf.get(rc.MULTICHIP_EXPANSION)))
        self.last_stats: Dict = {}

    @classmethod
    def for_devices(cls, n_devices: int, conf) -> "MeshQueryExecutor":
        """A mesh of n shards: on the CPU (spark.rapids.torch.device=cpu)
        all of them share it; on CUDA the first n visible GPUs, raising
        when fewer are visible."""
        from spark_rapids_tpu_torch.exec.base import conf_device

        n = max(1, int(n_devices))
        dev = conf_device(conf)
        devices = [dev] * n if dev.type == "cpu" else None
        return cls(mesh_exec.make_mesh(n, devices=devices), conf)

    # --- plan walking ---

    def _collect_sources(self, node: PhysicalPlan,
                         out: List[PhysicalPlan]) -> None:
        if isinstance(node, _SOURCE_TYPES) or not node.is_tpu:
            out.append(node)
            return
        if not isinstance(node, _SUPPORTED):
            raise MeshCompileError(
                f"{type(node).__name__} has no mesh lowering")
        for c in node.children:
            self._collect_sources(c, out)

    def _materialize(self, source: PhysicalPlan) -> ColumnBatch:
        """Collect a source that is not a file scan on the host and upload
        it as one batch on the mesh's first device, its capacity a
        multiple of the shard count (file scans ingest per shard:
        `_ingest_scan_sharded`)."""
        if isinstance(source, ops.LocalRelationExec):
            table = source.table
        elif isinstance(source, ops.ArrowToDeviceExec):
            tables = list(source.host_tables())
            table = (pa.concat_tables(tables) if tables
                     else _empty_table(source.schema))
        else:
            table = source.collect()
        cap = next_capacity(max(table.num_rows, 1))
        if cap % self.n:
            cap = -(-cap // self.n) * self.n
        return arrow_to_device(table, capacity=cap,
                               device=self.mesh.devices[0])

    def _ingest_scan_sharded(self, scan: ops.TpuFileScanExec
                             ) -> List[ColumnBatch]:
        """Partitioned ingestion: the scan's files are dealt to the shards
        (file f to shard f % n) and each shard decodes only its own, in a
        pool of reader threads, into its own device buffer; string
        columns are reconciled onto one union dictionary a column, and
        every leaf's trailing axes padded to the widest shard's."""
        n = self.n
        files = [f for t in scan._tasks for f in t]
        shard_files = [files[s::n] for s in range(n)]
        devs = self.mesh.devices

        def decode(s: int) -> Tuple[int, List[DeviceColumn]]:
            fs = shard_files[s]
            if fs:
                t = pa.concat_tables(list(scan._host_tables(fs)))
                t = t.unify_dictionaries().combine_chunks()
            else:
                t = _empty_table(scan.schema)
            cols = []
            for i, field in enumerate(scan.schema.fields):
                col = t.column(i)
                arr = (col.chunk(0) if col.num_chunks else
                       pa.array([], type=t.schema.field(i).type))
                cols.append(column_from_arrow(arr, field, devs[s]))
            return t.num_rows, cols

        with ThreadPoolExecutor(max_workers=min(8, n)) as pool:
            decoded = list(pool.map(decode, range(n)))
            rows = [r for r, _ in decoded]
            shard_cols = [c for _, c in decoded]
            shard_cap = next_capacity(max(max(rows), 1))
            col_dicts = self._reconcile_dictionaries(scan, shard_cols)
            for ci in range(len(scan.schema.fields)):
                leaves = [sc[ci].leaves() for sc in shard_cols]
                for li in range(len(leaves[0])):
                    for ax in range(1, leaves[0][li].ndim):
                        m = max(int(ls[li].shape[ax]) for ls in leaves)
                        for ls in leaves:
                            ls[li] = _pad_axis(ls[li], ax, m)
                for sc, ls in zip(shard_cols, leaves):
                    sc[ci] = sc[ci].with_leaves(ls)

            dicts = {ci: mesh_exec.replicate_dictionary(self.mesh, dd)
                     for ci, dd in col_dicts.items()}

            def upload(s: int) -> ColumnBatch:
                cols = upload_columns(shard_cols[s], shard_cap, devs[s])
                for ci, dd in dicts.items():
                    dd = dd[devs[s]]
                    cols[ci] = cols[ci].replace(
                        encoding=dd, vrange=(0, max(dd.num_values - 1, 0)))
                return ColumnBatch(scan.schema, cols, rows[s])

            return list(pool.map(upload, range(n)))

    def _reconcile_dictionaries(self, scan, shard_cols) -> Dict[int, str]:
        """Rewrite per-shard encoded columns onto one shared dictionary.

        Returns {column index: union dictionary id} for the columns that
        stay encoded; their shard columns are left holding remapped host
        codes with the encoding stripped (the caller attaches each
        device's copy of the union dictionary after the upload). A column
        whose shards cannot reconcile (a live plain shard mixed with
        encoded ones, an evicted host dictionary, or
        reconcileDictionaries off) decodes on the host instead."""
        reconcile = self.conf.get(rc.MULTICHIP_RECONCILE_DICTS)
        col_dicts: Dict[int, str] = {}
        for ci in range(len(scan.schema.fields)):
            cols = [sc[ci] for sc in shard_cols]
            encs = [c.encoding for c in cols]
            if all(e is None for e in encs):
                continue
            live_plain = any(
                e is None and int(np.asarray(c.validity).sum()) > 0
                for c, e in zip(cols, encs))
            union_id = hd = None
            if reconcile and not live_plain:
                union_id = self._union_dictionary_id(encs)
                hd = (_enc._host_dict(union_id)
                      if union_id is not None else None)
            if hd is None:
                for s, c in enumerate(cols):
                    if encs[s] is not None:
                        shard_cols[s][ci] = self._decode_host(c)
                continue
            k = max(hd.matrix.shape[0], 1)
            code_dt = np.int16 if k < (1 << 15) else np.int32
            for s, (c, e) in enumerate(zip(cols, encs)):
                if e is None:  # an empty plain shard: all-dead codes
                    nrow = len(np.asarray(c.validity))
                    shard_cols[s][ci] = c.replace(
                        data=np.zeros(nrow, dtype=code_dt),
                        validity=np.zeros(nrow, dtype=bool), lengths=None,
                        vrange=(0, k - 1), encoding=None)
                    continue
                codes = np.asarray(c.data).astype(np.int64)
                remap = _enc.remap_table(e.dict_id, union_id)
                if remap is not None:
                    codes = remap[np.clip(codes, 0, len(remap) - 1)]
                    codes = np.where(codes >= 0, codes, 0)
                shard_cols[s][ci] = c.replace(
                    data=codes.astype(code_dt), vrange=(0, k - 1),
                    encoding=None)
            col_dicts[ci] = union_id
        return col_dicts

    @staticmethod
    def _union_dictionary_id(encs) -> Optional[str]:
        """dict_id of the union dictionary covering every shard's
        encoding (the distinct dictionaries' values in shard order), or
        None when a contributing dictionary is gone."""
        ids: List[str] = []
        for e in encs:
            if e is not None and e.dict_id not in ids:
                ids.append(e.dict_id)
        if len(ids) == 1:
            return ids[0]
        values: List[str] = []
        for did in ids:
            v = _enc.dictionary_values(did)
            if v is None:
                return None
            values.extend(x for x in v.to_pylist() if x is not None)
        if not values:
            return None
        uid, _ = _enc.intern_dictionary(
            pa.array(values, type=pa.large_string()))
        return uid

    @staticmethod
    def _decode_host(col: DeviceColumn) -> DeviceColumn:
        """Host decode of an encoded column of numpy leaves to the plain
        padded string layout."""
        enc = col.encoding
        hd = _enc._host_dict(enc.dict_id)
        dmat = hd.matrix if hd is not None else enc.data.cpu().numpy()
        dlen = hd.lengths if hd is not None else enc.lengths.cpu().numpy()
        k = max(dmat.shape[0], 1)
        codes = np.clip(np.asarray(col.data).astype(np.int64), 0, k - 1)
        val = np.asarray(col.validity)
        data = np.where(val[:, None], dmat[codes], 0).astype(np.uint8)
        lengths = np.where(val, dlen[codes], 0).astype(np.int32)
        return col.replace(data=data, lengths=lengths, vrange=None,
                           encoding=None)

    # --- execution ---

    def execute(self, phys: PhysicalPlan) -> pa.Table:
        from spark_rapids_tpu_torch.exec.fused import TpuSplitAndRetryOOM

        if self.conf.get(rc.ANSI_ENABLED):
            raise MeshCompileError("ANSI mode uses the eager engine")
        if not self.conf.get(rc.MULTICHIP_ICI_SHUFFLE):
            # every exchange is pinned to the host transport, which has
            # no mesh lowering: the single-chip engines run the plan
            if self.n > 1 and plan_bears_exchange(phys):
                raise MeshCompileError(
                    "ICI shuffle disabled: exchanges keep the host path")
            if _has_exchange(phys):
                raise MeshCompileError(
                    "exchange pinned to the host shuffle path")
        sources: List[PhysicalPlan] = []
        self._collect_sources(phys, sources)
        sharded = [
            self._ingest_scan_sharded(s)
            if isinstance(s, ops.TpuFileScanExec) and s.is_tpu
            else mesh_exec.shard_batch(self.mesh, self._materialize(s))
            for s in sources]
        expansion = self._expansion
        retries = 0
        while True:
            self.last_stats = {"shards": self.n, "expansion": expansion,
                               "retries": retries, "slots": []}
            try:
                return self._run(phys, sources, sharded, expansion)
            except TpuSplitAndRetryOOM:
                if expansion >= 256:
                    raise
                expansion *= 2
                retries += 1

    def _run(self, phys: PhysicalPlan, sources: List[PhysicalPlan],
             sharded: List[List[ColumnBatch]], expansion: int) -> pa.Table:
        from spark_rapids_tpu_torch.exec.fused import TpuSplitAndRetryOOM

        src_index = {id(s): i for i, s in enumerate(sources)}
        flags: List = []

        def track(pair):
            out, ovf = pair
            if ovf is True:
                # known on the host already (a join's match total)
                raise TpuSplitAndRetryOOM(
                    "mesh join expansion overflowed; re-running with a "
                    "larger expansion factor")
            flags.extend(ovf if isinstance(ovf, list) else [ovf])
            return out

        def emit(node: PhysicalPlan) -> List[ColumnBatch]:
            if id(node) in src_index:
                return sharded[src_index[id(node)]]
            if isinstance(node, (ops.TpuProjectExec, ops.TpuFilterExec)):
                return [node._run(b) for b in emit(node.children[0])]
            if isinstance(node, ops.TpuHashAggregateExec):
                return self._emit_agg(node, emit, track, expansion)
            if isinstance(node, ops.TpuShuffleExchangeExec):
                return self._emit_exchange(
                    node, emit(node.children[0]), track, expansion)
            if isinstance(node, J.TpuShuffledHashJoinExec):
                # the join owns co-partitioning: each side rides one
                # all-to-all keyed by its join keys; planner-inserted
                # exchanges carrying exactly those keys are bypassed
                lc = self._skip_keyed_exchange(node.children[0],
                                               node.left_keys)
                rc_ = self._skip_keyed_exchange(node.children[1],
                                                node.right_keys)
                lbs = self._key_exchange(emit(lc), node.left_keys, track,
                                         expansion)
                rbs = self._key_exchange(emit(rc_), node.right_keys, track,
                                         expansion)
                return [self._join(node, lb, rb, track, expansion)
                        for lb, rb in zip(lbs, rbs)]
            if isinstance(node, J.TpuBroadcastHashJoinExec):
                lbs = emit(node.children[0])
                rbs = collective.all_gather_batch(emit(node.children[1]))
                return [self._join(node, lb, rb, track, expansion)
                        for lb, rb in zip(lbs, rbs)]
            if isinstance(node, _SUPPORTED):
                raise NotImplementedError(
                    f"{type(node).__name__} {_NOT_PORTED}")
            raise MeshCompileError(type(node).__name__)

        out = emit(phys)
        counts, overflow = mesh_exec.read_counts(out, flags)
        if overflow:
            raise TpuSplitAndRetryOOM(
                "mesh collective slot overflowed; re-running with a "
                "larger expansion factor")
        result = mesh_exec.gather_result(out, counts)
        flag = torch.zeros(1, dtype=torch.bool, device=result.device)
        return device_to_arrow_fused(result, flag)[0]

    # --- node lowerings needing state ---

    @staticmethod
    def _join(node, left: ColumnBatch, right: ColumnBatch, track,
              expansion: int) -> ColumnBatch:
        out_cap = next_capacity(expansion * max(left.capacity,
                                                right.capacity))
        return track(shard_equi_join(node, left, right, out_cap))

    @staticmethod
    def _skip_keyed_exchange(child: PhysicalPlan, keys) -> PhysicalPlan:
        if (isinstance(child, ops.TpuShuffleExchangeExec)
                and child.key_exprs is not None
                and len(child.key_exprs) == len(keys)
                and all(a is b for a, b in zip(child.key_exprs, keys))):
            return child.children[0]
        return child

    def _exchange(self, shards: List[ColumnBatch], pids, track,
                  expansion: int) -> List[ColumnBatch]:
        """The all-to-all with a slot sized off the widest shard (every
        source writes one [n, slot] layout)."""
        slot = collective.slot_capacity(max(b.capacity for b in shards),
                                        self.n, expansion)
        self.last_stats["slots"].append(slot)
        return track(collective.all_to_all_batch(shards, pids, self.n,
                                                 slot))

    def _key_exchange(self, shards: List[ColumnBatch], keys, track,
                      expansion: int) -> List[ColumnBatch]:
        """Co-partitioning by key hash: row -> shard hash % n."""
        pids = [murmur3_pmod([k.eval(EvalContext(b)) for k in keys],
                             self.n) for b in shards]
        return self._exchange(shards, pids, track, expansion)

    def _emit_agg(self, node: ops.TpuHashAggregateExec, emit, track,
                  expansion: int) -> List[ColumnBatch]:
        fns = [a.children[0] for a in node.aggs]
        if any(not f.jittable and isinstance(f, (CollectList, CountDistinct))
               for f in fns):
            raise NotImplementedError(
                f"the static collect widths of collect_list, collect_set "
                f"and count(DISTINCT) {_NOT_PORTED}")
        if any(not f.jittable for f in fns):
            # exact percentile keeps its unbounded row-sized buffers
            raise MeshCompileError("non-jittable aggregate (exact "
                                   "percentile family)")
        if node.mode == "partial":
            return [node._partial(b) for b in emit(node.children[0])]
        if node.mode == "final":
            return self._first_shard_only(
                [node._merge_final(b) for b in emit(node.children[0])],
                node)
        # complete: the planner saw one partition; distribute it as
        # partial -> key-hash all-to-all -> final
        part = [node._partial(b) for b in emit(node.children[0])]
        nk = len(node.grouping)
        if nk:
            pids = [murmur3_pmod(p.columns[:nk], self.n) for p in part]
            ex = self._exchange(part, pids, track, expansion)
        else:
            ex = collective.gather_to_one(part)
        return self._first_shard_only([node._merge_final(b) for b in ex],
                                      node)

    def _first_shard_only(self, out: List[ColumnBatch],
                          node: ops.TpuHashAggregateExec
                          ) -> List[ColumnBatch]:
        """A global (ungrouped) aggregate emits exactly one row, on shard
        0, where gather_to_one put the buffers; every shard's merge would
        otherwise emit its one row on empty input."""
        if node.grouping:
            return out
        return [b if s == 0
                else ColumnBatch(b.schema, b.columns, 0)
                for s, b in enumerate(out)]

    def _emit_exchange(self, node: ops.TpuShuffleExchangeExec,
                       shards: List[ColumnBatch], track,
                       expansion: int) -> List[ColumnBatch]:
        if isinstance(node, ops.TpuRangeShuffleExchangeExec):
            raise NotImplementedError(
                f"the range exchange of a global sort {_NOT_PORTED}")
        if node.key_exprs:
            return self._key_exchange(shards, node.key_exprs, track,
                                      expansion)
        if node.num_partitions == 1:
            return collective.gather_to_one(shards)
        # round-robin repartition: row i of each shard to shard i % n
        pids = [(torch.arange(b.capacity, dtype=torch.int32,
                              device=b.device) % self.n)
                .to(torch.int32) for b in shards]
        return self._exchange(shards, pids, track, expansion)


def _empty_table(schema) -> pa.Table:
    return pa.schema([
        pa.field(f.name, to_arrow_type(f.dataType), f.nullable)
        for f in schema.fields]).empty_table()


def _pad_axis(a: np.ndarray, ax: int, m: int) -> np.ndarray:
    """a zero-padded along axis ax to m."""
    if a.shape[ax] >= m:
        return a
    width = [(0, 0)] * a.ndim
    width[ax] = (0, m - a.shape[ax])
    return np.pad(a, width)
