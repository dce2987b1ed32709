"""Delta Lake v1 — counterpart of `spark_rapids_tpu/lakehouse/delta.py`:
one protocol implementation against the open Delta transaction-log spec.

- transaction log replay: JSON commit files, parquet checkpoints and the
  _last_checkpoint pointer give the active add-file set, the schema, the
  partition columns, the protocol and the table's configuration
  (`load_snapshot`);
- read: `spark.read.format("delta").load(path)` (or `read.delta`) builds
  a parquet FileScan over the active files; tables with deletion vectors
  or column mapping read each file through `read_data_file` (fmt
  "delta"), its deleted rows dropped and its physical columns renamed;
  an empty table is an empty LocalRelation;
- write: append / overwrite commits of add and remove actions, each add
  carrying per-file min/max/null statistics; a commit claims its version
  with a hard link, so exactly one writer wins it, and retries on a lost
  claim under the shared backoff policy; a parquet checkpoint every
  `spark.rapids.lakehouse.delta.checkpointInterval` commits;
- DML: `DeltaTable.forPath(spark, path)` with delete, update, merge
  (matched update / matched delete / not-matched insert) and optimize
  (compaction, ZORDER BY), each rewriting only the files whose statistics
  say they could match; DELETE on a table with
  `delta.enableDeletionVectors=true` writes deletion vectors and rewrites
  no data file.

Every read and rewrite runs through the port's session (its engines, on
its device); `executeZOrderBy` sorts on the session's device through
`ops/zorder.py` (K9, K14, K36, K8). Not ported: the reference's obs
events (`write.conflict`) and the chaos site `commit.conflict` (ROADMAP
A17); a lost claim is still counted (`io/commit.py` `note_conflict`, the
backoff counter "commit.conflict").
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

_LOG_DIR = "_delta_log"


# ------------------------------------------------------------- log replay

def _log_path(table_path: str) -> str:
    return os.path.join(table_path, _LOG_DIR)


def _commit_file(table_path: str, version: int) -> str:
    return os.path.join(_log_path(table_path), f"{version:020d}.json")


def _list_versions(table_path: str) -> List[int]:
    d = _log_path(table_path)
    if not os.path.isdir(d):
        return []
    out = []
    for f in os.listdir(d):
        if f.endswith(".json") and f[:-5].isdigit():
            out.append(int(f[:-5]))
    return sorted(out)


class Snapshot:
    """Materialized table state at a version (DeltaLog snapshot role)."""

    def __init__(self, version: int, schema_json: Optional[dict],
                 partition_cols: List[str],
                 files: Dict[str, dict],
                 protocol: Optional[dict] = None,
                 config: Optional[dict] = None):
        self.version = version
        self.schema_json = schema_json
        self.partition_cols = partition_cols
        self.files = files  # relative path -> add action
        self.protocol = protocol  # last protocol action seen
        self.config = config or {}  # metaData.configuration
        self.meta_id = None  # the table's stable metaData.id

    @property
    def column_mapping_mode(self) -> str:
        return self.config.get("delta.columnMapping.mode", "none")

    @property
    def deletion_vectors_enabled(self) -> bool:
        return (self.config.get("delta.enableDeletionVectors", "false")
                .lower() == "true")

    def physical_renames(self) -> Optional[Dict[str, str]]:
        """physical column name -> logical name under columnMapping
        ('name'/'id' modes stamp delta.columnMapping.physicalName into
        each field's metadata; id-mode files also carry parquet field
        ids, but the physicalName is always present and unique, so name
        resolution covers both modes)."""
        if self.column_mapping_mode == "none" or not self.schema_json:
            return None
        out = {}
        for f in self.schema_json["fields"]:
            meta = f.get("metadata") or {}
            phys = meta.get("delta.columnMapping.physicalName")
            out[phys or f["name"]] = f["name"]
        return out

    def has_deletion_vectors(self) -> bool:
        return any(a.get("deletionVector") for a in self.files.values())

    @property
    def file_paths(self) -> List[str]:
        return sorted(self.files)


def _read_checkpoint(table_path: str) -> Tuple[int, Dict[str, dict],
                                               Optional[dict], List[str],
                                               Optional[dict]]:
    """-> (checkpoint version, files, metaData, partition_cols,
    protocol) or (-1, {}, None, [], None)."""
    lc = os.path.join(_log_path(table_path), "_last_checkpoint")
    if not os.path.exists(lc):
        return -1, {}, None, [], None
    with open(lc) as f:
        info = json.load(f)
    v = int(info["version"])
    cp = os.path.join(_log_path(table_path),
                      f"{v:020d}.checkpoint.parquet")
    files: Dict[str, dict] = {}
    meta = None
    protocol = None
    parts: List[str] = []
    t = pq.read_table(cp)
    for row in t.to_pylist():
        if row.get("add"):
            add = dict(row["add"])
            pv = add.get("partitionValues")
            if isinstance(pv, str):  # legacy JSON-encoded map field
                add["partitionValues"] = json.loads(pv)
            elif isinstance(pv, list):  # arrow map -> [(k, v), ...]
                add["partitionValues"] = dict(pv)
            files[add["path"]] = add
        if row.get("metaData"):
            meta = dict(row["metaData"])
            fmt = meta.get("format")
            if isinstance(fmt, dict) and isinstance(
                    fmt.get("options"), list):
                fmt["options"] = dict(fmt["options"])
            if isinstance(meta.get("configuration"), list):
                meta["configuration"] = dict(meta["configuration"])
            parts = [c for c in (meta.get("partitionColumns") or [])
                     if c]
        if row.get("protocol"):
            protocol = {k: v2 for k, v2 in dict(row["protocol"]).items()
                        if v2 is not None}
    return v, files, meta, parts, protocol


def load_snapshot(table_path: str) -> Snapshot:
    cp_version, files, meta, parts, protocol = _read_checkpoint(
        table_path)
    versions = [v for v in _list_versions(table_path) if v > cp_version]
    if cp_version < 0 and not versions:
        raise FileNotFoundError(
            f"{table_path} is not a Delta table (no {_LOG_DIR})")
    schema_json = None
    config: Dict[str, str] = {}
    meta_id = None
    if meta is not None:
        if meta.get("schemaString"):
            schema_json = json.loads(meta["schemaString"])
        if meta.get("configuration"):
            config = dict(meta["configuration"])
        meta_id = meta.get("id")
    last = cp_version
    for v in versions:
        last = v
        with open(_commit_file(table_path, v)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                action = json.loads(line)
                if "add" in action:
                    files[action["add"]["path"]] = action["add"]
                elif "remove" in action:
                    files.pop(action["remove"]["path"], None)
                elif "metaData" in action:
                    m = action["metaData"]
                    schema_json = json.loads(m["schemaString"])
                    parts = list(m.get("partitionColumns") or [])
                    config = dict(m.get("configuration") or {})
                    meta_id = m.get("id") or meta_id
                elif "protocol" in action:
                    protocol = action["protocol"]
    snap = Snapshot(last, schema_json, parts, files, protocol, config)
    snap.meta_id = meta_id
    return snap


_DELTA_TO_ARROW = {
    "string": pa.string(), "long": pa.int64(), "integer": pa.int32(),
    "short": pa.int16(), "byte": pa.int8(), "double": pa.float64(),
    "float": pa.float32(), "boolean": pa.bool_(), "date": pa.date32(),
    "timestamp": pa.timestamp("us", tz="UTC"),
}


def _delta_type_to_arrow(t) -> pa.DataType:
    if isinstance(t, str):
        if t.startswith("decimal"):
            p, _, s = t[len("decimal("):-1].partition(",")
            return pa.decimal128(int(p), int(s or 0))
        return _DELTA_TO_ARROW[t]
    if isinstance(t, dict) and t.get("type") == "array":
        return pa.list_(_delta_type_to_arrow(t["elementType"]))
    raise TypeError(f"delta type {t!r}")


def _arrow_to_delta_type(at: pa.DataType):
    import pyarrow.types as pt

    if pt.is_int64(at):
        return "long"
    if pt.is_int32(at):
        return "integer"
    if pt.is_int16(at):
        return "short"
    if pt.is_int8(at):
        return "byte"
    if pt.is_float64(at):
        return "double"
    if pt.is_float32(at):
        return "float"
    if pt.is_string(at) or pt.is_large_string(at):
        return "string"
    if pt.is_boolean(at):
        return "boolean"
    if pt.is_date(at):
        return "date"
    if pt.is_timestamp(at):
        return "timestamp"
    if pt.is_decimal(at):
        return f"decimal({at.precision},{at.scale})"
    if pt.is_list(at):
        return {"type": "array",
                "elementType": _arrow_to_delta_type(at.value_type),
                "containsNull": True}
    raise TypeError(f"arrow type {at} has no delta mapping")


def _schema_to_delta(schema: pa.Schema) -> str:
    fields = [{"name": f.name,
               "type": _arrow_to_delta_type(f.type),
               "nullable": f.nullable, "metadata": {}}
              for f in schema]
    return json.dumps({"type": "struct", "fields": fields})


def _delta_schema_to_arrow(schema_json: dict) -> pa.Schema:
    return pa.schema([
        pa.field(f["name"], _delta_type_to_arrow(f["type"]),
                 f.get("nullable", True))
        for f in schema_json["fields"]])


# ------------------------------------------------------------------ read

class DeltaReadContext:
    """Per-file read state for merge-on-read tables: deletion-vector
    descriptors and columnMapping physical->logical renames
    (GpuDeltaParquetFileFormat + GpuDeleteFilter roles)."""

    def __init__(self, table_path: str, snap: "Snapshot"):
        self.table_path = table_path
        self.renames = snap.physical_renames()
        self.dv_by_path = {
            os.path.join(table_path, p): a["deletionVector"]
            for p, a in snap.files.items() if a.get("deletionVector")}

    def apply_renames(self, t: pa.Table) -> pa.Table:
        if not self.renames:
            return t
        return t.rename_columns(
            [self.renames.get(n, n) for n in t.column_names])

    def physical_columns(self, logical) -> Optional[List[str]]:
        """Requested logical columns -> physical parquet names (for
        column-projection pushdown into the file read)."""
        if logical is None:
            return None
        inv = {lg: ph for ph, lg in (self.renames or {}).items()}
        return [inv.get(c, c) for c in logical]


def read_data_file(ctx: DeltaReadContext, path: str,
                   columns) -> pa.Table:
    """One data file -> logical-schema table with deleted rows dropped.
    Column projection pushes down to the parquet read (via the
    physical-name mapping)."""
    import numpy as np

    from spark_rapids_tpu_torch.lakehouse import deletion_vectors as dvmod

    t = pq.read_table(path, columns=ctx.physical_columns(
        list(columns) if columns else None))
    t = ctx.apply_renames(t)
    dv = ctx.dv_by_path.get(path)
    if dv is not None:
        deleted = dvmod.load_descriptor(ctx.table_path, dv)
        keep = np.ones(t.num_rows, dtype=bool)
        keep[deleted[deleted < t.num_rows]] = False
        t = t.filter(pa.array(keep))
    if columns:
        t = t.select(list(columns))
    return t


def read_delta(session, path: str):
    """Delta scan: active-file parquet FileScan with the log's schema
    (GpuDeltaParquetFileFormat role). Tables with deletion vectors or
    column mapping read through the per-file merge-on-read path
    (fmt='delta'); plain tables keep the chunked parquet readers."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    from spark_rapids_tpu_torch.columnar.arrow_bridge import schema_from_arrow
    from spark_rapids_tpu_torch.plan.logical import FileScan

    snap = load_snapshot(path)
    files = [os.path.join(path, p) for p in snap.file_paths]
    if snap.schema_json is not None:
        schema = schema_from_arrow(_delta_schema_to_arrow(
            snap.schema_json))
    else:
        from spark_rapids_tpu_torch.io.readers import infer_parquet_schema

        schema = schema_from_arrow(infer_parquet_schema(files))
    if not files:
        # empty table: empty LocalRelation with the log schema
        from spark_rapids_tpu_torch.plan.logical import LocalRelation

        at = _delta_schema_to_arrow(snap.schema_json)
        return DataFrame(LocalRelation(at.empty_table()), session)
    if snap.has_deletion_vectors() or snap.column_mapping_mode != "none":
        ctx = DeltaReadContext(path, snap)
        return DataFrame(
            FileScan("delta", files, schema, {"delta_ctx": ctx}),
            session)
    return DataFrame(FileScan("parquet", files, schema, {}), session)


# ----------------------------------------------------------------- write

def _default_ckpt_interval() -> int:
    from spark_rapids_tpu_torch.config import rapids_conf as rc

    return rc.DELTA_CHECKPOINT_INTERVAL.default


# module-level alias kept for sessionless callers/tests; the single
# source of truth is the conf entry's default
CHECKPOINT_INTERVAL = _default_ckpt_interval()


def _ckpt_interval(session) -> Optional[int]:
    from spark_rapids_tpu_torch.config import rapids_conf as rc

    c = getattr(session, "rapids_conf", None)
    return c.get(rc.DELTA_CHECKPOINT_INTERVAL) if c is not None else None


class DeltaCommitConflict(RuntimeError):
    """Another writer claimed this log version first. RETRYABLE: the
    optimistic-transaction loop (_commit_txn) re-reads the snapshot,
    re-runs conflict semantics and re-claims the next version."""

    def __init__(self, table_path: str, version: int):
        self.version = version
        super().__init__(
            f"concurrent commit conflict at version {version} "
            f"of {table_path}")


class DeltaConcurrentModification(RuntimeError):
    """A concurrent commit invalidated what this transaction READ
    (files it rewrites were removed, or a blind overwrite raced new
    data it cannot preserve). NOT retryable — retrying would silently
    drop the other writer's rows; the caller must re-run its DML
    against the new snapshot."""


def _commit(table_path: str, version: int, actions: List[dict],
            checkpoint_interval: Optional[int] = None):
    """Write one atomic commit file (OptimisticTransaction.commit's
    write path): the full content lands fsync'd in a tmp file, then an
    O_EXCL-equivalent hard link claims the version — exactly one
    writer wins a given version, and a claimed commit file is never
    partial. Every CHECKPOINT_INTERVAL versions also writes a parquet
    checkpoint + _last_checkpoint pointer so log replay stays
    O(interval)."""
    os.makedirs(_log_path(table_path), exist_ok=True)
    target = _commit_file(table_path, version)
    tmp = target + f".tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, target)  # fails if the version already exists
    except FileExistsError:
        os.unlink(tmp)
        raise DeltaCommitConflict(table_path, version)
    os.unlink(tmp)
    if checkpoint_interval is None:
        checkpoint_interval = CHECKPOINT_INTERVAL
    # interval <= 0 disables checkpointing entirely
    if (checkpoint_interval > 0 and version > 0
            and version % checkpoint_interval == 0):
        write_checkpoint(table_path)


def _occ_policy(session):
    """Backoff policy for the optimistic-commit retry loop: the shared
    delay curve (io.retry.backoffMs) with its own attempt budget
    (write.delta.commitAttempts)."""
    from spark_rapids_tpu_torch.config import rapids_conf as rc
    from spark_rapids_tpu_torch.runtime import backoff

    c = getattr(session, "rapids_conf", None)

    def get(entry):
        return c.get(entry) if c is not None else entry.default

    return backoff.BackoffPolicy(get(rc.WRITE_DELTA_COMMIT_ATTEMPTS),
                                 get(rc.IO_RETRY_BACKOFF_MS),
                                 get(rc.IO_RETRY_MAX_BACKOFF_MS))


def _commit_txn(table_path: str, build, session=None,
                what: str = "delta commit"):
    """Optimistic transaction driver: `build()` re-reads the snapshot
    and returns (version, actions) — or None to skip — and the claim
    runs under the shared backoff policy (the reference's chaos site
    `commit.conflict` and its per-query retry budget are ROADMAP A17). A
    DeltaCommitConflict loser re-enters build() against the NEW
    snapshot; DeltaConcurrentModification (conflict semantics say
    retrying would lose data) fails immediately."""
    from spark_rapids_tpu_torch.runtime import backoff

    def attempt():
        built = build()
        if built is None:
            return None
        version, actions = built
        _commit(table_path, version, actions, _ckpt_interval(session))
        return version

    def on_retry(err):
        from spark_rapids_tpu_torch.io import commit as iocommit

        iocommit.note_conflict()
        # the reference's obs event write.conflict: ROADMAP A17

    return backoff.retry_io(
        attempt, what=what, site="commit.conflict",
        retry_on=(DeltaCommitConflict,),
        no_retry=(DeltaConcurrentModification,),
        policy=_occ_policy(session), counter="commit.conflict",
        on_retry=on_retry)


def _check_rewrite_conflict(read_version: int, cur: "Snapshot",
                            read_set: set, full_table: bool,
                            op: str) -> None:
    """Append-vs-rewrite conflict semantics for a read-dependent
    transaction (DML, overwrite-of-candidates) retrying on top of
    interim commits: files this transaction read and rewrites must
    still be live, and a FULL-table rewrite cannot preserve rows a
    concurrent append added after its read — both raise
    DeltaConcurrentModification. Pure concurrent appends against a
    partial rewrite are compatible (the new files stay live alongside
    the rewrite)."""
    live = set(cur.file_paths)
    gone = read_set - live
    if gone:
        raise DeltaConcurrentModification(
            f"{op}: {len(gone)} file(s) this transaction read at "
            f"version {read_version} were removed by a concurrent "
            f"commit (now at {cur.version}): {sorted(gone)[:3]}")
    if full_table and (live - read_set):
        raise DeltaConcurrentModification(
            f"{op}: a concurrent commit added files after this "
            f"full-table transaction's read at version "
            f"{read_version}; retrying would drop those rows")


_CP_MAP = pa.map_(pa.string(), pa.string())
_CP_SCHEMA = pa.schema([
    ("protocol", pa.struct([("minReaderVersion", pa.int32()),
                            ("minWriterVersion", pa.int32()),
                            ("readerFeatures", pa.list_(pa.string())),
                            ("writerFeatures", pa.list_(pa.string()))])),
    ("metaData", pa.struct([
        ("id", pa.string()),
        ("format", pa.struct([("provider", pa.string()),
                              ("options", _CP_MAP)])),
        ("schemaString", pa.string()),
        ("partitionColumns", pa.list_(pa.string())),
        ("configuration", _CP_MAP),
        ("createdTime", pa.int64())])),
    ("add", pa.struct([
        ("path", pa.string()),
        ("partitionValues", _CP_MAP),
        ("size", pa.int64()),
        ("modificationTime", pa.int64()),
        ("dataChange", pa.bool_()),
        ("stats", pa.string())])),
])

_CP_ADD_FIELDS = {"path", "partitionValues", "size",
                  "modificationTime", "dataChange", "stats"}


def write_checkpoint(table_path: str) -> bool:
    """Materialize the current snapshot as a spec-conformant parquet
    checkpoint (Checkpoints.writeCheckpoint role): protocol + metaData +
    add rows with proper map-typed fields. Tables whose add actions
    carry fields this writer cannot represent (deletionVector, tags from
    richer external writers) are left checkpoint-less — dropping those
    fields would corrupt them for readers that start from
    _last_checkpoint. Returns False when skipped."""
    snap = load_snapshot(table_path)
    for add in snap.files.values():
        extra = set(add) - _CP_ADD_FIELDS
        if extra:
            import logging

            logging.getLogger(__name__).warning(
                "skipping checkpoint: add action carries fields this "
                "writer cannot preserve: %s", sorted(extra))
            return False
    protocol = snap.protocol or {"minReaderVersion": 1,
                                 "minWriterVersion": 2}
    meta = {"id": snap.meta_id or str(uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": json.dumps(snap.schema_json)
            if snap.schema_json else "{}",
            "partitionColumns": list(snap.partition_cols),
            "configuration": dict(snap.config),
            "createdTime": int(time.time() * 1000)}
    rows = [{"protocol": {
                "minReaderVersion": int(
                    protocol.get("minReaderVersion", 1)),
                "minWriterVersion": int(
                    protocol.get("minWriterVersion", 2)),
                # feature-based protocols REQUIRE the lists in the
                # checkpoint too; None for legacy protocols
                "readerFeatures": protocol.get("readerFeatures"),
                "writerFeatures": protocol.get("writerFeatures")},
             "metaData": None, "add": None},
            {"protocol": None, "metaData": meta, "add": None}]
    for add in snap.files.values():
        rows.append({"protocol": None, "metaData": None,
                     "add": {
                         "path": add["path"],
                         "partitionValues": dict(
                             add.get("partitionValues") or {}),
                         "size": int(add.get("size", 0)),
                         "modificationTime": int(
                             add.get("modificationTime", 0)),
                         "dataChange": bool(
                             add.get("dataChange", True)),
                         "stats": add.get("stats")}})
    t = pa.Table.from_pylist(rows, schema=_CP_SCHEMA)
    cp = os.path.join(_log_path(table_path),
                      f"{snap.version:020d}.checkpoint.parquet")
    pq.write_table(t, cp)
    # atomic pointer update: a reader between truncate and write (or a
    # crash mid-write) must never see a partial _last_checkpoint
    lc = os.path.join(_log_path(table_path), "_last_checkpoint")
    tmp = lc + f".tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump({"version": snap.version, "size": len(rows)}, f)
    os.replace(tmp, lc)
    return True


def _meta_action(schema: pa.Schema, partition_cols: List[str],
                 configuration: Optional[Dict[str, str]] = None,
                 table_id: Optional[str] = None) -> dict:
    # metaData.id is the table's STABLE identity — external consumers
    # (streaming sources, CDC readers) abort when it changes, so
    # existing tables must carry theirs forward
    return {"metaData": {
        "id": table_id or str(uuid.uuid4()),
        "format": {"provider": "parquet", "options": {}},
        "schemaString": _schema_to_delta(schema),
        "partitionColumns": partition_cols,
        "configuration": dict(configuration or {}),
        "createdTime": int(time.time() * 1000),
    }}


def _file_stats(piece: pa.Table) -> str:
    """Per-file column statistics in Delta's `stats` JSON shape
    ({numRecords, minValues, maxValues, nullCount}) — the input DML
    file pruning needs (GpuDeltaTaskStatisticsTracker role)."""
    import pyarrow.compute as pc

    mins, maxs, nulls = {}, {}, {}
    for name in piece.column_names:
        col = piece.column(name)
        nulls[name] = col.null_count
        t = col.type
        if not (pa.types.is_integer(t) or pa.types.is_floating(t)
                or pa.types.is_string(t) or pa.types.is_date(t)
                or pa.types.is_timestamp(t)):
            continue
        if col.null_count == len(col):
            continue
        mn, mx = pc.min(col).as_py(), pc.max(col).as_py()
        if mn is not None:
            mins[name] = mn if not hasattr(mn, "isoformat") \
                else mn.isoformat()
            maxs[name] = mx if not hasattr(mx, "isoformat") \
                else mx.isoformat()
    return json.dumps({"numRecords": piece.num_rows, "minValues": mins,
                       "maxValues": maxs, "nullCount": nulls})


def _write_data_files(table: pa.Table, table_path: str,
                      rows_per_file: int = 1 << 20) -> List[dict]:
    adds = []
    for off in range(0, max(table.num_rows, 1), rows_per_file):
        piece = table.slice(off, min(rows_per_file,
                                     table.num_rows - off))
        if piece.num_rows == 0 and table.num_rows > 0:
            break
        name = f"part-{uuid.uuid4().hex}.snappy.parquet"
        full = os.path.join(table_path, name)
        pq.write_table(piece, full, compression="snappy")
        adds.append({"add": {
            "path": name, "partitionValues": {},
            "size": os.path.getsize(full),
            "modificationTime": int(time.time() * 1000),
            "dataChange": True,
            "stats": _file_stats(piece),
        }})
        if table.num_rows == 0:
            break
    return adds


def write_delta(df, path: str, mode: str = "error",
                partition_by: Optional[List[str]] = None,
                properties: Optional[Dict[str, str]] = None):
    """append / overwrite commit (GpuOptimisticTransaction role).
    `properties` become metaData.configuration (e.g.
    delta.enableDeletionVectors=true)."""
    if partition_by:
        raise NotImplementedError(
            "partitioned Delta writes are a follow-up")
    table = df.collect_arrow()
    session = getattr(df, "session", None)
    existed = bool(_list_versions(path)) or os.path.isdir(_log_path(path))
    if existed and mode == "error":
        raise FileExistsError(f"Delta table {path} exists (mode=error)")
    if existed and mode == "ignore":
        return
    os.makedirs(path, exist_ok=True)
    # data files land ONCE, before the optimistic loop: their names are
    # uuid-unique so the same add actions are safe to re-offer on every
    # commit attempt — only the log claim retries
    adds = _write_data_files(table, path)

    def build():
        actions: List[dict] = []
        now_exists = bool(_list_versions(path))
        if now_exists and not existed:
            # creation race: someone committed version 0 between our
            # pre-check and the claim
            if mode == "error":
                raise DeltaConcurrentModification(
                    f"Delta table {path} was created concurrently "
                    f"(mode=error)")
            if mode == "ignore":
                for a in adds:  # our staged data files are now orphans
                    try:
                        os.unlink(os.path.join(path, a["add"]["path"]))
                    except OSError:
                        pass
                return None
        if not now_exists:
            version = 0
            actions.append(_meta_action(table.schema, [], properties))
            if properties and properties.get(
                    "delta.enableDeletionVectors", "").lower() == "true":
                actions.append({"protocol": {
                    "minReaderVersion": 3, "minWriterVersion": 7,
                    "readerFeatures": ["deletionVectors"],
                    "writerFeatures": ["deletionVectors"]}})
        else:
            snap = load_snapshot(path)
            version = snap.version + 1
            merged = {**snap.config, **(properties or {})}
            if mode == "overwrite":
                # removes are recomputed from the FRESH snapshot each
                # attempt, so a lost race replaces the other writer's
                # output too: last-overwrite-wins (documented in
                # docs/writes.md)
                ts = int(time.time() * 1000)
                actions.append(_meta_action(table.schema, [], merged,
                                            table_id=snap.meta_id))
                for p in snap.file_paths:
                    actions.append({"remove": {
                        "path": p, "deletionTimestamp": ts,
                        "dataChange": True}})
            elif properties:
                # append with new properties: a metaData action carrying
                # the merged configuration (schema unchanged)
                meta = _meta_action(table.schema,
                                    list(snap.partition_cols),
                                    merged, table_id=snap.meta_id)
                if snap.schema_json is not None:
                    meta["metaData"]["schemaString"] = json.dumps(
                        snap.schema_json)
                actions.append(meta)
        actions.extend(adds)
        actions.append({"commitInfo": {
            "timestamp": int(time.time() * 1000),
            "operation": "WRITE",
            "operationParameters": {"mode": mode.upper()},
        }})
        return version, actions

    _commit_txn(path, build, session, what=f"delta write ({mode})")


# ------------------------------------------------- merge / delete / update

def _add_stats(add: dict) -> Optional[dict]:
    s = add.get("stats")
    if not s:
        return None
    try:
        return json.loads(s) if isinstance(s, str) else dict(s)
    except (ValueError, TypeError):
        return None


def _file_might_match(e, stats: Optional[dict]) -> bool:
    """Conservative interval analysis of a DML condition against one
    file's min/max stats (the reference's candidate-file selection in
    GpuDeleteCommand/GpuMergeIntoCommand: only files that COULD contain
    matching rows are rewritten). True = cannot prove empty."""
    from spark_rapids_tpu_torch.api.functions import UnresolvedColumn
    from spark_rapids_tpu_torch.expr.core import Literal
    from spark_rapids_tpu_torch.expr.predicates import (
        And,
        EqualTo,
        GreaterThan,
        GreaterThanOrEqual,
        In,
        IsNotNull,
        IsNull,
        LessThan,
        LessThanOrEqual,
        Not,
        Or,
    )

    if stats is None:
        return True
    mins = stats.get("minValues") or {}
    maxs = stats.get("maxValues") or {}
    nulls = stats.get("nullCount") or {}

    def col_lit(a, b):
        """-> (name, literal, flipped) for col-vs-literal shapes."""
        if isinstance(a, UnresolvedColumn) and isinstance(b, Literal):
            return a.name, b.value, False
        if isinstance(b, UnresolvedColumn) and isinstance(a, Literal):
            return b.name, a.value, True
        return None

    def rng(name):
        if name in mins and name in maxs:
            return mins[name], maxs[name]
        return None

    if isinstance(e, And):
        return (_file_might_match(e.children[0], stats)
                and _file_might_match(e.children[1], stats))
    if isinstance(e, Or):
        return (_file_might_match(e.children[0], stats)
                or _file_might_match(e.children[1], stats))
    if isinstance(e, Not):
        c = e.children[0]
        flip = {GreaterThan: LessThanOrEqual,
                GreaterThanOrEqual: LessThan,
                LessThan: GreaterThanOrEqual,
                LessThanOrEqual: GreaterThan}
        if type(c) in flip:
            return _file_might_match(
                flip[type(c)](c.children[0], c.children[1]), stats)
        return True
    if isinstance(e, IsNull):
        c = e.children[0]
        if isinstance(c, UnresolvedColumn) and c.name in nulls:
            return nulls[c.name] > 0
        return True
    if isinstance(e, IsNotNull):
        c = e.children[0]
        if isinstance(c, UnresolvedColumn) and c.name in nulls:
            return stats.get("numRecords", 1) > nulls[c.name]
        return True
    if isinstance(e, In):
        c = e.children[0]
        if isinstance(c, UnresolvedColumn) and rng(c.name):
            lo, hi = rng(c.name)
            vals = [x.value if isinstance(x, Literal) else x
                    for x in e.values]
            try:
                return any(lo <= v <= hi for v in vals
                           if v is not None)
            except TypeError:
                return True
        return True
    if isinstance(e, (EqualTo, GreaterThan, GreaterThanOrEqual,
                      LessThan, LessThanOrEqual)):
        cl = col_lit(e.children[0], e.children[1])
        if cl is None:
            return True
        name, v, flipped = cl
        if v is None or rng(name) is None:
            return True
        lo, hi = rng(name)
        op = type(e)
        if flipped:  # lit OP col  ->  col FLIP(OP) lit
            op = {GreaterThan: LessThan, LessThan: GreaterThan,
                  GreaterThanOrEqual: LessThanOrEqual,
                  LessThanOrEqual: GreaterThanOrEqual,
                  EqualTo: EqualTo}[op]
        try:
            if op is EqualTo:
                return lo <= v <= hi
            if op is GreaterThan:
                return hi > v
            if op is GreaterThanOrEqual:
                return hi >= v
            if op is LessThan:
                return lo < v
            return lo <= v
        except TypeError:
            return True
    return True


def _read_files(session, path: str, snap: Snapshot,
                rel_paths: List[str]):
    """DataFrame over a SUBSET of a snapshot's files (candidate-only
    DML rewrites)."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    from spark_rapids_tpu_torch.columnar.arrow_bridge import schema_from_arrow
    from spark_rapids_tpu_torch.plan.logical import FileScan, LocalRelation

    at = _delta_schema_to_arrow(snap.schema_json)
    if not rel_paths:
        return DataFrame(LocalRelation(at.empty_table()), session)
    files = [os.path.join(path, p) for p in rel_paths]
    if (snap.column_mapping_mode != "none"
            or any(snap.files[p].get("deletionVector")
                   for p in rel_paths)):
        # DML over merge-on-read files must apply DV masks and
        # physical->logical renames, or a rewrite would resurrect
        # deleted rows / miss renamed columns
        ctx = DeltaReadContext(path, snap)
        return DataFrame(FileScan("delta", files, schema_from_arrow(at),
                                  {"delta_ctx": ctx}), session)
    return DataFrame(FileScan("parquet", files, schema_from_arrow(at),
                              {}), session)


class DeltaTable:
    """DeltaTable.forPath(spark, path).merge(source, cond)... — the
    GpuMergeIntoCommand / GpuDeleteCommand / GpuUpdateCommand surface.
    v1 rewrites the whole table through the engine and commits
    remove+add."""

    def __init__(self, session, path: str):
        self.session = session
        self.path = path

    @classmethod
    def forPath(cls, session, path: str) -> "DeltaTable":
        load_snapshot(path)  # validates
        return cls(session, path)

    def toDF(self):
        return read_delta(self.session, self.path)

    # --- merge builder ---

    def merge(self, source, on) -> "DeltaMergeBuilder":
        """MERGE keyed by column name(s) present on both sides (the
        overwhelmingly common upsert shape; arbitrary conditions are a
        follow-up)."""
        keys = [on] if isinstance(on, str) else list(on)
        return DeltaMergeBuilder(self, source, keys)

    def _candidates(self, snap: Snapshot, cond_expr) -> List[str]:
        """Files whose stats say they COULD hold matching rows; the
        rest keep their add actions untouched."""
        return [p for p in snap.file_paths
                if _file_might_match(cond_expr,
                                     _add_stats(snap.files[p]))]

    def delete(self, condition=None):
        """DELETE FROM target WHERE condition — with deletion vectors
        enabled, matched rows are masked via DV sidecars and NO data
        file is rewritten (merge-on-read; the Delta 2.4 fast path);
        otherwise only candidate files rewrite (GpuDeleteCommand's
        candidate-file selection)."""
        from spark_rapids_tpu_torch.api import functions as F

        snap = load_snapshot(self.path)
        if condition is None:
            self._rewrite(self.toDF().filter(
                F.lit(False)).collect_arrow(), "DELETE")
            return
        cands = self._candidates(snap, condition.expr)
        if not cands:
            return  # provably no matching rows: no-op, no commit
        if snap.deletion_vectors_enabled:
            self._delete_via_dv(snap, condition, cands)
            return
        kept = _read_files(self.session, self.path, snap,
                           cands).filter(~condition)
        self._rewrite(kept.collect_arrow(), "DELETE", snap=snap,
                      only_files=cands)

    def _delete_via_dv(self, snap: Snapshot, condition,
                       cands: List[str]) -> None:
        """Write/extend deletion vectors for candidate files instead of
        rewriting them. Per file: new DV = old DV union rows matching
        the condition (positions are PHYSICAL file row indexes); a file
        whose every row is deleted gets a plain remove action."""
        import numpy as np

        from spark_rapids_tpu_torch.lakehouse import deletion_vectors as dvmod

        ctx = DeltaReadContext(self.path, snap)
        new_dv: Dict[str, np.ndarray] = {}
        fully_deleted: List[str] = []
        for rel in cands:
            full = os.path.join(self.path, rel)
            t = ctx.apply_renames(pq.read_table(full))
            pos = pa.array(np.arange(t.num_rows, dtype=np.int64))
            df = self.session.createDataFrame(
                t.append_column("__pos", pos))
            hit = df.filter(condition).select("__pos").collect_arrow()
            matched = hit.column("__pos").to_numpy().astype(np.int64)
            old = snap.files[rel].get("deletionVector")
            if old is not None:
                prev = dvmod.load_descriptor(self.path, old)
                matched = np.union1d(matched, prev)
            else:
                matched = np.unique(matched)
            if len(matched) == 0:
                continue
            if len(matched) >= t.num_rows:
                fully_deleted.append(rel)
            else:
                new_dv[rel] = matched
        if not new_dv and not fully_deleted:
            return  # stats said maybe, rows said no: no-op
        ts = int(time.time() * 1000)
        actions: List[dict] = []
        old_proto = snap.protocol or {}
        rfeats = set(old_proto.get("readerFeatures") or [])
        wfeats = set(old_proto.get("writerFeatures") or [])
        if "deletionVectors" not in rfeats:
            # upgrading to the table-features protocol (3,7) requires
            # every ACTIVE feature to be listed explicitly: merge the
            # existing lists AND re-declare the features the legacy
            # version numbers implied (Delta spec table-features
            # upgrade rules), don't replace wholesale
            _LEGACY_WRITER = {
                2: ["appendOnly", "invariants"],
                3: ["checkConstraints"],
                4: ["changeDataFeed", "generatedColumns"],
                5: ["columnMapping"],
                6: ["identityColumns"],
            }
            old_w = int(old_proto.get("minWriterVersion", 2))
            for v, feats in _LEGACY_WRITER.items():
                if old_w >= v and old_w < 7:
                    wfeats.update(feats)
            if int(old_proto.get("minReaderVersion", 1)) == 2:
                rfeats.add("columnMapping")
            rfeats.add("deletionVectors")
            wfeats.add("deletionVectors")
            if snap.column_mapping_mode != "none":
                rfeats.add("columnMapping")
                wfeats.add("columnMapping")
            actions.append({"protocol": {
                "minReaderVersion": 3, "minWriterVersion": 7,
                "readerFeatures": sorted(rfeats),
                "writerFeatures": sorted(wfeats)}})
        # small DVs inline into the commit line itself; larger ones
        # share one sidecar file
        from spark_rapids_tpu_torch.config import rapids_conf as rc

        inline_max = (self.session.rapids_conf.get(
            rc.DELTA_DV_INLINE_MAX_BYTES)
            if getattr(self.session, "rapids_conf", None) is not None
            else rc.DELTA_DV_INLINE_MAX_BYTES.default)
        descs: Dict[str, dict] = {}
        to_file: Dict[str, "np.ndarray"] = {}
        for rel, idx in new_dv.items():
            inline = dvmod.inline_descriptor(idx, max_bytes=inline_max)
            if inline is not None:
                descs[rel] = inline
            else:
                to_file[rel] = idx
        if to_file:
            descs.update(dvmod.write_dv_file(self.path, to_file))
        for rel in fully_deleted:
            actions.append({"remove": {
                "path": rel, "deletionTimestamp": ts,
                "dataChange": True}})
        for rel, desc in descs.items():
            add = dict(snap.files[rel])
            add["deletionVector"] = desc
            add["modificationTime"] = ts
            add["dataChange"] = True
            actions.append({"remove": {
                "path": rel, "deletionTimestamp": ts,
                "dataChange": True}})
            actions.append({"add": add})
        actions.append({"commitInfo": {
            "timestamp": ts, "operation": "DELETE",
            "operationParameters": {"deletionVectors": True},
            "readVersion": snap.version}})
        read_set = set(fully_deleted) | set(descs)

        def build():
            cur = load_snapshot(self.path)
            if cur.version != snap.version:
                _check_rewrite_conflict(snap.version, cur, read_set,
                                        False, "DELETE(dv)")
                for rel in descs:
                    # the DV we unioned with must still be the one on
                    # the table: an interim commit that re-vectored the
                    # file would be silently undone by our stale add
                    if (cur.files[rel].get("deletionVector")
                            != snap.files[rel].get("deletionVector")):
                        raise DeltaConcurrentModification(
                            f"DELETE(dv): deletion vector of {rel} "
                            f"changed concurrently (read version "
                            f"{snap.version}, now {cur.version})")
            return cur.version + 1, actions

        _commit_txn(self.path, build, self.session,
                    what="delta delete (dv)")

    def update(self, condition, set_exprs: Dict[str, object]):
        """UPDATE target SET col = expr WHERE condition — candidate
        files only (GpuUpdateCommand)."""
        from spark_rapids_tpu_torch.api import functions as F

        snap = load_snapshot(self.path)
        cands = (self._candidates(snap, condition.expr)
                 if condition is not None else list(snap.file_paths))
        if not cands:
            return
        target = _read_files(self.session, self.path, snap, cands)
        cols = []
        for name in target.columns:
            if name in set_exprs:
                new = set_exprs[name]
                new_col = new if hasattr(new, "expr") else F.lit(new)
                cols.append(
                    F.when(condition, new_col)
                    .otherwise(F.col(name)).alias(name))
            else:
                cols.append(F.col(name))
        self._rewrite(target.select(*cols).collect_arrow(), "UPDATE",
                      snap=snap, only_files=cands)

    def optimize(self) -> "DeltaOptimizeBuilder":
        return DeltaOptimizeBuilder(self)

    def _rewrite(self, table: pa.Table, op: str,
                 snap: Optional[Snapshot] = None,
                 only_files: Optional[List[str]] = None):
        """Commit remove(only_files or all) + add(new files). Files not
        in only_files keep their add actions (file-level pruning).
        Optimistic: the claim retries under commit.conflict, and each
        retry re-checks that the files this rewrite READ are still live
        (and, for a full-table rewrite, that nothing was appended)."""
        if snap is None:
            snap = load_snapshot(self.path)
        ts = int(time.time() * 1000)
        full_table = only_files is None
        removes = list(only_files) if only_files is not None \
            else list(snap.file_paths)
        read_set = set(removes)
        actions: List[dict] = []
        for p in removes:
            actions.append({"remove": {
                "path": p, "deletionTimestamp": ts, "dataChange": True}})
        actions.extend(_write_data_files(table, self.path))
        actions.append({"commitInfo": {
            "timestamp": ts, "operation": op,
            "operationParameters": {},
            "readVersion": snap.version,
            "prunedFiles": (len(snap.file_paths) - len(only_files))
            if only_files is not None else 0}})

        def build():
            cur = load_snapshot(self.path)
            if cur.version != snap.version:
                _check_rewrite_conflict(snap.version, cur, read_set,
                                        full_table, op)
            return cur.version + 1, actions

        _commit_txn(self.path, build, self.session,
                    what=f"delta {op.lower()}")


class DeltaOptimizeBuilder:
    """OPTIMIZE [ZORDER BY cols] — compaction + Morton-curve clustering
    (reference delta-lake zorder/ZOrderRules.scala + GpuInterleaveBits;
    device kernel in ops/zorder.py)."""

    def __init__(self, table: DeltaTable):
        self.table = table

    def executeCompaction(self):
        t = self.table.toDF().collect_arrow()
        self.table._rewrite(t, "OPTIMIZE")

    def executeZOrderBy(self, *cols: str):
        """Sort the table along the Morton curve of `cols` on the
        session's device and rewrite it."""
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            arrow_to_device,
            device_to_arrow,
        )
        from spark_rapids_tpu_torch.ops.zorder import zorder_sort

        t = self.table.toDF().collect_arrow()
        batch = arrow_to_device(t, device=self.table.session.device)
        ordinals = [t.column_names.index(c) for c in cols]
        out = device_to_arrow(zorder_sort(batch, ordinals))
        self.table._rewrite(out, "OPTIMIZE")


class DeltaMergeBuilder:
    def __init__(self, table: DeltaTable, source, keys: List[str]):
        self.table = table
        self.source = source
        self.keys = keys
        self._update_all = False
        self._insert_all = False
        self._delete_matched = False

    def whenMatchedUpdateAll(self) -> "DeltaMergeBuilder":
        self._update_all = True
        return self

    def whenMatchedDelete(self) -> "DeltaMergeBuilder":
        self._delete_matched = True
        return self

    def whenNotMatchedInsertAll(self) -> "DeltaMergeBuilder":
        self._insert_all = True
        return self

    def execute(self):
        """MERGE rewrite through the engine: candidate target files are
        those whose key-column stats overlap the SOURCE's key ranges —
        a source key matching any target row implies range overlap, so
        joins against candidates alone are exact
        (GpuMergeIntoCommand's candidate-file selection). Then:
        candidates LEFT-ANTI source (untouched rows) UNION matched
        source rows (updateAll) UNION not-matched source rows
        (insertAll); non-candidate files keep their add actions."""
        import pyarrow.compute as pc

        t = self.table
        keys = self.keys
        snap = load_snapshot(t.path)
        src_tbl = self.source.collect_arrow()
        source = t.session.createDataFrame(src_tbl)

        def overlaps(add) -> bool:
            stats = _add_stats(add)
            if stats is None or src_tbl.num_rows == 0:
                return True
            mins = stats.get("minValues") or {}
            maxs = stats.get("maxValues") or {}
            for k in keys:
                if k not in mins or k not in maxs:
                    continue
                col = src_tbl.column(k)
                if col.null_count == len(col):
                    continue
                smin, smax = pc.min(col).as_py(), pc.max(col).as_py()
                try:
                    if smax < mins[k] or smin > maxs[k]:
                        return False
                except TypeError:
                    continue
            return True

        cands = [p for p in snap.file_paths
                 if overlaps(snap.files[p])]
        target = _read_files(t.session, t.path, snap, cands)
        parts = []
        if self._delete_matched or self._update_all:
            untouched = target.join(source, on=keys, how="left_anti")
        else:
            untouched = target
        parts.append(untouched.collect_arrow())
        if self._update_all:
            matched = source.join(target, on=keys, how="left_semi")
            parts.append(matched.collect_arrow())
        if self._insert_all:
            unmatched_src = source.join(target, on=keys,
                                        how="left_anti")
            parts.append(unmatched_src.collect_arrow())
        cols = parts[0].column_names
        merged = pa.concat_tables(
            [p.select(cols).cast(parts[0].schema) for p in parts],
            promote_options="none")
        t._rewrite(merged, "MERGE", snap=snap, only_files=cands)
