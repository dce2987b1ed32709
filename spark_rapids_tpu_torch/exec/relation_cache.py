"""Device-resident relation cache — counterpart of
`spark_rapids_tpu/exec/relation_cache.py`: Spark's CacheManager +
InMemoryRelation pair with device memory as the storage tier.

    base = spark.read.parquet(path).cache(storage="device")
    base.filter(...).groupBy(...).agg(...)   # serves from device memory

A `DeviceCacheEntry` holds one logical subtree AS DEVICE BATCHES,
materialised once (the port's planner plans the subtree and every
partition's output batches become the entry's parts: one per parquet
file for a PERFILE scan) and then read by every query at device-memory
bandwidth. String columns arrive as parquet dictionary arrays, so they
stay encoded (codes plus one interned dictionary). The `CacheManager`
matches subtrees by canonical plan key (plan/logical.py `plan_key`), so
an independently rebuilt DataFrame over the same source hits the cache.

Parts are materialised as the reference materialises them: through the
fused engine's `execute_parts` (exec/fused.py), falling back to the
per-operator engine plus one `upload_narrowed` for a plan the fused
engine cannot lower. Either way integer columns are narrowed with a
quantized `vrange` and parts sit in 1/16-octave capacity buckets, so a
group-by on an integer key of a cached relation takes the binned path.

Each entry lives on one device, its conf's; a session's `CacheManager`
registers entries of the session's device only, so one session never
reads another device's parts.

Not ported yet: the spill catalog behind the parts and device-loss
recovery (ROADMAP A10, A17).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch


class DeviceCacheEntry:
    """Lazily materialised device copy of one logical subtree.

    `DeviceCacheEntry(paths, device=...)` caches a set of parquet files
    (one part per file, as slice 1's hand-built plan uses it);
    `DeviceCacheEntry(logical=plan, conf=conf)` caches any subtree the
    planner can run, as `DataFrame.cache(storage="device")` does."""

    def __init__(self, paths: Optional[Sequence[str]] = None, device=None,
                 *, logical=None, conf=None):
        from spark_rapids_tpu_torch.config import rapids_conf as rc
        from spark_rapids_tpu_torch.exec.base import conf_device

        if logical is None:
            if not paths:
                raise ValueError("a cached relation needs at least one file")
            from spark_rapids_tpu_torch import resolve_device
            from spark_rapids_tpu_torch.columnar.arrow_bridge import (
                schema_from_arrow,
            )
            from spark_rapids_tpu_torch.io.readers import (
                infer_parquet_schema,
            )
            from spark_rapids_tpu_torch.plan.logical import FileScan

            device = resolve_device(device)
            logical = FileScan("parquet", list(paths), schema_from_arrow(
                infer_parquet_schema(list(paths))))
            # one part per file: a row cap no file reaches
            conf = rc.RapidsConf({
                rc.TORCH_DEVICE.key: str(device),
                rc.MAX_READER_BATCH_SIZE_ROWS.key: 1 << 40})
        self.logical = logical
        self.conf = conf if conf is not None else rc.RapidsConf()
        self.device = conf_device(self.conf)
        self._parts: Optional[List[ColumnBatch]] = None
        self._released = False
        self._lock = threading.Lock()

    @property
    def schema(self):
        return self.logical.schema

    def materialize(self) -> None:
        """Plan the subtree and keep its output parts on the device
        (once)."""
        from spark_rapids_tpu_torch.exec.fused import (
            FusedCompileError,
            FusedSingleChipExecutor,
            upload_narrowed,
        )
        from spark_rapids_tpu_torch.plan.optimizer import optimize
        from spark_rapids_tpu_torch.plan.overrides import plan_query

        with self._lock:
            if self._released:
                raise RuntimeError(
                    "cached relation was unpersisted; re-cache the "
                    "DataFrame to use it again")
            if self._parts is not None:
                return
            phys, _ = plan_query(optimize(self.logical), self.conf)
            parts = None
            try:
                parts = FusedSingleChipExecutor(
                    self.conf).execute_parts(phys)
            except (FusedCompileError, NotImplementedError):
                pass
            if parts is None:
                # a plan the fused engine cannot lower: run it on the
                # per-operator engine and upload the result once
                table = phys.collect()
                parts = ([upload_narrowed(table, device=self.device)]
                         if table.num_rows else [])
            self._parts = parts

    def num_parts(self) -> int:
        self.materialize()
        return len(self._parts)

    def device_part(self, i: int) -> ColumnBatch:
        self.materialize()
        return self._parts[i]

    def device_parts(self) -> List[ColumnBatch]:
        self.materialize()
        return list(self._parts)

    def release(self) -> None:
        with self._lock:
            self._released = True
            self._parts = None


class CacheManager:
    """Session-level registry: canonical plan key -> DeviceCacheEntry, every
    entry on the session's device."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self._entries: Dict[tuple, DeviceCacheEntry] = {}
        self._lock = threading.Lock()

    def _check_device(self, conf) -> None:
        """A conf naming another device than the session's never gets an
        entry here: checked before anything is planned or uploaded."""
        from spark_rapids_tpu_torch.exec.base import conf_device

        if conf_device(conf) != self.device:
            raise ValueError(
                f"a relation cached for {conf_device(conf)} cannot be "
                f"registered with a session on {self.device}")

    @staticmethod
    def _key(logical) -> tuple:
        from spark_rapids_tpu_torch.plan.logical import plan_key

        return plan_key(logical)

    def register(self, logical, conf) -> DeviceCacheEntry:
        self._check_device(conf)
        key = self._key(logical)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = DeviceCacheEntry(logical=logical, conf=conf)
                self._entries[key] = entry
            return entry

    def lookup(self, logical) -> Optional[DeviceCacheEntry]:
        with self._lock:
            if not self._entries:
                return None
        key = self._key(logical)
        with self._lock:
            return self._entries.get(key)

    def unregister(self, logical) -> None:
        key = self._key(logical)
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None:
            entry.release()

    def clear(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.release()

    def substitute(self, logical):
        """Rewrite a logical tree, replacing registered subtrees with
        CachedRelation leaves (Spark CacheManager.useCachedData role);
        keys compose bottom-up in one pass."""
        import copy

        from spark_rapids_tpu_torch.plan import logical as L
        from spark_rapids_tpu_torch.plan.logical import plan_own_key

        with self._lock:
            if not self._entries:
                return logical

        def walk(node):
            results = [walk(c) for c in node.children]
            key = (type(node).__name__, plan_own_key(node),
                   tuple(k for k, _ in results))
            with self._lock:
                entry = self._entries.get(key)
            if entry is not None:
                return key, L.CachedRelation(entry)
            new_children = [c for _, c in results]
            if all(n is o for n, o in zip(new_children, node.children)):
                return key, node
            node = copy.copy(node)
            node.children = new_children
            return key, node

        return walk(logical)[1]
