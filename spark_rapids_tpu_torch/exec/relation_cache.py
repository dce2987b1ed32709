"""Device-resident relation cache — counterpart of the `DeviceCacheEntry`
part of `spark_rapids_tpu/exec/relation_cache.py`.

An entry holds a parquet relation AS DEVICE BATCHES, uploaded once (one
part per file) and then read by every query at device-memory bandwidth.
String columns are read as parquet DICTIONARY arrays, so they upload
encoded (codes plus one interned dictionary), as the reference's device
scan does (`TpuFileScanExec._dict_columns`). The reference's spill
catalog, canonical-plan matching and device-loss recovery are not
ported yet: parts stay on the device while the entry lives.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar.arrow_bridge import (
    arrow_to_device,
    schema_from_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch


class DeviceCacheEntry:
    """Lazily materialised device copy of a set of parquet files."""

    def __init__(self, paths: Sequence[str], device=None):
        if not paths:
            raise ValueError("a cached relation needs at least one file")
        self.paths = list(paths)
        self.device = resolve_device(device)
        file_schema = pq.read_schema(self.paths[0])
        self._dict_cols = [f.name for f in file_schema
                           if pa.types.is_string(f.type)
                           or pa.types.is_large_string(f.type)]
        self.schema = schema_from_arrow(file_schema)
        self._parts: Optional[List[ColumnBatch]] = None
        self._lock = threading.Lock()

    def materialize(self) -> None:
        """Upload every file once (one part each)."""
        with self._lock:
            if self._parts is None:
                self._parts = [
                    arrow_to_device(
                        pq.read_table(p, read_dictionary=self._dict_cols),
                        device=self.device)
                    for p in self.paths]

    def num_parts(self) -> int:
        self.materialize()
        return len(self._parts)

    def device_part(self, i: int) -> ColumnBatch:
        self.materialize()
        return self._parts[i]
