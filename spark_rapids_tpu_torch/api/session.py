"""TpuSparkSession — the port's session entry point, counterpart of
`spark_rapids_tpu/api/session.py`: the builder, conf, `read.parquet`,
the device relation cache and the last query's execution record.

    spark = TpuSparkSession.builder.getOrCreate()    # the CUDA device
    fact = spark.read.parquet(path).cache(storage="device")
    fact.filter(F.col("amount") > 10.0).groupBy(...).agg(...).collect()

The session resolves its device once, from the conf key
`spark.rapids.torch.device`: unset means the current CUDA device, and
creating the session raises when there is none; "cpu" runs every
kernel's plain PyTorch version on the CPU (as the port's tests do).
Sessions of one process share nothing a query reads: each has its own
relation cache, tied to its device, a DataFrame runs in the session that
made it and cannot be combined with another device's, and a running
query sees its own session as the active one. The
reference's plugin lifecycle (memory pool, spill catalog, semaphore),
observability, admission control and serving are not ported yet
(ROADMAP A10, A17).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

from spark_rapids_tpu_torch.config import rapids_conf as rc


class TpuSparkSessionBuilder:
    def __init__(self):
        self._conf: Dict[str, object] = {}

    def config(self, key: str, value) -> "TpuSparkSessionBuilder":
        self._conf[key] = value
        return self

    def master(self, _: str) -> "TpuSparkSessionBuilder":
        return self

    def appName(self, _: str) -> "TpuSparkSessionBuilder":
        return self

    def getOrCreate(self) -> "TpuSparkSession":
        return TpuSparkSession(self._conf)


class DataFrameReader:
    def __init__(self, session: "TpuSparkSession"):
        self.session = session

    def parquet(self, *paths: str):
        from spark_rapids_tpu_torch.api.dataframe import DataFrame
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            schema_from_arrow,
        )
        from spark_rapids_tpu_torch.io.readers import infer_parquet_schema
        from spark_rapids_tpu_torch.plan.logical import FileScan

        schema = schema_from_arrow(infer_parquet_schema(list(paths)))
        return DataFrame(FileScan("parquet", list(paths), schema, {}),
                         self.session)


_active: Optional["TpuSparkSession"] = None
_active_lock = threading.Lock()
#: the session whose query this thread is planning or running
_current = threading.local()


class TpuSparkSession:
    builder = None  # class attribute set below

    def __init__(self, conf: Optional[Dict[str, object]] = None):
        from spark_rapids_tpu_torch.exec.base import conf_device
        from spark_rapids_tpu_torch.exec.relation_cache import CacheManager

        self._settings = dict(conf or {})
        self.rapids_conf = rc.RapidsConf(self._settings)
        #: settings the port accepts but does not read (each warned on)
        self.ignored_settings = rc.check_port_settings(self.rapids_conf,
                                                       self._settings)
        #: where every upload of this session goes (raises without a GPU
        #: unless the conf asks for the CPU)
        self.device = conf_device(self.rapids_conf)
        #: this session's relation cache; it holds entries of this
        #: session's device only
        self.cache_manager = CacheManager(self.device)
        #: which engine ran the last query, why faster ones were skipped,
        #: and the adaptive executor's decisions
        self.last_execution = None
        global _active
        with _active_lock:
            _active = self

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def stop(self):
        global _active
        self.cache_manager.clear()
        with _active_lock:
            if _active is self:
                _active = None

    @contextmanager
    def activated(self):
        """Make this session the active one of this thread while its
        query is planned and run, so that what reads the active session
        (the regex limits, ANSI mode, the expression switches) reads this
        session's conf, and not that of the last session created."""
        prev = getattr(_current, "session", None)
        _current.session = self
        try:
            yield self
        finally:
            _current.session = prev

    @staticmethod
    def active() -> Optional["TpuSparkSession"]:
        """The session whose query this thread runs, else the last one
        created and not stopped."""
        s = getattr(_current, "session", None)
        return s if s is not None else _active


TpuSparkSession.builder = TpuSparkSessionBuilder()
