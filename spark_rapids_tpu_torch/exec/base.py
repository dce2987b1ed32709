"""Physical operator base — counterpart of `spark_rapids_tpu/exec/base.py`.

`PhysicalPlan.execute_partition(pid, ctx)` yields device ColumnBatches;
`collect()` runs every partition in turn on the calling thread and
returns one Arrow table. The reference's stage scheduler, task
semaphore, profiler ranges and event hooks are not ported yet (ROADMAP
A10, A17).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List

import pyarrow as pa
import torch

from spark_rapids_tpu_torch.sqltypes import StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import to_arrow_type

_task_counter = itertools.count(1)


class TaskContext:
    def __init__(self, task_id: int):
        self.task_id = task_id


def new_task_context(conf=None) -> TaskContext:
    return TaskContext(next(_task_counter))


def conf_device(conf) -> torch.device:
    """The device a plan built under `conf` uploads to:
    spark.rapids.torch.device, else the current CUDA device (raising
    when there is none)."""
    from spark_rapids_tpu_torch import resolve_device
    from spark_rapids_tpu_torch.config import rapids_conf as rc

    want = conf.get(rc.TORCH_DEVICE) if conf is not None else ""
    return resolve_device(want or None)


class PhysicalPlan:
    """Base physical node."""

    is_tpu = True

    def __init__(self, children: List["PhysicalPlan"], schema: StructType,
                 conf=None):
        self.children = children
        self.schema = schema
        self.conf = conf

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def execute_partition(self, pid: int, ctx: TaskContext) -> Iterator:
        raise NotImplementedError

    def _node_string(self) -> str:
        return type(self).__name__

    def pretty(self, indent: int = 0) -> str:
        s = "  " * indent + self._node_string()
        for c in self.children:
            s += "\n" + c.pretty(indent + 1)
        return s

    def collect(self) -> pa.Table:
        """Run all partitions -> one Arrow table (driver collect)."""
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            device_to_arrow,
        )

        tables = []
        for pid in range(self.num_partitions):
            ctx = new_task_context(self.conf)
            tables.extend(device_to_arrow(b)
                          for b in self.execute_partition(pid, ctx))
        if not tables:
            return pa.schema([
                pa.field(f.name, to_arrow_type(f.dataType), f.nullable)
                for f in self.schema.fields]).empty_table()
        return pa.concat_tables(tables)
