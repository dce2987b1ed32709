"""The q5 star query on the port's physical operators, and its data.

q5 is the interactive-analytics loop that `bench.py` times
(`engine_query`): a cached fact table, filter `amount > 10`, inner
broadcast join on `store` to a 2,000-row dimension, filter
`region != 'region_11'` on the dimension's dictionary-encoded string
column, project `amount * qty`, group by `region` with sum, avg and count,
collect to Arrow. `q5_plan` builds the per-operator plan the JAX package
runs for it with the fused engine off:

    TpuHashAggregateExec(complete, grouping=[region])
      TpuProjectExec([region, amount*qty AS revenue, amount])
        TpuFilterExec(Not(EqualTo(region, 'region_11')))
          TpuBroadcastHashJoinExec(inner, store = store)
            TpuFilterExec(amount > 10.0)
              TpuCachedRelationExec   (fact)
            TpuCachedRelationExec     (dim)

`write_q5_data` writes the bench's data: the same seeded generator,
columns, file layout and parquet settings.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.exec.joins import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.operators import (
    TpuCachedRelationExec,
    TpuFilterExec,
    TpuHashAggregateExec,
    TpuProjectExec,
)
from spark_rapids_tpu_torch.expr.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.expr.arith import Multiply
from spark_rapids_tpu_torch.expr.core import Alias, BoundReference, Literal
from spark_rapids_tpu_torch.expr.predicates import EqualTo, GreaterThan, Not
from spark_rapids_tpu_torch.sqltypes import StructField, StructType


def write_q5_data(root: str, rows: int, stores: int = 2000,
                  regions: int = 12, files: int = 8,
                  seed: int = 0) -> Tuple[List[str], str]:
    """Write the fact files under root/fact and the dimension file under
    root/dim; returns (fact paths, dimension path). Same generator calls
    as bench.py."""
    fact_dir = os.path.join(root, "fact")
    dim_dir = os.path.join(root, "dim")
    os.makedirs(fact_dir, exist_ok=True)
    os.makedirs(dim_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = rows // files
    fact_paths = []
    for i in range(files):
        t = pa.table({
            "store": pa.array(rng.integers(0, stores, per), type=pa.int64()),
            "amount": pa.array(rng.random(per) * 100.0, type=pa.float64()),
            "qty": pa.array(rng.integers(1, 100, per), type=pa.int64()),
            "day": pa.array(rng.integers(0, 365, per), type=pa.int64()),
        })
        path = os.path.join(fact_dir, f"part-{i}.parquet")
        pq.write_table(t, path, compression="NONE", use_dictionary=False,
                       row_group_size=per, data_page_size=64 << 20)
        fact_paths.append(path)
    dim = pa.table({
        "store": pa.array(np.arange(stores), type=pa.int64()),
        "region": pa.array([f"region_{i % regions:02d}"
                            for i in range(stores)]),
        "opened_day": pa.array(rng.integers(0, 3650, stores),
                               type=pa.int64()),
    })
    dim_path = os.path.join(dim_dir, "dim-0.parquet")
    pq.write_table(dim, dim_path, compression="NONE",
                   use_dictionary=["region"])
    return fact_paths, dim_path


def q5_plan(fact_entry, dim_entry,
            regions: int = 12) -> TpuHashAggregateExec:
    """The q5 physical plan over two DeviceCacheEntry relations."""
    fact = TpuCachedRelationExec(fact_entry)
    dim = TpuCachedRelationExec(dim_entry)
    fs, ds = fact.schema, dim.schema

    def ref(schema, name, base=0):
        i = schema.field_index(name)
        return BoundReference(base + i, schema.fields[i].dataType)

    big = TpuFilterExec(GreaterThan(ref(fs, "amount"), Literal(10.0)), fact)
    joined_schema = StructType(list(fs.fields) + list(ds.fields))
    join = TpuBroadcastHashJoinExec(
        big, dim, "inner", [ref(fs, "store")], [ref(ds, "store")],
        joined_schema)
    nf = len(fs.fields)
    region = ref(ds, "region", base=nf)
    kept = TpuFilterExec(
        Not(EqualTo(region, Literal(f"region_{regions - 1:02d}"))), join)
    amount = ref(fs, "amount")
    revenue = Multiply(amount, ref(fs, "qty"))
    proj_exprs = [Alias(region, "region"), Alias(revenue, "revenue"),
                  Alias(amount, "amount")]
    proj = TpuProjectExec(
        proj_exprs, kept,
        StructType([StructField(a.name, a.dtype, True) for a in proj_exprs]))
    ps = proj.schema
    return TpuHashAggregateExec(
        "complete", [Alias(ref(ps, "region"), "region")],
        [Alias(Sum(ref(ps, "revenue")), "rev"),
         Alias(Average(ref(ps, "amount")), "avg_amount"),
         Alias(Count(), "sales")],
        proj)
