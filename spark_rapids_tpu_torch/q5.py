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
columns, file layout and parquet settings, and with `dup_per_store` the
bench's duplicate-key dimension too (`root/dup/dup-0.parquet`).

`engine_query` and `dupjoin_query` are bench.py's two queries written
against the port's DataFrame API; `topn_query`, `sorted_q5_query`,
`dedup_query` and `window_query` are ScaleTest's TopN (q7), sorted
aggregate (q5), distinct (q10) and window (q6, widened to the rank family
and a running sum) shapes over the same tables; `q6_query` is ScaleTest
q6 as written (row_number alone) over the facts, and `running_query`,
`moving_query`, `range_query` and `u2u_query` drive each window mode the
reference's planner picks: the "running" carry, the batched bounded
frames (halo), the whole partition with RANGE frames and the rank
arithmetic, and the two-pass whole-partition aggregate. Through the
port's session with bench.py's conf they run on the fused engine
(exec/fused.py), which evaluates every window over the whole partition;
with
spark.rapids.sql.fusedExec.enabled off, the planner's plan (a
bloom-prefiltered broadcast join, a binned partial aggregate, a murmur3
hash exchange and a final aggregate) runs on the `aqe` engine.
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
                  regions: int = 12, files: int = 8, seed: int = 0,
                  dup_per_store: int = 0) -> Tuple[List[str], str]:
    """Write the fact files under root/fact and the dimension file under
    root/dim, and with dup_per_store > 0 the duplicate-key dimension
    (dup_per_store rows per store: `promo` a plain, non-dictionary string
    of 5 values, `discount` in [0, 0.3)) at root/dup/dup-0.parquet;
    returns (fact paths, dimension path). Same generator calls as
    bench.py."""
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
    if dup_per_store > 0:
        n = stores * dup_per_store
        dup = pa.table({
            "store": pa.array(np.repeat(np.arange(stores), dup_per_store),
                              type=pa.int64()),
            "promo": pa.array([f"promo_{i % 5:02d}" for i in range(n)]),
            "discount": pa.array(rng.random(n) * 0.3),
        })
        os.makedirs(os.path.join(root, "dup"), exist_ok=True)
        pq.write_table(dup, os.path.join(root, "dup", "dup-0.parquet"),
                       compression="NONE", use_dictionary=False)
    return fact_paths, dim_path


def engine_query(base, dim, regions: int = 12):
    """bench.py's q5 on the port's DataFrames: filter, broadcast join to
    the store dimension, a string filter on the dimension's region, and a
    group-by of region."""
    from spark_rapids_tpu_torch.api import functions as F

    return (base
            .filter(F.col("amount") > 10.0)
            .join(dim, on="store", how="inner")
            .filter(F.col("region") != f"region_{regions - 1:02d}")
            .select("region",
                    (F.col("amount") * F.col("qty")).alias("revenue"),
                    "amount")
            .groupBy("region")
            .agg(F.sum("revenue").alias("rev"),
                 F.avg("amount").alias("avg_amount"),
                 F.count("*").alias("sales")))


def dupjoin_query(base, dup):
    """bench.py's duplicate-key join: every kept fact row matches
    dup_per_store dimension rows (a row-expanding join), grouped by
    promo."""
    from spark_rapids_tpu_torch.api import functions as F

    return (base
            .filter(F.col("amount") > 50.0)
            .join(dup, on="store", how="inner")
            .select("promo",
                    (F.col("amount") * F.col("discount")).alias("rebate"))
            .groupBy("promo")
            .agg(F.sum("rebate").alias("total_rebate"),
                 F.count("*").alias("n")))


def topn_query(base, n: int = 100):
    """ScaleTest q7 over the facts: a global sort on amount, descending,
    and the first n rows (TakeOrderedAndProject)."""
    from spark_rapids_tpu_torch.api import functions as F

    return base.orderBy(F.col("amount").desc()).limit(n)


def sorted_q5_query(base, dim, regions: int = 12):
    """ScaleTest q5's shape: bench.py's q5 ordered by revenue."""
    from spark_rapids_tpu_torch.api import functions as F

    return engine_query(base, dim, regions).orderBy(F.col("rev").desc())


def dedup_query(base):
    """ScaleTest q10 over the facts: distinct (store, qty) pairs, sorted."""
    return base.select("store", "qty").distinct().orderBy("store", "qty")


def window_query(base):
    """ScaleTest q6 over the facts, widened to the rank family and a
    running sum: per store ordered by day, row_number, rank, dense_rank
    and the sum of amount over Spark's default frame (RANGE UNBOUNDED
    PRECEDING..CURRENT ROW, so each row's whole day peer run)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store").orderBy("day")
    return base.select("store", "day", "amount",
                       F.row_number().over(w).alias("rn"),
                       F.rank().over(w).alias("rk"),
                       F.dense_rank().over(w).alias("drk"),
                       F.sum("amount").over(w).alias("run_amount"))


def q6_query(base):
    """ScaleTest q6 as written, over the facts: row_number per store by
    day (the "running" mode on the adaptive engine)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store").orderBy("day")
    return base.select("store", "day",
                       F.row_number().over(w).alias("rn"))


def running_query(base):
    """The "running" mode: ranks and running sum, min, max and count of
    amount per store, ordered by (day, amount) so that ROWS frames are
    deterministic."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store").orderBy("day", "amount")
    run = w.rowsBetween(Window.unboundedPreceding, Window.currentRow)
    return base.select("store", "day", "amount",
                       F.row_number().over(w).alias("rn"),
                       F.rank().over(w).alias("rk"),
                       F.dense_rank().over(w).alias("drk"),
                       F.sum("amount").over(run).alias("run_sum"),
                       F.min("amount").over(run).alias("run_min"),
                       F.max("amount").over(run).alias("run_max"),
                       F.count("amount").over(run).alias("run_cnt"))


def moving_query(base):
    """The batched bounded-frame mode (halo 6): moving average and maximum
    of amount over the week before each sale, the minimum qty three sales
    around it, lag and lead (with a default), and first/last of the
    week's frame, per store ordered by (day, amount)."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store").orderBy("day", "amount")
    week = w.rowsBetween(-6, 0)
    return base.select("store", "day", "amount", "qty",
                       F.avg("amount").over(week).alias("avg7"),
                       F.max("amount").over(week).alias("max7"),
                       F.min("qty").over(w.rowsBetween(-3, 3)).alias(
                           "min_qty"),
                       F.lag("amount", 1).over(w).alias("prev"),
                       F.lead("amount", 2, 0.0).over(w).alias("next2"),
                       F.first("amount").over(week).alias("first7"),
                       F.last("amount", ignorenulls=True).over(week).alias(
                           "last7"))


def range_query(base):
    """The whole-partition mode with RANGE frames: sum, count and min of
    amount and max of qty over the days [day - 6, day] of each store, and
    percent_rank, cume_dist and ntile(4) by day."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store").orderBy("day")
    days = w.rangeBetween(-6, 0)
    return base.select("store", "day", "amount", "qty",
                       F.sum("amount").over(days).alias("sum7d"),
                       F.count("amount").over(days).alias("cnt7d"),
                       F.min("amount").over(days).alias("min7d"),
                       F.max("qty").over(days).alias("max_qty7d"),
                       F.percent_rank().over(w).alias("prk"),
                       F.cume_dist().over(w).alias("cd"),
                       F.ntile(4).over(w).alias("q4"))


def u2u_query(base):
    """The two-pass "u2u" mode: per-store totals beside every sale."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window

    w = Window.partitionBy("store")
    return base.select("store", "amount", "qty",
                       F.sum("amount").over(w).alias("tot"),
                       F.avg("amount").over(w).alias("mean"),
                       F.min("amount").over(w).alias("lo"),
                       F.max("qty").over(w).alias("qmax"),
                       F.count("*").over(w).alias("n"))


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
