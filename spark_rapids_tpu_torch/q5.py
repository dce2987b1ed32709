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
arithmetic, and the two-pass whole-partition aggregate.
`string_q5_query` and `string_dup_query` filter, project and group
bench.py's two queries by string expressions and RLIKE;
`orders_q13_query` and `orders_words_query` run TPC-H q13's comment
predicate and word split over an ORDERS-shaped table that
`write_orders_data` generates. `orders_q4_window_query`,
`orders_ingest_query` and `orders_monthly_query` run TPC-H q4's date
window, the typing step of a text load and a monthly report in the
session zone over the dated ORDERS that `write_orders_dated` writes
typed and as .tbl text; `orders_price_stats_query`,
`orders_daily_distinct_query` and `orders_price_window_query` run the
statistical, distinct and percentile aggregates and the variance window
frames over its typed table. `q13_outer_query` (TPC-H q13: a
conditional left outer join), `q22_anti_query` (q22's NOT EXISTS: a left
anti join), `orders_yoy_full_query` (a full outer join of two years),
`orders_price_bands_query` (a condition-only full outer nested-loop
join), `customer_segments_query` (a join on dictionary-encoded keys of
two dictionaries) and `orders_union_rr_query` (a union and a round-robin
repartition) run over the CUSTOMER, ORDERS, band and quota tables that
`write_customer_data` writes. `lineitem_q1_query` (TPC-H q1 over
decimal(15,2) money columns), `orders_tbl_decimal_query` (a .tbl load
typed to decimal, its sums printed as text) and `q22_decimal_query`
(TPC-H q22 over a decimal balance) run over the LINEITEM and decimal
CUSTOMER that `write_decimal_data` writes and the ORDERS text and table
above. `delta_write`, `delta_zorder`, `delta_rf1`, `delta_rf2`,
`delta_retention_delete`, `delta_request_delete` and `delta_update`
keep the typed ORDERS as a Delta table (the write with deletion
vectors, OPTIMIZE ZORDER BY, TPC-H's refresh functions as MERGEs, two
DELETEs and an UPDATE); `delta_priority_summary_query` reads it back.
Through the
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


def _functions(F):
    if F is None:
        from spark_rapids_tpu_torch.api import functions as F
    return F


def string_q5_query(base, dim, F=None):
    """bench.py's q5 with string predicates on the dictionary-encoded
    region (contains, RLIKE and a negated startswith), grouped by an
    expression of it: upper(substring(region, 8, 2)). `F` is the
    functions module to build it with (the port's by default)."""
    F = _functions(F)
    region = F.col("region")
    return (base
            .filter(F.col("amount") > 10.0)
            .join(dim, on="store", how="inner")
            .filter(region.contains("_0") & region.rlike("region_0[1-7]")
                    & ~region.startswith("region_05"))
            .select(F.upper(F.substring("region", 8, 2)).alias("rk"),
                    (F.col("amount") * F.col("qty")).alias("revenue"),
                    "amount")
            .groupBy("rk")
            .agg(F.sum("revenue").alias("rev"),
                 F.avg("amount").alias("avg_amount"),
                 F.count("*").alias("sales")))


def string_dup_query(base, dup, F=None):
    """bench.py's duplicate-key join, its plain `promo` rewritten by the
    string functions: grouped by `tag` = concat_ws("|", promo,
    upper(promo)) and `shape`, the concatenation of rpad, replace,
    translate, reverse and initcap of promo, with the count, the rebate's
    sum and the sum of length(tag)."""
    F = _functions(F)
    promo = F.col("promo")
    shape = F.concat(F.rpad(promo, 12, "*"), F.replace(promo, "_0", "#"),
                     F.translate(promo, "mo", "MX"), F.reverse(promo),
                     F.initcap(promo))
    tag = F.concat_ws("|", promo, F.upper(promo))
    return (base
            .filter(F.col("amount") > 50.0)
            .join(dup, on="store", how="inner")
            .select(tag.alias("tag"), shape.alias("shape"),
                    F.length(tag).alias("tag_len"),
                    (F.col("amount") * F.col("discount")).alias("rebate"))
            .groupBy("tag", "shape")
            .agg(F.count("*").alias("n"),
                 F.sum("rebate").alias("total_rebate"),
                 F.sum("tag_len").alias("tag_chars")))


def orders_q13_query(orders, F=None):
    """TPC-H q13's comment predicate over ORDERS: the orders whose
    comment does not match 'special.*requests', per order priority: the
    count, the comments' total characters and the latest position of
    'furiously'."""
    F = _functions(F)
    return (orders
            .filter(~F.rlike("o_comment", "special.*requests"))
            .select("o_orderpriority",
                    F.length("o_comment").alias("chars"),
                    F.instr("o_comment", "furiously").alias("furious_at"))
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("n"), F.sum("chars").alias("chars"),
                 F.max("furious_at").alias("furious_at")))


def orders_words_query(orders, F=None):
    """ORDERS grouped by the comment's first word (substring_index on a
    space): the count, the total characters of the trimmed comment with
    'requests' shortened to 'reqs', and the longest comment padded on the
    left to 80 characters."""
    F = _functions(F)
    comment = F.col("o_comment")
    return (orders
            .select(F.substring_index(comment, " ", 1).alias("word"),
                    F.length(F.trim(F.replace(comment, "requests",
                                              "reqs"))).alias("short"),
                    F.length(F.lpad(comment, 80, ".")).alias("padded"))
            .groupBy("word")
            .agg(F.count("*").alias("n"), F.sum("short").alias("short"),
                 F.max("padded").alias("padded")))


def orders_q4_window_query(orders, F=None):
    """TPC-H q4's date predicate and output over the typed ORDERS, without
    its EXISTS subquery (a semi join, not ported yet): the orders of the
    quarter from 1993-07-01 per priority, with the count, the revenue and
    the first and last order date."""
    F = _functions(F)
    start = F.to_date(F.lit("1993-07-01"))
    date = F.col("o_orderdate")
    return (orders
            .filter((date >= start) & (date < F.add_months(start, 3)))
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"),
                 F.sum("o_totalprice").alias("revenue"),
                 F.min("o_orderdate").alias("first_date"),
                 F.max("o_orderdate").alias("last_date")))


def orders_ingest_query(orders_tbl, F=None):
    """The typing step of a text load over ORDERS as dbgen's .tbl prints
    it (every column a string): the key and the price cast to numbers,
    the date parsed with to_date and, as a timestamp in the session zone,
    with unix_timestamp; per order year the count, the revenue, the
    largest key and the sum of the unix timestamps."""
    F = _functions(F)
    return (orders_tbl
            .select(F.col("o_orderkey").cast("bigint").alias("key"),
                    F.col("o_totalprice").cast("double").alias("price"),
                    F.year(F.to_date("o_orderdate")).alias("o_year"),
                    F.unix_timestamp("o_orderdate").alias("ts"))
            .groupBy("o_year")
            .agg(F.count("*").alias("n"), F.sum("price").alias("revenue"),
                 F.max("key").alias("max_key"), F.sum("ts").alias("ts_sum")))


def orders_monthly_query(orders, F=None):
    """A monthly revenue report in the session zone over the typed ORDERS:
    each order date as a timestamp (local midnight), grouped by its month
    as text and by the hour that instant reads in Asia/Kolkata's wall
    clock; the revenue, the count, and the total characters of the key
    and of the timestamp cast to strings."""
    F = _functions(F)
    ts = F.col("o_orderdate").cast("timestamp")
    return (orders
            .select(F.date_format(ts, "yyyy-MM").alias("month"),
                    F.hour(F.from_utc_timestamp(ts, "Asia/Kolkata")).alias(
                        "ist_hour"),
                    "o_totalprice",
                    F.length(F.col("o_orderkey").cast("string")).alias(
                        "key_chars"),
                    F.length(ts.cast("string")).alias("ts_chars"))
            .groupBy("month", "ist_hour")
            .agg(F.sum("o_totalprice").alias("revenue"),
                 F.count("*").alias("n"),
                 F.sum("key_chars").alias("key_chars"),
                 F.sum("ts_chars").alias("ts_chars")))


def orders_price_stats_query(orders, F=None):
    """The spread of order value per priority and order year (35 groups):
    sample and population variance and stddev, skewness and kurtosis of
    o_totalprice, its covariance and correlation with the order's day
    number, its approximate 90th percentile, and whether every order is
    over 900 and whether any is over 500,000. Every aggregate is
    jittable: the fused engine runs it."""
    F = _functions(F)
    price = F.col("o_totalprice")
    return (orders
            .select("o_orderpriority",
                    F.year("o_orderdate").alias("o_year"), "o_totalprice",
                    F.datediff(F.col("o_orderdate"),
                               F.to_date(F.lit("1992-01-01"))).alias("day"))
            .groupBy("o_orderpriority", "o_year")
            .agg(F.var_samp("o_totalprice").alias("var_samp"),
                 F.var_pop("o_totalprice").alias("var_pop"),
                 F.stddev_samp("o_totalprice").alias("sd_samp"),
                 F.stddev_pop("o_totalprice").alias("sd_pop"),
                 F.skewness("o_totalprice").alias("skew"),
                 F.kurtosis("o_totalprice").alias("kurt"),
                 F.covar_pop("o_totalprice", "day").alias("cov_pop"),
                 F.covar_samp("o_totalprice", "day").alias("cov_samp"),
                 F.corr("o_totalprice", "day").alias("corr"),
                 F.percentile_approx("o_totalprice", 0.9).alias("p90"),
                 F.bool_and(price > 900.0).alias("all_over_900"),
                 F.bool_or(price > 500000.0).alias("any_over_500k")))


def orders_daily_distinct_query(orders, F=None):
    """A dashboard's daily line (2,406 groups at SF10): the orders, the
    distinct customers and the median order value of each order date.
    count(DISTINCT) and percentile are not jittable: the fused engine
    falls back to the adaptive one, as the reference's does."""
    F = _functions(F)
    return (orders
            .groupBy("o_orderdate")
            .agg(F.count("*").alias("n"),
                 F.countDistinct("o_custkey").alias("customers"),
                 F.percentile("o_totalprice", 0.5).alias("median")))


def orders_price_window_query(orders, F=None, Window=None):
    """Variance window frames over every order: the sample stddev of
    o_totalprice over the 100 orders up to each one of its priority (in
    date and key order: ROWS 99 PRECEDING to CURRENT ROW), and the
    population variance over the whole priority. `Window` is the window
    builder of the package `F` belongs to (the port's by default)."""
    F = _functions(F)
    if Window is None:
        from spark_rapids_tpu_torch.api.window import Window
    prio = Window.partitionBy("o_orderpriority")
    moving = prio.orderBy("o_orderdate", "o_orderkey").rowsBetween(-99, 0)
    return orders.select(
        "o_orderkey", "o_orderpriority", "o_orderdate", "o_totalprice",
        F.stddev_samp("o_totalprice").over(moving).alias("sd100"),
        F.var_pop("o_totalprice").over(prio).alias("prio_var"))


def q13_outer_query(customer, orders, F=None):
    """TPC-H q13 as the spec writes it: every customer left-joined to its
    orders whose comment does not match 'special.*requests' (a join
    condition beside the key), the orders counted per customer, then the
    customers counted per order count, by custdist and c_count
    descending."""
    F = _functions(F)
    c_orders = (customer.select("c_custkey")
                .join(orders.select("o_orderkey", "o_custkey", "o_comment"),
                      on=(F.col("c_custkey") == F.col("o_custkey"))
                      & ~F.rlike("o_comment", "special.*requests"),
                      how="left")
                .groupBy("c_custkey")
                .agg(F.count("o_orderkey").alias("c_count")))
    return (c_orders.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(F.col("custdist").desc(), F.col("c_count").desc()))


def q22_anti_query(customer, orders, F=None):
    """The NOT EXISTS core of TPC-H q22: the customers with a positive
    balance that placed no order (a left anti join on the key), counted
    and their balances summed per country code, the first two characters
    of c_phone. q22's scalar subquery and IN list are left out."""
    F = _functions(F)
    return (customer
            .filter(F.col("c_acctbal") > 0.0)
            .select(F.substring("c_phone", 1, 2).alias("cntrycode"),
                    "c_acctbal", "c_custkey")
            .join(orders.select("o_custkey"),
                  on=F.col("c_custkey") == F.col("o_custkey"),
                  how="left_anti")
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal")))


def orders_yoy_full_query(orders, F=None):
    """A year-over-year report: each customer's revenue in 1995 full-outer
    joined to the same in 1996 on the customer key. One row: the
    customers of either year, those of each year, both revenues and the
    change (the customers of one year only are the total less the other
    year's)."""
    F = _functions(F)

    def revenue(y, key, rev):
        return (orders.filter(F.year("o_orderdate") == y)
                .groupBy("o_custkey")
                .agg(F.sum("o_totalprice").alias(rev))
                .withColumnRenamed("o_custkey", key))

    both = revenue(1995, "ck95", "rev95").join(
        revenue(1996, "ck96", "rev96"),
        on=F.col("ck95") == F.col("ck96"), how="full")
    return (both.agg(F.count("*").alias("customers"),
                     F.count("ck95").alias("in95"),
                     F.count("ck96").alias("in96"),
                     F.sum("rev95").alias("rev95"),
                     F.sum("rev96").alias("rev96"))
            .select("customers",
                    (F.col("customers") - F.col("in96")).alias("only95"),
                    (F.col("customers") - F.col("in95")).alias("only96"),
                    "rev95", "rev96",
                    (F.col("rev96") - F.col("rev95")).alias("change")))


def orders_price_bands_query(orders, bands, F=None):
    """Orders against a price-band table by a range condition alone (no
    key: a nested-loop join), full outer: orders in no band and bands with
    no order are kept. Per band the orders and their revenue."""
    F = _functions(F)
    price = F.col("o_totalprice")
    return (orders.select("o_totalprice")
            .join(bands, on=(price >= F.col("b_lo")) & (price < F.col("b_hi")),
                  how="full")
            .groupBy("b_band")
            .agg(F.count("o_totalprice").alias("n"),
                 F.sum("o_totalprice").alias("revenue")))


def customer_segments_query(quota, customer, F=None):
    """The segment quota table joined to every customer on the market
    segment: both columns are dictionary-encoded, with dictionaries in
    different orders, so the join compares codes re-encoded into one code
    space. Per segment and nation the customers, their balance and its
    excess over the segment's quota."""
    F = _functions(F)
    return (quota
            .join(customer,
                  on=F.col("q_mktsegment") == F.col("c_mktsegment"),
                  how="inner")
            .select("c_mktsegment", "c_nationkey", "c_acctbal",
                    (F.col("c_acctbal") - F.col("q_quota")).alias("excess"))
            .groupBy("c_mktsegment", "c_nationkey")
            .agg(F.count("*").alias("n"),
                 F.sum("c_acctbal").alias("acctbal"),
                 F.sum("excess").alias("excess")))


def orders_union_rr_query(orders, F=None, partitions: int = 16):
    """Two loads appended and spread evenly before a report: the 1995 and
    1997 orders, union-ed, repartitioned round-robin into `partitions`,
    then counted and summed per priority."""
    F = _functions(F)
    year = F.year("o_orderdate")
    cols = ("o_orderpriority", "o_totalprice")
    return (orders.filter(year == 1995).select(*cols)
            .union(orders.filter(year == 1997).select(*cols))
            .repartition(partitions)
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("n"),
                 F.sum("o_totalprice").alias("revenue")))


#: TPC-H q22's country codes (spec 2.4.22.3, the default substitution)
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22_full_query(customer, orders, F=None, zero=0.0):
    """TPC-H q22 as written: the customers whose country code (the first
    two characters of c_phone) is in the IN list, whose balance is above
    the average positive balance of those codes (the scalar subquery, a
    crossJoin to its one-row aggregate, as a DataFrame user writes it) and
    who placed no order (a left anti join); counted and their balances
    summed per code, in code order. `zero` is the literal the positive
    balances are compared with."""
    F = _functions(F)
    cand = (customer
            .select(F.substring("c_phone", 1, 2).alias("cntrycode"),
                    "c_acctbal", "c_custkey")
            .filter(F.col("cntrycode").isin(*Q22_CODES)))
    avg_bal = (cand.filter(F.col("c_acctbal") > F.lit(zero))
               .agg(F.avg("c_acctbal").alias("avg_bal")))
    return (cand.crossJoin(avg_bal)
            .filter(F.col("c_acctbal") > F.col("avg_bal"))
            .join(orders.select("o_custkey"),
                  on=F.col("c_custkey") == F.col("o_custkey"),
                  how="left_anti")
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .orderBy("cntrycode"))


def orders_priority_split_query(orders, F=None):
    """TPC-H q12's CASE WHEN split over ORDERS by order year: the orders
    of priority 1-URGENT or 2-HIGH, the others, and all of them."""
    F = _functions(F)
    high = F.col("o_orderpriority").isin("1-URGENT", "2-HIGH")
    return (orders
            .select(F.year("o_orderdate").alias("o_year"), "o_orderpriority")
            .groupBy("o_year")
            .agg(F.sum(F.when(high, 1).otherwise(0)).alias("high_line_count"),
                 F.sum(F.when(~high, 1).otherwise(0)).alias("low_line_count"),
                 F.count("*").alias("n"))
            .orderBy("o_year"))


def orders_hash_sample_query(orders, F=None):
    """A deterministic 5 % sample of ORDERS, pmod(xxhash64(o_orderkey),
    100) < 5, grouped into Spark's bucketing hash, pmod(hash(o_custkey),
    64): per bucket the orders, their revenue and the bottom-1 MinHash of
    (o_custkey, o_orderpriority, o_comment) as hex text. `F` must have
    `pmod` (PySpark's; the port's functions module has it)."""
    F = _functions(F)
    return (orders
            .filter(F.pmod(F.xxhash64("o_orderkey"), 100) < 5)
            .select(F.pmod(F.hash("o_custkey"), 64).alias("bucket"),
                    "o_totalprice",
                    F.xxhash64("o_custkey", "o_orderpriority",
                               "o_comment").alias("mh"))
            .groupBy("bucket")
            .agg(F.count("*").alias("n"),
                 F.sum("o_totalprice").alias("revenue"),
                 F.min("mh").alias("minhash"))
            .select("bucket", "n", "revenue",
                    F.hex("minhash").alias("minhash_hex"))
            .orderBy("bucket"))


def customer_value_bands_query(customer, orders, F=None):
    """Every customer left-joined to their 1996 revenue, banded by the
    order of magnitude of the balance, floor(log10(|c_acctbal| + 1)): per
    band the customers, those without a 1996 order (isNull), those in the
    BUILDING or MACHINERY segment (IN over the dictionary-encoded
    c_mktsegment) and those with an even key (%), the revenue with no
    order as 0.0 (coalesce), the largest of revenue and balance
    (greatest), and the average revenue rounded to cents and its ceiling."""
    F = _functions(F)
    rev = (orders.filter(F.year("o_orderdate") == 1996)
           .groupBy("o_custkey")
           .agg(F.sum("o_totalprice").alias("revenue")))
    joined = customer.join(rev, on=F.col("c_custkey") == F.col("o_custkey"),
                           how="left")
    banded = joined.select(
        F.floor(F.log10(F.abs(F.col("c_acctbal")) + 1.0)).alias("band"),
        F.when(F.col("revenue").isNull(), 1).otherwise(0).alias("no_orders"),
        F.when(F.col("c_mktsegment").isin("BUILDING", "MACHINERY"), 1)
        .otherwise(0).alias("industrial"),
        F.when(F.col("c_custkey") % 2 == 0, 1).otherwise(0).alias("even"),
        F.coalesce(F.col("revenue"), F.lit(0.0)).alias("rev0"),
        F.greatest(F.col("revenue"), F.col("c_acctbal")).alias("top"))
    return (banded.groupBy("band")
            .agg(F.count("*").alias("customers"),
                 F.sum("no_orders").alias("without_orders"),
                 F.sum("industrial").alias("industrial"),
                 F.sum("even").alias("even_keys"),
                 F.sum("rev0").alias("revenue"),
                 F.avg("rev0").alias("avg_rev"),
                 F.max("top").alias("max_top"))
            .select("band", "customers", "without_orders", "industrial",
                    "even_keys", "revenue",
                    F.round("avg_rev", 2).alias("avg_revenue"),
                    F.ceil("avg_rev").alias("avg_revenue_ceil"),
                    "max_top")
            .orderBy("band"))


#: TPC-H's o_orderpriority values (spec 4.2.2.13: PRIORITIES)
def lineitem_q1_query(lineitem, F=None, charge: bool = False):
    """TPC-H q1, the pricing summary report, over decimal(15,2) LINEITEM
    columns: the lines shipped by 1998-09-02 grouped by return flag and
    line status, with the sums of quantity, price and discounted price
    (decimal(32,4) products, summed as decimal(38,4)), the averages of
    quantity, price and discount and the count, in key order. The 1 of
    1 - l_discount is a decimal literal, since an integral counts as
    decimal(19, 0). With `charge`, sum_charge too (price * (1 - discount)
    * (1 + tax), a decimal(32,4) operand of Multiply: the reference runs it
    on its CPU engine)."""
    from decimal import Decimal

    F = _functions(F)
    one = F.lit(Decimal("1"))
    price = F.col("l_extendedprice")
    disc_price = price * (one - F.col("l_discount"))
    aggs = [F.sum("l_quantity").alias("sum_qty"),
            F.sum("l_extendedprice").alias("sum_base_price"),
            F.sum(disc_price).alias("sum_disc_price")]
    if charge:
        aggs.append(F.sum(disc_price * (one + F.col("l_tax")))
                    .alias("sum_charge"))
    aggs += [F.avg("l_quantity").alias("avg_qty"),
             F.avg("l_extendedprice").alias("avg_price"),
             F.avg("l_discount").alias("avg_disc"),
             F.count("*").alias("count_order")]
    return (lineitem
            .filter(F.col("l_shipdate") <= F.to_date(F.lit(Q1_SHIP_CUTOFF)))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(*aggs)
            .orderBy("l_returnflag", "l_linestatus"))


def orders_tbl_decimal_query(orders_tbl, F=None):
    """A .tbl load typed as TPC-H types it: o_totalprice cast from text to
    decimal(15,2) and the order date parsed; the orders above 100,000.00
    per order year with their revenue (a decimal(25,2) sum), average
    (decimal(19,6)), smallest and largest price and count, the revenue
    and the extremes also as text, in descending revenue."""
    from decimal import Decimal

    F = _functions(F)
    return (orders_tbl
            .select(F.col("o_totalprice").cast("decimal(15,2)")
                    .alias("price"),
                    F.year(F.to_date("o_orderdate")).alias("o_year"))
            .filter(F.col("price") > F.lit(Decimal("100000.00")))
            .groupBy("o_year")
            .agg(F.sum("price").alias("revenue"),
                 F.avg("price").alias("avg_price"),
                 F.min("price").alias("min_price"),
                 F.max("price").alias("max_price"),
                 F.count("*").alias("n"))
            .select("o_year", "revenue", "avg_price", "min_price",
                    "max_price", "n",
                    F.col("revenue").cast("string").alias("revenue_text"),
                    F.col("min_price").cast("string").alias("min_text"),
                    F.col("max_price").cast("string").alias("max_text"))
            .orderBy(F.col("revenue").desc()))


def q22_decimal_query(customer_dec, orders, F=None):
    """TPC-H q22 as written over a decimal(15,2) c_acctbal: the positive
    balances are those above Decimal("0.00"), their average is a
    decimal(19,6), and each balance is compared with it as decimal(38,6)
    limbs; the balances are summed per country code as decimal(25,2)."""
    from decimal import Decimal

    return q22_full_query(customer_dec, orders, F=F, zero=Decimal("0.00"))


ORDER_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW")
#: words of dbgen's text grammar (TPC-H spec 4.2.2.14)
_NOUNS = ("foxes", "ideas", "theodolites", "pinto beans", "instructions",
          "dependencies", "excuses", "platelets", "asymptotes", "courts",
          "dolphins", "multipliers", "sauternes", "warthogs", "frets",
          "dinos", "attainments", "somas", "Tiresias", "patterns", "forges",
          "braids", "hockey players", "frays", "warhorses", "dugouts",
          "notornis", "epitaphs", "pearls", "tithes", "waters", "orbits",
          "gifts", "sheaves", "depths", "sentiments", "decoys", "realms",
          "pains", "grouches", "escapades", "packages", "requests",
          "accounts", "deposits")
_VERBS = ("sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
          "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
          "sublate", "solve", "thrash", "promise", "engage", "hinder",
          "print", "x-ray", "breach", "eat", "grow", "impress", "mold",
          "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
          "kindle", "play", "hang", "believe", "doubt")
_ADJECTIVES = ("furious", "sly", "careful", "blithe", "quick", "fluffy",
               "slow", "quiet", "ruthless", "thin", "close", "dogged",
               "daring", "brave", "stealthy", "permanent", "enticing",
               "idle", "busy", "regular", "final", "ironic", "even", "bold",
               "silent", "special", "pending", "express", "unusual")
_ADVERBS = ("sometimes", "always", "never", "furiously", "slyly",
            "carefully", "blithely", "quickly", "fluffily", "slowly",
            "quietly", "ruthlessly", "thinly", "closely", "doggedly",
            "daringly", "bravely", "stealthily", "permanently",
            "enticingly", "idly", "busily", "regularly", "finally",
            "ironically", "evenly", "boldly", "silently")
_PREPOSITIONS = ("about", "above", "according to", "across", "after",
                 "against", "along", "alongside of", "among", "around",
                 "at", "atop", "before", "behind", "beneath", "beside",
                 "besides", "between", "beyond", "by", "despite", "during",
                 "except", "for", "from", "in place of", "inside",
                 "instead of", "into", "near", "of", "on", "outside",
                 "over", "past", "since", "through", "throughout", "to",
                 "toward", "under", "until", "up", "upon", "without",
                 "with", "within")
_TERMINATORS = (".", ";", ":", "?", "!", "--")


def text_pool(rng, sentences: int) -> bytes:
    """dbgen's text pool in miniature: sentences of the grammar's
    'adjective noun adverb verb preposition the adjective noun' shape."""
    parts = [(_ADJECTIVES, 1), (_NOUNS, 1), (_ADVERBS, 1), (_VERBS, 1),
             (_PREPOSITIONS, 1), (("the",), 0), (_ADJECTIVES, 1),
             (_NOUNS, 1)]
    cols = [np.asarray(words)[rng.integers(0, len(words), sentences)]
            for words, _ in parts]
    term = np.asarray(_TERMINATORS)[rng.integers(0, len(_TERMINATORS),
                                                 sentences)]
    return " ".join(" ".join(ws) + t for *ws, t in zip(*cols, term)).encode()


def _comments(rng, pool: np.ndarray, n: int) -> pa.Array:
    """n comments as dbgen's TEXT(19, 78) draws them: a random 19 to 78
    byte window of the text pool, built as an Arrow StringArray from
    offset and byte buffers."""
    lengths = rng.integers(19, 79, n)
    starts = rng.integers(0, len(pool) - 78, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    src = (np.arange(offsets[-1], dtype=np.int64)
           - np.repeat(offsets[:-1] - starts, lengths))
    return pa.LargeStringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(pool[src].tobytes())).cast(pa.string())


def write_orders_data(root: str, rows: int, files: int = 8, seed: int = 0
                      ) -> List[str]:
    """Write an ORDERS-shaped table under root/orders in `files` parquet
    files: o_orderkey (int64), o_orderpriority (one of TPC-H's 5, plain,
    not dictionary-encoded) and o_comment, dbgen's TEXT(19, 78): a random
    19 to 78 byte window of a text pool made from dbgen's grammar, cut
    mid-word as dbgen cuts it. The comments are built as an Arrow
    StringArray from offset and byte buffers; returns the paths."""
    out_dir = os.path.join(root, "orders")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(text_pool(rng, 100_000), dtype=np.uint8)
    prio = pa.array(ORDER_PRIORITIES)
    per = -(-rows // files)
    paths = []
    for i in range(files):
        n = min(per, rows - i * per)
        comment = _comments(rng, pool, n)
        t = pa.table({
            "o_orderkey": pa.array(np.arange(i * per, i * per + n) * 4 + 1,
                                   type=pa.int64()),
            "o_orderpriority": prio.take(pa.array(
                rng.integers(0, len(ORDER_PRIORITIES), n))),
            "o_comment": comment,
        })
        path = os.path.join(out_dir, f"orders-{i}.parquet")
        pq.write_table(t, path, compression="NONE", use_dictionary=False)
        paths.append(path)
    return paths


#: dbgen's order dates: STARTDATE 1992-01-01 to ENDDATE - 151 days
#: (1998-08-02), as days since 1970-01-01 (TPC-H spec 4.2.3)
ORDER_DATE_LO, ORDER_DATE_HI = 8035, 10440
#: o_totalprice's range in cents (the smallest and largest at SF1)
ORDER_PRICE_CENTS = (85_771, 55_528_516)


def orders_dated_draws(rows: int, files: int = 8, seed: int = 0):
    """The seeded draws of `write_orders_dated`, one dict of numpy arrays
    a file: o_orderkey (int64), priority (index into ORDER_PRIORITIES),
    o_orderdate (int32 days), cents (int64) and o_custkey (int64, from a
    generator of its own, so the other draws stay as they were)."""
    rng = np.random.default_rng(seed)
    crng = np.random.default_rng([seed, 3])
    per = -(-rows // files)
    out = []
    for i in range(files):
        n = min(per, rows - i * per)
        out.append(dict(
            o_orderkey=np.arange(i * per, i * per + n, dtype=np.int64) * 4 + 1,
            priority=rng.integers(0, len(ORDER_PRIORITIES), n),
            o_orderdate=rng.integers(ORDER_DATE_LO, ORDER_DATE_HI + 1,
                                     n).astype(np.int32),
            cents=rng.integers(ORDER_PRICE_CENTS[0], ORDER_PRICE_CENTS[1] + 1,
                               n),
            o_custkey=_custkeys(crng, n, rows)))
    return out


def _custkeys(rng, n: int, rows: int) -> np.ndarray:
    """o_custkey as dbgen draws it (TPC-H spec 4.2.3): uniform over
    [1, SF * 150,000] (SF = rows / 1,500,000), a multiple of 3 moved to
    the next key (the last key, itself a multiple of 3, to the one
    before): a third of the customers place no order."""
    top = max(rows // 10, 3)
    k = rng.integers(1, top + 1, n).astype(np.int64)
    k = k + (k % 3 == 0)
    return np.where(k > top, top - 1, k)


def write_orders_dated(root: str, rows: int, files: int = 8, seed: int = 0
                       ) -> Tuple[List[str], List[str]]:
    """Write ORDERS with its date and price twice from one set of seeded
    draws (`orders_dated_draws`), in `files` PLAIN parquet files each:
    root/orders_dated, typed (o_orderkey int64, o_orderpriority,
    o_orderdate date32 uniform over dbgen's order dates, o_totalprice
    float64 in whole cents, as the earlier slices' queries read it; TPC-H
    declares it decimal(15,2), as `orders_tbl_decimal_query` types the
    text), and root/orders_tbl, the same rows as
    dbgen's .tbl text prints them, every column a string (the key in
    decimal, the price as %.2f, the date as yyyy-MM-dd): what a CSV or
    .tbl load lands before typing. The typed table also holds o_custkey
    (int64, as dbgen draws it). Returns the two lists of paths."""
    import pyarrow.compute as pc

    prio = pa.array(ORDER_PRIORITIES)
    typed, text = [], []
    for sub in ("orders_dated", "orders_tbl"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, d in enumerate(orders_dated_draws(rows, files, seed)):
        key = pa.array(d["o_orderkey"])
        priority = prio.take(pa.array(d["priority"]))
        date = pa.array(d["o_orderdate"], type=pa.date32())
        cents = d["cents"]
        t = pa.table({"o_orderkey": key, "o_orderpriority": priority,
                      "o_orderdate": date,
                      "o_totalprice": pa.array(cents / 100.0),
                      "o_custkey": pa.array(d["o_custkey"])})
        price = pc.binary_join_element_wise(
            pc.cast(pa.array(cents // 100), pa.string()),
            pc.utf8_lpad(pc.cast(pa.array(cents % 100), pa.string()), 2, "0"),
            ".")
        tbl = pa.table({"o_orderkey": pc.cast(key, pa.string()),
                        "o_orderpriority": priority,
                        "o_orderdate": pc.cast(date, pa.string()),
                        "o_totalprice": price})
        for table, sub, paths in ((t, "orders_dated", typed),
                                  (tbl, "orders_tbl", text)):
            path = os.path.join(root, sub, f"{sub}-{i}.parquet")
            pq.write_table(table, path, compression="NONE",
                           use_dictionary=False)
            paths.append(path)
    return typed, text


#: TPC-H's market segments (spec 4.2.2.13: SEGMENTS)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
#: the price bands of orders_price_bands_query: [lo, hi) in o_totalprice,
#: covering part of the price range only; the last lies above every price
PRICE_BANDS = tuple((k * 40_000.0, k * 40_000.0 + 25_000.0)
                    for k in range(9)) + ((600_000.0, 700_000.0),)


def customer_draws(customers: int, seed: int = 0) -> dict:
    """The seeded draws of CUSTOMER (`write_customer_data`, and
    `write_decimal_data`'s customer_dec from the same balances): nation
    (0-24), phone (a pyarrow string array), segment (index into SEGMENTS)
    and cents (c_acctbal in cents, -99,999 to 999,999), in that order from
    one generator."""
    import pyarrow.compute as pc

    rng = np.random.default_rng([seed, 5])
    nation = rng.integers(0, 25, customers)
    digits = [pc.cast(pa.array(rng.integers(lo, hi, customers)), pa.string())
              for lo, hi in ((100, 1000), (100, 1000), (1000, 10000))]
    phone = pc.binary_join_element_wise(
        pc.cast(pa.array(nation + 10), pa.string()), *digits, "-")
    segment = rng.integers(0, len(SEGMENTS), customers)
    cents = rng.integers(-99_999, 1_000_000, customers)
    return dict(nation=nation, phone=phone, segment=segment, cents=cents)


def write_customer_data(root: str, customers: int, orders: int,
                        files: int = 8, seed: int = 0) -> dict:
    """Write the tables of the join queries under root, PLAIN parquet:

    - customer/ (one file): CUSTOMER as dbgen makes it (TPC-H spec 4.2.3):
      c_custkey 1..customers, c_nationkey 0-24, c_acctbal in cents from
      -999.99 to 9,999.99, c_mktsegment one of SEGMENTS, dictionary-encoded
      in SEGMENTS' order, and c_phone, whose first two digits are
      c_nationkey + 10 (then 3, 3 and 4 random digits);
    - orders_cust/ (`files` files): ORDERS with o_orderkey,
      o_orderpriority, o_orderdate, o_totalprice and o_custkey drawn as
      `orders_dated_draws` draws them (a third of the customers place no
      order) and o_comment as `write_orders_data` draws it, from a
      generator of its own;
    - bands/: PRICE_BANDS as b_band (int32), b_lo and b_hi (float64);
    - quota/: one row per segment, q_mktsegment dictionary-encoded in
      SEGMENTS' reverse order, and q_quota (float64).

    Returns {table: [paths]}."""
    import pyarrow.compute as pc

    out = {}
    for sub in ("customer", "orders_cust", "bands", "quota"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    d = customer_draws(customers, seed)
    t = pa.table({
        "c_custkey": pa.array(np.arange(1, customers + 1, dtype=np.int64)),
        "c_nationkey": pa.array(d["nation"].astype(np.int64)),
        "c_acctbal": pa.array(d["cents"] / 100.0),
        "c_mktsegment": pa.DictionaryArray.from_arrays(
            pa.array(d["segment"].astype(np.int32)), pa.array(SEGMENTS)),
        "c_phone": d["phone"]})
    path = os.path.join(root, "customer", "customer-0.parquet")
    pq.write_table(t, path, compression="NONE",
                   use_dictionary=["c_mktsegment"])
    out["customer"] = [path]
    crng = np.random.default_rng([seed, 4])
    pool = np.frombuffer(text_pool(crng, 100_000), dtype=np.uint8)
    prio = pa.array(ORDER_PRIORITIES)
    out["orders_cust"] = []
    for i, d in enumerate(orders_dated_draws(orders, files, seed)):
        n = len(d["o_orderkey"])
        t = pa.table({
            "o_orderkey": pa.array(d["o_orderkey"]),
            "o_custkey": pa.array(d["o_custkey"]),
            "o_orderpriority": prio.take(pa.array(d["priority"])),
            "o_orderdate": pa.array(d["o_orderdate"], type=pa.date32()),
            "o_totalprice": pa.array(d["cents"] / 100.0),
            "o_comment": _comments(crng, pool, n)})
        path = os.path.join(root, "orders_cust", f"orders_cust-{i}.parquet")
        pq.write_table(t, path, compression="NONE", use_dictionary=False)
        out["orders_cust"].append(path)
    bands = pa.table({
        "b_band": pa.array(np.arange(len(PRICE_BANDS), dtype=np.int32)),
        "b_lo": pa.array([lo for lo, _ in PRICE_BANDS]),
        "b_hi": pa.array([hi for _, hi in PRICE_BANDS])})
    rev = SEGMENTS[::-1]
    quota = pa.table({
        "q_mktsegment": pa.DictionaryArray.from_arrays(
            pa.array(np.arange(len(rev), dtype=np.int32)), pa.array(rev)),
        "q_quota": pa.array([1000.0 * (k + 1) for k in range(len(rev))])})
    for name, table, enc in (("bands", bands, False),
                             ("quota", quota, ["q_mktsegment"])):
        path = os.path.join(root, name, f"{name}-0.parquet")
        pq.write_table(table, path, compression="NONE", use_dictionary=enc)
        out[name] = [path]
    return out


#: TPC-H q1's ship-date cutoff: 1998-12-01 less the default DELTA of 90
#: days (spec 2.4.1.3)
Q1_SHIP_CUTOFF = "1998-09-02"
#: dbgen's CURRENTDATE (1995-06-17, spec 4.2.3) as days since 1970-01-01:
#: the return flag and line status are drawn against it
LINEITEM_CURRENT_DATE = 9298
#: LINEITEM's return flags and line statuses, dictionary-encoded in this
#: order
RETURN_FLAGS = ("A", "N", "R")
LINE_STATUSES = ("F", "O")
#: LINEITEM rows at SF10 (dbgen's count)
SF10_LINEITEM = 59_986_052


def lineitem_draws(rows: int, files: int = 8, seed: int = 0):
    """The seeded draws of `write_decimal_data`'s LINEITEM, one dict of
    numpy arrays a file, drawn as dbgen draws them (TPC-H spec 4.2.3):
    quantity 1-50; the part key uniform over [1, SF * 200,000] (SF =
    rows / 6,000,000, at least 1) and the extended price quantity times
    its retail price, (90,000 + (key / 10) mod 20,001 + 100 * (key mod
    1,000)) cents; discount 0-10 and tax 0-8 cents on the unit; the ship
    date an order date (uniform over dbgen's, ORDER_DATE_LO-HI) plus 1-121
    days and the receipt date 1-30 days after it; the return flag R or A
    at random where the receipt date is on or before CURRENTDATE, else N;
    the line status O where the ship date is after it, else F. Each value
    in hundredths (qty_c, price_c, disc_c, tax_c: int64), flag and status
    as indices into RETURN_FLAGS and LINE_STATUSES, shipdate int32
    days."""
    rng = np.random.default_rng([seed, 7])
    parts = max(rows // 30, 200_000)
    per = -(-rows // files)
    out = []
    for i in range(files):
        n = min(per, rows - i * per)
        qty = rng.integers(1, 51, n)
        key = rng.integers(1, parts + 1, n)
        retail = 90_000 + (key // 10) % 20_001 + 100 * (key % 1_000)
        ship = (rng.integers(ORDER_DATE_LO, ORDER_DATE_HI + 1, n)
                + rng.integers(1, 122, n))
        receipt = ship + rng.integers(1, 31, n)
        returned = receipt <= LINEITEM_CURRENT_DATE
        flag = np.where(returned, np.where(rng.random(n) < 0.5, 0, 2), 1)
        out.append(dict(
            qty_c=qty * 100, price_c=qty * retail,
            disc_c=rng.integers(0, 11, n), tax_c=rng.integers(0, 9, n),
            flag=flag.astype(np.int32),
            status=(ship > LINEITEM_CURRENT_DATE).astype(np.int32),
            shipdate=ship.astype(np.int32)))
    return out


def decimal_array(cents: np.ndarray, precision: int, scale: int
                  ) -> pa.Array:
    """An int64 vector of unscaled values as an Arrow decimal128 array."""
    from spark_rapids_tpu_torch.columnar.arrow_bridge import _decimal_array
    from spark_rapids_tpu_torch.sqltypes import DecimalType

    return _decimal_array(np.asarray(cents, dtype=np.int64),
                          np.ones(len(cents), dtype=bool),
                          DecimalType(precision, scale))


def write_decimal_data(root: str, lineitem: int, customers: int,
                       files: int = 8, seed: int = 0, lines=None) -> dict:
    """Write the decimal queries' tables under root, PLAIN parquet:

    - lineitem/ (`files` files): LINEITEM as `lineitem_draws` draws it,
      l_quantity, l_extendedprice, l_discount and l_tax decimal(15,2) as
      TPC-H declares them, l_returnflag and l_linestatus
      dictionary-encoded, l_shipdate a date;
    - customer_dec/ (one file): `write_customer_data`'s CUSTOMER with
      c_acctbal as decimal(15,2) from the same cents.

    A decimal(<= 18) is stored as a parquet INT64 (INT32 up to 9 digits),
    as Spark's writer stores it, where this pyarrow can (its
    `store_decimal_as_integer`). `lines`: the `lineitem_draws` of these
    arguments, when the caller has them. Returns {table: [paths]}."""
    out = {"lineitem": []}
    for sub in ("lineitem", "customer_dec"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    flags, statuses = pa.array(RETURN_FLAGS), pa.array(LINE_STATUSES)
    for i, d in enumerate(lines or lineitem_draws(lineitem, files, seed)):
        t = pa.table({
            "l_quantity": decimal_array(d["qty_c"], 15, 2),
            "l_extendedprice": decimal_array(d["price_c"], 15, 2),
            "l_discount": decimal_array(d["disc_c"], 15, 2),
            "l_tax": decimal_array(d["tax_c"], 15, 2),
            "l_returnflag": pa.DictionaryArray.from_arrays(
                pa.array(d["flag"]), flags),
            "l_linestatus": pa.DictionaryArray.from_arrays(
                pa.array(d["status"]), statuses),
            "l_shipdate": pa.array(d["shipdate"], type=pa.date32())})
        path = os.path.join(root, "lineitem", f"lineitem-{i}.parquet")
        _write_decimal_table(t, path, ["l_returnflag", "l_linestatus"])
        out["lineitem"].append(path)
    d = customer_draws(customers, seed)
    t = pa.table({
        "c_custkey": pa.array(np.arange(1, customers + 1, dtype=np.int64)),
        "c_nationkey": pa.array(d["nation"].astype(np.int64)),
        "c_acctbal": decimal_array(d["cents"], 15, 2),
        "c_phone": d["phone"]})
    path = os.path.join(root, "customer_dec", "customer_dec-0.parquet")
    _write_decimal_table(t, path, False)
    out["customer_dec"] = [path]
    return out


def _write_decimal_table(table: pa.Table, path: str, use_dictionary
                         ) -> None:
    try:
        pq.write_table(table, path, compression="NONE",
                       use_dictionary=use_dictionary,
                       store_decimal_as_integer=True)
    except TypeError:  # a pyarrow without the option: FIXED_LEN_BYTE_ARRAY
        pq.write_table(table, path, compression="NONE",
                       use_dictionary=use_dictionary)


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


# ------------------------------------------------------------ nested orders

#: TPC-H's ship modes (spec 4.2.2.13: MODES)
SHIP_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")


def nested_orders_draws(orders: int, lineitem: int, files: int = 8,
                        seed: int = 0, lines=None):
    """The draws of NESTED_ORDERS: `orders_dated_draws`' ORDERS (all
    files' rows concatenated), each order's line count uniform over 1-7
    as dbgen draws it, then moved by one on seeded orders until the counts
    sum to `lineitem` exactly (>= orders), the `lineitem_draws` LINEITEM
    rows of `write_decimal_data` (the same seed, so the same lines) in
    order, each order's own lines being the next count of them, a ship
    mode a line (an index into SHIP_MODES) and a clerk an order (1 to
    SF * 1,000); `lines` takes the caller's `lineitem_draws(lineitem,
    files, seed)`. Returns (orders dict, counts int32, lines dict, modes,
    clerks)."""
    if lineitem < orders:
        raise ValueError(f"{lineitem} lines cannot give {orders} orders "
                         "one line each")
    o = orders_dated_draws(orders, files, seed)
    o = {k: np.concatenate([d[k] for d in o]) for k in o[0]}
    rng = np.random.default_rng([seed, 11])
    counts = rng.integers(1, 8, orders)
    diff = lineitem - int(counts.sum())
    while diff:
        room = np.flatnonzero(counts < 7 if diff > 0 else counts > 1)
        pick = rng.choice(room, size=min(abs(diff), len(room)),
                          replace=False)
        counts[pick] += 1 if diff > 0 else -1
        diff = lineitem - int(counts.sum())
    lines = lines or lineitem_draws(lineitem, files, seed)
    lines = {k: np.concatenate([d[k] for d in lines]) for k in lines[0]}
    modes = rng.integers(0, len(SHIP_MODES), lineitem)
    clerks = rng.integers(1, max(orders // 1500, 1) + 1, orders)
    return o, counts.astype(np.int32), lines, modes, clerks


def _nested_orders_table(draws, files: int, i: int) -> pa.Table:
    """File i's rows of NESTED_ORDERS (`nested_orders_tables`)."""
    o, counts, lines, modes, clerks = draws
    orders = len(counts)
    offsets = np.zeros(orders + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    per = -(-orders // files)
    lo, hi = i * per, min((i + 1) * per, orders)
    a, b = int(offsets[lo]), int(offsets[hi])
    off = offsets[lo:hi + 1] - a
    n_open = np.add.reduceat(lines["status"][a:b], off[:-1]) \
        if hi > lo else np.zeros(0, dtype=np.int64)
    status = np.where(n_open == 0, 0,
                      np.where(n_open == counts[lo:hi], 1, 2))
    line_no = (np.arange(b - a, dtype=np.int64)
               - np.repeat(off[:-1], counts[lo:hi]) + 1).astype(np.int32)
    off = pa.array(off.astype(np.int32))

    def lst(values):
        return pa.ListArray.from_arrays(off, values)

    price = pa.array(lines["price_c"][a:b] / 100.0)
    return pa.table({
        "o_orderkey": pa.array(o["o_orderkey"][lo:hi]),
        "o_custkey": pa.array(o["o_custkey"][lo:hi]),
        "o_orderdate": pa.array(o["o_orderdate"][lo:hi], type=pa.date32()),
        "o_totalprice": pa.array(o["cents"][lo:hi] / 100.0),
        "o_orderstatus": pa.array(["F", "O", "P"]).take(pa.array(status)),
        "o_info": pa.StructArray.from_arrays(
            [pa.array(ORDER_PRIORITIES).take(pa.array(o["priority"][lo:hi])),
             pa.array(clerks[lo:hi].astype(np.int32)),
             pa.array(np.zeros(hi - lo, dtype=np.int32))],
            names=["priority", "clerk", "shippriority"]),
        "l_quantity": lst(pa.array(
            (lines["qty_c"][a:b] // 100).astype(np.int32))),
        "l_extendedprice": lst(price),
        "l_shipdate": lst(pa.array(lines["shipdate"][a:b],
                                   type=pa.date32())),
        "l_shipmode": lst(pa.array(SHIP_MODES).take(pa.array(modes[a:b]))),
        "l_price_by_line": pa.MapArray.from_arrays(
            off, pa.array(line_no), price)})


def nested_orders_tables(orders: int, lineitem: int, files: int = 8,
                         seed: int = 0, draws=None) -> List[pa.Table]:
    """NESTED_ORDERS in `files` tables: ORDERS at one row an order
    (o_orderkey, o_custkey int64, o_orderdate date32, o_totalprice
    float64, o_orderstatus F, O or P from its lines' statuses as dbgen
    derives it, o_info struct<priority: string, clerk: int, shippriority:
    int>) carrying its own LINEITEM rows as parallel arrays (l_quantity
    array<int>, l_extendedprice array<double>, l_shipdate array<date>,
    l_shipmode array<string>) and l_price_by_line map<int, double> from
    line number (1-7) to price, all built from offsets with
    pa.ListArray.from_arrays (`nested_orders_draws`, or `draws` when the
    caller has them)."""
    draws = draws or nested_orders_draws(orders, lineitem, files, seed)
    return [_nested_orders_table(draws, files, i) for i in range(files)]


def write_nested_orders(root: str, orders: int, lineitem: int,
                        files: int = 8, seed: int = 0,
                        draws=None) -> List[str]:
    """Write NESTED_ORDERS (`nested_orders_tables`) under
    root/nested_orders, PLAIN parquet, one file a table, the files built
    and written in parallel threads. Returns the paths."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(os.path.join(root, "nested_orders"), exist_ok=True)
    draws = draws or nested_orders_draws(orders, lineitem, files, seed)

    def write(i):
        path = os.path.join(root, "nested_orders",
                            f"nested_orders-{i}.parquet")
        pq.write_table(_nested_orders_table(draws, files, i), path,
                       compression="NONE", use_dictionary=False)
        return path

    with ThreadPoolExecutor(max_workers=min(files, 8)) as pool:
        return list(pool.map(write, range(files)))


def nested_explode_query(orders, F=None):
    """The flattening every nested pipeline does: posexplode the order's
    quantities, then sum and count the lines by (o_orderstatus, line
    position)."""
    F = _functions(F)
    return (orders.select("o_orderstatus", F.posexplode("l_quantity"))
            .groupBy("o_orderstatus", "pos")
            .agg(F.sum("col").alias("qty"), F.count("col").alias("lines")))


def nested_item_stats_query(orders, F=None):
    """Per order: its line count, largest price, whether any line ships
    by AIR (over the array<string> cube), its largest quantity (the first
    of the quantities sorted descending), its distinct quantities and
    quantities over 25, the first line's price and whether a seventh line
    exists (the map); then sums and counts by o_info.priority."""
    F = _functions(F)
    per_order = orders.select(
        F.col("o_info").getField("priority").alias("priority"),
        F.size("l_quantity").alias("n_lines"),
        F.array_max("l_extendedprice").alias("max_price"),
        F.array_contains("l_shipmode", F.lit("AIR")).alias("air"),
        F.element_at(F.sort_array("l_quantity", False), 1).alias("top_qty"),
        F.size(F.array_distinct("l_quantity")).alias("n_distinct"),
        F.size(F.filter_array("l_quantity", lambda x: x > 25))
        .alias("n_big"),
        F.element_at("l_price_by_line", 1).alias("first_price"),
        F.map_contains_key("l_price_by_line", 7).alias("has7"))
    return per_order.groupBy("priority").agg(
        F.count("*").alias("orders"),
        F.sum("n_lines").alias("lines"),
        F.sum("max_price").alias("sum_max_price"),
        F.sum(F.col("air").cast("int")).alias("air_orders"),
        F.sum("top_qty").alias("sum_top_qty"),
        F.sum("n_distinct").alias("sum_distinct"),
        F.sum("n_big").alias("big_lines"),
        F.sum("first_price").alias("sum_first_price"),
        F.sum(F.col("has7").cast("int")).alias("seven_line_orders"))


def customer_order_lists_query(orders, F=None):
    """Each customer's orders and order years as arrays: collect_list of
    o_orderkey and collect_set of year(o_orderdate) by o_custkey, with
    their sizes, the years sorted and a struct of the key and its order
    count."""
    F = _functions(F)
    lists = orders.groupBy("o_custkey").agg(
        F.collect_list("o_orderkey").alias("order_keys"),
        F.collect_set(F.year("o_orderdate")).alias("years"))
    return lists.select(
        "o_custkey", "order_keys",
        F.size("order_keys").alias("n_orders"),
        F.size("years").alias("n_years"),
        F.sort_array("years").alias("years_sorted"),
        F.struct("o_custkey", F.size("order_keys").alias("n"))
        .alias("summary"))


def recent_orders_window_query(orders, F=None, Window=None):
    """The per-customer recent-orders feature table: over each customer's
    orders in (o_orderdate, o_orderkey) order, the prices of the order and
    the two before it (collect_list over ROWS 2 PRECEDING to CURRENT ROW)
    and the distinct years of the order and the five before it
    (collect_set over ROWS 5 PRECEDING to CURRENT ROW). `Window` is the
    window builder of the package `F` belongs to (the port's by
    default)."""
    F = _functions(F)
    if Window is None:
        from spark_rapids_tpu_torch.api.window import Window
    w = Window.partitionBy("o_custkey").orderBy("o_orderdate", "o_orderkey")
    # the flat columns first: a struct payload stays off the device window
    # in both packages
    flat = orders.select("o_orderkey", "o_custkey", "o_orderdate",
                         "o_totalprice")
    return flat.select(
        "o_orderkey", "o_custkey",
        F.collect_list("o_totalprice").over(w.rowsBetween(-2, 0))
        .alias("last3_prices"),
        F.collect_set(F.year("o_orderdate")).over(w.rowsBetween(-5, 0))
        .alias("recent_years"))


# ------------------------------------------------ Delta Lake: ORDERS upkeep
#
# The upkeep of an ORDERS fact table kept as a Delta table: written once
# with deletion vectors enabled, clustered by OPTIMIZE ZORDER BY on the
# columns dashboards filter by (o_custkey, o_orderdate), then TPC-H's
# refresh functions as MERGEs (RF1 inserts SF x 1,500 new orders, RF2
# deletes SF x 1,500 old ones), a retention DELETE and a request DELETE
# through deletion vectors, and an UPDATE of a priority. `DeltaTable` and
# `F` are the package's own (the port's by default), so the tests run the
# same steps through the JAX package's session.

#: the retention DELETE's cutoff (about a seventh of dbgen's order dates)
DELTA_RETENTION_DATE = "1993-01-01"
#: the Z-order probe's month of o_orderdate, as ISO dates (the log's
#: statistics hold dates so)
ZORDER_PROBE_MONTH = ("1995-06-01", "1995-06-30")


def _delta_table(DeltaTable):
    if DeltaTable is None:
        from spark_rapids_tpu_torch.lakehouse.delta import DeltaTable
    return DeltaTable


def refresh_draws(rows: int, seed: int = 0) -> dict:
    """TPC-H's refresh sets for ORDERS of `rows` rows (SF = rows /
    1,500,000): RF1's SF x 1,500 new orders, keyed in the holes of
    dbgen's sparse key space (4i + 3, where the table holds 4i + 1), the
    other columns drawn as `orders_dated_draws` draws them, and RF2's SF x
    1,500 existing keys to delete. Returns {"rf1": Arrow table in ORDERS'
    column order, "rf2": Arrow table of o_orderkey}."""
    rng = np.random.default_rng([seed, 13])
    n = max(1, rows // 1000)
    slots = np.sort(rng.choice(rows, n, replace=False)).astype(np.int64)
    prio = pa.array(ORDER_PRIORITIES)
    rf1 = pa.table({
        "o_orderkey": pa.array(slots * 4 + 3),
        "o_orderpriority": prio.take(pa.array(
            rng.integers(0, len(ORDER_PRIORITIES), n))),
        "o_orderdate": pa.array(rng.integers(
            ORDER_DATE_LO, ORDER_DATE_HI + 1, n).astype(np.int32),
            type=pa.date32()),
        "o_totalprice": pa.array(rng.integers(
            ORDER_PRICE_CENTS[0], ORDER_PRICE_CENTS[1] + 1, n) / 100.0),
        "o_custkey": pa.array(_custkeys(rng, n, rows)),
    })
    gone = np.sort(rng.choice(rows, n, replace=False)).astype(np.int64)
    return {"rf1": rf1, "rf2": pa.table({"o_orderkey": gone * 4 + 1})}


def request_delete_custkey(rows: int) -> int:
    """The request DELETE's bound: o_custkey below it (about 3 % of the
    customers of ORDERS of `rows` rows)."""
    return max(2, rows // 300)


def update_price_cutoff() -> float:
    """The UPDATE's bound: o_totalprice above it (the top 1 % of dbgen's
    price range)."""
    lo, hi = ORDER_PRICE_CENTS
    return (hi - (hi - lo) // 100) / 100.0


def delta_write(orders, path: str) -> None:
    """Write ORDERS as a Delta table with deletion vectors enabled."""
    (orders.write.format("delta")
     .option("delta.enableDeletionVectors", "true").save(path))


def delta_priority_summary_query(orders, F=None):
    """The read-back: orders and revenue per priority."""
    F = _functions(F)
    return orders.groupBy("o_orderpriority").agg(
        F.count("*").alias("orders"),
        F.sum("o_totalprice").alias("revenue"))


def delta_zorder(spark, path: str, DeltaTable=None) -> None:
    """OPTIMIZE ZORDER BY (o_custkey, o_orderdate)."""
    (_delta_table(DeltaTable).forPath(spark, path).optimize()
     .executeZOrderBy("o_custkey", "o_orderdate"))


def zorder_probe_bounds(rows: int) -> Tuple[int, int]:
    """zorder_probe's o_custkey range: 1 % of the customers of ORDERS of
    `rows` rows, from the middle."""
    top = max(rows // 10, 3)
    lo = top // 2
    return lo, lo + max(1, top // 100)


def zorder_probe(rows: int, F=None):
    """A dashboard's filter, for file pruning by the log's statistics:
    o_custkey within zorder_probe_bounds, o_orderdate within
    ZORDER_PROBE_MONTH (ISO strings, as the statistics hold dates; the
    filter serves the statistics, not a query)."""
    F = _functions(F)
    lo, hi = zorder_probe_bounds(rows)
    c = F.col("o_custkey")
    d = F.col("o_orderdate")
    return ((c >= F.lit(lo)) & (c <= F.lit(hi))
            & (d >= F.lit(ZORDER_PROBE_MONTH[0]))
            & (d <= F.lit(ZORDER_PROBE_MONTH[1])))


def delta_rf1(spark, path: str, new_orders, DeltaTable=None) -> None:
    """TPC-H RF1 as a MERGE: insert the new orders not in the table."""
    (_delta_table(DeltaTable).forPath(spark, path)
     .merge(spark.createDataFrame(new_orders), "o_orderkey")
     .whenNotMatchedInsertAll().execute())


def delta_rf2(spark, path: str, old_keys, DeltaTable=None) -> None:
    """TPC-H RF2 as a MERGE: delete the orders of the given keys."""
    (_delta_table(DeltaTable).forPath(spark, path)
     .merge(spark.createDataFrame(old_keys), "o_orderkey")
     .whenMatchedDelete().execute())


def delta_retention_delete(spark, path: str, F=None,
                           DeltaTable=None) -> None:
    """DELETE WHERE o_orderdate < DELTA_RETENTION_DATE (deletion vectors
    on a table that enables them)."""
    F = _functions(F)
    (_delta_table(DeltaTable).forPath(spark, path).delete(
        F.col("o_orderdate") < F.to_date(F.lit(DELTA_RETENTION_DATE))))


def delta_request_delete(spark, path: str, rows: int, F=None,
                         DeltaTable=None) -> None:
    """DELETE WHERE o_custkey < request_delete_custkey(rows)."""
    F = _functions(F)
    (_delta_table(DeltaTable).forPath(spark, path).delete(
        F.col("o_custkey") < F.lit(request_delete_custkey(rows))))


def delta_update(spark, path: str, F=None, DeltaTable=None) -> None:
    """UPDATE SET o_orderpriority = '1-URGENT' WHERE o_totalprice >
    update_price_cutoff()."""
    F = _functions(F)
    (_delta_table(DeltaTable).forPath(spark, path).update(
        F.col("o_totalprice") > F.lit(update_price_cutoff()),
        {"o_orderpriority": "1-URGENT"}))
