"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit; build the port's CUDA kernels from
   spark_rapids_tpu_torch/kernels/csrc with nvcc (sm_90a, one process
   per source, all started together). Phases 3-14's seeded data and
   oracles are made meanwhile, in three worker processes (HOST_JOBS),
   while phases 1 and 2 run; phase 15's, in a freed worker, while phases
   11-14 run (its Morton order once the Delta write has named its
   files);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the q5 path gives it (bench.py's full size: 8 parts of 4.5M
   rows): K1-K4, K5 (bloom build and might_contain), K6 (murmur3
   partition ids), K7 (partition_by_ids), K8 (the batch gather), K9
   (orderable key words and their stable radix sort), K10 (group
   boundaries), K11 (dense bin permutation), K12 (segmented min/max, at
   the fused window's 37,748,736 sorted positions), K13 (the merge of two
   sorted 2^22-row runs), K14 (the window's frame prefix, restarted at
   each partition for float64 sums, its inverse permutation and its
   evaluation with the write-back to input order, percent_rank, cume_dist
   and ntile included), K15 (RANGE frame bounds), K16 (min/max frames)
   and K17 (first/last and lead/lag source rows), with the device time of
   the kernel, the plain version and, where one exists, one PyTorch
   library call computing the same function (a call of 1 ms or more: its
   CUDA-event time; a shorter one: torch.profiler's summed durations of
   what it runs on the card, so host dispatch is not counted, or its
   CUDA-event time where three traces in a row hold no device events or
   the sum falls under the kernel's bound, named in the output), and the
   kernel's bound (the bytes this
   run's data needs, at 3.35 TB/s, the H100 SXM's rate); K9's sort also
   at the 65,536-row build sort, 2^24 rows of heavy ties and 2^22 random
   keys; then edge shapes (partial tiles, several key words, null keys,
   dead rows, every string tail length, -0.0 and NaN, INT64_MIN, 1 to 7
   sort keys of every kind in both directions, 1 to 200 partitions, leaf
   widths no multiple of 4; K12 over every type with NaN and -0.0, K13
   with empty, dead and string runs, K14 at 1 to 70,001 rows; K15-K17
   and K14's new kinds at 1 to 70,001 rows and every row dead, over every
   key and value type with nulls, NaN, +-inf and -0.0, empty frames and
   offsets past any partition), exact but for K14's float64 sums (1e-9
   relative); K18-K21 (slice 6's string kernels: the regex DFA walk, the
   needle search, the byte rewrite and the span assembly) at the path
   shapes, 15,000,000 ORDERS comments of width 128 and 36,000,000 decoded
   `region` rows of width 16 (their plain versions in 2^20-row pieces),
   and at edge shapes: every length 0 to the width at widths 8, 12, 16,
   24, 64 and 128, 1- to 4-byte characters, characters cut at the row's
   end, bare continuation bytes, null rows, needles longer than the row,
   self-overlapping or empty, empty pads and separators, Substring at
   negative and zero positions, SubstringIndex at negative counts,
   patterns anchored at ^, $ and neither, and a DFA too large for shared
   memory; K22-K24 (slice 7's string parse, time-zone rebase and text
   format) in every mode at the path shapes, the text of 15,000,000 ORDERS
   rows (dates, keys, prices and booleans of width 8 and 16), their LA
   midnights and their dates, keys and wall clocks, and at edge shapes
   (`check_slice7_edges`: the cast edge sets with random strings at widths
   8 to 64, a literal as a row-stride-0 view, every transition of three
   zones, the int64 and calendar ends, every DateFormat token); K4's
   multi-sum (k = 5 and 8), K25 (rank selection and interpolation) and
   K26 (collect ranks and scatter) at the slice-8 path shapes (a 2^20-row
   batch of the price statistics in 35 groups, the daily line's
   2^20-row partial and its 2,406 sorted price rows) and at edge shapes
   (`check_slice8_edges`: k = 1 to 16, the privatised bins' limit, groups
   of one row, all-NaN and empty groups, ties at a target, max_elems = 1,
   every element kind with NaN, -0.0 and nulls); K27 (the join's probe
   marks, build marks and coverage), K28 (the round-robin partition) and
   K29 (the dictionary re-encode) at the slice-9 path shapes (150,000,000
   pair slots of 2^28 into 2^24 marks and into the bands' marks, 900,000
   probe ranges into 2^20 build rows, 4,500,000 rows into 16 partitions,
   1,500,000 codes through 5 entries) and at edge shapes
   (`check_slice9_edges`: no pairs, all and none ok, int64 indices,
   clipped and ORed marks, ranges past the build's end, n = 1 and n
   above the rows, codes at 0, K - 1 and past K, the shared-memory
   table's limit, and whole joins on the card against the CPU over null,
   NaN and -0.0 keys and empty sides); K30 (xxhash64) and K24's hex mode
   at the slice-10 path shapes (15,000,000 rows of orders_hash_sample's
   MinHash key: o_custkey, o_orderpriority's 16-byte and o_comment's
   128-byte rows; o_orderkey alone; the hex of 15,000,000 int64 values)
   and at edge shapes (`check_slice10_edges`: every key kind with int32
   and int64 limits, -0.0, NaNs and +-inf, strings of 0-130 bytes at
   aligned and unaligned widths, nulls first, in the middle and last,
   chains past the 8 columns of one launch; hex at 0, +-1, the powers of
   16 and the int64 ends); K31 (decimal128), K32 (seg_sum128) and the
   decimal modes of K22 and K24 at the slice-11 path shapes (q1's
   59,986,052 price and discount pairs multiplied into decimal(32,4)
   limbs and 1 - discount subtracted, the products summed in 6 sorted
   groups and in 1,024 bins; 15,000,000 balances widened to decimal(38,6)
   and compared, decimal(25,2) sums averaged over counts, to double and to
   long; ORDERS' 15,000,000 price texts parsed to decimal(15,2) and
   15,000,000 narrow and wide decimals printed) and at edge shapes
   (`check_slice11_edges`: values near +-10^38, +-2^63, +-2^64 and the
   128-bit ends, HALF_UP ties of both signs, shifts -38 to 38, counts of
   1, 3 and past 2^32, sums wrapping mod 2^128 into segments in and past
   shared memory, texts with signs, exponents and 19+ digits, -0.05, and
   K9's pack and sort of decimal(38,2) keys), and MonthsBetween on the
   card over dates and timestamps, with and without roundOff, bit for
   bit against a numpy float64 oracle with true division; K33
   (frame_collect), K34 (array_compact, array_distinct) and K35
   (array_sort) at the slice-12 path shapes (15,000,000 orders in about
   1,000,000 customers sorted by date and key, collect_list of float64
   prices over 3 rows and collect_set of int32 years over 6; [2^24, 8]
   int32 quantities of 1-7 elements filtered, deduplicated and sorted
   descending) and at edge shapes (`check_slice12_edges`: W = 1, 3, 6
   and 1,024, every element type with NaN, +-inf, -0.0, INT_MIN and
   INT_MAX, nulls, empty and all-null rows, dead rows, max_elems 1 to 64,
   cubes of empty strings), floats bit for bit; K36 (the Z-order
   interleave) at OPTIMIZE ZORDER BY's shape (the o_custkey and
   o_orderdate ranks of 15,000,000 ORDERS rows in capacity 2^24, from
   column_ranks, which must equal a numpy stable-argsort oracle) and at
   edge shapes (`check_slice13_edges`: n = 1-5, 8, 63, 64 and 65 rank
   columns at capacities 1,024 and 2^24, column_ranks over every key
   type with nulls, NaN, +-inf, -0.0, ties and dead rows, all-dead
   batches, and zorder_sort against the numpy Morton order). K10's and
   K13's library calls (torch.unique_consecutive over the sorted words; a
   stable torch.sort chain over both runs' words) are checked equal to
   their kernels before they are timed;
3. slice 1's hand-built q5 plan at the bench's full size (36M fact rows
   in 8 parquet files, a 2,000-row dimension with a dictionary-encoded
   `region`) over device-cached relations: upload, one cold run and 5
   hot runs, each checked against a pyarrow oracle (groups equal, counts
   exact, sums and averages within 1e-9 relative);
4. q5 and the duplicate-key join (a 4,000-row dimension, 2 rows per
   store) through the port's session: `read.parquet(...).cache(
   storage="device")`, the DataFrame API, the optimizer, the planner and
   the adaptive (`aqe`) engine, checked against pyarrow oracles in the
   same way; the engine and the adaptive decisions are printed;
5. the same two queries with bench.py's conf, where the fused engine is
   on: both must run on it, q5 keeping its lookup join and dupjoin losing
   the lookup bet, and equal the oracles;
6. ScaleTest's sort, TopN, distinct and window shapes over the same
   tables (q5.py: topn_query, sorted_q5_query, dedup_query, window_query)
   on the adaptive and the fused engine, against pyarrow/numpy oracles:
   the first 100 rows by amount, q5 in revenue order, the sorted distinct
   (store, qty) pairs, and per (store, day) peer run the rank, dense rank
   and running sum (1e-9 relative) with row numbers that permute the run's
   positions. The window must launch K12 and K14 on both engines, and the
   TopN's final sort on the adaptive engine K13 (it merges one sorted run
   per map block); each query's peak device bytes are printed;
7. slice 5's window queries over the same facts (q5.py: running_query,
   moving_query, range_query, u2u_query) on the adaptive and the fused
   engine at spark.rapids.sql.batchSizeRows 2^20, against numpy oracles:
   every row's running ranks, sums, minima, maxima and counts, moving
   averages, maxima and minima, lag, lead with its default, first and
   last (rows found by their unique amount); the RANGE sums, counts,
   minima and maxima, percent_rank and cume_dist by (store, day), ntile(4)
   as a multiset within each (store, day) run; each store's totals. The
   planner must pick the "running", halo (6 rows), whole-partition and
   "u2u" modes, and each query must launch its kernels (K15 on range, K16
   on running, moving and range, K17 on moving, K2 and K4 on the adaptive
   u2u);
8. slice 6's string queries (q5.py: string_q5_query, string_dup_query,
   orders_q13_query, orders_words_query) on the adaptive and the fused
   engine: bench.py's q5 filtered by contains, RLIKE and a negated
   startswith on the decoded `region` and grouped by
   upper(substring(region, 8, 2)); the duplicate-key join grouped by
   concat_ws, rpad, replace, translate, reverse and initcap of `promo`;
   and TPC-H q13's comment predicate and a first-word split over a
   generated ORDERS table at SF10 (15,000,000 rows in 8 files, comments
   drawn as dbgen draws them), each against pyarrow compute or, where its
   semantics differ from Spark's, plain Python over the 12 regions and 5
   promos. K18 must run on both RLIKE queries, K19-K21 where their
   expressions run;
9. slice 7's date queries (q5.py: orders_q4_window_query,
   orders_ingest_query, orders_monthly_query) on the adaptive and the
   fused engine over a dated ORDERS table at SF10 (15,000,000 rows in 8
   files, written typed and as dbgen's .tbl text): TPC-H q4's date window
   in UTC, the typing casts of a text load and a monthly report in
   America/Los_Angeles, each against numpy over the typed table and
   zoneinfo over the 2,406 distinct dates. K22 must run on the text load
   and on q4's date literal, K23 on both Los Angeles queries, K24 on the
   monthly report;
10. slice 8's statistical queries (q5.py: orders_price_stats_query,
   orders_daily_distinct_query, orders_price_window_query) on the
   adaptive and the fused engine over the same dated ORDERS at
   spark.rapids.sql.batchSizeRows 2^20: the variances, stddevs, skewness,
   kurtosis, covariances and corr of the price per (priority, year)
   against the reference's formulas over math.fsum sums (within 1e-9 of
   their terms' size), bool_and/or exact, percentile_approx within 4/128
   of its rank; each day's count and distinct customers exact and median
   within 1e-12; every order's 100-row stddev and its priority's variance
   against extended-precision prefix sums. The fused engine runs the
   statistics and the windows and falls back to the adaptive one for the
   daily line (count(DISTINCT), percentile). K4 and K25's selection must
   run on the statistics, K26 and K25's interpolation on the daily line,
   K14 on the windows;
11. slice 9's joins (q5.py: q13_outer_query, q22_anti_query,
   orders_yoy_full_query, orders_price_bands_query,
   customer_segments_query, orders_union_rr_query) over CUSTOMER (1,500,000
   rows as dbgen makes them) and ORDERS with customers and comments
   (15,000,000 rows in 8 files) at SF10, a 10-row price-band table and a
   5-row segment-quota table, with every hash join shuffled
   (spark.sql.autoBroadcastJoinThreshold=-1), on the adaptive and the
   fused engine (the nested-loop bands query on the adaptive engine
   alone: neither package's fused engine lowers it): TPC-H q13 (a
   conditional left outer join), q22's NOT EXISTS (a left anti join), a
   year-over-year full outer join, a condition-only full outer
   nested-loop join, a join on two dictionaries' codes and a union with a
   round-robin repartition, each against pyarrow (Table.join left outer,
   left anti, full outer) and numpy: counts exact, sums within 1e-9
   relative. K27's probe marks must run on q13 and the bands, its build
   marks on the bands, its coverage on the full join, K29 on the segment
   join, K28 on the adaptive engine's round-robin exchange;
12. slice 10's expressions (q5.py: q22_full_query,
   orders_priority_split_query, orders_hash_sample_query,
   customer_value_bands_query) over the same CUSTOMER and ORDERS on the
   adaptive and the fused engine (q22's crossJoin, a nested-loop join,
   falls back to the adaptive engine in both packages): TPC-H q22 as
   written (IN, the scalar subquery, the anti join), q12's CASE WHEN split
   by year, a pmod(xxhash64) 5 % sample grouped by pmod(hash) with a
   MinHash min(xxhash64) shown as hex, and value bands by
   floor(log10(abs)) with isNull, IN over the encoded segment, %,
   coalesce, greatest, round and ceil; against pyarrow and numpy (Spark's
   XXH64 and Murmur3 in numpy uint64/uint32 arithmetic over the column
   values). K30, K6 and the hex mode must run on the hash sample; each
   query's K30, K6 and hex launches, largest device items, host syncs,
   idle share and peak memory are printed;
13. slice 11's decimal queries (q5.py: lineitem_q1_query,
   orders_tbl_decimal_query, q22_decimal_query) in the same session, over
   LINEITEM at SF10 (59,986,052 rows in 8 files, drawn as dbgen draws
   them, its money columns decimal(15,2)), phase 9's ORDERS text and
   CUSTOMER with a decimal(15,2) c_acctbal, on the adaptive and the fused
   engine (q22's crossJoin falls back to the adaptive one): TPC-H q1
   without sum_charge, a .tbl load typed to decimal(15,2) with its sums
   as text in descending revenue, and TPC-H q22 over the decimal balance,
   each equal to an exact integer oracle (every decimal as its unscaled
   integer, no float). K31 and K32 must run on every query, K22's and
   K24's decimal modes on the load; each query's launches of K31, K32
   and the two modes, largest device items, host syncs, idle share and
   peak memory are printed;
14. slice 12's nested columns: first the relation cache across devices
   (a CPU session caches and queries a small NESTED_ORDERS, then a CUDA
   session, the first still open, caches the same parquet plan: its
   parts must be CUDA tensors, its run must launch K3, K8 and K4 and
   equal the CPU run, and a DataFrame of the one cannot join the
   other's); then NESTED_ORDERS (q5.py `write_nested_orders`: the
   15,000,000 SF10 ORDERS of phases 9-13 each carrying its own 1-7 of
   phase 13's 59,986,052 LINEITEM rows as parallel arrays of quantities,
   prices, ship dates and ship modes (array<string>), a map of line
   number to price and an o_info struct) through
   `read.parquet(...).cache(storage="device")` on the adaptive and the
   fused engine: the four nested queries (q5.py: nested_explode_query,
   nested_item_stats_query, customer_order_lists_query,
   recent_orders_window_query), each against numpy oracles over the
   draws (counts, sizes, maxima and orders exact, double sums within
   1e-9 relative, each customer's orders as a multiset and years as a
   set, each order's price frame in order and its years as a set). The
   fused engine hands the collect results to the adaptive one; the
   adaptive window must take the halo mode (5 rows); K33 must run on the
   window, K34 and K35 on the item statistics, K35 and K26 on the lists,
   K3 on the explode;
15. slice 13's Delta Lake upkeep of phase 9's typed ORDERS (q5.py): the
   write with deletion vectors enabled (15 files of 2^20 rows, each add's
   stats equal to pyarrow's, the priority summary read back on both
   engines), OPTIMIZE ZORDER BY (o_custkey, o_orderdate) (its row order
   equal to the numpy Morton order of the snapshot's files, a dashboard
   filter's candidate files through the log's statistics equal to the
   oracle's before and after; K9, K14's inverse, K36 and K8 must run, and
   the sort is profiled alone), TPC-H RF1 and RF2 as MERGEs (15,000
   orders in, 15,000 out; K2 must run), the retention DELETE (dates
   before 1993) and a request DELETE through deletion vectors (no data
   file written; the second's vectors hold the first's), an UPDATE of
   the top 1 % of prices, and the read-back on both engines: each
   priority's count, revenue (1e-9 relative) and order keys against a
   numpy oracle that applied the same steps.

For each query run (phases 3-14) and each phase-15 step the kernels'
launch counts are reset just before the cold run and read just after it;
every kernel of that path must have run. Phases 3-5 time 3 hot runs a
query, phases 7 and 10 none (cut from 2 to 1 when phases 12 and 13 were
added, to none when phase 14 was: their times are the cold and the
profiled run's), phases 6, 8, 9 and 11-14 1 (cut from 2 when phase 14
was added), and each kernel's device time in phase 2 is the mean of 4
calls (10 before phase 14 was added).
One more hot run counts the host syncs (torch.cuda's
sync debug mode; not in phases 7 and 10 since phase 14 was added: their
counts stand in PERF.md from PRs 5 and 8) and one, under torch.profiler,
gives the device's busy time against wall time and must hold no library
sort or scan kernel.

The line before the last holds the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Needs a CUDA device and the repository
around this file; the port never falls back to the CPU.
"""

import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak device-memory rate
ROWS = 36_000_000
FILES = 8
STORES = 2000
REGIONS = 12
HOT_RUNS = 3
#: hot runs of each query in phases 6, 8, 9, 11 and 12 (phases 3-5 keep
#: HOT_RUNS; cut from 2 when phase 14 was added)
LATER_HOT_RUNS = 1
#: hot runs of each query in phase 7 (its 36M-row checks are the run's
#: largest; cut from 2 before phase 12 was added, to 0 before phase 14:
#: its queries' times are the cold and the profiled run's)
SLICE5_HOT_RUNS = 0
#: hot runs of each query in phase 10 (its 15M-row window checks are the
#: next largest; cut from 2 before phase 13 was added, to 0 before phase
#: 14)
SLICE8_HOT_RUNS = 0
#: hot runs of each query in phase 13 (cut from 2 when phase 14 was
#: added)
SLICE11_HOT_RUNS = 1
#: calls a kernel's (and K1-K17's plain and library) device time is the
#: mean of (cut from 10 when phase 14 was added)
TIMING_ITERS = 4
DUP_PER_STORE = 2       # rows per store in the duplicate-key dimension
REL_TOL = 1e-9          # sums and averages against the oracles
MERGE_ROWS = 1 << 22    # rows of each run in K13's record
F64_ATOMIC_TOL = 1e-12  # K4's float64 sums: atomic order varies


#: slice 3's kernels: K9 (pack, sort), K10, K11; every path runs them
SLICE3_KERNELS = ("pack_keys", "sort_words", "group_bounds",
                  "dense_bin_perm")
#: kernels slice 1's hand-built q5 plan runs (no exchange: no K6, K7)
SLICE1_PATH_KERNELS = ("compact_perm", "probe_ranges", "expand_gather_maps",
                       "seg_sum_count", "bloom_build", "bloom_might_contain",
                       "gather_leaves") + SLICE3_KERNELS
#: kernels each query on the adaptive engine runs: all of K1-K11
SESSION_PATH_KERNELS = SLICE1_PATH_KERNELS + ("murmur3", "partition_by_ids")
#: kernels each query on the fused engine runs (no bloom prefilter, and
#: the single-chip exchange is identity: no K5, K6, K7); dupjoin's
#: expanded join adds K3
FUSED_PATH_KERNELS = {
    "q5": ("compact_perm", "probe_ranges", "seg_sum_count",
           "gather_leaves") + SLICE3_KERNELS,
    "dupjoin": ("compact_perm", "probe_ranges", "expand_gather_maps",
                "seg_sum_count", "gather_leaves") + SLICE3_KERNELS,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Mean milliseconds per call, by CUDA events around back-to-back
    calls after one warm-up: host dispatch between launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: traces that came back without device events; their times are CUDA-event
#: times instead (printed before the result)
PROFILER_MISSES = []


def traced(run, what: str):
    """(device events, wall ms) of run() under torch.profiler, or (None,
    wall ms) when three traces in a row hold no device events (a trace now
    and then comes back without them on a shared machine)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        all_events = prof.events()
        events = [e for e in all_events if e.device_type == DeviceType.CUDA]
        if events:
            return events, wall_ms
        print(f"chip_smoke: torch.profiler traced no device activity for "
              f"{what} (try {attempt + 1}, {len(all_events)} host events)",
              file=sys.stderr, flush=True)
    PROFILER_MISSES.append(what)
    return None, wall_ms


#: CUDA-event milliseconds a call from which its time is its CUDA-event
#: time: host dispatch is then a small share, while traces of such calls
#: have lost kernel records (summing a half or three quarters of it)
LOST_MIN_MS = 1.0


def device_ms(fn, what: str, iters: int = TIMING_ITERS,
              floor_ms: float = 0.0, event_ms=None) -> float:
    """Mean milliseconds per call on the card, after one warm-up. A call
    of LOST_MIN_MS or more: its CUDA-event time. A shorter one: the summed
    durations of the kernels, copies and memsets the calls put on the
    card, as torch.profiler traces them (one stream, so they do not
    overlap; host dispatch between them is not counted), or the CUDA-event
    time where the trace holds no device events or sums to less than
    `floor_ms` (the byte bound of a kernel whose data far exceed the 50 MB
    L2), named in PROFILER_MISSES. `event_ms`: the CUDA-event time of
    these calls where the caller has it."""
    if event_ms is None:
        event_ms = time_ms(fn, iters)
    if event_ms >= LOST_MIN_MS:
        return event_ms

    def calls():
        for _ in range(iters):
            fn()

    events, _ = traced(calls, what)
    if events is None:
        return event_ms
    ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    if ms < floor_ms:
        PROFILER_MISSES.append(f"{what} (device trace under its bound)")
        return event_ms
    return ms


def timed(name: str, kernel, plain, library,
          other_iters: int = TIMING_ITERS, floor_ms: float = 0.0) -> dict:
    """device_ms of a kernel's wrapper, its plain version and the library
    call (None where no one PyTorch call computes the function; those two
    over other_iters calls), and the wrapper's CUDA-event time."""
    event_ms = time_ms(kernel)
    return dict(ms=device_ms(kernel, name, floor_ms=floor_ms,
                             event_ms=event_ms),
                plain_ms=device_ms(plain, f"{name} plain", other_iters),
                library_ms=None if library is None
                else device_ms(library, f"{name} library", other_iters),
                event_ms=event_ms)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:
        return float((a - b).abs().max().item())
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def exact(name: str, got, want) -> None:
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"{name}: kernel differs from its plain version "
             f"(max abs err {max_abs_err(got, want)})")


def check_kernels(dev):
    """Phase 2: K1-K4 against their plain versions at q5's shapes.
    Returns {kernel name: record} without launch counts."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.ops import filterops, joinops, segmented

    rng = np.random.default_rng(1)
    part_rows = ROWS // FILES
    cap = next_capacity(part_rows)
    out = {}

    # K1 compact_perm: the fact part's `amount > 10` keep mask
    amount = rng.random(part_rows) * 100.0
    keep_np = np.zeros(cap, bool)
    keep_np[:part_rows] = amount > 10.0
    keep = torch.from_numpy(keep_np).to(dev)
    perm, n_keep = filterops.compact_perm(keep, cap)
    perm_p, n_keep_p = filterops.compact_perm_plain(keep, cap)
    torch.cuda.synchronize()
    exact("compact_perm perm", perm, perm_p)
    exact("compact_perm n_keep", n_keep, n_keep_p)
    n_kept = int(n_keep.item())
    out["compact_perm"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/compact_perm.cu",
        replaces="spark_rapids_tpu/ops/filterops.py:16",
        max_abs_err=max_abs_err(perm, perm_p),
        **timed("compact_perm", lambda: filterops.compact_perm(keep, cap),
                lambda: filterops.compact_perm_plain(keep, cap),
                lambda: torch.argsort(~keep, stable=True)),
        bound_ms=bound_ms(cap * 1 + cap * 4 + 4), bound_by="bytes",
        shape=f"keep [{cap}] bool, {n_kept} kept")

    # K2 probe_ranges: the kept fact rows' store keys against the sorted
    # 2,000-row dimension (capacity 2,048; W=1)
    bcap = next_capacity(STORES)
    build_np = np.zeros(bcap, np.int64)
    build_np[:STORES] = np.arange(STORES)
    store = rng.integers(0, STORES, part_rows)
    probe_np = np.zeros(cap, np.int64)
    probe_np[:n_kept] = store[amount > 10.0]
    all_valid_np = np.arange(cap) < n_kept
    build_keys = [torch.from_numpy(build_np).to(dev)]
    probe_keys = [torch.from_numpy(probe_np).to(dev)]
    all_valid = torch.from_numpy(all_valid_np).to(dev)
    bound = torch.tensor(STORES, dtype=torch.int32, device=dev)
    args = (build_keys, probe_keys, bound, all_valid, bcap)
    lo, counts = joinops.probe_bounds(*args)
    lo_p, counts_p = joinops.probe_bounds_plain(*args)
    torch.cuda.synchronize()
    exact("probe_ranges lo", lo, lo_p)
    exact("probe_ranges count", counts, counts_p)
    sorted_build = build_keys[0][:STORES]

    def library_probe():
        lower = torch.searchsorted(sorted_build, probe_keys[0])
        upper = torch.searchsorted(sorted_build, probe_keys[0], right=True)
        return lower, upper

    out["probe_ranges"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/probe_ranges.cu",
        replaces="spark_rapids_tpu/ops/joinops.py:86",
        max_abs_err=max(max_abs_err(lo, lo_p),
                        max_abs_err(counts, counts_p)),
        **timed("probe_ranges", lambda: joinops.probe_bounds(*args),
                lambda: joinops.probe_bounds_plain(*args), library_probe),
        bound_ms=bound_ms(bcap * 8 + 4 + cap * (8 + 1) + cap * 8),
        bound_by="bytes",
        shape=f"build [1, {bcap}] int64, probe [1, {cap}] int64")

    # K3 expand_gather_maps: K2's ranges -> the join's gather maps
    total = int(counts.sum().item())
    out_cap = next_capacity(total)
    pi, bi, tot = joinops.expand_gather_maps(lo, counts, out_cap)
    pi_p, bi_p, tot_p = joinops.expand_gather_maps_plain(lo, counts, out_cap)
    torch.cuda.synchronize()
    exact("expand_gather_maps pi", pi, pi_p)
    exact("expand_gather_maps bi", bi, bi_p)
    exact("expand_gather_maps total", tot, tot_p)
    rows_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    matched = int((counts > 0).sum().item())
    out["expand_gather_maps"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/expand_gather_maps.cu",
        replaces="spark_rapids_tpu/ops/joinops.py:129",
        max_abs_err=max(max_abs_err(pi, pi_p), max_abs_err(bi, bi_p)),
        **timed("expand_gather_maps",
                lambda: joinops.expand_gather_maps(lo, counts, out_cap),
                lambda: joinops.expand_gather_maps_plain(lo, counts,
                                                         out_cap),
                lambda: torch.repeat_interleave(rows_idx, counts,
                                                output_size=total)),
        # counts of every probe row, lo of the matched ones, both maps
        bound_ms=bound_ms(cap * 4 + matched * 4 + out_cap * 8 + 4),
        bound_by="bytes",
        shape=f"counts [{cap}] -> pi, bi [{out_cap}], total {total}")

    # K4 seg_sum_count: the binned partial over the joined rows that pass
    # `region != 'region_11'` (11 region codes, bins 1..11 of 1,024): one
    # launch sums revenue and amount, each under its validity, with their
    # counts and the bins' row count (count(*))
    n = out_cap
    nseg = 1024
    n_live = total * (REGIONS - 1) // REGIONS
    live = torch.arange(n, device=dev) < n_live
    gid = torch.from_numpy(rng.integers(1, REGIONS, n).astype(np.int32)
                           ).to(dev)
    amount_v = torch.from_numpy(10.0 + rng.random(n) * 90.0).to(dev)
    revenue = amount_v * torch.from_numpy(
        rng.integers(1, 100, n).astype(np.float64)).to(dev)
    masks = [live.clone(), live.clone()]   # the columns' validity
    vals = [revenue, amount_v]

    def k4():
        with segmented.unsorted_gids():
            return segmented.seg_sum_count_multi(vals, live, gid, nseg, masks,
                                                 value_counts=True)

    def k4_plain():
        return segmented.seg_sum_count_plain(vals, live, gid, nseg, masks,
                                             value_counts=True)

    got, want = k4(), k4_plain()
    torch.cuda.synchronize()
    exact("seg_sum_count count", got.count, want.count)
    err = 0.0
    for j in range(len(vals)):
        exact(f"seg_sum_count value count {j}", got.value_counts[j],
              want.value_counts[j])
        s, s_p = got.sums[j], want.sums[j]
        rel = ((s - s_p).abs() / s_p.abs().clamp(min=1e-300)).max().item()
        if not rel <= F64_ATOMIC_TOL:
            fail(f"seg_sum_count float64 sums off by {rel} relative")
        err = max(err, max_abs_err(s, s_p))
    # int64 sums are exact
    qty = torch.from_numpy(rng.integers(1, 100, n).astype(np.int64)).to(dev)
    with segmented.unsorted_gids():
        gi = segmented.seg_sum_count_multi([qty], live, gid, nseg)
    wi = segmented.seg_sum_count_plain([qty], live, gid, nseg)
    exact("seg_sum_count int64 sum", gi.sums[0], wi.sums[0])
    # the merge shape: sorted ids, sums straight to device memory
    m = 8 * 1024
    mgid = torch.sort(torch.from_numpy(
        rng.integers(0, 100, m).astype(np.int32)).to(dev)).values
    mval = torch.from_numpy(rng.integers(0, 1000, m)).to(dev)
    mvalid = torch.ones(m, dtype=torch.bool, device=dev)
    gm = segmented.seg_sum_count_multi([mval], mvalid, mgid, m)
    wm = segmented.seg_sum_count_plain([mval], mvalid, mgid, m)
    exact("seg_sum_count sorted sum", gm.sums[0], wm.sums[0])
    exact("seg_sum_count sorted count", gm.count, wm.count)

    gid64 = gid.to(torch.int64)
    zeros = torch.zeros((nseg, 4), dtype=torch.float64, device=dev)
    # one index_add_ of [sum, count] pairs for both vectors
    stacked = torch.stack([torch.where(live, revenue, 0.0),
                           live.to(torch.float64),
                           torch.where(live, amount_v, 0.0),
                           live.to(torch.float64)], 1)
    n_valid = int(live.sum().item())
    out["seg_sum_count"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/seg_sum_count.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:371",
        max_abs_err=err,
        **timed("seg_sum_count", k4, k4_plain,
                lambda: zeros.clone().index_add_(0, gid64, stacked)),
        # valid for every row; gid and both masks for the valid rows; each
        # value where its mask holds (every valid row here); the outputs
        bound_ms=bound_ms(n + n_valid * (4 + 2) + 2 * n_valid * 8
                          + nseg * 8 * (2 * 2 + 1)),
        bound_by="bytes",
        shape=f"gid [{n}] int32, 2 float64 vectors with masks, {n_valid} "
              f"valid rows, {nseg} bins")
    return out


def _col(dtype, data, validity, lengths=None, vrange=None, encoding=None):
    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn

    return DeviceColumn(dtype, data, validity, lengths, vrange=vrange,
                        encoding=encoding)


def _region_strings(dev, n: int, live: int):
    """A decoded `region` key column as the exchange hashes it: n rows
    of a [n, 16] zero-padded byte matrix, the first `live` valid."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.sqltypes.datatypes import string

    data = np.zeros((n, 16), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(live):
        b = f"region_{i % REGIONS:02d}".encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return _col(string, torch.from_numpy(data).to(dev),
                torch.from_numpy(np.arange(n) < live).to(dev),
                torch.from_numpy(lengths).to(dev))


def check_slice2_kernels(dev):
    """Phase 2, slice 2: K5-K8 against their plain versions at the shapes
    the session path gives them. Returns {kernel name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import batch as B
    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.ops import bloom, hashing, partition
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        double,
        long,
        short,
    )

    rng = np.random.default_rng(3)
    part_rows = ROWS // FILES
    cap = next_capacity(part_rows)
    out = {}

    # K5 build: the dimension's store keys (2,000 rows at capacity 2,048)
    bcap = next_capacity(STORES)
    bkeys = np.zeros(bcap, np.int64)
    bkeys[:STORES] = np.arange(STORES)
    build_col = _col(long, torch.from_numpy(bkeys).to(dev),
                     torch.from_numpy(np.arange(bcap) < STORES).to(dev))
    live_b = torch.from_numpy(np.arange(bcap) < STORES).to(dev)
    m = bloom.size_for(STORES)
    bits = bloom.build([build_col], live_b, m)
    bits_p = bloom.build_plain([build_col], live_b, m)
    torch.cuda.synchronize()
    exact("bloom build bits", bits, bits_p)
    out["bloom_build"] = dict(
        route="cuda", source="spark_rapids_tpu_torch/kernels/csrc/bloom.cu",
        replaces="spark_rapids_tpu/ops/bloom.py:45",
        max_abs_err=max_abs_err(bits, bits_p),
        **timed("bloom_build", lambda: bloom.build([build_col], live_b, m),
                lambda: bloom.build_plain([build_col], live_b, m), None),
        # keys, validity and live mask read; m bytes of bits written
        bound_ms=bound_ms(bcap * (8 + 1 + 1) + m), bound_by="bytes",
        shape=f"build [{bcap}] int64, {STORES} live, m = {m}")

    # K5 might_contain: the filtered fact part's store keys, the live rows
    # tested and the kept ones counted
    amount = rng.random(part_rows) * 100.0
    n_kept = int((amount > 10.0).sum())
    probe_np = rng.integers(0, STORES, cap)
    probe_col = _col(long, torch.from_numpy(probe_np).to(dev),
                     torch.ones(cap, dtype=torch.bool, device=dev))
    nrows = torch.tensor(n_kept, dtype=torch.int32, device=dev)
    live_p = torch.arange(cap, device=dev) < n_kept

    def plain_probe():
        keep = bloom.might_contain_plain(bits, [probe_col]) & live_p
        return keep, keep.sum()

    keep, kept = bloom.might_contain_count(bits, [probe_col], nrows)
    keep_p, kept_p = plain_probe()
    torch.cuda.synchronize()
    exact("bloom might_contain", keep, keep_p)
    exact("bloom kept count", kept, kept_p)
    out["bloom_might_contain"] = dict(
        route="cuda", source="spark_rapids_tpu_torch/kernels/csrc/bloom.cu",
        replaces="spark_rapids_tpu/ops/bloom.py:55",
        max_abs_err=max_abs_err(keep, keep_p),
        **timed("bloom_might_contain",
                lambda: bloom.might_contain_count(bits, [probe_col], nrows),
                plain_probe, None),
        # key and validity per live row, the bits, keep per row of the
        # capacity, the row count and the kept count
        bound_ms=bound_ms(n_kept * (8 + 1) + m + cap + 4 + 8),
        bound_by="bytes",
        shape=f"probe [{cap}] int64, {n_kept} live rows, m = {m}")

    # K6 murmur3: the exchange's partition ids over the partial's decoded
    # region keys (1,024 rows, 11 groups live), 8 partitions
    nparts = 8
    region = _region_strings(dev, 1024, REGIONS - 1)
    pid = hashing.murmur3_pmod([region], nparts)
    pid_p = hashing.pmod_plain(hashing.murmur3_columns_plain([region]),
                               nparts)
    torch.cuda.synchronize()
    exact("murmur3 partition ids", pid, pid_p)
    out["murmur3"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/murmur3_partition.cu",
        replaces="spark_rapids_tpu/ops/hashing.py:153",
        max_abs_err=max_abs_err(pid, pid_p),
        **timed("murmur3", lambda: hashing.murmur3_pmod([region], nparts),
                lambda: hashing.pmod_plain(
                    hashing.murmur3_columns_plain([region]), nparts), None),
        # the live rows' bytes, lengths and validity; pid written whole
        bound_ms=bound_ms((REGIONS - 1) * (16 + 4 + 1) + 1024 * 4),
        bound_by="bytes",
        shape="decoded region strings [1024, 16], 11 live, 8 partitions")

    # K7 partition_by_ids: those ids, 11 live rows
    live_rows = torch.tensor(REGIONS - 1, dtype=torch.int32, device=dev)
    perm, counts = partition.partition_perm(pid, live_rows, nparts)
    perm_p, counts_p = partition.partition_perm_plain(pid, live_rows, nparts)
    torch.cuda.synchronize()
    exact("partition_by_ids perm", perm, perm_p)
    exact("partition_by_ids counts", counts, counts_p)
    key = torch.where(torch.arange(1024, device=dev) < REGIONS - 1, pid,
                      nparts)
    out["partition_by_ids"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/partition_by_ids.cu",
        replaces="spark_rapids_tpu/ops/partition.py:35",
        max_abs_err=max(max_abs_err(perm, perm_p),
                        max_abs_err(counts, counts_p)),
        **timed("partition_by_ids",
                lambda: partition.partition_perm(pid, live_rows, nparts),
                lambda: partition.partition_perm_plain(pid, live_rows,
                                                       nparts),
                lambda: torch.argsort(key, stable=True)),
        # the live rows' ids and the row count; perm and counts written
        bound_ms=bound_ms((REGIONS - 1) * 4 + 4 + 1024 * 4 + nparts * 4),
        bound_by="bytes", shape="pid [1024] int32, 11 live, 8 partitions")

    # K8 gather_leaves: the join's output gather, both sides in one
    # launch (4 fact columns by pi, 3 dimension columns by bi; 14 leaves)
    n_out = next_capacity(n_kept)
    pi = torch.from_numpy(np.sort(rng.integers(0, n_kept, n_out))
                          .astype(np.int32)).to(dev)
    bi = torch.from_numpy(rng.integers(0, STORES, n_out)
                          .astype(np.int32)).to(dev)
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    left = [_col(long, torch.from_numpy(probe_np).to(dev), ones),
            _col(double, torch.from_numpy(rng.random(cap) * 100).to(dev),
                 ones),
            _col(long, torch.from_numpy(rng.integers(1, 100, cap)).to(dev),
                 ones),
            _col(long, torch.from_numpy(rng.integers(0, 365, cap)).to(dev),
                 ones)]
    right = [build_col,
             _col(short, torch.from_numpy((np.arange(bcap) % REGIONS)
                                          .astype(np.int16)).to(dev),
                  live_b, vrange=(0, REGIONS - 1)),
             _col(long, torch.from_numpy(rng.integers(0, 3650, bcap))
                  .to(dev), live_b)]
    pairs = [(c, pi) for c in left] + [(c, bi) for c in right]
    srcs = [x for c, _ in pairs for x in c.leaves()]
    idxs = [i for c, i in pairs for _ in c.leaves()]
    got = B.gather_leaves(srcs, idxs)
    want = B.gather_leaves_plain(srcs, idxs)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        exact(f"gather_leaves leaf {k}", a, b)
    # each source row an index names is read once, each output row
    # written once, and both index vectors read once
    distinct = {id(i): int(torch.unique(i).numel()) for i in (pi, bi)}
    needed = sum((distinct[id(i)] + n_out) * x[0].numel() * x.element_size()
                 for x, i in zip(srcs, idxs)) + 2 * n_out * 4
    out["gather_leaves"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/gather_leaves.cu",
        replaces="spark_rapids_tpu/columnar/batch.py:345",
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        **timed("gather_leaves", lambda: B.gather_leaves(srcs, idxs),
                lambda: B.gather_leaves_plain(srcs, idxs),
                lambda: [s.index_select(0, i) for s, i in zip(srcs, idxs)]),
        bound_ms=bound_ms(needed), bound_by="bytes",
        shape=f"join output: {len(srcs)} leaves of 7 columns, {n_out} rows")
    return out


def check_slice2_edges(dev) -> int:
    """Phase 2, slice 2 edge shapes, exact against the plain versions:
    string lengths 0-12 (every tail length, bytes >= 0x80), null keys and
    dead rows, negative and INT64_MIN longs, -0.0 and NaN doubles, int32,
    float32 and bool keys, chains of key columns, per-row seeds,
    num_partitions 1, 8 and 200, a build side with duplicate keys, a
    filter too big for shared memory, leaf widths that are no multiple of
    4, more than 32 leaves, and decode's clipped codes. Returns the
    number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import batch as B
    from spark_rapids_tpu_torch.columnar import encoding as E
    from spark_rapids_tpu_torch.ops import bloom, hashing, partition
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        boolean,
        double,
        float_t,
        integer,
        long,
        string,
    )

    rng = np.random.default_rng(4)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def strings(n):
        lengths = rng.integers(0, 13, n).astype(np.int32)
        data = rng.integers(0, 256, (n, 16)).astype(np.uint8)
        data[np.arange(16)[None, :] >= lengths[:, None]] = 0
        return _col(string, t(data), t(rng.random(n) < 0.9), t(lengths))

    def longs(n):
        v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        v[:4] = [-(1 << 63), -1, 0, (1 << 63) - 1]
        return _col(long, t(v), t(rng.random(n) < 0.9))

    def doubles(n):
        v = rng.choice([0.0, -0.0, np.nan, -np.nan, 1.5, -2.25, np.inf], n)
        return _col(double, t(v), t(rng.random(n) < 0.9))

    for n in (1000, 4096):
        cols = [strings(n), longs(n), doubles(n),
                _col(integer, t(rng.integers(-9, 9, n).astype(np.int32)),
                     t(rng.random(n) < 0.8)),
                _col(float_t, t(rng.choice([0.0, -0.0, np.nan, 3.5], n)
                                .astype(np.float32)), t(rng.random(n) < 0.8)),
                _col(boolean, t(rng.random(n) < 0.5), t(rng.random(n) < 0.8))]
        for nparts in (0, 1, 8, 200):
            for k in range(1, len(cols) + 1):
                got = hashing.murmur3_pmod(cols[:k], nparts, seed=7 + k)
                h = hashing.murmur3_columns_plain(cols[:k], 7 + k)
                want = hashing.pmod_plain(h, nparts) if nparts else h
                exact(f"murmur3 n={n} cols={k} parts={nparts}", got, want)
                cases += 1
        seed = t(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
        for c in cols:
            exact(f"hash_column {c.dtype}", hashing.hash_column(c, seed),
                  hashing.hash_column_plain(c, seed))
            cases += 1
        x = t(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
        exact("pmod", hashing.pmod(x, 200), hashing.pmod_plain(x, 200))
        cases += 1

        # bloom: duplicate and null build keys, dead rows, two key columns
        nb = 300
        bk = [_col(long, t(rng.integers(0, 50, nb)), t(rng.random(nb) < 0.9)),
              strings(nb)]
        live = t(np.arange(nb) < nb - 20)
        pk = [_col(long, t(rng.integers(0, 60, n)), t(rng.random(n) < 0.9)),
              strings(n)]
        for m in (8192, 1 << 20):
            bits = bloom.build(bk, live, m)
            exact(f"bloom build m={m}", bits, bloom.build_plain(bk, live, m))
            keep, kept = bloom.might_contain_count(bits, pk, n - 30)
            keep_p, kept_p = bloom.might_contain_count_plain(bits, pk,
                                                              n - 30)
            exact(f"bloom might_contain_count m={m}", keep, keep_p)
            exact(f"bloom count m={m}", kept, kept_p)
            exact(f"bloom might_contain m={m}",
                  bloom.might_contain(bits, pk),
                  bloom.might_contain_plain(bits, pk))
            cases += 3

    for n, nparts in ((1024, 1), (5000, 8), (70000, 200)):
        pid = t(rng.integers(0, nparts, n).astype(np.int32))
        for nrows in (n, n - 333, torch.tensor(n // 2, dtype=torch.int32,
                                               device=dev)):
            got = partition.partition_perm(pid, nrows, nparts)
            want = partition.partition_perm_plain(pid, nrows, nparts)
            for a, b in zip(got, want):
                exact(f"partition_by_ids n={n} parts={nparts}", a, b)
            cases += 1

    # K8: widths 7, 10, 12, 24 (no multiple of 4 among some), 40 leaves
    n_src, n_out = 3000, 2500
    srcs = [t(rng.integers(0, 256, (n_src, w)).astype(np.uint8))
            for w in (7, 10, 12, 24)]
    srcs += [t(rng.integers(-9, 9, n_src).astype(dt))
             for dt in (np.int8, np.int16, np.int32, np.int64)] * 9
    idx = [t(rng.integers(0, n_src, n_out).astype(np.int32)) for _ in srcs]
    for a, b in zip(B.gather_leaves(srcs, idx),
                    B.gather_leaves_plain(srcs, idx)):
        exact("gather_leaves widths", a, b)
    cases += 1
    # decode: int16 codes beyond the dictionary clip, null rows zero
    dd_vals = [f"v{i}" * (i % 4 + 1) for i in range(9)]
    import pyarrow as pa

    dict_id, _ = E.intern_dictionary(pa.array(dd_vals,
                                              type=pa.large_string()))
    dd = E.device_dictionary(dict_id, dev)
    enc = _col(string, t(rng.integers(-3, 14, n_out).astype(np.int16)),
               t(rng.random(n_out) < 0.8), vrange=(0, 8), encoding=dd)
    got, want = E.decode_column(enc), E.decode_column_plain(enc)
    exact("decode data", got.data, want.data)
    exact("decode lengths", got.lengths, want.lengths)
    cases += 1
    torch.cuda.synchronize()
    return cases


def _region_codes(dev, n: int, live: int):
    """The merge's group key: int16 region codes (vrange 0..11) of n rows,
    the first `live` valid."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.sqltypes.datatypes import short

    codes = (np.arange(n) % REGIONS).astype(np.int16)
    valid = torch.from_numpy(np.arange(n) < live).to(dev)
    return _col(short, torch.from_numpy(codes).to(dev), valid,
                vrange=(0, REGIONS - 1)), valid


def check_slice3_kernels(dev):
    """Phase 2, slice 3: K9 (pack and sort), K10 and K11 against their
    plain versions at the fused q5 path's shapes: the final merge of the
    8 parts' buffer rows (32,768 rows concatenated, 11 live a part, keyed
    by region codes: a null-rank word and a code word) and the pushdown
    pre-aggregate's 4,096 bins. Returns {kernel name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.ops import common, segmented

    out = {}
    n = 8 * 4096
    live_rows = 8 * (REGIONS - 1)
    col, _ = _region_codes(dev, n, n)
    # the concatenated parts' live rows are compacted to the front
    live = torch.arange(n, device=dev) < live_rows
    spec = [common.KeySpec(col, codes_ok=True, normalize_zero=True)]
    words, _ = common.pack_keys(spec, live)
    words_p, _ = common.pack_keys_plain(spec, live)
    torch.cuda.synchronize()
    exact("pack_keys words", words, words_p)
    out["pack_keys"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/sort_keys.cu",
        replaces="spark_rapids_tpu/ops/common.py:96",
        max_abs_err=max_abs_err(words, words_p),
        **timed("pack_keys", lambda: common.pack_keys(spec, live),
                lambda: common.pack_keys_plain(spec, live), None),
        # live read for every row, codes and validity only for the live
        # rows (dead rows' words are constants); two int64 words written
        bound_ms=bound_ms(n + live_rows * (2 + 1) + n * 16),
        bound_by="bytes",
        shape=f"region codes [{n}] int16, {live_rows} live -> words "
              f"[2, {n}]")

    perm = common.sort_words(words)
    perm_p = common.sort_permutation_plain(list(words_p.unbind(0)), n)
    torch.cuda.synchronize()
    exact("sort_words perm", perm, perm_p)
    out["sort_words"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/sort_keys.cu",
        replaces="spark_rapids_tpu/ops/common.py:175",
        max_abs_err=max_abs_err(perm, perm_p),
        **timed("sort_words", lambda: common.sort_words(words),
                lambda: common.sort_permutation_plain(
                    list(words_p.unbind(0)), n),
                # the library call: the same stable torch.sort chain
                lambda: common.sort_permutation_plain(
                    list(words_p.unbind(0)), n)),
        bound_ms=bound_ms(n * 16 + n * 4), bound_by="bytes",
        shape=f"words [2, {n}] int64 -> perm [{n}] int32")

    gb = segmented.group_bounds(words, perm, live)
    gb_p = segmented.group_bounds_plain(words, perm, live)
    torch.cuda.synchronize()
    for a, b, what in zip(gb, gb_p, gb._fields):
        exact(f"group_bounds {what}", a, b)

    def bounds_library():
        # one library call over the sorted words: its groups are K10's
        # live groups and, after them, the dead rows' one group
        return torch.unique_consecutive(words.index_select(1, perm.long()),
                                        dim=1, return_inverse=True,
                                        return_counts=True)

    _, inverse, counts = bounds_library()
    ng = int(gb.num_groups.item())
    first = torch.cumsum(counts, 0) - counts
    exact("group_bounds library gid", inverse[:live_rows].to(torch.int32),
          gb.gid[:live_rows])
    exact("group_bounds library first_pos", first[:ng].to(torch.int32),
          gb.first_pos[:ng])
    if counts.numel() != ng + (live_rows < n):
        fail(f"group_bounds library: {counts.numel()} groups, K10 {ng}")
    out["group_bounds"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/group_bounds.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:306",
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(gb, gb_p)),
        **timed("group_bounds",
                lambda: segmented.group_bounds(words, perm, live),
                lambda: segmented.group_bounds_plain(words, perm, live),
                bounds_library),
        # perm and live per row, both words only for the live sorted
        # rows; gid, live_s, first_pos and num_groups out
        bound_ms=bound_ms(n * (4 + 1) + live_rows * 16 + n * (4 + 1 + 4)
                          + 4),
        bound_by="bytes", shape=f"words [2, {n}], perm [{n}]")

    bins = 4096
    occ_np = np.zeros(bins, bool)
    occ_np[1:STORES + 1] = True  # bin 0 is the null key; stores 0..1999
    occupied = torch.from_numpy(occ_np).to(dev)
    d = segmented.dense_bin_perm(occupied, bins)
    d_p = segmented.dense_bin_perm_plain(occupied, bins)
    torch.cuda.synchronize()
    exact("dense_bin_perm", d, d_p)
    out["dense_bin_perm"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/dense_bin_perm.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:297",
        max_abs_err=max_abs_err(d, d_p),
        **timed("dense_bin_perm",
                lambda: segmented.dense_bin_perm(occupied, bins),
                lambda: segmented.dense_bin_perm_plain(occupied, bins),
                lambda: torch.nonzero(occupied)),
        bound_ms=bound_ms(bins + bins * 4), bound_by="bytes",
        shape=f"occupied [{bins}] bool, {STORES} occupied")
    return out


def time_large_sorts(dev) -> list:
    """K9's sort at sizes where its bound is above launch latency: the
    65,536-row build sort of the dimension (lead rank, store), 2^24 rows
    of 16 distinct values (heavy ties) and 2^22 random 64-bit keys; each
    exact against the stable torch.sort chain, with both device times."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.ops import common

    rng = np.random.default_rng(5)
    cases = []
    build = np.zeros((2, 1 << 16), np.int64)
    build[0, STORES:] = 1
    build[1, :STORES] = rng.permutation(STORES)
    cases.append(("build sort [2, 65536]", build))
    cases.append(("2^24 rows, 16 values [1, 16777216]",
                  rng.integers(0, 16, (1, 1 << 24)).astype(np.int64)))
    cases.append(("2^22 random int64 [1, 4194304]",
                  rng.integers(-(1 << 63), (1 << 63) - 1, (1, 1 << 22),
                               dtype=np.int64)))
    out = []
    for what, w_np in cases:
        w = torch.from_numpy(w_np).to(dev)
        got = common.sort_words(w)
        want = common.sort_permutation_plain(list(w.unbind(0)),
                                             w.shape[1])
        torch.cuda.synchronize()
        exact(f"sort_words {what}", got, want)
        ms = device_ms(lambda: common.sort_words(w), f"sort {what}", 5)
        lib_ms = device_ms(lambda: common.sort_permutation_plain(
            list(w.unbind(0)), w.shape[1]), f"torch.sort {what}", 5)
        nbytes = w.numel() * 8 + w.shape[1] * 4
        out.append(dict(shape=what, ms=ms, library_ms=lib_ms,
                        bound_ms=bound_ms(nbytes)))
        del w, got, want
    return out


def check_slice3_edges(dev) -> int:
    """Phase 2, slice 3 edge shapes, exact against the plain versions:
    1-7 key columns of every kind (strings of 0-12 bytes with bytes >=
    0x80, INT64_MIN and negative longs, -0.0, NaN and +-inf doubles and
    floats, int32, int16, bools), ascending and descending, nulls first
    and last, -0.0 folded or not, dead rows, a join side's leading rank,
    every live row dead, partial tiles, and K11 at empty, sparse and full
    occupancy. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.ops import common, segmented
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        boolean,
        double,
        float_t,
        integer,
        long,
        short,
        string,
    )

    rng = np.random.default_rng(6)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def columns(n):
        lengths = rng.integers(0, 13, n).astype(np.int32)
        data = rng.integers(0, 256, (n, 12)).astype(np.uint8)
        data[np.arange(12)[None, :] >= lengths[:, None]] = 0
        v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        v[:4] = [-(1 << 63), -1, 0, (1 << 63) - 1]
        specials = [0.0, -0.0, np.nan, 1.5, -2.25, np.inf, -np.inf]
        return [
            _col(string, t(data), t(rng.random(n) < 0.9), t(lengths)),
            _col(long, t(v), t(rng.random(n) < 0.9)),
            _col(double, t(rng.choice(specials, n)), t(rng.random(n) < 0.9)),
            _col(integer, t(rng.integers(-9, 9, n).astype(np.int32)),
                 t(rng.random(n) < 0.8)),
            _col(float_t, t(rng.choice(specials, n).astype(np.float32)),
                 t(rng.random(n) < 0.8)),
            _col(short, t(rng.integers(0, 5, n).astype(np.int16)),
                 t(rng.random(n) < 0.95)),
            _col(boolean, t(rng.random(n) < 0.5), t(rng.random(n) < 0.8)),
        ]

    # below, at and past one sort block's 4,096 rows, and many blocks
    for n in (1000, 4096, 5000, 32768, 32769, 70001):
        cols = columns(n)
        live = t(np.arange(n) < n - 17)
        for k in range(1, len(cols) + 1):
            for asc in (True, False):
                specs = [common.KeySpec(c, asc, i % 2 == 0, True, False,
                                        i % 3 == 0)
                         for i, c in enumerate(cols[:k])]
                w, av = common.pack_keys(specs, live, want_all_valid=True)
                wp, avp = common.pack_keys_plain(specs, live)
                exact(f"pack_keys n={n} k={k}", w, wp)
                exact(f"pack_keys all_valid n={n} k={k}", av, avp)
                p = common.sort_words(w)
                exact(f"sort_words n={n} k={k} asc={asc}", p,
                      common.sort_permutation_plain(list(wp.unbind(0)), n))
                for a, b in zip(segmented.group_bounds(w, p, live),
                                segmented.group_bounds_plain(wp, p, live)):
                    exact(f"group_bounds n={n} k={k}", a, b)
                cases += 1
        specs = [common.KeySpec(c, with_rank=False, normalize_zero=True)
                 for c in cols[:2]]
        w, _ = common.pack_keys(specs, live, lead_rank=True)
        exact(f"pack_keys lead rank n={n}", w,
              common.pack_keys_plain(specs, live, lead_rank=True)[0])
        for p_occ in (0.0, 0.3, 1.0):
            occ = t(rng.random(n) < p_occ)
            exact(f"dense_bin_perm n={n} p={p_occ}",
                  segmented.dense_bin_perm(occ, n),
                  segmented.dense_bin_perm_plain(occ, n))
        cases += 4
    dead = torch.zeros(4096, dtype=torch.bool, device=dev)
    w, _ = common.pack_keys([common.KeySpec(columns(4096)[5])], dead)
    p = common.sort_words(w)
    for a, b in zip(segmented.group_bounds(w, p, dead),
                    segmented.group_bounds_plain(w, p, dead)):
        exact("group_bounds with every row dead", a, b)
    cases += 1
    torch.cuda.synchronize()
    return cases


def check_edge_shapes(dev) -> int:
    """Phase 2, small shapes the q5 run does not reach: partial tiles,
    two and three key words with null rows, several matches per row, ids
    out of range, bins beyond shared memory. Exact against the plain
    versions; returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.ops import filterops, joinops, segmented

    rng = np.random.default_rng(2)
    cases = 0
    for cap, p in ((1024, 0.5), (2048, 0.0), (2048, 1.0), (12288, 0.3)):
        keep = torch.from_numpy(rng.random(cap) < p).to(dev)
        for a, b in zip(filterops.compact_perm(keep, cap),
                        filterops.compact_perm_plain(keep, cap)):
            exact(f"compact_perm cap {cap}", a, b)
        cases += 1
    for w, bcap, n in ((1, 1024, 3000), (2, 4096, 5000), (3, 16384, 777)):
        words = [rng.integers(0, 50, bcap)] + [rng.integers(0, 4, bcap)
                                                for _ in range(w - 1)]
        order = np.lexsort(words[::-1])  # sorted by word 0, then 1, ...
        build = [torch.from_numpy(x[order]).to(dev) for x in words]
        probe = [torch.from_numpy(rng.integers(-2, 52 if i == 0 else 5, n))
                 .to(dev) for i in range(w)]
        all_valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        bound = torch.tensor(bcap - 7, dtype=torch.int32, device=dev)
        args = (build, probe, bound, all_valid, bcap)
        for a, b in zip(joinops.probe_bounds(*args),
                        joinops.probe_bounds_plain(*args)):
            exact(f"probe_ranges W={w}", a, b)
        cases += 1
    for n, hi in ((1024, 3), (5000, 1), (9000, 4)):
        counts = torch.from_numpy(rng.integers(0, hi, n).astype(np.int32))
        lo = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
        counts, lo = counts.to(dev), lo.to(dev)
        out_cap = max(1024, 1 << max(0, int(counts.sum()) - 1).bit_length())
        for a, b in zip(joinops.expand_gather_maps(lo, counts, out_cap),
                        joinops.expand_gather_maps_plain(lo, counts,
                                                         out_cap)):
            exact(f"expand_gather_maps n={n}", a, b)
        cases += 1
    for n, nseg, k, ordered in ((20000, 2000, 4, False), (3000, 64, 0, True),
                                (70000, 30000, 2, False)):
        gid = torch.from_numpy(rng.integers(-1, nseg + 1, n)
                               .astype(np.int32)).to(dev)
        if ordered:
            gid = torch.sort(gid).values
        valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        vals = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))
                .to(dev) for _ in range(k)]
        masks = [None if j % 2 else torch.from_numpy(rng.random(n) < 0.6)
                 .to(dev) for j in range(k)]
        args = (vals, valid, gid, nseg, masks)
        if ordered:
            got = segmented.seg_sum_count_multi(*args, value_counts=True)
        else:
            with segmented.unsorted_gids():
                got = segmented.seg_sum_count_multi(*args, value_counts=True)
        want = segmented.seg_sum_count_plain(*args, value_counts=True)
        for a, b in zip(got.sums + got.value_counts + [got.count],
                        want.sums + want.value_counts + [want.count]):
            exact(f"seg_sum_count n={n} bins={nseg} k={k}", a, b)
        cases += 1
    torch.cuda.synchronize()
    return cases


def same_bits(name: str, got, want) -> None:
    """Exact, NaNs included: floats compare by their bit patterns."""
    import torch

    if got.dtype.is_floating_point:
        ity = {torch.float32: torch.int32, torch.float64: torch.int64}
        got, want = got.view(ity[got.dtype]), want.view(ity[want.dtype])
    exact(name, got, want)


def close_where(name: str, got, want, valid) -> float:
    """float64 results within REL_TOL relative where `valid`; returns the
    largest relative difference."""
    import torch

    g, w = got[valid], want[valid]
    if g.numel() == 0:
        return 0.0
    rel = float(((g - w).abs() / w.abs().clamp(min=1e-300)).max().item())
    if not rel <= REL_TOL:
        fail(f"{name}: float64 results off by {rel} relative")
    return rel


def _window_inputs(dev, cap: int, live_rows: int, seed: int):
    """The window query's input as the fused engine concatenates it: the
    8 cached parts' rows (store, day, amount) compacted to the front of a
    `cap`-row batch."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import double, long

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def live_part(x):
        x[live_rows:] = 0
        return x

    store = live_part(torch.randint(0, STORES, (cap,), generator=g,
                                    device=dev))
    day = live_part(torch.randint(0, 365, (cap,), generator=g, device=dev))
    amount = live_part(torch.rand(cap, generator=g, device=dev,
                                  dtype=torch.float64) * 100.0)
    valid = torch.arange(cap, device=dev) < live_rows
    schema = StructType([StructField("store", long), StructField("day", long),
                         StructField("amount", double)])
    cols = [_col(long, store, valid.clone()), _col(long, day, valid.clone()),
            _col(double, amount, valid.clone())]
    return ColumnBatch(schema, cols, live_rows)


def check_slice4_kernels(dev):
    """Phase 2, slice 4: K12 (segmented min/max), K13 (the sorted-run
    merge) and K14 (the window's prefix and its evaluation) against their
    plain versions at the shapes the path gives them: the fused window's
    sorted domain (36M live rows of 8 parts of 4,718,592; ~2,000
    partitions and ~730,000 (store, day) peer runs) and two 2^22-row
    (store, qty) runs. Returns {kernel name: record}."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.expr.core import BoundReference
    from spark_rapids_tpu_torch.ops import common, segmented, sortops
    from spark_rapids_tpu_torch.ops import windowops as W
    from spark_rapids_tpu_torch.plan.logical import SortOrder
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import long

    from spark_rapids_tpu_torch.exec.fused import bucket_capacity

    out = {}
    cap = FILES * bucket_capacity(ROWS // FILES)
    batch = _window_inputs(dev, cap, ROWS, 8)
    store, day, amount = batch.columns
    live = batch.live_mask()
    sw = W.sort_for_window(batch, [store], [(day, True, True)])
    words, _ = common.pack_keys([common.KeySpec(store, True, True, True,
                                                False, True)], live)
    gid = segmented.group_bounds(words, sw.perm, live).gid
    del words
    live_pos = torch.where(sw.live, sw.pos, cap)
    nparts = int(gid.max().item()) + 1
    npeers = int(sw.pid.max().item()) + 1

    # K12: the partitions' first positions (sorted gid, no validity)
    got = segmented.seg_min(live_pos, None, gid, cap)
    want = segmented.seg_minmax_plain(live_pos, None, gid, cap, False)
    torch.cuda.synchronize()
    exact("seg_min partition starts", got, want)
    for ids, what in ((gid, "partition"), (sw.pid, "peer")):
        exact(f"seg_max {what} ends",
              segmented.seg_max(torch.where(sw.live, sw.pos, -1), None, ids,
                                cap),
              segmented.seg_minmax_plain(torch.where(sw.live, sw.pos, -1),
                                         None, ids, cap, True))
    gid64 = gid.to(torch.int64)
    i32_max = torch.full((cap,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
    out["seg_minmax"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/seg_minmax.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:420",
        max_abs_err=max_abs_err(got, want),
        **timed("seg_minmax",
                lambda: segmented.seg_min(live_pos, None, gid, cap),
                lambda: segmented.seg_minmax_plain(live_pos, None, gid, cap,
                                                   False),
                lambda: i32_max.clone().scatter_reduce_(0, gid64, live_pos,
                                                        "amin")),
        # each row's value and gid read once, the segments written once
        bound_ms=bound_ms(cap * (4 + 4) + cap * 4), bound_by="bytes",
        shape=f"positions [{cap}] int32, {nparts} sorted segments "
              f"(partitions)")
    peer_ms = device_ms(lambda: segmented.seg_min(live_pos, None, sw.pid,
                                                  cap), "seg_min peers")
    out["seg_minmax"]["extra"] = (
        f"the {npeers} peer runs: kernel_ms={peer_ms:.4f}")
    del gid64, i32_max

    # K14 prefix: the running sum's float64 prefix through the sort,
    # restarted at each partition
    amt = amount.data
    p = W.window_prefix(amt, amount.validity, sw.live, sw.perm,
                        torch.float64, sw.seg_start)
    p_plain = W.window_prefix_plain(amt, amount.validity, sw.live, sw.perm,
                                    torch.float64, sw.seg_start)
    torch.cuda.synchronize()
    rel = close_where("window_prefix", p, p_plain,
                      torch.ones_like(p, dtype=torch.bool))
    sorted_amt = torch.where(
        sw.live & amount.validity.index_select(0, sw.perm.to(torch.int64)),
        amt.index_select(0, sw.perm.to(torch.int64)), 0.0)
    whole_ms = device_ms(lambda: W.window_prefix(
        amt, amount.validity, sw.live, sw.perm, torch.float64),
        "window_prefix whole batch")
    cumsum_ms = device_ms(lambda: torch.cumsum(sorted_amt, 0),
                          "window_prefix cumsum")
    out["window_prefix"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/window_frames.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:227",
        max_abs_err=max_abs_err(p, p_plain),
        **timed("window_prefix",
                lambda: W.window_prefix(amt, amount.validity, sw.live,
                                        sw.perm, torch.float64,
                                        sw.seg_start),
                lambda: W.window_prefix_plain(amt, amount.validity, sw.live,
                                              sw.perm, torch.float64,
                                              sw.seg_start), None),
        # perm, live_s and seg_start a row, value and validity a live row,
        # p out
        bound_ms=bound_ms(cap * (4 + 1 + 4) + ROWS * (8 + 1)
                          + (cap + 1) * 8),
        bound_by="bytes", rel_err=rel,
        shape=f"amount [{cap}] float64 through perm, {ROWS} live rows, "
              f"restarted at {nparts} partitions",
        extra=f"the whole-batch prefix (int64 counts): "
              f"kernel_ms={whole_ms:.4f}; torch.cumsum of the sorted "
              f"values (no restarts) {cumsum_ms:.4f} ms")
    del sorted_amt, p_plain

    # K14 evaluation: row_number, rank, dense_rank and the running sum
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)
    frame = W.frame_of(None, True)
    reqs = [W.WinRequest(kernels.WIN_ROW_NUMBER),
            W.WinRequest(kernels.WIN_RANK),
            W.WinRequest(kernels.WIN_DENSE_RANK),
            W.WinRequest(kernels.WIN_SUM_F64, frame, p, pcnt)]
    got = W.window_eval(sw, reqs, sw.perm)
    want = W.window_eval_plain(sw, reqs, sw.perm)
    torch.cuda.synchronize()
    err, rel = 0, 0.0
    for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        exact(f"window_eval validity {k}", gv, wv)
        if gd.dtype.is_floating_point:
            rel = close_where("window_eval sum", gd, wd, wv)
        else:
            exact(f"window_eval rank {k}", gd, wd)
            err = max(err, max_abs_err(gd, wd))
    out["window_eval"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/window_frames.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:397",
        max_abs_err=err,
        **timed("window_eval", lambda: W.window_eval(sw, reqs, sw.perm),
                lambda: W.window_eval_plain(sw, reqs, sw.perm), None),
        # perm, seg_start, peer_start, peer_end, pid and both prefixes a
        # row; three int32 and one float64 column with validity out
        bound_ms=bound_ms(cap * (5 * 4 + 2 * 8) + cap * (3 * 5 + 9)),
        bound_by="bytes", rel_err=rel,
        shape=f"{cap} sorted rows, {nparts} partitions, {npeers} peer "
              "runs -> rn, rk, drk, run_amount")
    del batch, sw, got, want, p, pcnt, live_pos, gid
    torch.cuda.empty_cache()

    # K13: two sorted 2^22-row (store, qty) runs, as the merge tree meets
    # them
    n = MERGE_ROWS
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    schema = StructType([StructField("store", long),
                         StructField("qty", long)])
    orders = [SortOrder(BoundReference(0, long), True),
              SortOrder(BoundReference(1, long), True)]
    runs = []
    for _ in range(2):
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        b = ColumnBatch(schema, [
            _col(long, torch.randint(0, STORES, (n,), generator=g,
                                     device=dev), ones),
            _col(long, torch.randint(1, 100, (n,), generator=g, device=dev),
                 ones.clone())], n)
        runs.append(sortops.sort_batch(b, orders))
    ka, kb = (sortops.order_keys(r, orders) for r in runs)
    la = [x for c in runs[0].columns for x in c.leaves()]
    lb = [x for c in runs[1].columns for x in c.leaves()]
    got = sortops.merge_runs(ka, kb, n, n, la, lb, 2 * n)
    want = sortops.merge_runs_plain(ka, kb, n, n, la, lb, 2 * n)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        exact(f"merge_runs leaf {k}", a, b)

    def merge_library():
        # a stable torch.sort chain over both runs' words, the first run's
        # first (its rows win ties), then each leaf gathered by it
        order = common.sort_permutation_plain(
            list(torch.cat([ka, kb], 1).unbind(0)), 2 * n).long()
        return [torch.cat([xa, xb]).index_select(0, order)
                for xa, xb in zip(la, lb)]

    for k, (a, b) in enumerate(zip(merge_library(), got)):
        exact(f"merge_runs library leaf {k}", a, b)
    leaf_bytes = sum(x[0].numel() * x.element_size() for x in la)
    out["merge_runs"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/merge_runs.cu",
        replaces="spark_rapids_tpu/ops/sortops.py:89",
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        **timed("merge_runs",
                lambda: sortops.merge_runs(ka, kb, n, n, la, lb, 2 * n),
                lambda: sortops.merge_runs_plain(ka, kb, n, n, la, lb,
                                                 2 * n), merge_library),
        # both runs' key words and leaves read once, the output written
        bound_ms=bound_ms(2 * n * (ka.shape[0] * 8 + leaf_bytes)
                          + 2 * n * leaf_bytes),
        bound_by="bytes",
        shape=f"two runs of {n} (store, qty) rows, {ka.shape[0]} key words")
    del runs, ka, kb, la, lb, got, want
    torch.cuda.empty_cache()
    return out


def check_slice4_edges(dev) -> int:
    """Phase 2, slice 4 edge shapes against the plain versions: K12 over
    every type, sorted and unsorted ids, 0 and 1 rows, every row invalid,
    runs across a warp's 512 rows and a block's 4,096, ids out of range,
    NaN, +-inf and -0.0 (bit for bit); K13 with empty, one-row and dead
    runs, long, double and string keys of other widths in both
    directions with nulls first and last, and more than 32 leaves; K14 at
    1 row, every row dead, 4,095-4,097 rows, ROWS frames and given bounds,
    counts, averages and int64 sums, with and without the write-back.
    Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.expr.core import BoundReference
    from spark_rapids_tpu_torch.ops import segmented, sortops
    from spark_rapids_tpu_torch.ops import windowops as W
    from spark_rapids_tpu_torch.plan.logical import SortOrder
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        double,
        long,
        string,
    )

    rng = np.random.default_rng(10)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # K12
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5]
    for np_t in (np.int32, np.int64, np.float32, np.float64):
        for n in (0, 1, 511, 512, 513, 4095, 4096, 4097, 70001):
            for is_sorted in (True, False):
                nseg = max(1, n // 3)
                gid = rng.integers(-2, nseg + 2, n).astype(np.int32)
                if n > 40:
                    gid[:40] = 3  # one long run across lanes
                if is_sorted:
                    gid = np.sort(gid)
                if np.issubdtype(np_t, np.floating):
                    v = rng.choice(specials, n).astype(np_t)
                else:
                    v = rng.integers(-1000, 1000, n).astype(np_t)
                valid = rng.random(n) < (0.0 if n == 513 else 0.8)
                for is_max in (False, True):
                    args = (t(v), t(valid), t(gid), nseg)
                    if is_sorted:
                        got = segmented._seg_minmax(*args, is_max)
                    else:
                        with segmented.unsorted_gids():
                            got = segmented._seg_minmax(*args, is_max)
                    same_bits(f"seg_minmax {np_t.__name__} n={n} "
                              f"sorted={is_sorted} max={is_max}", got,
                              segmented.seg_minmax_plain(*args, is_max))
                    cases += 1

    # K13
    words = ["", "a", "ab", "abc", "zz", "zzzzzz", "m"]

    def run(n, live, width_words, orders):
        lengths = np.array([len(w) for w in width_words])
        pick = rng.integers(0, len(width_words), n)
        mb = max(1, int(lengths.max()))
        data = np.zeros((n, mb), np.uint8)
        for i, w in enumerate(pick):
            b = width_words[w].encode()
            data[i, :len(b)] = np.frombuffer(b, np.uint8) if b else 0
        cols = [_col(long, t(rng.integers(0, 9, n)), t(rng.random(n) < 0.9)),
                _col(double, t(rng.choice(specials, n)),
                     t(rng.random(n) < 0.9)),
                _col(string, t(data), t(rng.random(n) < 0.9),
                     t(lengths[pick].astype(np.int32)))]
        schema = StructType([StructField("l", long), StructField("d", double),
                             StructField("s", string)])
        return sortops.sort_batch(ColumnBatch(schema, cols, live), orders)

    for (na, ca), (nb, cb) in (((1, 1), (1, 1)), ((0, 1024), (50, 1024)),
                               ((0, 64), (0, 64)), ((4095, 4096),
                                                     (4097, 8192)),
                               ((1460, 2048), (4700, 8192))):
        for asc, nf in ((True, True), (False, False), (True, False)):
            for keys in ([0], [1], [2], [2, 0, 1]):
                orders = [SortOrder(BoundReference(k, [long, double,
                                                       string][k]),
                                    asc, nf) for k in keys]
                a = run(ca, na, words, orders)
                b = run(cb, nb, words + ["q" * 15], orders)
                a2, b2 = sortops.align_string_widths(a, b)
                ka = sortops.order_keys(a2, orders)
                kb = sortops.order_keys(b2, orders)
                la = [x for c in a2.columns for x in c.leaves()]
                lb = [x for c in b2.columns for x in c.leaves()]
                out_cap = max(1, na + nb + 7)
                for k, (x, y) in enumerate(zip(
                        sortops.merge_runs(ka, kb, na, nb, la, lb, out_cap),
                        sortops.merge_runs_plain(ka, kb, na, nb, la, lb,
                                                 out_cap))):
                    same_bits(f"merge_runs {na}/{nb} keys={keys} "
                              f"asc={asc} leaf {k}", x, y)
                cases += 1
    # more than 32 leaves: two scatter launches over one search
    n = 3000
    la = [t(rng.integers(0, 100, n).astype(np.int16)) for _ in range(40)]
    lb = [t(rng.integers(0, 100, n).astype(np.int16)) for _ in range(40)]
    ka = t(np.sort(rng.integers(0, 50, (1, n)), axis=1))
    kb = t(np.sort(rng.integers(0, 50, (1, n)), axis=1))
    for k, (x, y) in enumerate(zip(
            sortops.merge_runs(ka, kb, n - 3, n, la, lb, 2 * n),
            sortops.merge_runs_plain(ka, kb, n - 3, n, la, lb, 2 * n))):
        exact(f"merge_runs 40 leaves leaf {k}", x, y)
    cases += 1

    # K14
    for cap, live_rows in ((1, 1), (600, 0), (4095, 4000), (4096, 4096),
                           (4097, 3000), (70001, 69000)):
        batch = _window_inputs(dev, cap, live_rows, 11 + cap)
        store, day, amount = batch.columns
        store.data.remainder_(37)  # many small partitions
        sw = W.sort_for_window(batch, [store], [(day, True, True)])
        qty = store.data * 3 - 50
        pos = sw.pos
        frames = [W.frame_of(None, True), W.Frame(kernels.WIN_OFFSET,
                                                  kernels.WIN_OFFSET, -2, 1),
                  W.Frame(kernels.WIN_SEG, kernels.WIN_OFFSET, 0, 0),
                  W.Frame(kernels.WIN_GIVEN, kernels.WIN_GIVEN,
                          start=torch.maximum(pos - 3, sw.seg_start),
                          end=torch.minimum(pos + 2, sw.seg_end))]
        for perm in (None, sw.perm):
            pf = W.window_prefix(amount.data, amount.validity, sw.live,
                                 sw.perm, torch.float64, sw.seg_start)
            close_where(f"window_prefix float64 cap={cap}", pf,
                        W.window_prefix_plain(amount.data, amount.validity,
                                              sw.live, sw.perm,
                                              torch.float64, sw.seg_start),
                        torch.ones_like(pf, dtype=torch.bool))
            pi = W.window_prefix(qty, amount.validity, sw.live, sw.perm,
                                 torch.int64)
            pc = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                                 torch.int64)
            same_bits(f"window_prefix int64 cap={cap}", pi,
                      W.window_prefix_plain(qty, amount.validity, sw.live,
                                            sw.perm, torch.int64))
            same_bits(f"window_prefix count cap={cap}", pc,
                      W.window_prefix_plain(None, amount.validity, sw.live,
                                            sw.perm, torch.int64))
            reqs = [W.WinRequest(k) for k in (kernels.WIN_ROW_NUMBER,
                                              kernels.WIN_RANK,
                                              kernels.WIN_DENSE_RANK)]
            for fr in frames:
                reqs += [W.WinRequest(kernels.WIN_SUM_F64, fr, pf, pc),
                         W.WinRequest(kernels.WIN_SUM_I64, fr, pi, pc),
                         W.WinRequest(kernels.WIN_COUNT, fr, pcnt=pc),
                         W.WinRequest(kernels.WIN_AVG, fr, pf, pc)]
            got = W.window_eval(sw, reqs, perm)
            want = W.window_eval_plain(sw, reqs, perm)
            for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
                exact(f"window_eval cap={cap} out {k} validity", gv, wv)
                if gd.dtype.is_floating_point:
                    close_where(f"window_eval cap={cap} out {k}", gd, wd,
                                wv)
                else:
                    exact(f"window_eval cap={cap} out {k}", gd, wd)
            cases += 1
    torch.cuda.synchronize()
    return cases


def _fact_batch(dev, cap: int, live_rows: int, seed: int):
    """The fact table's four columns as the fused engine concatenates them
    (store, day, amount, qty), live rows at the front of `cap`."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import long

    batch = _window_inputs(dev, cap, live_rows, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    qty = torch.randint(1, 100, (cap,), generator=g, device=dev)
    qty[live_rows:] = 0
    valid = batch.columns[0].validity
    schema = StructType(list(batch.schema.fields) + [StructField("qty",
                                                                long)])
    return ColumnBatch(schema, list(batch.columns)
                       + [_col(long, qty, valid.clone())], live_rows)


def check_slice5_kernels(dev):
    """Phase 2, slice 5: K15 (RANGE bounds), K16 (min/max frames), K17
    (first/last and lead/lag sources), K14's inverse permutation and its
    new kinds (percent_rank, cume_dist, ntile) against their plain
    versions at the fused engine's shapes: 36M live rows of 8 parts of
    4,718,592, sorted by (store, day) for range_query and by (store, day,
    amount) for moving_query. Returns {record name: record}."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.exec.fused import bucket_capacity
    from spark_rapids_tpu_torch.ops import windowops as W

    out = {}
    cap = FILES * bucket_capacity(ROWS // FILES)
    batch = _fact_batch(dev, cap, ROWS, 21)
    store, day, amount, qty = batch.columns
    src = "spark_rapids_tpu_torch/kernels/csrc/"

    # range_query's domain: partitions by store, ordered by day
    sw = W.sort_for_window(batch, [store], [(day, True, True)])
    nparts = int((sw.seg_start == sw.pos).sum().item())

    # K14's inverse permutation
    inv = W.inverse_permutation(sw.perm)
    want = W.inverse_permutation_plain(sw.perm)
    torch.cuda.synchronize()
    exact("window_inverse", inv, want)
    out["window_inverse"] = dict(
        route="cuda", source=src + "window_frames.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:113",
        max_abs_err=max_abs_err(inv, want),
        **timed("window_inverse", lambda: W.inverse_permutation(sw.perm),
                lambda: W.inverse_permutation_plain(sw.perm),
                lambda: torch.argsort(sw.perm)),
        bound_ms=bound_ms(cap * (4 + 4)), bound_by="bytes",
        shape=f"perm [{cap}] int32")

    # K15: the lower side of RANGE BETWEEN 6 PRECEDING AND CURRENT ROW
    start, _ = W.range_bounds(sw, day.data, day.validity, sw.perm, -6, None,
                              True)
    want, _ = W.range_bounds_plain(sw, day.data, day.validity, sw.perm, -6,
                                   None, True)
    torch.cuda.synchronize()
    exact("range_bounds", start, want)
    day_s = torch.where(sw.live, day.data.index_select(
        0, sw.perm.to(torch.int64)), 1 << 20)
    keys = sw.seg_start.to(torch.int64) * 2048 + day_s
    targets = keys - 6
    out["range_bounds"] = dict(
        route="cuda", source=src + "range_bounds.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:167",
        max_abs_err=max_abs_err(start, want),
        **timed("range_bounds",
                lambda: W.range_bounds(sw, day.data, day.validity, sw.perm,
                                       -6, None, True),
                lambda: W.range_bounds_plain(sw, day.data, day.validity,
                                             sw.perm, -6, None, True),
                lambda: torch.searchsorted(keys, targets)),
        # perm, live_s, the key and its validity in, start out
        bound_ms=bound_ms(cap * (4 + 1 + 8 + 1 + 4)), bound_by="bytes",
        shape=f"day [{cap}] int64 through perm, {nparts} partitions, "
              "lower offset -6")
    del want, day_s, keys, targets

    # K16: min of amount over those RANGE frames, with its validity
    fr = W.Frame(kernels.WIN_GIVEN, kernels.WIN_PEER, start=start)
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)
    got = W.frame_minmax_eval(amount.data, amount.validity, sw, fr, False,
                              pcnt, sw.perm, inv)
    want = W.frame_minmax_plain(amount.data, amount.validity, sw, fr, False,
                                pcnt, sw.perm)
    torch.cuda.synchronize()
    same_bits("frame_minmax", got[0], want[0])
    exact("frame_minmax validity", got[1], want[1])
    out["frame_minmax"] = dict(
        route="cuda", source=src + "frame_minmax.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:271",
        max_abs_err=max_abs_err(got[0], want[0]),
        **timed("frame_minmax",
                lambda: W.frame_minmax_eval(amount.data, amount.validity, sw,
                                            fr, False, pcnt, sw.perm, inv),
                lambda: W.frame_minmax_plain(amount.data, amount.validity,
                                             sw, fr, False, pcnt, sw.perm),
                None),
        # perm, live_s, value, validity, inv, seg_start, the given start,
        # peer_end and two prefix reads in; result and validity out
        bound_ms=bound_ms(cap * (4 + 1 + 8 + 1 + 4 + 4 + 4 + 4 + 16 + 8
                                 + 1)),
        bound_by="bytes",
        shape=f"amount [{cap}] float64, RANGE frames of days [d - 6, d] "
              f"over {nparts} partitions")
    del got, want

    # K14's new kinds: percent_rank, cume_dist, ntile(4) in input order
    reqs = [W.WinRequest(kernels.WIN_PERCENT_RANK),
            W.WinRequest(kernels.WIN_CUME_DIST),
            W.WinRequest(kernels.WIN_NTILE, buckets=4)]
    got = W.window_eval(sw, reqs, sw.perm, inv)
    want = W.window_eval_plain(sw, reqs, sw.perm)
    torch.cuda.synchronize()
    for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        same_bits(f"window_eval rank kind {k}", gd, wd)
        exact(f"window_eval rank kind {k} validity", gv, wv)
    out["window_eval_ranks"] = dict(
        route="cuda", source=src + "window_frames.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:413",
        counter="window_eval",
        max_abs_err=max(max_abs_err(g[0], w[0]) for g, w in zip(got, want)),
        **timed("window_eval_ranks",
                lambda: W.window_eval(sw, reqs, sw.perm, inv),
                lambda: W.window_eval_plain(sw, reqs, sw.perm), None),
        # inv and four bound arrays in; two float64 and one int32 column
        # with validity out
        bound_ms=bound_ms(cap * (4 + 4 * 4) + cap * (9 + 9 + 5)),
        bound_by="bytes",
        shape=f"{cap} sorted rows, {nparts} partitions -> percent_rank, "
              "cume_dist, ntile(4)")
    del got, want, sw, inv, start, pcnt, fr
    torch.cuda.empty_cache()

    # moving_query's domain: ordered by (day, amount)
    sw = W.sort_for_window(batch, [store], [(day, True, True),
                                            (amount, True, True)])
    inv = W.inverse_permutation(sw.perm)
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)
    week = W.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, -6, 0)
    picks = [W.Pick(kernels.PICK_SHIFT, offset=-1),
             W.Pick(kernels.PICK_SHIFT, offset=2),
             W.Pick(kernels.PICK_FIRST, week),
             W.Pick(kernels.PICK_LAST_VALID, week, pcnt=pcnt)]
    got = W.frame_pick(sw, picks, sw.perm, inv)
    want = W.frame_pick_plain(sw, picks, sw.perm)
    torch.cuda.synchronize()
    for k, ((gs, gh), (ws, wh)) in enumerate(zip(got, want)):
        exact(f"frame_pick {k} src", gs, ws)
        exact(f"frame_pick {k} has", gh, wh)
    out["frame_pick"] = dict(
        route="cuda", source=src + "frame_pick.cu",
        replaces="spark_rapids_tpu/ops/windowops.py:318",
        max_abs_err=max(max_abs_err(g[0], w[0]) for g, w in zip(got, want)),
        **timed("frame_pick", lambda: W.frame_pick(sw, picks, sw.perm, inv),
                lambda: W.frame_pick_plain(sw, picks, sw.perm), None),
        # inv, seg_start, seg_end and two prefix reads in; perm read and
        # src and has written for each of the four picks
        bound_ms=bound_ms(cap * (4 + 4 + 4 + 16) + cap * 4 * (4 + 4 + 1)),
        bound_by="bytes",
        shape=f"{cap} rows by (store, day, amount): lag 1, lead 2, first "
              "and last ignoring nulls of ROWS 6 PRECEDING")
    moving_ms = device_ms(lambda: W.frame_minmax_eval(
        amount.data, amount.validity, sw, week, True, pcnt, sw.perm, inv),
        "frame_minmax moving")
    running = W.Frame(kernels.WIN_SEG, kernels.WIN_OFFSET, 0, 0)
    running_ms = device_ms(lambda: W.frame_minmax_eval(
        amount.data, amount.validity, sw, running, False, pcnt, sw.perm,
        inv), "frame_minmax running")
    out["frame_minmax"]["extra"] = (
        f"max over ROWS 6 PRECEDING: kernel_ms={moving_ms:.4f}; running "
        f"min: kernel_ms={running_ms:.4f}")
    del batch, sw, inv, pcnt, got, want
    torch.cuda.empty_cache()
    return out


def check_slice5_edges(dev) -> int:
    """Phase 2, slice 5 edge shapes against the plain versions, at 1 to
    70,001 rows, every row dead, partitions of one row and of thousands:
    K15 over int16, int32, int64 and float64 keys (nulls, NaN, +-inf and
    -0.0) in both null orders with integer, fractional and larger-than-
    any-partition offsets; K16 over int8, int16, int32, int64, float32,
    float64 and bool values (nulls, NaN, +-inf and -0.0, bit for bit) over
    empty, one-tile, many-tile, whole-partition and RANGE frames; K17's
    five kinds with shifts of 1-3 and past the partition; K14's inverse
    and new kinds with ntile(1, 3, 7). Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.ops import windowops as W

    rng = np.random.default_rng(12)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5])
    for cap, live_rows, nstore in ((1, 1, 1), (600, 0, 5), (4095, 4000, 37),
                                   (4097, 3000, 2), (70001, 69000, 37)):
        batch = _fact_batch(dev, cap, live_rows, 30 + cap)
        store, day, amount, qty = batch.columns
        store.data.remainder_(nstore)
        sw = W.sort_for_window(batch, [store], [(day, True, True)])
        n = cap
        valid = t(rng.random(n) < 0.85)
        # K15
        f = rng.integers(-30, 30, n).astype(np.float64)
        pick = rng.random(n) < 0.2
        f[pick] = rng.choice(specials, int(pick.sum()))
        keys = {"int16": t(rng.integers(-50, 50, n).astype(np.int16)),
                "int32": t(rng.integers(-50, 50, n).astype(np.int32)),
                "int64": t(rng.integers(-50, 50, n)),
                "float64": t(f)}
        for kname, key in keys.items():
            for nf in (True, False):
                for lower, upper in ((-3, 2), (1, 4), (-1.5, 0.5),
                                     (-100000, 100000), (None, -2)):
                    for perm in (sw.perm, None):
                        args = (sw, key, valid, perm, lower, upper, nf)
                        for side, (g, w) in enumerate(zip(
                                W.range_bounds(*args),
                                W.range_bounds_plain(*args))):
                            if w is not None:
                                exact(f"range_bounds {kname} cap={cap} "
                                      f"nf={nf} {lower},{upper} "
                                      f"side {side}", g, w)
                        cases += 1
        given, _ = W.range_bounds(sw, keys["int64"], valid, sw.perm, -3,
                                  None, True)
        # K16
        d = rng.random(n) * 200 - 100
        pick = rng.random(n) < 0.3
        d[pick] = rng.choice(specials, int(pick.sum()))
        values = {"int8": t(rng.integers(-100, 100, n).astype(np.int8)),
                  "int16": t(rng.integers(-300, 300, n).astype(np.int16)),
                  "int32": t(rng.integers(-9, 9, n).astype(np.int32)),
                  "int64": t(rng.integers(-10**12, 10**12, n)),
                  "float32": t(d.astype(np.float32)), "float64": t(d),
                  "bool": t(rng.random(n) < 0.5)}
        pcnt = W.window_prefix(None, valid, sw.live, sw.perm, torch.int64)
        frames = [W.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, -2, 1),
                  W.Frame(kernels.WIN_SEG, kernels.WIN_OFFSET, 0, 0),
                  W.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, 3, 5),
                  W.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, -40, 40),
                  W.Frame(kernels.WIN_SEG, kernels.WIN_SEG),
                  W.Frame(kernels.WIN_GIVEN, kernels.WIN_PEER,
                          start=given)]
        for vname, v in values.items():
            for fr in frames:
                for is_max in (False, True):
                    for perm in (sw.perm, None):
                        g = W.frame_minmax_eval(v, valid, sw, fr, is_max,
                                                pcnt, perm)
                        w = W.frame_minmax_plain(v, valid, sw, fr, is_max,
                                                 pcnt, perm)
                        what = (f"frame_minmax {vname} cap={cap} "
                                f"{fr.start_kind}/{fr.end_kind} "
                                f"{fr.lower},{fr.upper} max={is_max}")
                        same_bits(what, g[0], w[0])
                        exact(what + " validity", g[1], w[1])
                        cases += 1
        # K17
        picks = [W.Pick(k, fr, pcnt=pcnt) for k in (
            kernels.PICK_FIRST, kernels.PICK_LAST, kernels.PICK_FIRST_VALID,
            kernels.PICK_LAST_VALID) for fr in frames[:4] + frames[5:]]
        picks += [W.Pick(kernels.PICK_SHIFT, offset=o)
                  for o in (1, 2, 3, -1, -2, -3, 100000, -100000)]
        for perm in (sw.perm, None):
            for k, ((gs, gh), (ws, wh)) in enumerate(zip(
                    W.frame_pick(sw, picks, perm),
                    W.frame_pick_plain(sw, picks, perm))):
                exact(f"frame_pick cap={cap} pick {k} src", gs, ws)
                exact(f"frame_pick cap={cap} pick {k} has", gh, wh)
                cases += 1
        # K14's inverse and new kinds
        exact(f"window_inverse cap={cap}", W.inverse_permutation(sw.perm),
              W.inverse_permutation_plain(sw.perm))
        reqs = [W.WinRequest(kernels.WIN_PERCENT_RANK),
                W.WinRequest(kernels.WIN_CUME_DIST)] + [
            W.WinRequest(kernels.WIN_NTILE, buckets=b) for b in (1, 3, 7)]
        for perm in (sw.perm, None):
            for k, ((gd, gv), (wd, wv)) in enumerate(zip(
                    W.window_eval(sw, reqs, perm),
                    W.window_eval_plain(sw, reqs, perm))):
                same_bits(f"window_eval cap={cap} rank kind {k}", gd, wd)
                exact(f"window_eval cap={cap} rank kind {k} validity", gv,
                      wv)
            cases += 2
    torch.cuda.synchronize()
    return cases


#: TPC-H ORDERS at SF10 (spec 4.2.5: 1,500,000 x SF rows); o_comment is
#: 19-78 bytes (4.2.3), so its byte matrix is 128 wide
ORDERS_ROWS = 15_000_000
ORDERS_WIDTH = 128
#: rows a plain version (and an oracle's chunk) takes at once at the path
#: shapes: the reference's byte matrices of int64 indices do not fit 80 GB
#: whole
PLAIN_CHUNK = 1 << 20
#: calls a plain version's device time is the mean of at the path shapes
#: (cut from 3 when phase 14 was added)
PLAIN_ITERS = 1


def _region_rows(dev, n: int, seed: int):
    """n decoded `region` rows as K8 decodes the dimension's dictionary
    after the join: [n, 16] uint8 (9 bytes each), lengths, validity."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dic = np.zeros((REGIONS, 16), dtype=np.uint8)
    for i in range(REGIONS):
        raw = f"region_{i:02d}".encode()
        dic[i, :len(raw)] = list(raw)
    codes = torch.from_numpy(rng.integers(0, REGIONS, n)).to(dev)
    data = torch.from_numpy(dic).to(dev)[codes]
    lengths = torch.full((n,), 9, dtype=torch.int32, device=dev)
    return data, lengths, torch.ones(n, dtype=torch.bool, device=dev)


def _comment_rows(dev, n: int, seed: int):
    """n ORDERS comments as q5.write_orders_data draws them (a 19-78 byte
    window of dbgen's text pool), built on the card: [n, 128] uint8 and
    lengths."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.q5 import text_pool

    rng = np.random.default_rng(seed)
    pool = torch.from_numpy(np.frombuffer(text_pool(rng, 100_000),
                                          dtype=np.uint8).copy()).to(dev)
    lengths = torch.from_numpy(rng.integers(19, 79, n).astype(
        np.int32)).to(dev)
    starts = torch.from_numpy(rng.integers(0, len(pool) - 78, n)).to(dev)
    data = torch.empty((n, ORDERS_WIDTH), dtype=torch.uint8, device=dev)
    ar = torch.arange(ORDERS_WIDTH, device=dev)
    for lo in range(0, n, PLAIN_CHUNK):
        hi = min(n, lo + PLAIN_CHUNK)
        idx = torch.clamp(starts[lo:hi, None] + ar, max=len(pool) - 1)
        data[lo:hi] = torch.where(ar < lengths[lo:hi, None], pool[idx], 0)
    return data, lengths


def _chunked(fn, n: int, chunk: int = PLAIN_CHUNK):
    """fn(lo, hi) over row ranges of `chunk`, each output concatenated:
    the plain versions at the path shapes."""
    import torch

    outs = [fn(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i] for o in outs])
                     for i in range(len(outs[0])))
    return torch.cat(outs)


def _exact_all(name: str, got, want) -> float:
    """exact() over one output or a tuple of them; the largest error, 0.0
    once all are equal (taken without the int64 copies max_abs_err makes,
    which would not fit beside a [15M, 512] output)."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        exact(f"{name} output {k}", g, w)
    return 0.0


def _strcol(data, lengths, validity):
    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.sqltypes.datatypes import string

    return DeviceColumn(string, data, validity, lengths)


def check_slice6_kernels(dev):
    """Phase 2, slice 6: K18-K21 against their plain versions at the path
    shapes: 15,000,000 ORDERS comments of width 128 (the q13 pattern,
    instr, the greedy selection, trim, replace's emission) and 36,000,000
    decoded `region` rows of width 16 (the rlike pattern, contains,
    substring, concat_ws with upper). The plain versions run in 2^20-row
    pieces (their byte-matrix temporaries do not fit the card whole).
    Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.expr import strings as S
    from spark_rapids_tpu_torch.ops import regexops as R
    from spark_rapids_tpu_torch.regex import compile_search

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    out = {}

    def record(name, csrc, replaces, kernel, plain, library, nbytes,
               shape, counter=None):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = _exact_all(name, got, want)
        del got, want
        rec = dict(route="cuda", source=src + csrc, replaces=replaces,
                   max_abs_err=err,
                   **timed(name, kernel, plain, library, PLAIN_ITERS),
                   bound_ms=bound_ms(nbytes), bound_by="bytes", shape=shape)
        if counter:
            rec["counter"] = counter
        out[name] = rec
        torch.cuda.empty_cache()

    # the ORDERS comments
    n = ORDERS_ROWS
    data, lens = _comment_rows(dev, n, 31)
    held = int(lens.sum().item())  # the bytes the rows hold
    q13 = compile_search("special.*requests")
    record("dfa_match", "dfa_match.cu", "spark_rapids_tpu/ops/regexops.py:18",
           lambda: R.dfa_match(data, lens, q13),
           lambda: _chunked(lambda lo, hi: R.dfa_match_plain(
               data[lo:hi], lens[lo:hi], q13), n), None,
           held + n * (4 + 1),
           f"o_comment [{n}, 128], 'special.*requests' "
           f"({q13.n_states} states x {q13.table.shape[1]} classes)")
    record("str_find", "str_find.cu",
           "spark_rapids_tpu/expr/strings.py:550",
           lambda: S._first_match_charpos(data, lens, b"furiously", 0),
           lambda: _chunked(lambda lo, hi: S._first_match_charpos_plain(
               data[lo:hi], lens[lo:hi], b"furiously", 0), n), None,
           held + n * (4 + 4), f"o_comment [{n}, 128], instr 'furiously'")
    record("str_find_select", "str_find.cu",
           "spark_rapids_tpu/expr/strings.py:289",
           lambda: S._select_nonoverlapping(data, lens, b"requests"),
           lambda: _chunked(lambda lo, hi: S._select_nonoverlapping_plain(
               data[lo:hi], lens[lo:hi], b"requests"), n), None,
           held + n * (4 + ORDERS_WIDTH),
           f"o_comment [{n}, 128], the starts of 'requests'",
           counter="str_find")
    space = np.zeros(256, dtype=np.int16)
    space[ord(" ")] = -1
    trim = S.Rewrite(K.REWRITE_TRIM, space, 1, 1)
    # trim's kept bytes: from the first byte that is not a space to the
    # last, inside the length
    body = (S._position_mask(data, lens) & (data != ord(" "))).to(
        torch.uint8)
    first = torch.argmax(body, dim=1, keepdim=True)
    last = ORDERS_WIDTH - 1 - torch.argmax(torch.flip(body, dims=[1]), dim=1,
                                           keepdim=True)
    pos = torch.arange(ORDERS_WIDTH, device=dev)[None, :]
    keep = (body.amax(dim=1, keepdim=True) > 0) & (pos >= first) & (
        pos <= last)
    del body, first, last, pos
    record("str_rewrite", "str_rewrite.cu",
           "spark_rapids_tpu/expr/strings.py:321",
           lambda: S._rewrite(data, lens, trim),
           lambda: _chunked(lambda lo, hi: S._rewrite_plain(
               data[lo:hi], lens[lo:hi], trim), n),
           lambda: torch.gather(data, 1, torch.argsort(
               (~keep).to(torch.uint8), dim=1, stable=True)),
           held + n * (4 + ORDERS_WIDTH + 4),
           f"o_comment [{n}, 128], trim")
    del keep
    sel = S._select_nonoverlapping(data, lens, b"requests")
    col = _strcol(data, lens, torch.ones(n, dtype=torch.bool, device=dev))
    rep = S.Assemble(K.ASSEMBLE_REPLACE, b"reqs", 8, sel)
    mb_out = S._width(ORDERS_WIDTH * 4)
    record("str_assemble_replace", "str_assemble.cu",
           "spark_rapids_tpu/expr/strings.py:625",
           lambda: S._assemble([col], rep, mb_out),
           lambda: _chunked(lambda lo, hi: S._assemble_plain(
               [_strcol(data[lo:hi], lens[lo:hi], col.validity[lo:hi])],
               rep._replace(sel=sel[lo:hi]), mb_out), n), None,
           held + n * (4 + ORDERS_WIDTH) + n * (mb_out + 4),
           f"o_comment [{n}, 128] -> [{n}, {mb_out}], 'requests' -> "
           "'reqs' at K19's starts", counter="str_assemble")
    del data, lens, sel, col, rep
    torch.cuda.empty_cache()

    # the decoded region rows
    n = ROWS
    data, lens, valid = _region_rows(dev, n, 32)
    held = int(lens.sum().item())
    rx = compile_search("region_0[1-7]")
    record("dfa_match_region", "dfa_match.cu",
           "spark_rapids_tpu/ops/regexops.py:18",
           lambda: R.dfa_match(data, lens, rx),
           lambda: _chunked(lambda lo, hi: R.dfa_match_plain(
               data[lo:hi], lens[lo:hi], rx), n, 4 * PLAIN_CHUNK), None,
           held + n * (4 + 1), f"region [{n}, 16], 'region_0[1-7]'",
           counter="dfa_match")
    record("str_find_region", "str_find.cu",
           "spark_rapids_tpu/expr/strings.py:226",
           lambda: S._contains(data, lens, b"_0"),
           lambda: _chunked(lambda lo, hi: S._contains_plain(
               data[lo:hi], lens[lo:hi], b"_0"), n, 4 * PLAIN_CHUNK), None,
           held + n * (4 + 1), f"region [{n}, 16], contains '_0'",
           counter="str_find")
    sub = S.Rewrite(K.REWRITE_CHARS, a=8, b=2)
    pos = torch.arange(16, device=dev)[None, :]
    keep = (pos >= 7) & (pos < 9) & (pos < lens[:, None])
    record("str_rewrite_region", "str_rewrite.cu",
           "spark_rapids_tpu/expr/strings.py:102",
           lambda: S._rewrite(data, lens, sub),
           lambda: _chunked(lambda lo, hi: S._rewrite_plain(
               data[lo:hi], lens[lo:hi], sub), n, 4 * PLAIN_CHUNK),
           lambda: torch.gather(data, 1, torch.argsort(
               (~keep).to(torch.uint8), dim=1, stable=True)),
           held + n * (4 + 16 + 4), f"region [{n}, 16], substring(8, 2)",
           counter="str_rewrite")
    del keep
    up, _ = S._rewrite(data, lens, S.Rewrite(K.REWRITE_MAP, S._UPPER),
                       new_lengths=False)
    cols = [_strcol(data, lens, valid), _strcol(up, lens, valid)]
    ws = S.Assemble(K.ASSEMBLE_CONCAT_WS, b"|")
    # the reference's idiom: one gather from [region | '|' | upper | 0]
    # by each output byte's source column
    srcm = torch.cat([data, torch.full((n, 1), ord("|"), dtype=torch.uint8,
                                       device=dev), up,
                      torch.zeros((n, 1), dtype=torch.uint8, device=dev)], 1)
    j = torch.arange(64, device=dev)[None, :]
    ln = lens[:, None].to(torch.int64)
    idx = torch.where(j < ln, j, torch.where(
        j == ln, 16, torch.where(j < 2 * ln + 1, j - ln - 1 + 17, 33)))
    del ln, j
    record("str_assemble", "str_assemble.cu",
           "spark_rapids_tpu/expr/strings.py:679",
           lambda: S._assemble(cols, ws, 64),
           lambda: _chunked(lambda lo, hi: S._assemble_plain(
               [_strcol(c.data[lo:hi], c.lengths[lo:hi], c.validity[lo:hi])
                for c in cols], ws, 64), n, 4 * PLAIN_CHUNK),
           lambda: torch.gather(srcm, 1, idx),
           2 * (held + n * (4 + 1)) + n * (64 + 4),
           f"concat_ws('|', region, upper(region)): [{n}, 16] x 2 -> "
           f"[{n}, 64]")
    del data, lens, valid, up, cols, srcm, idx
    torch.cuda.empty_cache()
    return out


#: UTF-8 pieces the edge rows are drawn from: 1- to 4-byte characters,
#: spaces and the needles' bytes, and bare continuation bytes (a
#: character cut by the row's end or by a substring)
_EDGE_PIECES = (b"a", b"a", b"b", b" ", b"_", b"0", b"\xc3\xa9", b"\xe6\x97\xa5",
                b"\xf0\x9f\x98\x80", b"aa", b"\x80", b"\xbf")


def _edge_rows(rng, n: int, mb: int):
    """n rows of width mb, row i of length i % (mb + 1) cut from random
    pieces (so a multi-byte character may be cut at its end), every tenth
    row null and empty. Host numpy: (data, lengths, validity)."""
    import numpy as np

    data = np.zeros((n, mb), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    validity = np.ones(n, dtype=bool)
    for i in range(n):
        if i % 10 == 9:
            validity[i] = False
            continue
        want = i % (mb + 1)
        raw = b""
        while len(raw) < want:
            raw += _EDGE_PIECES[rng.integers(0, len(_EDGE_PIECES))]
        raw = raw[:want]
        data[i, :want] = list(raw)
        lengths[i] = want
    return data, lengths, validity


def check_slice6_edges(dev) -> int:
    """Phase 2, slice 6 edge shapes of K18-K21 against their plain
    versions: widths 8, 12 (no multiple of 8: byte loads), 16, 64 and 128
    with every length 0 to the width, 1- to 4-byte characters, characters
    cut at the row's end and bare continuation bytes, null rows, a batch of
    one row and one whose rows are all null and empty (the kernels take
    no row count: rows past the live ones are computed like any other);
    needles longer than the row, self-overlapping ("aa" in "aaa"), empty
    needles, pads and separators; Substring at negative, zero and
    far-negative positions and negative lengths; SubstringIndex at counts
    -3 to 3; patterns anchored at ^, at $ and neither, and a DFA too large
    for shared memory (spark.rapids.sql.regexp.maxStates 16,384). Returns
    the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.expr import strings as S
    from spark_rapids_tpu_torch.ops import regexops as R
    from spark_rapids_tpu_torch.regex import compile_search

    rng = np.random.default_rng(17)
    cases = 0

    def check(name, kernel, plain):
        nonlocal cases
        _exact_all(name, kernel(), plain())
        cases += 1

    patterns = [compile_search(p) for p in (
        "a", "^a", "a$", "^$", "^a.*b$", "\xc3\xa9.", "[0-9]+_|aa", "b|^_")]
    big = TpuSparkSession({"spark.rapids.sql.regexp.maxStates": 1 << 14,
                           "spark.rapids.sql.regexp.complexityLimit": 1 << 20})
    try:
        huge = compile_search(
            "[a-z]*a[a-z]{11}|0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    finally:
        big.stop()
    s, c = huge.table.shape
    if 512 + 2 * s * c + s <= K.smem_optin(torch.empty(1, device=dev)):
        fail(f"the {s}-state DFA fits shared memory: no global-table case")
    space_a = np.zeros(256, dtype=np.int16)
    space_a[[ord(" "), ord("a")]] = -1
    translate = np.arange(256, dtype=np.int16)
    translate[ord("a")], translate[ord("b")], translate[0xA9] = ord("B"), -1, -1
    needles = (b"a", b"aa", b"\xc3\xa9", b"\x80", b"a_0", b"")
    for mb, n in ((8, 95), (12, 140), (16, 700), (64, 1300), (128, 2600),
                  (16, 1), (24, 300)):
        d, ln, v = _edge_rows(rng, n, mb)
        if (mb, n) == (24, 300):  # every row null and empty
            d[:] = 0
            ln[:] = 0
            v[:] = False
        data = torch.from_numpy(d).to(dev)
        lens = torch.from_numpy(ln).to(dev)
        valid = torch.from_numpy(v).to(dev)
        tag = f"mb={mb} n={n}"
        for rx in patterns:
            check(f"dfa_match {tag} {rx.pattern!r}",
                  lambda: R.dfa_match(data, lens, rx),
                  lambda: R.dfa_match_plain(data, lens, rx))
        # K19
        for nd in needles + (b"a" * (mb + 1),):
            check(f"contains {tag} {nd!r}", lambda: S._contains(data, lens, nd),
                  lambda: S._contains_plain(data, lens, nd))
            for m in (0, 2, 5):
                check(f"first {tag} {nd!r} {m}",
                      lambda: S._first_match_charpos(data, lens, nd, m),
                      lambda: S._first_match_charpos_plain(data, lens, nd, m))
            check(f"select {tag} {nd!r}",
                  lambda: S._select_nonoverlapping(data, lens, nd),
                  lambda: S._select_nonoverlapping_plain(data, lens, nd))
            if nd:
                for cnt in (-3, -2, -1, 1, 2, 3):
                    check(f"split {tag} {nd!r} {cnt}",
                          lambda: S._substring_index_bounds(data, lens, nd,
                                                            cnt),
                          lambda: S._substring_index_bounds_plain(
                              data, lens, nd, cnt))
        # K20
        lo, hi = S._substring_index_bounds(data, lens, b"a", -2)
        rules = [S.Rewrite(K.REWRITE_MAP, S._UPPER),
                 S.Rewrite(K.REWRITE_MAP, S._LOWER),
                 S.Rewrite(K.REWRITE_MAP, translate),
                 S.Rewrite(K.REWRITE_RANGE, lo=lo, hi=hi),
                 S.Rewrite(K.REWRITE_REVERSE), S.Rewrite(K.REWRITE_INITCAP)]
        rules += [S.Rewrite(K.REWRITE_TRIM, space_a, a, b)
                  for a, b in ((1, 1), (1, 0), (0, 1))]
        rules += [S.Rewrite(K.REWRITE_CHARS, a=p, b=q)
                  for p in (1, 2, 0, -1, -3, -mb - 5)
                  for q in (1, 3, 0, -1, 1 << 30)]
        for rw in rules:
            check(f"rewrite {tag} {rw.kind} {rw.a} {rw.b}",
                  lambda: S._rewrite(data, lens, rw),
                  lambda: S._rewrite_plain(data, lens, rw))
        check(f"length {tag}", lambda: S._char_count(data, lens),
              lambda: S._char_count_plain(data, lens))
        # K21
        c1 = _strcol(data, lens, valid)
        c2 = _strcol(data[:, :8].contiguous(), torch.clamp(lens, max=8),
                     torch.roll(valid, 3))
        layouts = [([c1, c2], S.Assemble(K.ASSEMBLE_CONCAT), mb + 8),
                   ([c2, c1, c2], S.Assemble(K.ASSEMBLE_CONCAT), mb + 16)]
        for sep in (b"|", b"", b"--"):
            layouts.append(([c1, c2, c1], S.Assemble(K.ASSEMBLE_CONCAT_WS,
                                                     sep),
                            2 * mb + 8 + 2 * len(sep)))
        for kind in (K.ASSEMBLE_LPAD, K.ASSEMBLE_RPAD):
            for target in (0, 3, mb + 2):
                for pad in (b"xy", b" "):
                    layouts.append(([c1], S.Assemble(kind, pad, target),
                                    target + mb))
        for times in (1, 3):
            layouts.append(([c1], S.Assemble(K.ASSEMBLE_REPEAT, a=times),
                            mb * times))
        for nd, rep in ((b"a", b""), (b"aa", b"xyz"), (b"\xc3\xa9", b"e"),
                        (b"a" * (mb + 1), b"q")):
            sel = S._select_nonoverlapping_plain(data, lens, nd)
            layouts.append(([c1], S.Assemble(K.ASSEMBLE_REPLACE, rep,
                                             len(nd), sel),
                            mb * max(1, len(rep))))
        for cols, asm, total in layouts:
            mb_out = S._width(total)
            check(f"assemble {tag} {asm.kind} {asm.text!r} {asm.a}",
                  lambda: S._assemble(cols, asm, mb_out),
                  lambda: S._assemble_plain(cols, asm, mb_out))
    # the DFA whose table stays in device memory, over letters and digits
    d = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789ABC",
                                 dtype=np.uint8), (5000, 64))
    ln = rng.integers(0, 65, 5000).astype(np.int32)
    d[np.arange(64)[None, :] >= ln[:, None]] = 0
    data = torch.from_numpy(d).to(dev)
    lens = torch.from_numpy(ln).to(dev)
    check(f"dfa_match global table ({s} states x {c} classes)",
          lambda: R.dfa_match(data, lens, huge),
          lambda: R.dfa_match_plain(data, lens, huge))
    torch.cuda.synchronize()
    return cases


#: K22's timestamp text of a date: 'yyyy-MM-dd' (orders_tbl's o_orderdate)
ZONE_LA = "America/Los_Angeles"
ZONE_IST = "Asia/Kolkata"
US_PER_DAY = 86_400_000_000


def _text_rows(dev, arr, width: int):
    """A pyarrow string array as the port's byte matrix on the card:
    [n, width] uint8 (zero past each length) and int32 lengths."""
    import numpy as np
    import pyarrow as pa
    import torch

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    arr = arr.cast(pa.large_string())
    n = len(arr)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64)[
        arr.offset:arr.offset + n + 1]
    off = torch.from_numpy(offsets.copy()).to(dev)
    buf = torch.from_numpy(np.frombuffer(arr.buffers()[2],
                                         dtype=np.uint8).copy()).to(dev)
    lens = (off[1:] - off[:-1]).to(torch.int32)
    if int(lens.max().item()) > width:
        fail(f"text rows wider than {width}")
    data = torch.empty((n, width), dtype=torch.uint8, device=dev)
    ar = torch.arange(width, device=dev)
    for lo in range(0, n, PLAIN_CHUNK):
        hi = min(n, lo + PLAIN_CHUNK)
        idx = torch.clamp(off[lo:hi, None] + ar, max=max(len(buf) - 1, 0))
        data[lo:hi] = torch.where(ar < lens[lo:hi, None], buf[idx], 0)
    return data, lens


def _price_text(dev, n: int, seed: int):
    """o_totalprice as write_orders_dated draws and prints it ('%d.%02d'
    of its cents), on the card: [n, 16] text and lengths."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from spark_rapids_tpu_torch.q5 import orders_dated_draws

    cents = orders_dated_draws(n, files=1, seed=seed)[0]["cents"]
    return _text_rows(dev, pc.binary_join_element_wise(
        pc.cast(pa.array(cents // 100), pa.string()),
        pc.utf8_lpad(pc.cast(pa.array(cents % 100), pa.string()), 2, "0"),
        "."), 16)


def _orders_text(dev, n: int, seed: int):
    """ORDERS as write_orders_dated draws and prints it, on the card: the
    order dates (int32 days), the keys (int64) and the text of the date
    [n, 16], the key [n, 8] and the price [n, 16]."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    from spark_rapids_tpu_torch.q5 import orders_dated_draws

    d = orders_dated_draws(n, files=1, seed=seed)[0]
    cents = d["cents"]
    date = pa.array(d["o_orderdate"], type=pa.date32())
    price = pc.binary_join_element_wise(
        pc.cast(pa.array(cents // 100), pa.string()),
        pc.utf8_lpad(pc.cast(pa.array(cents % 100), pa.string()), 2, "0"),
        ".")
    return dict(
        days=torch.from_numpy(d["o_orderdate"]).to(dev),
        keys=torch.from_numpy(d["o_orderkey"]).to(dev),
        date_text=_text_rows(dev, pc.cast(date, pa.string()), 16),
        key_text=_text_rows(dev, pc.cast(pa.array(d["o_orderkey"]),
                                         pa.string()), 8),
        price_text=_text_rows(dev, price, 16),
        bool_text=_text_rows(dev, pa.array(
            ["true", "false", "yes", "no", "t", "f", "1", "0", " TRUE ",
             "maybe"]).take(pa.array(
                 np.random.default_rng(seed).integers(0, 10, n))), 8))


def check_slice7_kernels(dev):
    """Phase 2, slice 7: K22-K24 against their plain versions at the path
    shapes: the text of 15,000,000 ORDERS rows as orders_tbl holds it
    (K22: the date and timestamp of o_orderdate [15M, 16], the key [15M,
    8], the price [15M, 16], and booleans [15M, 8]), the LA midnights of
    the order dates (K23, both directions), and the order dates, keys and
    LA wall clocks (K24: 'yyyy-MM', cast to string of a date, an int64 and
    a timestamp). The plain versions run in 2^22-row pieces. Returns
    {record name: record}."""
    import torch

    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.expr import cast as C
    from spark_rapids_tpu_torch.expr import datetimes as DT
    from spark_rapids_tpu_torch.ops import stringcast as SC
    from spark_rapids_tpu_torch.ops import tzdb
    from spark_rapids_tpu_torch.sqltypes import datatypes as T

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    out = {}

    def record(name, csrc, replaces, kernel, plain, library, nbytes,
               shape, counter=None):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for k, (g, w) in enumerate(zip(got, want)):
            same_bits(f"{name} output {k}", g, w)
        del got, want
        rec = dict(route="cuda", source=src + csrc, replaces=replaces,
                   max_abs_err=0.0,
                   **timed(name, kernel, plain, library, PLAIN_ITERS),
                   bound_ms=bound_ms(nbytes), bound_by="bytes", shape=shape)
        if counter:
            rec["counter"] = counter
        out[name] = rec
        torch.cuda.empty_cache()

    n = ORDERS_ROWS
    o = _orders_text(dev, n, 41)
    valid = torch.ones(n, dtype=torch.bool, device=dev)

    def col(text):
        return _strcol(text[0], text[1], valid)

    def parse(fn, text, dtype):
        c = col(text)
        return lambda: (lambda r: (r.data, r.validity))(fn(c, dtype))

    def parse_plain(fn, text, dtype):
        data, lens = text
        return lambda: _chunked(lambda lo, hi: (lambda r: (
            r.data, r.validity))(fn(_strcol(data[lo:hi], lens[lo:hi],
                                            valid[lo:hi]), dtype)), n,
            4 * PLAIN_CHUNK)

    parses = (
        ("str_parse", SC.parse_date, SC.parse_date_plain, "date_text",
         T.date, 4, ":313", "o_orderdate [{n}, 16] -> date"),
        ("str_parse_timestamp", SC.parse_timestamp,
         SC.parse_timestamp_plain, "date_text", T.timestamp, 8, ":319",
         "o_orderdate [{n}, 16] -> timestamp"),
        ("str_parse_long", SC.parse_long, SC.parse_long_plain, "key_text",
         T.long, 8, ":71", "o_orderkey [{n}, 8] -> bigint"),
        ("str_parse_double", SC.parse_double, SC.parse_double_plain,
         "price_text", T.double, 8, ":180",
         "o_totalprice [{n}, 16] -> double"),
        ("str_parse_bool", SC.parse_bool, SC.parse_bool_plain, "bool_text",
         T.boolean, 1, ":236", "booleans [{n}, 8] -> boolean"))
    for name, fn, plain, key, dtype, size, line, shape in parses:
        text = o[key]
        held = int(text[1].sum().item())
        record(name, "str_parse.cu",
               "spark_rapids_tpu/ops/stringcast.py" + line,
               parse(fn, text, dtype), parse_plain(plain, text, dtype), None,
               held + n * (4 + 1 + size + 1), shape.format(n=n),
               counter=None if name == "str_parse" else "str_parse")

    # K23 over the LA midnights of the order dates
    local = o["days"].to(torch.int64) * US_PER_DAY
    utc = tzdb.local_to_utc_plain(local, ZONE_LA)
    trans, offsets, _ = tzdb.device_tables(ZONE_LA, str(dev))
    record("tz_rebase", "tz_rebase.cu", "spark_rapids_tpu/ops/tzdb.py:210",
           lambda: tzdb.utc_to_local(utc, ZONE_LA),
           lambda: tzdb.utc_to_local_plain(utc, ZONE_LA),
           lambda: utc + offsets[torch.searchsorted(trans, utc, right=True)],
           n * 16, f"[{n}] int64, {ZONE_LA} ({int(trans.shape[0])} "
           "transitions), UTC -> local")
    record("tz_rebase_to_utc", "tz_rebase.cu",
           "spark_rapids_tpu/ops/tzdb.py:221",
           lambda: tzdb.local_to_utc(local, ZONE_LA),
           lambda: tzdb.local_to_utc_plain(local, ZONE_LA), None,
           n * 16, f"[{n}] int64, {ZONE_LA}, local -> UTC (gap rule)",
           counter="tz_rebase")

    # K24
    days = o["days"]
    record("str_format", "str_format.cu",
           "spark_rapids_tpu/expr/datetimes.py:633",
           lambda: DT._pattern_to_string(days, True, "yyyy-MM"),
           lambda: _chunked(lambda lo, hi: DT._pattern_to_string_plain(
               days[lo:hi], True, "yyyy-MM"), n, 4 * PLAIN_CHUNK), None,
           n * (4 + 8 + 4), f"date_format [{n}] dates, 'yyyy-MM' -> "
           f"[{n}, 8]")
    record("str_format_date", "str_format.cu",
           "spark_rapids_tpu/expr/cast.py:323",
           lambda: C._format(K.FORMAT_DATE, days, 16, days_input=True),
           lambda: _chunked(lambda lo, hi: C._date_to_string_plain(
               days[lo:hi]), n, 4 * PLAIN_CHUNK), None,
           n * (4 + 16 + 4), f"cast [{n}] dates as string -> [{n}, 16]",
           counter="str_format")
    keys = o["keys"]
    record("str_format_int", "str_format.cu",
           "spark_rapids_tpu/expr/cast.py:284",
           lambda: C._format(K.FORMAT_INT, keys, 32),
           lambda: _chunked(lambda lo, hi: C._int_to_string_plain(
               keys[lo:hi]), n, 4 * PLAIN_CHUNK), None,
           n * (8 + 32 + 4), f"cast [{n}] bigint keys as string -> "
           f"[{n}, 32]", counter="str_format")
    record("str_format_timestamp", "str_format.cu",
           "spark_rapids_tpu/expr/cast.py:349",
           lambda: C._format(K.FORMAT_TIMESTAMP, local, 32),
           lambda: _chunked(lambda lo, hi: C._timestamp_to_string_plain(
               local[lo:hi]), n, 4 * PLAIN_CHUNK), None,
           n * (8 + 32 + 4), f"cast [{n}] LA-local timestamps as string -> "
           f"[{n}, 32]", counter="str_format")
    del o, local, utc, days, keys
    torch.cuda.empty_cache()
    return out


#: the parse edge sets of check_slice7_edges
_INT_TEXT = (
    "0", "1", "-1", "+42", "  17  ", "\t-8\n", "2147483647", "2147483648",
    "-2147483648", "-2147483649", "9223372036854775807",
    "-9223372036854775808", "9223372036854775808", "-9223372036854775809",
    "", "  ", "abc", "1.5", "1e3", "--5", "+-5", "5-", "00012",
    "999999999999999999999999", "+", "-", "127", "-128", "128", "32767",
    "-32769", "\x01\x1f 7\x0b", "0000000000000000000000001")
_FLOAT_TEXT = (
    "0", "1.5", "-2.25", "+3.", ".5", "-.5", "1e3", "1E-3", "2.5e+2",
    "  7.25 ", "Infinity", "-Infinity", "+Infinity", "inf", "-inf", "NaN",
    "nan", "1e999", "1e-999", "", "abc", "1.2.3", "1e", "e5", "1.5e2.5",
    "00.50", "9007199254740993", "-nan", "INF", "infinit",
    "123456789012345678901234", "0.000000000000000000000123", "1e308",
    "1.7976931348623157e308", "4.9e-324", "2.2250738585072014e-308",
    "1e-400", "0e999999", "-0", "-0.0", "1e+", "1e-", "+", ".", "474582.62",
    "0.1", "3.14159265358979323846", "1e-310", "-12.5E-3")
_DATE_TEXT = (
    "2020-01-01", "2020-1-1", "2020-12-31", "2020-02-29", "2021-02-29",
    "1999-13-01", "1999-00-10", "2020-06-31", "2020", "2020-06",
    "2020-06-15T12:00:00", "2020-06-15 anything", "  2020-06-15  ",
    "0001-01-01", "20-1-1", "abc", "", "2020-6-15-3", "9999-12-31",
    "10000-01-01", "1234567-1-1", "12345678", "0000-03-01", "1969-12-31",
    "1900-02-29", "2000-02-29", "1600-02-29", "-2020-01-01", "+2020-01-01",
    "2020-01-01T", "2020--01", "2020-001-01", "1950-07-04")
_TS_TEXT = (
    "2020-01-01 00:00:00", "2020-01-01T23:59:59", "2020-01-01 12:30",
    "2020-01-01 1:2:3", "2020-01-01 12:30:45.5",
    "2020-01-01 12:30:45.123456", "2020-01-01", "2020-02-29 10:00:00",
    "2021-02-29 10:00:00", "2020-01-01 24:00:00", "2020-01-01 12:61:00",
    "abc", "", "  2020-01-01 06:07:08  ", "2020-01-01 12",
    "2020-01-01 12:30:45.1234567", "2020-01-01 12:30.5",
    "2020-01-01 12:30:45.", "1969-12-31 23:59:59.999999",
    "0001-01-01 00:00:00", "2021-03-14 02:30:00", "2021-11-07 01:30:00")
_BOOL_TEXT = ("true", "TRUE", " t ", "yes", "Y", "1", "false", "F", "no",
              "N", "0", "tr", "2", "", "trUE", "ye s", " \x01n\x1f",
              "falsey")


def check_slice7_edges(dev) -> int:
    """Phase 2, slice 7 edge shapes of K22-K24 against their plain
    versions: each parse mode (every integral width) over the edge sets
    above (signs, whitespace below 0x20, overflow, INT64_MIN, exponents,
    inf/nan, subnormals, invalid days, years past 9,999, pre-1970 times)
    plus 3,000 seeded random strings over each parser's alphabet, at
    widths 8, 12 (no multiple of 8: byte loads), 16, 32 and 64, with nulls;
    a string literal as a row-stride-0 view; K23 at, and one microsecond
    around, every transition and wall-clock transition of
    America/Los_Angeles, Asia/Kolkata and Europe/London and at random
    instants to the int64 ends, both directions; K24 over the int64 ends,
    dates from -5,000,000 to 5,000,000 days and past the int32 ends'
    calendars, instants to the int64 ends, fractions of every length, and
    patterns of every token. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.expr import cast as C
    from spark_rapids_tpu_torch.expr import datetimes as DT
    from spark_rapids_tpu_torch.ops import stringcast as SC
    from spark_rapids_tpu_torch.ops import tzdb
    from spark_rapids_tpu_torch.sqltypes import datatypes as T

    rng = np.random.default_rng(71)
    cases = 0

    def check(name, kernel, plain):
        nonlocal cases
        got, want = kernel(), plain()
        for k, (g, w) in enumerate(zip(got, want)):
            same_bits(f"{name} output {k}", g, w)
        cases += 1

    def text(strs, mb):
        d = np.zeros((len(strs), mb), dtype=np.uint8)
        ln = np.zeros(len(strs), dtype=np.int32)
        for i, s in enumerate(strs):
            raw = s.encode("latin-1")[:mb]
            d[i, :len(raw)] = list(raw)
            ln[i] = len(raw)
        return (torch.from_numpy(d).to(dev), torch.from_numpy(ln).to(dev),
                torch.from_numpy(rng.random(len(strs)) > 0.05).to(dev))

    def fuzz(alphabet, count, max_len):
        return ["".join(rng.choice(list(alphabet), int(rng.integers(
            0, max_len + 1)))) for _ in range(count)]

    num = "0123456789" * 3 + "+-.eE \tx\x00InNaf"
    date = "0123456789" * 3 + "-- T:.\x1fa"
    sets = (
        (_INT_TEXT, num, [(SC.parse_long, SC.parse_long_plain, t)
                          for t in (T.long, T.integer, T.short, T.byte)]),
        (_FLOAT_TEXT, num, [(SC.parse_double, SC.parse_double_plain,
                             T.double), (SC.parse_double,
                                         SC.parse_double_plain, T.float_t)]),
        (_BOOL_TEXT, "tTrRuUeEfFsSyYnN01 ", [(SC.parse_bool,
                                              SC.parse_bool_plain,
                                              T.boolean)]),
        (_DATE_TEXT, date, [(SC.parse_date, SC.parse_date_plain, T.date)]),
        (_TS_TEXT + _DATE_TEXT, date, [(SC.parse_timestamp,
                                        SC.parse_timestamp_plain,
                                        T.timestamp)]))
    for fixed, alphabet, fns in sets:
        strs = list(fixed) + fuzz(alphabet, 3000, 30)
        for mb in (8, 12, 16, 32, 64):
            d, ln, v = text(strs, mb)
            c = _strcol(d, ln, v)
            for fn, plain, dtype in fns:
                check(f"{fn.__name__} {dtype} width {mb}",
                      lambda: (lambda r: (r.data, r.validity))(fn(c, dtype)),
                      lambda: (lambda r: (r.data, r.validity))(plain(c,
                                                                     dtype)))
        for s in fixed:  # a literal: one row as a row-stride-0 view
            d, ln, _ = text([s], 16)
            view = d[0][None, :].expand(37, 16)
            c = _strcol(view, ln.expand(37).contiguous(),
                        torch.ones(37, dtype=torch.bool, device=dev))
            fn, plain, dtype = fns[0]
            check(f"{fn.__name__} literal {s!r}",
                  lambda: (lambda r: (r.data, r.validity))(fn(c, dtype)),
                  lambda: (lambda r: (r.data, r.validity))(plain(c, dtype)))

    i64 = np.iinfo(np.int64)
    for zone in (ZONE_LA, ZONE_IST, "Europe/London"):
        trans, _, wall = tzdb.tables(zone)
        x = np.concatenate([
            trans, trans - 1, trans + 1, wall, wall - 1, wall + 1,
            wall + 3_600_000_000, rng.integers(i64.min, i64.max, 20_000,
                                               dtype=np.int64),
            rng.integers(-5 * 10 ** 15, 5 * 10 ** 15, 20_000),
            np.array([i64.min, i64.max, 0, -1], np.int64)]).astype(np.int64)
        xt = torch.from_numpy(x).to(dev)
        check(f"utc_to_local {zone}", lambda: (tzdb.utc_to_local(xt, zone),),
              lambda: (tzdb.utc_to_local_plain(xt, zone),))
        check(f"local_to_utc {zone}", lambda: (tzdb.local_to_utc(xt, zone),),
              lambda: (tzdb.local_to_utc_plain(xt, zone),))
        check(f"utc_to_local {zone} (one row)",
              lambda: (tzdb.utc_to_local(xt[:1], zone),),
              lambda: (tzdb.utc_to_local_plain(xt[:1], zone),))

    ints = torch.from_numpy(np.concatenate([
        rng.integers(i64.min, i64.max, 20_000, dtype=np.int64),
        rng.integers(-1000, 1000, 2000),
        np.array([0, 1, -1, 9, 10, -10, i64.min, i64.max, i64.min + 1,
                  10 ** 18, -10 ** 18], np.int64)])).to(dev)
    check("int to string", lambda: C._format(K.FORMAT_INT, ints, 32),
          lambda: C._int_to_string_plain(ints))
    days = torch.from_numpy(np.concatenate([
        rng.integers(-5_000_000, 5_000_000, 20_000),
        rng.integers(-800_000, 800_000, 20_000),
        np.array([0, -1, 8035, 10440, -719528, -719529, -719162, 2932896,
                  2932897, -865565, -865566, 2 ** 31 - 1, -2 ** 31],
                 np.int64)]).astype(np.int32)).to(dev)
    check("date to string",
          lambda: C._format(K.FORMAT_DATE, days, 16, days_input=True),
          lambda: C._date_to_string_plain(days))
    us = torch.from_numpy(np.concatenate([
        rng.integers(i64.min, i64.max, 20_000, dtype=np.int64),
        rng.integers(-10 ** 17, 10 ** 17, 20_000),
        rng.integers(-10 ** 6, 10 ** 6, 6000) * US_PER_DAY
        + rng.integers(0, 10, 6000) * 10 ** rng.integers(0, 7, 6000),
        np.array([0, -1, 1, i64.min, i64.max, 1500000], np.int64)])).to(dev)
    check("timestamp to string",
          lambda: C._format(K.FORMAT_TIMESTAMP, us, 32),
          lambda: C._timestamp_to_string_plain(us))
    for fmt in ("yyyy-MM", "yyyy-MM-dd HH:mm:ss", "dd/MM/yyyy HH:mm:ss.SSS",
                "yyyyMMdd", "HH", "ss:mm:HH dd MM yyyy [SSS] ==="):
        for vals, di in ((days, True), (us, False)):
            check(f"date_format {fmt!r} days={di}",
                  lambda: DT._pattern_to_string(vals, di, fmt),
                  lambda: DT._pattern_to_string_plain(vals, di, fmt))
    torch.cuda.synchronize()
    return cases


def q5_oracle(fact_paths, dim_path):
    """The same query in pyarrow on the host (bench.py's cpu_query)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in fact_paths])
    dim = pq.read_table(dim_path)
    f = t.filter(pc.greater(t.column("amount"), 10.0))
    j = f.join(dim, keys="store", join_type="inner")
    j = j.filter(pc.not_equal(j.column("region"),
                              f"region_{REGIONS - 1:02d}"))
    rev = pc.multiply(j.column("amount"),
                      pc.cast(j.column("qty"), pa.float64()))
    work = pa.table({"region": j.column("region"), "revenue": rev,
                     "amount": j.column("amount")})
    return work.group_by("region").aggregate(
        [("revenue", "sum"), ("amount", "mean"), ("region", "count")])


def check_q5(got, want) -> None:
    g = {r["region"]: r for r in got.to_pylist()}
    w = {r["region"]: r for r in want.to_pylist()}
    if set(g) != set(w):
        fail(f"q5 regions differ: {sorted(g)} vs {sorted(w)}")
    for region, row in w.items():
        mine = g[region]
        if mine["sales"] != row["region_count"]:
            fail(f"q5 {region}: count {mine['sales']} != "
                 f"{row['region_count']}")
        for a, b in (("rev", "revenue_sum"), ("avg_amount", "amount_mean")):
            rel = abs(mine[a] - row[b]) / max(abs(row[b]), 1e-300)
            if not rel <= REL_TOL:
                fail(f"q5 {region}: {a} {mine[a]} vs {row[b]} "
                     f"({rel} relative)")


def dupjoin_oracle(fact_paths, dup_path):
    """bench.py's cpu_dupjoin_query in pyarrow on the host."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in fact_paths])
    dup = pq.read_table(dup_path)
    f = t.filter(pc.greater(t.column("amount"), 50.0))
    j = f.join(dup, keys="store", join_type="inner")
    rebate = pc.multiply(j.column("amount"), j.column("discount"))
    work = pa.table({"promo": j.column("promo"), "rebate": rebate})
    return work.group_by("promo").aggregate(
        [("rebate", "sum"), ("promo", "count")])


def check_dupjoin(got, want) -> None:
    g = {r["promo"]: r for r in got.to_pylist()}
    w = {r["promo"]: r for r in want.to_pylist()}
    if set(g) != set(w):
        fail(f"dupjoin promos differ: {sorted(g)} vs {sorted(w)}")
    for promo, row in w.items():
        mine = g[promo]
        if mine["n"] != row["promo_count"]:
            fail(f"dupjoin {promo}: count {mine['n']} != "
                 f"{row['promo_count']}")
        rel = (abs(mine["total_rebate"] - row["rebate_sum"])
               / max(abs(row["rebate_sum"]), 1e-300))
        if not rel <= REL_TOL:
            fail(f"dupjoin {promo}: total_rebate {mine['total_rebate']} vs "
                 f"{row['rebate_sum']} ({rel} relative)")


def missing_launches(name: str, launches: dict, needed) -> None:
    missing = [k for k in needed if not launches.get(k)]
    if missing:
        fail(f"{name} never launched {missing}: {launches}")


def count_host_syncs(run) -> int:
    """Host syncs of one run: the warnings torch.cuda's sync debug mode
    raises for every operation that waits on the card."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _secs(v) -> str:
    """Seconds to 4 places, or "none" for a phase timed without hot
    runs."""
    return "none" if v is None else f"{v:.4f}"


def timed_runs(run, check, hot_runs: int = HOT_RUNS,
               count_syncs: bool = True) -> dict:
    """Reset the launch counts, one cold run, read the counts; then
    hot_runs hot runs, each checked against the oracle; with count_syncs
    one run counting its host syncs (else host_syncs None); one profiled
    run."""
    import torch

    from spark_rapids_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.monotonic()
    got = run()
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = dict(kernels.launches)
    check(got)
    hot = []
    for _ in range(hot_runs):
        t0 = time.monotonic()
        got = run()
        torch.cuda.synchronize()
        hot.append(time.monotonic() - t0)
        check(got)
    return dict(result_rows=got.num_rows, cold_s=cold_s,
                hot_median_s=statistics.median(hot) if hot else None,
                hot_s=hot,
                launches=launches,
                host_syncs=count_host_syncs(run) if count_syncs else None,
                profile=profile_run(run))


def run_q5_plan(dev, fact_paths, dim_path, want) -> dict:
    """Phase 3: slice 1's hand-built plan over two DeviceCacheEntry
    relations."""
    import torch

    from spark_rapids_tpu_torch.exec.relation_cache import DeviceCacheEntry
    from spark_rapids_tpu_torch.q5 import q5_plan

    t0 = time.monotonic()
    fact = DeviceCacheEntry(fact_paths, device=dev)
    dim = DeviceCacheEntry([dim_path], device=dev)
    fact.materialize()
    dim.materialize()
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    rec = timed_runs(lambda: q5_plan(fact, dim, REGIONS).collect(),
                     lambda got: check_q5(got, want))
    missing_launches("q5_plan", rec["launches"], SLICE1_PATH_KERNELS)
    rec["upload_s"] = upload_s
    fact.release()
    dim.release()
    return rec


def run_session(dev, root, want_q5, want_dup, fused: bool) -> dict:
    """Phases 4 and 5: q5 and the duplicate-key join through the port's
    session, DataFrame API, planner and (phase 4) the adaptive engine or
    (phase 5, bench.py's own conf) the fused engine, over relations cached
    on the device. Returns {query: record}."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import dupjoin_query, engine_query

    torch.cuda.reset_peak_memory_stats(dev)
    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 23)
             .config("spark.rapids.sql.batchSizeRows", 1 << 23)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    engine = "fused" if fused else "aqe"
    frames = {}
    t0 = time.monotonic()
    for name in ("fact", "dim", "dup"):
        df = spark.read.parquet(os.path.join(root, name)).cache(
            storage="device")
        spark.cache_manager.lookup(df._plan).materialize()
        frames[name] = df
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    out = {}
    queries = {
        "q5": (lambda: engine_query(frames["fact"], frames["dim"], REGIONS),
               lambda got: check_q5(got, want_q5)),
        "dupjoin": (lambda: dupjoin_query(frames["fact"], frames["dup"]),
                    lambda got: check_dupjoin(got, want_dup)),
    }
    for name, (build_df, check) in queries.items():
        rec = timed_runs(lambda: build_df().collect_arrow(), check)
        ex = spark.last_execution
        if ex["engine"] != engine:
            fail(f"session {name} ran on {ex['engine']}, not {engine}: "
                 f"{ex}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         FUSED_PATH_KERNELS[name] if fused
                         else SESSION_PATH_KERNELS)
        if fused and ex["fused"]["use_lookup"] != (name == "q5"):
            fail(f"fused {name} settled on {ex['fused']}: q5 keeps the "
                 "lookup join, dupjoin loses its uniqueness bet")
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   fallbacks=ex["fallbacks"], upload_s=upload_s)
        out[name] = rec
    out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    spark.stop()
    return out


def slice4_oracles(fact_paths, want_q5) -> dict:
    """pyarrow/numpy answers of the four slice-4 queries over the facts."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in fact_paths])
    store = t.column("store").to_numpy()
    day = t.column("day").to_numpy()
    amount = t.column("amount").to_numpy()
    qty = t.column("qty").to_numpy()
    top = pc.sort_indices(t, sort_keys=[("amount", "descending")])[:100]
    pairs = np.unique(store * 128 + qty)
    key = store * 365 + day
    cnt = np.bincount(key, minlength=STORES * 365).reshape(STORES, 365)
    sums = np.bincount(key, weights=amount,
                       minlength=STORES * 365).reshape(STORES, 365)
    rk = (np.cumsum(cnt, axis=1) - cnt + 1).reshape(-1)
    drk = np.cumsum(cnt > 0, axis=1).reshape(-1)
    run_amount = np.cumsum(sums, axis=1).reshape(-1)
    # where each peer run's rows start in the (store, day)-sorted order
    start = (np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1))
    return {
        "topn": t.take(top),
        "sorted_q5": want_q5.sort_by([("revenue_sum", "descending")]),
        "dedup": (pairs // 128, pairs % 128),
        "window": dict(rk=rk, drk=drk, run_amount=run_amount, start=start,
                       cnt=cnt.reshape(-1), sums=sums.reshape(-1)),
    }


def check_topn(got, want) -> None:
    if got.num_rows != 100:
        fail(f"topn: {got.num_rows} rows")
    for name in ("store", "amount", "qty", "day"):
        if got.column(name).to_pylist() != want.column(name).to_pylist():
            fail(f"topn: column {name} differs from the oracle")


def check_sorted_q5(got, want) -> None:
    check_q5(got, want)
    mine = got.column("region").to_pylist()
    theirs = want.column("region").to_pylist()
    if mine != theirs:
        fail(f"sorted_q5 order {mine} != {theirs}")


def check_dedup(got, want) -> None:
    import numpy as np

    s, q = want
    gs = got.column("store").to_numpy()
    gq = got.column("qty").to_numpy()
    if not (np.array_equal(gs, s) and np.array_equal(gq, q)):
        fail(f"dedup: {got.num_rows} rows differ from the {len(s)} oracle "
             "pairs")


def check_window(got, want) -> None:
    """rk, drk and run_amount per (store, day) peer run; rn a permutation
    of [rk, rk + run length - 1] within each peer run; every input row
    once (rows per peer run, and the amounts' sum per run)."""
    import numpy as np

    if got.num_rows != ROWS:
        fail(f"window: {got.num_rows} rows, not {ROWS}")
    col = {n: got.column(n).to_numpy() for n in got.column_names}
    key = col["store"] * 365 + col["day"]
    for name in ("rk", "drk"):
        if not np.array_equal(col[name], want[name][key]):
            fail(f"window: {name} differs from the oracle")
    ref = want["run_amount"][key]
    rel = float((np.abs(col["run_amount"] - ref) / np.abs(ref)).max())
    if not rel <= REL_TOL:
        fail(f"window: run_amount off by {rel} relative")
    WINDOW_REL_ERR.append(rel)
    off = col["rn"].astype(np.int64) - col["rk"]
    if off.min() < 0 or (off >= want["cnt"][key]).any():
        fail("window: rn outside its peer run")
    slots = np.bincount(want["start"][key] + off, minlength=ROWS)
    if not (slots == 1).all():
        fail("window: rn is not a permutation within every peer run")
    sums = np.bincount(key, weights=col["amount"],
                       minlength=STORES * 365)
    srel = np.abs(sums - want["sums"]) / np.maximum(np.abs(want["sums"]),
                                                    1e-300)
    if not srel.max() <= REL_TOL:
        fail("window: the rows' amounts differ from the input's")


#: run_amount's largest relative difference from the oracle, per check
WINDOW_REL_ERR = []

#: kernels each slice-4 query must launch on each engine; K12 and K14 on
#: the window, K13 where a sort meets more than one run (the TopN's final
#: sort on the adaptive engine merges one run per map block)
WINDOW_KERNELS = ("pack_keys", "sort_words", "group_bounds", "seg_minmax",
                  "window_prefix", "window_eval", "gather_leaves")
SLICE4_PATH_KERNELS = {
    ("aqe", "topn"): ("pack_keys", "sort_words", "gather_leaves",
                      "merge_runs"),
    ("fused", "topn"): ("pack_keys", "sort_words", "gather_leaves",
                        "compact_perm"),
    ("aqe", "sorted_q5"): SESSION_PATH_KERNELS,
    ("fused", "sorted_q5"): FUSED_PATH_KERNELS["q5"],
    ("aqe", "dedup"): ("pack_keys", "sort_words", "group_bounds",
                       "gather_leaves", "seg_sum_count", "dense_bin_perm",
                       "murmur3", "partition_by_ids", "probe_ranges"),
    ("fused", "dedup"): ("pack_keys", "sort_words", "group_bounds",
                         "gather_leaves", "seg_sum_count", "dense_bin_perm",
                         "compact_perm"),
    ("aqe", "window"): WINDOW_KERNELS + ("murmur3", "partition_by_ids"),
    ("fused", "window"): WINDOW_KERNELS + ("compact_perm",),
}


def run_slice4(dev, root, oracles, fused: bool) -> dict:
    """Phase 6: the TopN, the sorted q5, the distinct and the window
    queries through the port's session on the adaptive engine or (bench.py's
    conf) the fused engine, over the device-cached bench tables. Returns
    {query: record}, each with its peak device bytes."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        dedup_query,
        sorted_q5_query,
        topn_query,
        window_query,
    )

    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 23)
             .config("spark.rapids.sql.batchSizeRows", 1 << 23)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    engine = "fused" if fused else "aqe"
    t0 = time.monotonic()
    frames = {}
    for name in ("fact", "dim"):
        df = spark.read.parquet(os.path.join(root, name)).cache(
            storage="device")
        spark.cache_manager.lookup(df._plan).materialize()
        frames[name] = df
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    fact, dim = frames["fact"], frames["dim"]
    queries = {
        "topn": (lambda: topn_query(fact), check_topn),
        "sorted_q5": (lambda: sorted_q5_query(fact, dim, REGIONS),
                      check_sorted_q5),
        "dedup": (lambda: dedup_query(fact), check_dedup),
        "window": (lambda: window_query(fact), check_window),
    }
    out = {}
    for name, (build_df, check) in queries.items():
        torch.cuda.reset_peak_memory_stats(dev)
        want = oracles[name]
        rec = timed_runs(lambda: build_df().collect_arrow(),
                         lambda got: check(got, want), LATER_HOT_RUNS)
        ex = spark.last_execution
        if ex["engine"] != engine or ex["fallbacks"]:
            fail(f"{name} ran on {ex['engine']}, not {engine}: {ex}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE4_PATH_KERNELS[(engine, name)])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s,
                   peak_device_bytes=int(torch.cuda.max_memory_allocated(
                       dev)))
        out[name] = rec
    spark.stop()
    return out


def slice5_oracles(fact_paths) -> dict:
    """numpy answers of the four slice-5 window queries over the facts.
    Rows sorted by (store, day, amount), which is unique at seed 0 (the
    ROWS frames ordered by (day, amount) are then deterministic; the run
    fails if it is not). Per-row answers of running_query and
    moving_query are kept in amount order, which identifies each input
    row, for `check_rows`; range_query's by (store, day); u2u_query's by
    store."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in fact_paths])
    store = t.column("store").to_numpy()
    day = t.column("day").to_numpy()
    amount = t.column("amount").to_numpy()
    qty = t.column("qty").to_numpy()
    # the (store, day, amount) order in two passes, an order by amount made
    # stable by (store, day) (a third of np.lexsort's time); equal amounts
    # within a (store, day) fail below
    by_amount_in = np.argsort(amount)
    order = by_amount_in[np.argsort(
        (store * 365 + day)[by_amount_in].astype(np.int32), kind="stable")]
    st, dy, am, qt = store[order], day[order], amount[order], qty[order]
    if ((st[1:] == st[:-1]) & (dy[1:] == dy[:-1])
            & (am[1:] == am[:-1])).any():
        fail("(store, day, amount) is not unique: the ROWS frames are not "
             "deterministic")
    n = len(st)
    counts = np.bincount(st, minlength=STORES)
    starts = np.cumsum(counts) - counts
    pos = np.arange(n) - starts[st]
    plen = counts[st]
    bounds = np.append(starts, n)

    # running_query
    run_sum = np.empty(n)
    run_min = np.empty(n)
    run_max = np.empty(n)
    for a, b in zip(bounds[:-1], bounds[1:]):
        run_sum[a:b] = np.cumsum(am[a:b])
        run_min[a:b] = np.minimum.accumulate(am[a:b])
        run_max[a:b] = np.maximum.accumulate(am[a:b])
    rn = (pos + 1).astype(np.int32)
    running = {"rn": rn, "rk": rn, "drk": rn, "run_sum": run_sum,
               "run_min": run_min, "run_max": run_max,
               "run_cnt": (pos + 1).astype(np.int64)}

    # moving_query
    def shifted(x, k, fill):
        """x[i + k] inside the row's partition, else fill (a slice copy:
        a row inside its partition has i + k in range)."""
        out = np.full(n, fill, dtype=x.dtype)
        if k >= 0:
            out[:n - k] = x[k:]
        else:
            out[-k:] = x[:n + k]
        inside = (pos + k >= 0) & (pos + k < plen)
        return np.where(inside, out, fill), inside

    s7 = np.zeros(n)
    c7 = np.zeros(n, np.int64)
    m7 = np.full(n, -np.inf)
    for k in range(7):
        v, inside = shifted(am, -k, 0.0)
        s7 += v
        c7 += inside
        m7 = np.maximum(m7, np.where(inside, v, -np.inf))
    q3 = np.full(n, np.iinfo(np.int64).max)
    for k in range(-3, 4):
        v, inside = shifted(qt, k, np.iinfo(np.int64).max)
        q3 = np.minimum(q3, v)
    prev, has_prev = shifted(am, -1, 0.0)
    next2, _ = shifted(am, 2, 0.0)
    first7 = am[np.arange(n) - np.minimum(pos, 6)]
    moving = {"avg7": s7 / c7, "max7": m7, "min_qty": q3, "prev": prev,
              "prev#valid": has_prev, "next2": next2, "first7": first7,
              "last7": am}

    # rows of the sorted order by amount: the inverse of `order` through
    # the amount order already made
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    by_amount = inv[by_amount_in]

    # range_query: per (store, day)
    key = st * 365 + dy
    cnt = np.bincount(key, minlength=STORES * 365).reshape(STORES, 365)
    sums = np.bincount(key, weights=am,
                       minlength=STORES * 365).reshape(STORES, 365)
    run_starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    mins = np.full(STORES * 365, np.inf)
    mins[key[run_starts]] = am[run_starts]  # the run's first row
    qmax = np.full(STORES * 365, np.iinfo(np.int64).min)
    qmax[key[run_starts]] = np.maximum.reduceat(qt, run_starts)
    mins, qmax = mins.reshape(STORES, 365), qmax.reshape(STORES, 365)
    sum7 = np.zeros((STORES, 365))
    cnt7 = np.zeros((STORES, 365), np.int64)
    min7 = np.full((STORES, 365), np.inf)
    qmax7 = np.full((STORES, 365), np.iinfo(np.int64).min)
    for k in range(7):
        sum7[:, k:] += sums[:, :365 - k]
        cnt7[:, k:] += cnt[:, :365 - k]
        min7[:, k:] = np.minimum(min7[:, k:], mins[:, :365 - k])
        qmax7[:, k:] = np.maximum(qmax7[:, k:], qmax[:, :365 - k])
    before = (np.cumsum(cnt, axis=1) - cnt).reshape(-1)
    length = counts.repeat(365)
    prk = np.where(length > 1, before / np.maximum(length - 1, 1), 0.0)
    cd = (before + cnt.reshape(-1)) / np.maximum(length, 1)
    q, r = plen // 4, plen % 4
    thr = r * (q + 1)
    ntile = np.where(pos < thr, pos // np.maximum(q + 1, 1),
                     r + (pos - thr) // np.maximum(q, 1)) + 1
    ranged = {"sum7d": sum7.reshape(-1), "cnt7d": cnt7.reshape(-1),
              "min7d": min7.reshape(-1), "max_qty7d": qmax7.reshape(-1),
              "prk": prk, "cd": cd,
              "q4_counts": np.bincount(key * 5 + ntile,
                                       minlength=STORES * 365 * 5)}

    # u2u_query: per store
    tot = np.bincount(st, weights=am, minlength=STORES)
    u2u = {"tot": tot, "mean": tot / counts,
           "lo": np.minimum.reduceat(am, starts),
           "qmax": np.maximum.reduceat(qt, starts), "n": counts}
    return {"amount": am[by_amount],
            "running": {k: v[by_amount] for k, v in running.items()},
            "moving": {k: v[by_amount] for k, v in moving.items()},
            "range": ranged, "u2u": u2u}


#: the largest relative difference of each slice-5 float64 sum and average
#: from its oracle, per query and run
SLICE5_REL_ERR = {}


def _host(col, fill=0):
    import pyarrow.compute as pc

    return pc.fill_null(col, fill).to_numpy()


def _valid(col):
    import pyarrow.compute as pc

    return pc.is_valid(col).to_numpy(zero_copy_only=False)


def _close(name: str, query: str, got, want) -> None:
    """float64 results within REL_TOL relative (numpy or device arrays)."""
    import numpy as np
    import torch

    if isinstance(got, torch.Tensor):
        rel = float(((got - want).abs()
                     / want.abs().clamp(min=1e-300)).max().item())
    else:
        rel = float((np.abs(got - want)
                     / np.maximum(np.abs(want), 1e-300)).max())
    SLICE5_REL_ERR.setdefault(query, []).append(rel)
    if not rel <= REL_TOL:
        fail(f"{query}: {name} off by {rel} relative")


#: columns of running_query and moving_query compared within REL_TOL
_SUMMED = ("run_sum", "avg7")


def check_rows(query: str, got, want, dev) -> None:
    """running_query or moving_query: every input row once, and each
    column equal to the oracle's answer for its row (found by its amount
    on the card); sums and averages within REL_TOL, the rest exact."""
    import numpy as np
    import torch

    if got.num_rows != ROWS:
        fail(f"{query}: {got.num_rows} rows, not {ROWS}")
    amount = torch.from_numpy(got.column("amount").to_numpy()).to(dev)
    idx = torch.searchsorted(want["amount"], amount).clamp_(max=ROWS - 1)
    if not torch.equal(want["amount"][idx], amount):
        fail(f"{query}: rows whose amount is not the input's")
    if not bool((torch.bincount(idx, minlength=ROWS) == 1).all()):
        fail(f"{query}: the result is not the input's rows once each")
    for name, w in want[query].items():
        if name.endswith("#valid"):
            continue
        col = got.column(name)
        g = torch.from_numpy(_host(col)).to(dev)
        wv = w[idx]
        valid = torch.from_numpy(_valid(col)).to(dev)
        want_valid = want[query].get(f"{name}#valid")
        want_valid = (torch.ones_like(valid) if want_valid is None
                      else want_valid[idx])
        if not torch.equal(valid, want_valid):
            fail(f"{query}: {name}'s nulls differ from the oracle's")
        g, wv = g[valid], wv[valid]
        if name in _SUMMED:
            _close(name, query, g, wv)
        elif not torch.equal(g.to(wv.dtype), wv):
            fail(f"{query}: {name} differs from the oracle")
    del amount, idx


def check_range(got, want) -> None:
    """range_query: each row's RANGE sums, counts, min and max, and its
    percent_rank and cume_dist by (store, day); ntile(4) as a multiset
    within each (store, day) run (the order inside a run is free)."""
    import numpy as np

    if got.num_rows != ROWS:
        fail(f"range: {got.num_rows} rows, not {ROWS}")
    key = _host(got.column("store")) * 365 + _host(got.column("day"))
    for name in ("cnt7d", "min7d", "max_qty7d", "prk", "cd"):
        if not np.array_equal(_host(got.column(name)), want[name][key]):
            fail(f"range: {name} differs from the oracle")
    _close("sum7d", "range", _host(got.column("sum7d")), want["sum7d"][key])
    q4 = _host(got.column("q4")).astype(np.int64)
    counts = np.bincount(key * 5 + q4, minlength=STORES * 365 * 5)
    if not np.array_equal(counts, want["q4_counts"]):
        fail("range: ntile(4) is not the oracle's within each peer run")


def check_u2u(got, want) -> None:
    """u2u_query: each row carries its store's total, mean, minimum,
    maximum qty and count."""
    import numpy as np

    if got.num_rows != ROWS:
        fail(f"u2u: {got.num_rows} rows, not {ROWS}")
    st = _host(got.column("store"))
    for name in ("lo", "qmax", "n"):
        if not np.array_equal(_host(got.column(name)), want[name][st]):
            fail(f"u2u: {name} differs from the oracle")
    for name in ("tot", "mean"):
        _close(name, "u2u", _host(got.column(name)), want[name][st])


#: the window mode (presorted, halo, mode) the planner picks for each
#: slice-5 query
SLICE5_MODES = {"running": (True, None, "running"),
                "moving": (True, 6, None),
                "range": (False, None, None),
                "u2u": (False, None, "u2u")}
_WINDOW_BASE = ("pack_keys", "sort_words", "group_bounds", "seg_minmax",
                "window_inverse", "gather_leaves")
#: kernels each slice-5 query must launch on each engine; the fused engine
#: evaluates every window over the whole partition
SLICE5_PATH_KERNELS = {
    ("aqe", "running"): _WINDOW_BASE + ("window_prefix", "window_eval",
                                        "frame_minmax"),
    ("fused", "running"): _WINDOW_BASE + ("window_prefix", "window_eval",
                                          "frame_minmax"),
    ("aqe", "moving"): _WINDOW_BASE + ("window_prefix", "window_eval",
                                       "frame_minmax", "frame_pick"),
    ("fused", "moving"): _WINDOW_BASE + ("window_prefix", "window_eval",
                                         "frame_minmax", "frame_pick"),
    ("aqe", "range"): _WINDOW_BASE + ("range_bounds", "window_prefix",
                                      "window_eval", "frame_minmax"),
    ("fused", "range"): _WINDOW_BASE + ("range_bounds", "window_prefix",
                                        "window_eval", "frame_minmax"),
    ("aqe", "u2u"): ("seg_sum_count", "seg_minmax", "pack_keys",
                     "sort_words", "probe_ranges", "gather_leaves"),
    ("fused", "u2u"): _WINDOW_BASE + ("window_prefix", "window_eval",
                                      "frame_minmax"),
}


def _upload_oracle(dev, want: dict, query: str) -> dict:
    """The per-row oracle of one query on the card (amount order)."""
    import torch

    return {"amount": torch.from_numpy(want["amount"]).to(dev),
            query: {k: torch.from_numpy(v).to(dev)
                    for k, v in want[query].items()}}


def run_slice5(dev, root, oracles, fused: bool) -> dict:
    """Phase 7: running_query, moving_query, range_query and u2u_query
    through the port's session on the adaptive engine or (bench.py's conf)
    the fused engine at spark.rapids.sql.batchSizeRows 2^20, so the
    adaptive engine's running and halo modes carry across about four
    chunks a partition. The planner must pick each query's mode. Returns
    {query: record}, each with its peak device bytes beyond the checker's
    own arrays."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        moving_query,
        range_query,
        running_query,
        u2u_query,
    )

    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 23)
             .config("spark.rapids.sql.batchSizeRows", 1 << 20)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    engine = "fused" if fused else "aqe"
    t0 = time.monotonic()
    fact = spark.read.parquet(os.path.join(root, "fact")).cache(
        storage="device")
    spark.cache_manager.lookup(fact._plan).materialize()
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    queries = {"running": running_query, "moving": moving_query,
               "range": range_query, "u2u": u2u_query}
    out = {}
    for name, build_df in queries.items():
        mode = _window_mode(build_df(fact))
        if mode != SLICE5_MODES[name]:
            fail(f"{engine} {name}: the planner picked {mode}, not "
                 f"{SLICE5_MODES[name]}")
        base = torch.cuda.memory_allocated(dev)
        if name in ("running", "moving"):
            want = _upload_oracle(dev, oracles, name)

            def check(got, q=name, w=want):
                check_rows(q, got, w, dev)
        else:
            want = None
            check = (lambda got: check_range(got, oracles["range"])) \
                if name == "range" else (
                lambda got: check_u2u(got, oracles["u2u"]))
        checker_bytes = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build_df(fact).collect_arrow(), check,
                         SLICE5_HOT_RUNS, count_syncs=False)
        peak = int(torch.cuda.max_memory_allocated(dev)) - checker_bytes
        del want, check
        ex = spark.last_execution
        if ex["engine"] != engine or ex["fallbacks"]:
            fail(f"{name} ran on {ex['engine']}, not {engine}: {ex}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE5_PATH_KERNELS[(engine, name)])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   mode=list(mode), upload_s=upload_s,
                   peak_device_bytes=peak)
        out[name] = rec
        torch.cuda.empty_cache()
    spark.stop()
    return out


#: kernels each slice-6 query must launch on either engine
SLICE6_PATH_KERNELS = {
    "string_q5": ("dfa_match", "str_find", "str_rewrite"),
    "string_dup": ("str_find", "str_rewrite", "str_assemble"),
    "orders_q13": ("dfa_match", "str_find", "str_rewrite"),
    "orders_words": ("str_find", "str_rewrite", "str_assemble"),
}


def _spark_promo(promo: str):
    """string_dup_query's two keys of one promo in plain Python, with the
    reference's semantics (ASCII case maps; InitCap after spaces only)."""
    rpad = (promo + "*" * 12)[:12]
    initcap = " ".join(w[:1].upper() + w[1:].lower()
                       for w in promo.split(" "))
    shape = (rpad + promo.replace("_0", "#")
             + promo.translate(str.maketrans("mo", "MX")) + promo[::-1]
             + initcap)
    return promo + "|" + promo.upper(), shape


def slice6_oracles(order_paths, want_q5, want_dup) -> dict:
    """The four string queries' answers: string_q5 and string_dup from the
    pyarrow oracles' per-region and per-promo groups, each key mapped in
    plain Python (12 regions, 5 promos); the two ORDERS queries in pyarrow
    compute (match_substring_regex, utf8_length, find_substring,
    split_pattern, replace_substring, utf8_trim, utf8_lpad)."""
    import re

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    q5 = {}
    for r in want_q5.to_pylist():
        reg = r["region"]
        if ("_0" in reg and re.search("region_0[1-7]", reg)
                and not reg.startswith("region_05")):
            key = reg[7:9].upper()
            if key in q5:
                fail(f"string_q5 oracle: two regions give {key}")
            q5[(key,)] = dict(rev=r["revenue_sum"],
                              avg_amount=r["amount_mean"],
                              sales=r["region_count"])
    dup = {}
    for r in want_dup.to_pylist():
        tag, shape = _spark_promo(r["promo"])
        dup[(tag, shape)] = dict(n=r["promo_count"],
                                 total_rebate=r["rebate_sum"],
                                 tag_chars=r["promo_count"] * len(tag))
    t = pa.concat_tables([pq.read_table(p) for p in order_paths])
    com = t.column("o_comment")
    keep = pc.invert(pc.match_substring_regex(com, "special.*requests"))
    f = t.filter(keep)
    fc = f.column("o_comment")
    work = pa.table({"p": f.column("o_orderpriority"),
                     "chars": pc.utf8_length(fc),
                     "fur": pc.add(pc.find_substring(fc, "furiously"), 1)})
    g = work.group_by("p").aggregate([("p", "count"), ("chars", "sum"),
                                      ("fur", "max")])
    q13 = {(r["p"],): dict(n=r["p_count"], chars=r["chars_sum"],
                           furious_at=r["fur_max"]) for r in g.to_pylist()}
    work = pa.table({
        "w": pc.list_element(pc.split_pattern(com, " ", max_splits=1), 0),
        "short": pc.utf8_length(pc.utf8_trim(
            pc.replace_substring(com, "requests", "reqs"), " ")),
        "padded": pc.utf8_length(pc.utf8_lpad(com, 80, "."))})
    g = work.group_by("w").aggregate([("w", "count"), ("short", "sum"),
                                      ("padded", "max")])
    words = {(r["w"],): dict(n=r["w_count"], short=r["short_sum"],
                             padded=r["padded_max"]) for r in g.to_pylist()}
    return {"string_q5": (["rk"], q5), "string_dup": (["tag", "shape"], dup),
            "orders_q13": (["o_orderpriority"], q13),
            "orders_words": (["word"], words)}


def check_groups(query: str, got, want) -> None:
    """Groups equal, integers exact, doubles within REL_TOL relative."""
    keys, rows = want
    g = {tuple(r[k] for k in keys): r for r in got.to_pylist()}
    if set(g) != set(rows) or len(g) != got.num_rows:
        fail(f"{query}: groups differ: {sorted(g)[:8]} vs "
             f"{sorted(rows)[:8]} ({got.num_rows} rows)")
    for key, row in rows.items():
        for col, v in row.items():
            mine = g[key][col]
            if isinstance(v, float):
                rel = abs(mine - v) / max(abs(v), 1e-300)
                if not rel <= REL_TOL:
                    fail(f"{query} {key}: {col} {mine} vs {v} ({rel} "
                         "relative)")
            elif mine != v:
                fail(f"{query} {key}: {col} {mine} != {v}")


def run_slice6(dev, root, oracles, fused: bool) -> dict:
    """Phase 8: the four string queries (q5.py) through the port's session
    with bench.py's conf on the adaptive engine or the fused engine, over
    the cached facts, dimensions and ORDERS. Returns {query: record}, each
    with its peak device bytes."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        orders_q13_query,
        orders_words_query,
        string_dup_query,
        string_q5_query,
    )

    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 23)
             .config("spark.rapids.sql.batchSizeRows", 1 << 23)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    engine = "fused" if fused else "aqe"
    frames = {}
    t0 = time.monotonic()
    for name in ("fact", "dim", "dup", "orders"):
        df = spark.read.parquet(os.path.join(root, name)).cache(
            storage="device")
        spark.cache_manager.lookup(df._plan).materialize()
        frames[name] = df
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    queries = {
        "string_q5": lambda: string_q5_query(frames["fact"], frames["dim"]),
        "string_dup": lambda: string_dup_query(frames["fact"],
                                               frames["dup"]),
        "orders_q13": lambda: orders_q13_query(frames["orders"]),
        "orders_words": lambda: orders_words_query(frames["orders"]),
    }
    out = {}
    for name, build_df in queries.items():
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build_df().collect_arrow(),
                         lambda got, q=name: check_groups(q, got,
                                                          oracles[q]),
                         LATER_HOT_RUNS)
        ex = spark.last_execution
        if ex["engine"] != engine or ex["fallbacks"]:
            fail(f"{name} ran on {ex['engine']}, not {engine}: {ex}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE6_PATH_KERNELS[name])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s,
                   peak_device_bytes=int(torch.cuda.max_memory_allocated(
                       dev)))
        out[name] = rec
        torch.cuda.empty_cache()
    spark.stop()
    return out


#: the slice-7 kernels each query must launch (phase 9): K22 on the text
#: load and on the date literal of q4's window, K23 on both queries in Los
#: Angeles' zone, K24 on the monthly report's text
SLICE7_PATH_KERNELS = {
    "orders_q4_window": ("str_parse",),
    "orders_ingest": ("str_parse", "tz_rebase"),
    "orders_monthly": ("tz_rebase", "str_format"),
}
#: each query's session zone (phase 9)
SLICE7_ZONES = {"orders_q4_window": "UTC", "orders_ingest": ZONE_LA,
                "orders_monthly": ZONE_LA}


def slice7_oracles(typed_paths) -> dict:
    """The three date queries' answers from the typed table in pyarrow and
    numpy, and the zones from the standard library: zoneinfo over the
    2,406 distinct order dates, mapped onto the rows with numpy."""
    import datetime as dtm
    from zoneinfo import ZoneInfo

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in typed_paths])
    days = t.column("o_orderdate").cast(pa.int32()).to_numpy()
    keys = t.column("o_orderkey").to_numpy()
    price = t.column("o_totalprice").to_numpy()
    prio = t.column("o_orderpriority").combine_chunks().dictionary_encode()
    prio_code = prio.indices.to_numpy()
    prio_name = prio.dictionary.to_pylist()
    lo = int(days.min())
    epoch = dtm.date(1970, 1, 1)
    dates = [epoch + dtm.timedelta(days=int(d))
             for d in range(lo, int(days.max()) + 1)]
    la, ist = ZoneInfo(ZONE_LA), ZoneInfo(ZONE_IST)
    # unix seconds of each date's midnight in Los Angeles
    midnight = np.array([int(dtm.datetime(d.year, d.month, d.day,
                                          tzinfo=la).timestamp())
                         for d in dates], np.int64)
    # that instant in Kolkata's wall clock, read back as an instant in LA
    ist_hour = np.array([dtm.datetime.fromtimestamp(
        int(m) + int(dtm.datetime.fromtimestamp(int(m), ist).utcoffset()
                     .total_seconds()), la).hour for m in midnight])
    ts_chars = np.array([len(dtm.datetime.fromtimestamp(int(m), la)
                             .replace(tzinfo=None).isoformat(sep=" "))
                         for m in midnight])
    year = np.array([d.year for d in dates])
    row = days - lo

    def groups(codes, names, sel, aggs):
        """{key: {column: value}} over the rows `sel`, grouped by `codes`
        (one int64 code a row, named by names(code))."""
        uniq, inv = np.unique(codes[sel], return_inverse=True)
        out = {}
        cols = {name: fn(inv, len(uniq), sel) for name, fn in aggs.items()}
        for g, code in enumerate(uniq):
            out[names(int(code))] = {name: v[g] for name, v in cols.items()}
        return out

    def count(inv, k, sel):
        return [int(c) for c in np.bincount(inv, minlength=k)]

    def total(values):
        return lambda inv, k, sel: [
            float(v) for v in np.bincount(inv, weights=values[sel],
                                          minlength=k)]

    def int_total(values):
        def f(inv, k, sel):
            acc = np.zeros(k, np.int64)
            np.add.at(acc, inv, values[sel])
            return [int(v) for v in acc]
        return f

    def extreme(values, ufunc, init, conv):
        def f(inv, k, sel):
            acc = np.full(k, init, np.int64)
            ufunc.at(acc, inv, values[sel])
            return [conv(int(v)) for v in acc]
        return f

    def as_date(d):
        return epoch + dtm.timedelta(days=d)

    everything = np.ones(len(days), dtype=bool)
    start = (dtm.date(1993, 7, 1) - epoch).days
    end = (dtm.date(1993, 10, 1) - epoch).days
    q4 = groups(prio_code.astype(np.int64),
                lambda c: (prio_name[c],), (days >= start) & (days < end),
                dict(order_count=count, revenue=total(price),
                     first_date=extreme(days, np.minimum, 2 ** 40, as_date),
                     last_date=extreme(days, np.maximum, -2 ** 40,
                                       as_date)))
    ingest = groups(year[row].astype(np.int64), lambda c: (c,), everything,
                    dict(n=count, revenue=total(price),
                         max_key=extreme(keys, np.maximum, -2 ** 62, int),
                         ts_sum=int_total(midnight[row])))
    key_chars = np.floor(np.log10(keys)).astype(np.int64) + 1
    month_code = np.array([d.year * 12 + d.month - 1 for d in dates],
                          np.int64)

    def month_hour(c):
        return (f"{c // 100 // 12:04d}-{c // 100 % 12 + 1:02d}", c % 100)

    monthly = groups(month_code[row] * 100 + ist_hour[row], month_hour,
                     everything,
                     dict(revenue=total(price), n=count,
                          key_chars=int_total(key_chars),
                          ts_chars=int_total(ts_chars[row])))
    return {"orders_q4_window": (["o_orderpriority"], q4),
            "orders_ingest": (["o_year"], ingest),
            "orders_monthly": (["month", "ist_hour"], monthly)}


def run_slice7(dev, root, oracles, fused: bool) -> dict:
    """Phase 9: the three date queries (q5.py) through the port's session
    with bench.py's conf on the adaptive or the fused engine, over the
    typed ORDERS and its .tbl text cached on the card, each in its zone (a
    session a zone). Returns {query: record}, each with its peak device
    bytes."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        orders_ingest_query,
        orders_monthly_query,
        orders_q4_window_query,
    )

    engine = "fused" if fused else "aqe"
    builds = {"orders_q4_window": (orders_q4_window_query, "orders_dated"),
              "orders_ingest": (orders_ingest_query, "orders_tbl"),
              "orders_monthly": (orders_monthly_query, "orders_dated")}
    out = {}
    for zone in ("UTC", ZONE_LA):
        spark = (TpuSparkSession.builder
                 .config("spark.sql.shuffle.partitions", 8)
                 .config("spark.rapids.sql.reader.batchSizeRows", 1 << 23)
                 .config("spark.rapids.sql.batchSizeRows", 1 << 23)
                 .config("spark.rapids.shuffle.mode", "DEVICE")
                 .config("spark.rapids.sql.fusedExec.enabled", fused)
                 .config("spark.sql.session.timeZone", zone)
                 .getOrCreate())
        names = [q for q, z in SLICE7_ZONES.items() if z == zone]
        frames = {}
        t0 = time.monotonic()
        for table in sorted({builds[q][1] for q in names}):
            df = spark.read.parquet(os.path.join(root, table)).cache(
                storage="device")
            spark.cache_manager.lookup(df._plan).materialize()
            frames[table] = df
        torch.cuda.synchronize()
        upload_s = time.monotonic() - t0
        for name in names:
            build, table = builds[name]
            torch.cuda.reset_peak_memory_stats(dev)
            rec = timed_runs(
                lambda: build(frames[table]).collect_arrow(),
                lambda got, q=name: check_groups(q, got, oracles[q]),
                LATER_HOT_RUNS)
            ex = spark.last_execution
            if ex["engine"] != engine or ex["fallbacks"]:
                fail(f"{name} ran on {ex['engine']}, not {engine}: {ex}")
            missing_launches(f"{engine} {name}", rec["launches"],
                             SLICE7_PATH_KERNELS[name])
            rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                       zone=zone, upload_s=upload_s,
                       peak_device_bytes=int(
                           torch.cuda.max_memory_allocated(dev)))
            out[name] = rec
            torch.cuda.empty_cache()
        spark.stop()
    return out


# ---------------------------------------------------------------- slice 8

#: orders_price_stats' partial's rows (a cached part of the 15M ORDERS is
#: read in 2^20-row batches) and its groups; orders_daily_distinct's days
STAT_PART_ROWS = 1 << 20
STAT_GROUPS = 35
DAILY_GROUPS = 2406


def _f64_close(name: str, got, want, tol: float) -> float:
    """float64 results within tol relative (NaN where both are); returns
    the largest absolute difference."""
    import torch

    both_nan = torch.isnan(got) & torch.isnan(want)
    same = (got == want) | both_nan
    d = torch.where(same, torch.zeros_like(got), (got - want).abs())
    rel = torch.where(same, torch.zeros_like(got),
                      d / want.abs().clamp(min=1e-300))
    worst = float(rel.max().item()) if rel.numel() else 0.0
    if not worst <= tol:
        fail(f"{name}: kernel differs from its plain version by {worst} "
             "relative")
    return float(d.max().item()) if d.numel() else 0.0


def _same_selection(name: str, got, want, sgid, nseg: int) -> None:
    """K25's selection against its plain version, bit for bit, over the
    groups up to the largest id in sgid (the kernel leaves the groups past
    it, which lie past the batch's group count, unwritten)."""
    live = max(0, min(nseg, int(sgid[-1].item()) + 1))
    outs, total = got
    outs_p, total_p = want
    for j, (g, w) in enumerate(zip(outs + [total], outs_p + [total_p])):
        same_bits(f"{name} output {j}", g[:live], w[:live])


def check_slice8_kernels(dev):
    """Phase 2, slice 8: K4's multi-sum (k = 5, corr's sums, and k = 8) at
    orders_price_stats' partial's shape (a 2^20-row batch in 35 sorted
    groups); K25's selection at the same shape (K = 128 targets over rows
    sorted by (group, price), unit weights, 2^20 segments, as the update
    gives it) and at its merge's (a 2^20-row buffer batch of 35 groups
    flattened to 2^27 points, weights n on the scale of K), and its
    interpolation at orders_daily_distinct's final (2,406 days of ~6,200
    sorted prices, padded to 6,500); K26's rank and scatter at
    orders_daily_distinct's 2^20-row partial (o_custkey, 2,406 days of
    ~436 rows, duplicates dropped). Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.ops import segmented as S

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    rng = np.random.default_rng(81)
    out = {}
    n = STAT_PART_ROWS
    gid = torch.from_numpy(np.sort(rng.integers(0, STAT_GROUPS, n)).astype(
        np.int32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    price = torch.from_numpy(rng.integers(85_771, 55_528_517, n) / 100.0).to(
        dev)
    day = torch.from_numpy(rng.integers(0, 2406, n).astype(np.float64)).to(
        dev)
    for k in (5, 8):
        vecs = ([price, day, price * day, price * price, day * day]
                if k == 5 else [price ** (1 + j % 4) * (j + 1)
                                for j in range(k)])

        def k4(vecs=vecs):
            r = S.seg_sum_count_multi(vecs, valid, gid, STAT_GROUPS)
            return [r.count] + r.sums

        def k4_plain(vecs=vecs):
            r = S.seg_sum_count_plain(vecs, valid, gid, STAT_GROUPS)
            return [r.count] + r.sums

        got, want = k4(), k4_plain()
        torch.cuda.synchronize()
        exact(f"seg_multi_sum k={k} count", got[0], want[0])
        err = max(_f64_close(f"seg_multi_sum k={k} sum {j}", g, w,
                             F64_ATOMIC_TOL)
                  for j, (g, w) in enumerate(zip(got[1:], want[1:])))
        out[f"seg_multi_sum_k{k}"] = dict(
            route="cuda", source=src + "seg_sum_count.cu",
            replaces="spark_rapids_tpu/ops/segmented.py:392",
            max_abs_err=err, counter="seg_sum_count",
            **timed(f"seg_multi_sum k={k}", k4, k4_plain,
                    lambda vecs=vecs: [S.seg_sum(v, valid, gid, STAT_GROUPS)
                                       for v in vecs]),
            # valid for every row; gid and the k values for the valid rows;
            # k sums and a count out
            bound_ms=bound_ms(n + n * (4 + 8 * k) + STAT_GROUPS * 8 * (k + 1)),
            bound_by="bytes",
            shape=f"{k} float64 vectors of [{n}], {STAT_GROUPS} sorted groups",
            library_call=f"{k} separate K4 launches")
        del vecs, got, want
    # K25 select: the sorted update of one part
    cap = n  # a 2^20-row batch is its own capacity bucket
    K = 128
    perm = A._sort_by_group(gid, price, valid)
    svals, sgid = price[perm.long()], gid[perm.long()]
    slive = valid.clone()

    def k25():
        return A.rank_select(svals, sgid, None, slive, cap, K, 1e-12)

    def k25_plain():
        return A.rank_select_plain(svals, sgid, None, slive, cap, K, 1e-12)

    _same_selection("rank_select", k25(), k25_plain(), sgid, cap)
    bounds = torch.searchsorted(sgid, torch.arange(
        STAT_GROUPS + 1, dtype=torch.int32, device=dev)).tolist()
    qs = torch.linspace(0, 1, K, dtype=torch.float64, device=dev)
    out["rank_select"] = dict(
        route="cuda", source=src + "rank_select.cu",
        replaces="spark_rapids_tpu/expr/aggregates.py:996",
        max_abs_err=0.0,
        **timed("rank_select", k25, k25_plain,
                lambda: [torch.quantile(svals[lo:hi], qs,
                                        interpolation="lower")
                         for lo, hi in zip(bounds[:-1], bounds[1:])],
                PLAIN_ITERS),
        # gid and the live mask of every row, the K selected values and
        # the K + 1 outputs of each live group
        bound_ms=bound_ms(n * 5 + STAT_GROUPS * K * 8
                          + STAT_GROUPS * (K + 1) * 8),
        bound_by="bytes",
        shape=f"{n} sorted rows, {STAT_GROUPS} groups, K = {K}, {cap} "
              "segments",
        library_call="torch.quantile a group")
    del svals, sgid, slive, perm
    # K25 select at the merge: 35 live buffer rows of 2^20, their K
    # points each with weight n (the merge's n/K on the scale of K); the
    # dead rows' points sort after the last group's live ones, as K10
    # gives dead rows the last group's id
    flat = cap * K
    mgid = torch.full((flat,), STAT_GROUPS - 1, dtype=torch.int32,
                      device=dev)
    mgid[:STAT_GROUPS * K] = torch.repeat_interleave(torch.arange(
        STAT_GROUPS, dtype=torch.int32, device=dev), K)
    mw = torch.zeros(flat, dtype=torch.int64, device=dev)
    mw[:STAT_GROUPS * K] = torch.from_numpy(np.repeat(rng.integers(
        20_000, 40_000, STAT_GROUPS), K)).to(dev)
    mvals = torch.sort(torch.from_numpy(rng.normal(
        3e5, 1e5, STAT_GROUPS * K)).to(dev)).values
    mvals = torch.cat([mvals, torch.full((flat - STAT_GROUPS * K,),
                                         float("inf"), device=dev,
                                         dtype=torch.float64)])
    # sorted by (group, value): each live group's K points are a run
    mvals[:STAT_GROUPS * K] = mvals[:STAT_GROUPS * K].reshape(
        STAT_GROUPS, K).sort(dim=1).values.reshape(-1)

    def k25m():
        return A.rank_select(mvals, mgid, mw, None, cap, K, 1e-12 * K)

    def k25m_plain():
        return A.rank_select_plain(mvals, mgid, mw, None, cap, K, 1e-12 * K)

    _same_selection("rank_select merge", k25m(), k25m_plain(), mgid, cap)
    out["rank_select_merge"] = dict(
        route="cuda", source=src + "rank_select.cu",
        replaces="spark_rapids_tpu/expr/aggregates.py:1049",
        max_abs_err=0.0, counter="rank_select",
        **timed("rank_select merge", k25m, k25m_plain, None, PLAIN_ITERS),
        # gid and weight of the live points, the values of the targets
        # hit and the K + 1 outputs of each live group (the dead points'
        # are never read)
        bound_ms=bound_ms(STAT_GROUPS * K * (4 + 8 + 8)
                          + STAT_GROUPS * (K + 1) * 8),
        bound_by="bytes",
        shape=f"{flat} points, {STAT_GROUPS} live groups of {K} (the dead "
              f"points in the last), {cap} segments, weights n")
    del mgid, mw, mvals
    # K25 interpolate: the daily final's sorted price rows
    rows, me = next_capacity(DAILY_GROUPS), 6500
    lens = torch.from_numpy(np.where(
        np.arange(rows) < DAILY_GROUPS, rng.integers(5900, 6500, rows),
        0).astype(np.int32)).to(dev)
    sv = torch.sort(torch.from_numpy(rng.integers(85_771, 55_528_517,
                                                  (rows, me)) / 100.0).to(
        dev), dim=1).values

    def interp():
        return A.rank_interp(sv, lens, 0.5)

    def interp_plain():
        return A.rank_interp_plain(sv, lens, 0.5)

    same_bits("rank_interp", interp(), interp_plain())
    out["rank_interp"] = dict(
        route="cuda", source=src + "rank_select.cu",
        replaces="spark_rapids_tpu/expr/aggregates.py:934",
        max_abs_err=0.0,
        **timed("rank_interp", interp, interp_plain, None),
        bound_ms=bound_ms(rows * (4 + 2 * 8 + 8)), bound_by="bytes",
        shape=f"[{rows}, {me}] sorted prices, {DAILY_GROUPS} rows live")
    del sv
    # K26: the daily partial of one 2^20-row batch, a set of o_custkey
    m = 1 << 20
    dgid = torch.from_numpy(np.sort(rng.integers(0, DAILY_GROUPS, m)).astype(
        np.int32)).to(dev)
    cust = torch.from_numpy(rng.integers(1, 1_500_001, m)).to(dev)
    dvalid = torch.ones(m, dtype=torch.bool, device=dev)
    dperm = A._sort_by_group(dgid, cust, dvalid)
    cust, dgid = cust[dperm.long()], dgid[dperm.long()]
    nseg = next_capacity(DAILY_GROUPS)

    def rank():
        return A.collect_rank(cust, dvalid, dgid, nseg, True)

    def rank_plain():
        return A.collect_rank_plain(cust, dvalid, dgid, nseg, True)

    got, want = rank(), rank_plain()
    for j, (g, w) in enumerate(zip(got, want)):
        exact(f"collect_rank output {j}", g, w)
    keep, rk, counts = want
    me = max(int(counts.max()), 1)
    kept = int(keep.sum().item())
    out["collect_rank"] = dict(
        route="cuda", source=src + "collect_scatter.cu",
        replaces="spark_rapids_tpu/expr/aggregates.py:668",
        max_abs_err=0.0,
        **timed("collect_rank", rank, rank_plain, None),
        # valid, gid and the value (and its predecessor's) a row; keep and
        # rank out; the counts
        bound_ms=bound_ms(m * (1 + 4 + 8 + 1 + 4) + nseg * 4),
        bound_by="bytes",
        shape=f"[{m}] int64 o_custkey, {DAILY_GROUPS} sorted days, "
              "duplicates dropped")

    def scatter():
        return A.collect_scatter(cust, keep, rk, dgid, counts, nseg, me)

    def scatter_plain():
        return A.collect_scatter_plain(cust, keep, rk, dgid, counts, nseg,
                                       me)

    def library():
        order = torch.argsort(dgid, stable=True)
        o = torch.zeros((nseg, me), dtype=cust.dtype, device=dev)
        sel = order[keep[order]]
        o.index_put_((dgid[sel].long(), rk[sel].long()), cust[sel])
        return o

    got, want = scatter(), scatter_plain()
    for j, (g, w) in enumerate(zip(got, want)):
        exact(f"collect_scatter output {j}", g, w)
    out["collect_scatter"] = dict(
        route="cuda", source=src + "collect_scatter.cu",
        replaces="spark_rapids_tpu/expr/aggregates.py:723",
        max_abs_err=0.0,
        **timed("collect_scatter", scatter, scatter_plain, library),
        # keep a row; rank, gid and the value of the kept rows; the counts;
        # the [nseg, me] matrix and its validity out
        bound_ms=bound_ms(m + kept * (4 + 4 + 8) + nseg * 4
                          + nseg * me * (8 + 1)),
        bound_by="bytes",
        shape=f"{kept} kept rows into [{nseg}, {me}] int64",
        library_call="stable argsort + index_put_")
    torch.cuda.empty_cache()
    return out


def check_slice8_edges(dev) -> int:
    """Phase 2, slice 8 edge shapes against the plain versions: K4 at k = 1
    to 8, 9 and 16 (split launches), int64 and float64, sorted and
    unsorted ids, at 1,709 and 1,710 bins with k = 8 (the privatised
    bins' shared-memory limit, and one past it), ids outside the bins;
    K25's selection at K = 1, 2, 16 and 128 over groups of one row,
    all-NaN groups, groups with no live row, empty groups, ties of the
    running weight at a target (unit weights, totals multiple of K - 1,
    and merge weights), one position; its interpolation at widths 1 to 9
    and lengths 0 to the width, p = 0, 1 and between; K26 over every
    element kind with NaN, -0.0 and nulls, with and without the duplicate
    test, max_elems = 1, ids past the groups, one row. Returns the number
    of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.ops import segmented as S

    rng = np.random.default_rng(82)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16):
        for n, nseg, sort_ids, ty in ((1, 1, True, np.int64),
                                      (5000, 7, True, np.float64),
                                      (70001, 1709, False, np.int64),
                                      (70001, 1710, False, np.float64),
                                      (4097, 3, False, np.int64)):
            gid = rng.integers(-2, nseg + 2, n).astype(np.int32)
            if sort_ids:
                gid = np.sort(gid)
            gid, valid = t(gid), t(rng.random(n) > 0.3)
            vals = [t((rng.integers(-1000, 1000, n)
                       * (10 if j % 2 else 1)).astype(ty)) for j in range(k)]
            masks = [t(rng.random(n) > 0.5) if j % 3 == 1 else None
                     for j in range(k)]
            if sort_ids:
                got = S.seg_sum_count_multi(vals, valid, gid, nseg, masks,
                                            value_counts=True)
            else:
                with S.unsorted_gids():
                    got = S.seg_sum_count_multi(vals, valid, gid, nseg,
                                                masks, value_counts=True)
            want = S.seg_sum_count_plain(vals, valid, gid, nseg, masks,
                                         True, True)
            name = f"seg_sum_count k={k} n={n} bins={nseg}"
            exact(f"{name} count", got.count, want.count)
            for j in range(k):
                exact(f"{name} value count {j}", got.value_counts[j],
                      want.value_counts[j])
                if ty == np.int64:
                    exact(f"{name} sum {j}", got.sums[j], want.sums[j])
                else:
                    _f64_close(f"{name} sum {j}", got.sums[j], want.sums[j],
                               F64_ATOMIC_TOL)
            cases += 1
    # K25 select
    for K in (1, 2, 16, 128):
        for weighted in (False, True):
            sizes = [1, 1, 8, 127 * 2, 0, 3, 500, 1, 0, 60]
            gid = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
            n = len(gid)
            vals = rng.normal(size=n)
            vals[gid == 2] = np.nan            # an all-NaN group
            vals = np.sort(vals)               # any order; K25 reads rows
            live = rng.random(n) > 0.2
            live[gid == 5] = False             # a group with no live row
            live[gid == 3] = True              # a tie at every target
            # the live rows first in each group, as the sorts give them
            live = live[np.lexsort((~live, gid))]
            w = np.where(live, 1, 0) * (K if weighted else 1)
            sv, sg = t(vals), t(gid)
            args = ((t(w.astype(np.int64)), None) if weighted
                    else (None, t(live)))
            eps = 1e-12 * (K if weighted else 1)
            for nseg in (len(sizes), 6, 1024):
                _same_selection(
                    f"rank_select K={K} w={weighted} nseg={nseg}",
                    A.rank_select(sv, sg, *args, nseg, K, eps),
                    A.rank_select_plain(sv, sg, *args, nseg, K, eps), sg,
                    nseg)
                cases += 1
    one = (t(np.array([2.5])), t(np.array([0], np.int32)), None,
           t(np.array([True])), 1, 128, 1e-12)
    _same_selection("rank_select one position", A.rank_select(*one),
                    A.rank_select_plain(*one), one[1], 1)
    cases += 1
    # K25 interpolate
    for me in range(1, 10):
        sv = t(np.sort(rng.normal(size=(me + 2, me)), axis=1))
        lens = t(np.arange(me + 2).clip(max=me).astype(np.int32))
        for p in (0.0, 1.0, 0.5, 0.9, 1 / 3):
            same_bits(f"rank_interp me={me} p={p}", A.rank_interp(sv, lens, p),
                      A.rank_interp_plain(sv, lens, p))
            cases += 1
    # K26
    kinds = {
        "bool": lambda n: rng.random(n) > 0.5,
        "int8": lambda n: rng.integers(-3, 3, n).astype(np.int8),
        "int16": lambda n: rng.integers(-3, 3, n).astype(np.int16),
        "int32": lambda n: rng.integers(-3, 3, n).astype(np.int32),
        "int64": lambda n: rng.integers(-3, 3, n),
        "float32": lambda n: rng.choice(np.array(
            [0.0, -0.0, np.nan, 1.0, -np.inf], np.float32), n),
        "float64": lambda n: rng.choice(np.array(
            [0.0, -0.0, np.nan, 1.0, np.inf], np.float64), n),
    }
    for kind, draw in kinds.items():
        for n, groups, nseg in ((1, 1, 1), (300, 300, 300), (5000, 40, 37),
                                (70001, 900, 1024)):
            gid = t(np.sort(rng.integers(0, groups, n)).astype(np.int32))
            vals, valid = t(draw(n)), t(rng.random(n) > 0.1)
            for dedup in (False, True):
                if dedup:
                    perm = A._sort_by_group(gid, vals, valid).long()
                    v2, g2, ok2 = vals[perm], gid[perm], valid[perm]
                else:
                    v2, g2, ok2 = vals, gid, valid
                got = A.collect_rank(v2, ok2, g2, nseg, dedup)
                want = A.collect_rank_plain(v2, ok2, g2, nseg, dedup)
                name = f"collect {kind} n={n} nseg={nseg} dedup={dedup}"
                for j, (g, wn) in enumerate(zip(got, want)):
                    exact(f"{name} rank output {j}", g, wn)
                keep, rk, counts = want
                me = max(int(counts.max()), 1)
                for width in {me, 1}:
                    sg = A.collect_scatter(v2, keep, rk, g2, counts, nseg,
                                           width)
                    sw = A.collect_scatter_plain(v2, keep, rk, g2, counts,
                                                 nseg, width)
                    for j, (g, wn) in enumerate(zip(sg, sw)):
                        if g.dtype.is_floating_point:
                            same_bits(f"{name} width {width} output {j}", g,
                                      wn)
                        else:
                            exact(f"{name} width {width} output {j}", g, wn)
                cases += 1
    torch.cuda.synchronize()
    return cases


#: phase 2's slice-9 shapes: TPC-H SF10's 1,500,000 customers and
#: 15,000,000 orders
SF10_CUSTOMERS = 1_500_000
SF10_ORDERS = 15_000_000


def check_slice9_kernels(dev):
    """Phase 2, slice 9: K27's probe marks at orders_price_bands' shape
    (150,000,000 candidate pairs of 15,000,000 orders by 10 bands at
    capacity 2^28, a third ok, into the orders' 2^24 marks) and at q13's
    (15,000,000 pairs in probe-row runs, as K3 gives them, into the 1.5M
    customers' marks); its build marks at the bands shape (the same pairs
    into the bands' capacity) and at a q13-shaped full join's (15,000,000
    pairs into the orders' marks); its coverage at orders_yoy_full's
    (about 900,000 probe ranges of one row into 2^20 build rows); K28 at
    orders_union_rr's (4,500,000 live rows of a 4,718,592-row batch into
    16 partitions); K29 at customer_segments' (1,500,000 int16 codes
    through a 5-entry table). Exact against the plain versions. Returns
    {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import encoding as enc
    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.ops import joinops as J
    from spark_rapids_tpu_torch.ops import partition as P

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    rng = np.random.default_rng(91)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # bands: pair j is (order j // 10, band j % 10); K3 fills the slots
    # past the total with (n - 1, 0), which ok marks dead
    cap, total, marks = 1 << 28, SF10_ORDERS * 10, 1 << 24
    pi = torch.arange(cap, dtype=torch.int32, device=dev) // 10
    pi[total:] = SF10_ORDERS - 1
    bi = torch.arange(cap, dtype=torch.int32, device=dev) % 10
    bi[total:] = 0
    ok = torch.rand(cap, device=dev) < 1 / 3
    ok[total:] = False
    n_ok = int(ok.sum().item())
    for name, idx, m, fn, plain, counter, rep in (
            ("probe_marks", pi, marks, J.probe_marks, J.probe_marks_plain,
             "probe_marks", "spark_rapids_tpu/exec/joins.py:151"),
            ("build_marks", bi, next_capacity(10), J.build_marks,
             J.build_marks_plain,
             "build_marks", "spark_rapids_tpu/exec/joins.py:585")):
        got, want = fn(idx, ok, m), plain(idx, ok, m)
        torch.cuda.synchronize()
        exact(name, got, want)
        idx64 = idx.to(torch.int64)
        ok32 = ok.to(torch.int32)
        out[name] = dict(
            route="cuda", source=src + "join_marks.cu", replaces=rep,
            max_abs_err=max_abs_err(got, want), counter=counter,
            **timed(name, lambda idx=idx, m=m, fn=fn: fn(idx, ok, m),
                    lambda idx=idx, m=m, plain=plain: plain(idx, ok, m),
                    lambda idx64=idx64, m=m: torch.zeros(
                        m, dtype=torch.int32, device=dev).scatter_reduce_(
                            0, idx64, ok32, "amax"), 3),
            # ok read for every slot, the index of each ok pair, the marks
            # written
            bound_ms=bound_ms(cap + 4 * n_ok + m), bound_by="bytes",
            shape=f"{total} of {cap} pair slots, {n_ok} ok, into {m} marks",
            library_call="scatter_reduce_(amax) on int32, int64 index "
                         "made outside")
        del got, want, idx64, ok32
    del pi, bi, ok
    torch.cuda.empty_cache()
    # q13's pairs (runs of a probe row's matches) and a q13-shaped full
    # join's build marks
    counts = rng.poisson(10, SF10_CUSTOMERS).astype(np.int32)
    runs = np.repeat(np.arange(SF10_CUSTOMERS, dtype=np.int32), counts)
    q13cap = 1 << 24
    qpi = np.full(q13cap, SF10_CUSTOMERS - 1, np.int32)
    qpi[:len(runs)] = runs
    qok = np.zeros(q13cap, bool)
    qok[:len(runs)] = rng.random(len(runs)) < 0.98
    qbi = rng.integers(0, SF10_ORDERS, q13cap).astype(np.int32)
    qpi, qok, qbi = t(qpi), t(qok), t(qbi)
    for what, fn, plain, idx, m in (
            ("probe marks at q13", J.probe_marks, J.probe_marks_plain, qpi,
             1 << 21),
            ("build marks at a q13-shaped full join", J.build_marks,
             J.build_marks_plain, qbi, 1 << 24)):
        got, want = fn(idx, qok, m), plain(idx, qok, m)
        torch.cuda.synchronize()
        exact(what, got, want)
        print(f"{what}: {len(runs)} of {q13cap} pairs into {m} marks: "
              f"kernel_ms={device_ms(lambda: fn(idx, qok, m), what):.4f} "
              f"plain_ms="
              f"{device_ms(lambda: plain(idx, qok, m), what, 3):.4f}",
              flush=True)
    del qpi, qok, qbi, got, want
    # yoy's coverage: ~900,000 probe ranges of one build row each (80 %
    # matched) over the other year's sorted customers
    nb = 900_000
    ncap = 1 << 20
    lo = np.sort(rng.integers(0, nb, ncap)).astype(np.int32)
    cnt = (rng.random(ncap) < 0.8).astype(np.int32)
    cnt[nb:] = 0
    lo, cnt = t(lo), t(cnt)
    got = J.build_coverage(lo, cnt, ncap)
    want = J.build_coverage_plain(lo, cnt, ncap)
    torch.cuda.synchronize()
    exact("build_coverage", got, want)
    n_pos = int((cnt > 0).sum().item())

    def cov_library():
        has = (cnt > 0).to(torch.int32)
        d = torch.zeros(ncap + 1, dtype=torch.int32, device=dev)
        d.scatter_add_(0, lo.to(torch.int64), has)
        d.scatter_add_(0, (lo + cnt).to(torch.int64), -has)
        return torch.cumsum(d[:-1], 0) > 0

    out["build_coverage"] = dict(
        route="cuda", source=src + "join_marks.cu",
        replaces="spark_rapids_tpu/exec/joins.py:254",
        max_abs_err=max_abs_err(got, want), counter="build_coverage",
        **timed("build_coverage", lambda: J.build_coverage(lo, cnt, ncap),
                lambda: J.build_coverage_plain(lo, cnt, ncap), cov_library),
        # counts of every probe row, lo of the ranges, the marks written
        bound_ms=bound_ms(4 * ncap + 4 * n_pos + ncap), bound_by="bytes",
        shape=f"{n_pos} probe ranges of {ncap} rows into {ncap} build rows",
        library_call="difference array (scatter_add_) and torch.cumsum")
    del lo, cnt, got, want
    # K28: union_rr's batch into 16 partitions
    rcap, rrows, nparts = 4_718_592, 4_500_000, 16
    got = P.round_robin_perm(rcap, rrows, nparts, 0, dev)
    want = P.round_robin_perm_plain(rcap, torch.tensor(rrows, device=dev),
                                    nparts, 0)
    torch.cuda.synchronize()
    exact("round_robin_partition perm", got[0], want[0])
    exact("round_robin_partition counts", got[1], want[1])

    def rr_library():
        pid = (torch.arange(rcap, dtype=torch.int32, device=dev)
               % nparts)
        return P.partition_perm(pid, rrows, nparts)

    out["round_robin_partition"] = dict(
        route="cuda", source=src + "partition_by_ids.cu",
        replaces="spark_rapids_tpu/ops/partition.py:54",
        max_abs_err=max_abs_err(got[0], want[0]),
        counter="round_robin_partition",
        **timed("round_robin_partition",
                lambda: P.round_robin_perm(rcap, rrows, nparts, 0, dev),
                lambda: P.round_robin_perm_plain(
                    rcap, torch.tensor(rrows, device=dev), nparts, 0),
                rr_library),
        # the permutation written (no pid read), the counts
        bound_ms=bound_ms(4 * rcap + 4 * nparts), bound_by="bytes",
        shape=f"{rrows} live rows of {rcap} into {nparts} partitions",
        library_call="torch.arange % n, then K7")
    del got, want
    # K29: the customers' segment codes through the quota's 5-entry table
    codes = t(rng.integers(0, 5, SF10_CUSTOMERS).astype(np.int16))
    table = t(np.array([4, 3, 2, 1, 0], np.int32))
    codes64 = codes.to(torch.int64)
    got = enc.remap_codes(codes, table)
    want = enc.remap_codes_plain(codes, table)
    torch.cuda.synchronize()
    exact("codes_remap", got, want)
    out["codes_remap"] = dict(
        route="cuda", source=src + "codes_remap.cu",
        replaces="spark_rapids_tpu/columnar/encoding.py:524",
        max_abs_err=max_abs_err(got, want), counter="codes_remap",
        **timed("codes_remap", lambda: enc.remap_codes(codes, table),
                lambda: enc.remap_codes_plain(codes, table),
                lambda: table[codes64]),
        # int16 codes read, int32 codes written, the table once
        bound_ms=bound_ms(6 * SF10_CUSTOMERS + 20), bound_by="bytes",
        shape=f"{SF10_CUSTOMERS} int16 codes through 5 entries",
        library_call="table[codes] (int64 codes made outside)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def check_slice9_edges(dev) -> int:
    """Phase 2, slice 9 edge shapes against the plain versions: K27's marks
    with no pair, every pair ok and none, indices at 0 and the last mark,
    int64 indices, indices outside the marks (build marks clip), marks ORed
    into earlier ones, dead slots past the total; its coverage with no
    probe row, no range, ranges ending at or past the build's end, nested
    and overlapping ranges, one build row, partial tiles; K28 at n = 1,
    n above the rows, a start, no live row, a device row count, capacities
    no multiple of 1,024; K29 at codes 0, K - 1, past K and negative, K = 1,
    K = 12,288 and 12,289 (the shared-memory table's limit and one past),
    int16 and int32 codes; and whole joins on the card against the CPU
    (inner, left, full, semi, anti, with and without a condition, under
    the shuffled hash and nested-loop joins) over null, NaN and -0.0 keys,
    an empty probe and an empty build. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import encoding as enc
    from spark_rapids_tpu_torch.ops import joinops as J
    from spark_rapids_tpu_torch.ops import partition as P

    rng = np.random.default_rng(92)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for n, m, dt, p_ok in ((0, 1, np.int32, 0.5), (1, 1, np.int32, 1.0),
                           (5000, 1, np.int64, 0.5),
                           (4097, 300, np.int32, 1.0),
                           (4097, 300, np.int32, 0.0),
                           (70001, 70001, np.int64, 0.3),
                           (100_003, 17, np.int32, 0.5)):
        idx = rng.integers(0, m, n).astype(dt)
        if n:
            idx[:2] = [0, m - 1][:min(n, 2)]
        ok = rng.random(n) < p_ok
        if n > 10:
            ok[-7:] = False  # dead slots past the total
        out_idx = rng.integers(-3, m + 3, n).astype(dt)
        prev = rng.random(m) < 0.3
        ti, tk, to = t(idx), t(ok), t(out_idx)
        exact(f"probe_marks n={n} m={m}", J.probe_marks(ti, tk, m),
              J.probe_marks_plain(ti, tk, m))
        exact(f"build_marks n={n} m={m}", J.build_marks(to, tk, m),
              J.build_marks_plain(to, tk, m))
        exact(f"build_marks OR n={n} m={m}",
              J.build_marks(to, tk, m, out=t(prev)),
              J.build_marks_plain(to, tk, m, out=t(prev)))
        cases += 3
    for n_probe, n_build, maxc in ((0, 1, 1), (1, 1, 1), (9, 1, 3),
                                   (5000, 4096, 0), (5000, 4097, 40),
                                   (70001, 12289, 9000),
                                   (300, 1 << 20, 1 << 19)):
        lo = rng.integers(0, n_build, n_probe).astype(np.int32)
        cnt = rng.integers(0, maxc + 1, n_probe).astype(np.int32)
        if n_probe > 2:
            lo[-1], cnt[-1] = n_build - 1, maxc + 1  # past the end
        tl, tc = t(lo), t(cnt)
        exact(f"build_coverage {n_probe} -> {n_build}",
              J.build_coverage(tl, tc, n_build),
              J.build_coverage_plain(tl, tc, n_build))
        cases += 1
    for cap, rows, nparts, start in ((1, 1, 1, 0), (1000, 999, 1, 0),
                                     (1025, 1025, 2000, 3),
                                     (5000, 0, 16, 0), (70001, 70000, 7, 9),
                                     (4097, 4000, 8191, 1)):
        for dev_rows in (False, True):
            nr = torch.tensor(rows, device=dev) if dev_rows else rows
            got = P.round_robin_perm(cap, nr, nparts, start, dev)
            want = P.round_robin_perm_plain(
                cap, torch.tensor(rows, device=dev), nparts, start)
            exact(f"round_robin_partition {cap} n={nparts}", got[0], want[0])
            exact(f"round_robin_partition counts {cap}", got[1], want[1])
            cases += 1
    for n, k, dt in ((1, 1, np.int16), (5000, 5, np.int16),
                     (4097, 12288, np.int32), (4097, 12289, np.int32),
                     (70001, 1 << 16, np.int32)):
        codes = rng.integers(-2, k + 2, n).astype(dt)
        codes[:1] = 0
        if n > 2:
            codes[1], codes[2] = k - 1, k
        table = rng.integers(-1, 1000, k).astype(np.int32)
        tc, tt = t(codes), t(table)
        exact(f"codes_remap n={n} k={k}", enc.remap_codes(tc, tt),
              enc.remap_codes_plain(tc, tt))
        cases += 1
    cases += _joins_on_card_vs_cpu(dev, rng)
    return cases


def _joins_on_card_vs_cpu(dev, rng) -> int:
    """Small whole joins over null, NaN and -0.0 float keys and duplicate
    int keys on the card against the same on the CPU (plain versions)."""
    import numpy as np
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar.arrow_bridge import (
        arrow_to_device,
        device_to_arrow,
    )
    from spark_rapids_tpu_torch.exec import joins as PJ
    from spark_rapids_tpu_torch.exec.base import PhysicalPlan
    from spark_rapids_tpu_torch.expr import BoundReference
    from spark_rapids_tpu_torch.expr.predicates import LessThan
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import double, integer

    class Src(PhysicalPlan):
        def __init__(self, batches, schema):
            super().__init__([], schema, None)
            self.batches = batches

        @property
        def num_partitions(self):
            return max(1, len(self.batches))

        def execute_partition(self, pid, ctx):
            if pid < len(self.batches):
                yield self.batches[pid]

    def table(n, seed):
        r = np.random.default_rng(seed)
        f = r.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5]), n)
        return pa.table({
            "f": pa.array(f, mask=r.random(n) < 0.15),
            "v": pa.array(r.integers(0, 20, n).astype(np.int32))})

    lf = [StructField("f", double, True), StructField("v", integer, True)]
    rf = [StructField("rf", double, True), StructField("rv", integer, True)]
    cases = 0
    for nl, nr in ((300, 120), (0, 50), (80, 0)):
        lt = table(nl, 1)
        rt = table(nr, 2).rename_columns(["rf", "rv"])
        for strategy in ("shuffled", "nested_loop"):
            for jt in ("inner", "left", "full", "left_semi", "left_anti"):
                for cond in (False, True):
                    if strategy == "nested_loop" and not cond and nl * nr:
                        continue  # a cross product: no keys to test
                    res = {}
                    for where in ("cpu", dev):
                        def src(tb, fs):
                            b = [arrow_to_device(tb, device=where)] \
                                if tb.num_rows else []
                            return Src(b, StructType(fs))
                        schema = StructType(
                            lf + ([] if jt in ("left_semi", "left_anti")
                                  else rf))
                        c = (LessThan(BoundReference(1, integer),
                                      BoundReference(3, integer))
                             if cond else None)
                        if strategy == "nested_loop":
                            node = PJ.TpuBroadcastNestedLoopJoinExec(
                                src(lt, lf), src(rt, rf), jt, schema, None,
                                condition=c)
                        else:
                            node = PJ.TpuShuffledHashJoinExec(
                                src(lt, lf), src(rt, rf), jt,
                                [BoundReference(0, double)],
                                [BoundReference(0, double)], schema, None,
                                condition=c)
                        res[str(where)] = sorted(
                            map(repr, node.collect().to_pylist()))
                    if res["cpu"] != res[str(dev)]:
                        fail(f"{strategy} {jt} join (condition {cond}) of "
                             f"{nl} x {nr} rows differs on the card")
                    cases += 1
    return cases


#: the slice-8 kernels each query must launch (phase 10): K4 and K25's
#: selection on the price statistics, K26 and K25's interpolation on the
#: daily distinct counts and medians, K14 on the variance windows
SLICE8_PATH_KERNELS = {
    "orders_price_stats": ("seg_sum_count", "rank_select", "sort_words"),
    "orders_daily_distinct": ("collect_rank", "collect_scatter",
                              "rank_interp", "sort_words"),
    "orders_price_window": ("window_prefix", "window_eval"),
}
#: the engine each query runs on when the fused engine is on
SLICE8_FUSED_ENGINE = {"orders_price_stats": "fused",
                       "orders_daily_distinct": "aqe",
                       "orders_price_window": "fused"}
#: percentile_approx's rank error allowed against the exact rank: a few
#: merge levels of K = 128 points (the sketch's O(1/K) a level)
P90_RANK_TOL = 4 / 128
#: the largest rank error and moment deviation seen, per engine
SLICE8_ERRS = {}


def _moment_terms(x, y):
    """Per group: n and the fsum power and cross sums, with the sums of
    the absolute values the tolerance reads."""
    import math

    import numpy as np

    n = float(len(x))
    s = [math.fsum((x ** p).tolist()) for p in range(1, 5)]
    # the terms' sizes only scale the tolerance: a plain sum will do
    a = [float(np.sum(np.abs(x) ** p)) for p in range(1, 5)]
    sy, syy, sxy = (math.fsum(v.tolist()) for v in (y, y * y, x * y))
    ay, axy = float(np.sum(np.abs(y))), float(np.sum(np.abs(x * y)))
    return n, s, a, sy, syy, sxy, ay, axy


def _stats_oracle(x, y):
    """The reference's formulas over exact sums, each with the size of its
    terms: {column: (value or None, scale)}."""
    import math

    n, (s1, s2, s3, s4), (a1, a2, a3, a4), sy, syy, sxy, ay, axy = \
        _moment_terms(x, y)
    mu = s1 / n
    m2 = max(s2 - s1 * mu, 0.0)
    m3 = s3 - 3.0 * mu * s2 + 2.0 * mu * mu * s1
    m4 = s4 - 4.0 * mu * s3 + 6.0 * mu * mu * s2 - 3.0 * mu ** 3 * s1
    am = a1 / n
    var_scale = a2 + a1 * am
    cov = sxy - s1 * sy / n
    vy = max(syy - sy * sy / n, 0.0)
    cov_scale = axy + a1 * ay / n
    return {
        "var_samp": (m2 / (n - 1), var_scale / (n - 1)),
        "var_pop": (m2 / n, var_scale / n),
        "sd_samp": (math.sqrt(m2 / (n - 1)), var_scale / (n - 1)),
        "sd_pop": (math.sqrt(m2 / n), var_scale / n),
        "skew": (math.sqrt(n) * m3 / m2 ** 1.5,
                 math.sqrt(n) * (a3 + 3 * am * a2 + 2 * am * am * a1)
                 / m2 ** 1.5),
        "kurt": (n * m4 / (m2 * m2) - 3.0,
                 n * (a4 + 4 * am * a3 + 6 * am * am * a2
                      + 3 * am ** 3 * a1) / (m2 * m2)),
        "cov_pop": (cov / n, cov_scale / n),
        "cov_samp": (cov / (n - 1), cov_scale / (n - 1)),
        "corr": (max(-1.0, min(1.0, cov / (math.sqrt(m2) * math.sqrt(vy)))),
                 cov_scale / (math.sqrt(m2) * math.sqrt(vy))),
    }


def slice8_oracles(typed_paths) -> dict:
    """Phase 10's answers from the typed ORDERS in numpy: the price
    statistics per (priority, year) over math.fsum sums and the
    reference's formulas, each group's sorted prices for the p90's rank;
    each day's count, distinct customers and median (the rank
    interpolation over the sorted prices); each order's 100-row stddev and
    its priority's variance from extended-precision prefix sums."""
    import math

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.concat_tables([pq.read_table(p) for p in typed_paths])
    days = t.column("o_orderdate").cast(pa.int32()).to_numpy()
    price = t.column("o_totalprice").to_numpy()
    cust = t.column("o_custkey").to_numpy()
    keys = t.column("o_orderkey").to_numpy()
    prio = t.column("o_orderpriority").combine_chunks().dictionary_encode()
    pcode = prio.indices.to_numpy().astype(np.int64)
    pname = prio.dictionary.to_pylist()
    years = days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970
    day_no = (days - 8035).astype(np.float64)  # datediff from 1992-01-01
    # the statistics
    gkey = pcode * 100 + (years - 1990)
    order = np.argsort(gkey, kind="stable")
    uniq, starts = np.unique(gkey[order], return_index=True)
    ends = list(starts[1:]) + [len(order)]
    stats = {}
    for g, lo, hi in zip(uniq, starts, ends):
        rows = order[lo:hi]
        x, y = price[rows], day_no[rows]
        want = _stats_oracle(x, y)
        want["all_over_900"] = (bool((x > 900.0).all()), 0.0)
        want["any_over_500k"] = (bool((x > 500000.0).any()), 0.0)
        stats[(pname[g // 100], int(g % 100) + 1990)] = (want, np.sort(x))
    # the daily line
    dorder = np.lexsort((price, days))
    sd, sp = days[dorder], price[dorder]
    duniq, dstart, dcount = np.unique(sd, return_index=True,
                                      return_counts=True)
    pairs = np.unique(days.astype(np.int64) << 32 | cust)
    distinct = np.bincount((pairs >> 32) - duniq[0],
                           minlength=len(duniq))
    daily = {}
    for i, (d, lo, n) in enumerate(zip(duniq, dstart, dcount)):
        rk = 0.5 * max(n - 1, 0)
        lo_i, hi_i = int(math.floor(rk)), int(math.ceil(rk))
        vlo, vhi = sp[lo + lo_i], sp[lo + hi_i]
        daily[int(d)] = (int(n), int(distinct[d - duniq[0]]),
                         vlo + (vhi - vlo) * (rk - lo_i))
    # the windows: rows sorted by (priority, date, key); 100-row frames
    worder = np.lexsort((keys, days, pcode))
    wp = pcode[worder]
    xl = price[worder].astype(np.longdouble)
    c1 = np.concatenate([[0.0], np.cumsum(xl)])
    c2 = np.concatenate([[0.0], np.cumsum(xl * xl)])
    pstart = np.concatenate([[0], np.nonzero(np.diff(wp))[0] + 1])
    pend = np.concatenate([pstart[1:], [len(wp)]])
    start_of = np.repeat(pstart, pend - pstart)
    end_of = np.repeat(pend, pend - pstart)
    idx = np.arange(len(wp))
    lo = np.maximum(start_of, idx - 99)
    n = (idx + 1 - lo).astype(np.longdouble)
    s1, s2 = c1[idx + 1] - c1[lo], c2[idx + 1] - c2[lo]
    m2 = np.maximum(s2 - s1 * s1 / n, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        var100 = (m2 / (n - 1)).astype(np.float64)
        scale100 = ((s2 + s1 * s1 / n) / (n - 1)).astype(np.float64)
    pn = (end_of - start_of).astype(np.longdouble)
    ps1, ps2 = c1[end_of] - c1[start_of], c2[end_of] - c2[start_of]
    pvar = (np.maximum(ps2 - ps1 * ps1 / pn, 0) / pn).astype(np.float64)
    pscale = ((ps2 + ps1 * ps1 / pn) / pn).astype(np.float64)
    # indexed by original row: o_orderkey = 4 * row + 1
    back = np.empty(len(worder), np.int64)
    back[worder] = idx
    window = dict(var100=var100[back], scale100=scale100[back],
                  n100=(idx + 1 - lo)[back], pvar=pvar[back],
                  pscale=pscale[back], pcode=pcode, pname=pname,
                  days=days, price=price)
    return {"orders_price_stats": stats, "orders_daily_distinct": daily,
            "orders_price_window": window}


def _p90_rank_err(value, sorted_x) -> float:
    import numpy as np

    lo = np.searchsorted(sorted_x, value, side="left") / len(sorted_x)
    hi = np.searchsorted(sorted_x, value, side="right") / len(sorted_x)
    return 0.0 if lo <= 0.9 <= hi else min(abs(lo - 0.9), abs(hi - 0.9))


def check_price_stats(engine: str, got, want) -> None:
    """Groups equal; each moment within 1e-9 of its terms' size; bools
    exact; the p90's rank within P90_RANK_TOL of 0.9."""
    rows = {(r["o_orderpriority"], r["o_year"]): r for r in got.to_pylist()}
    if set(rows) != set(want):
        fail(f"orders_price_stats: groups differ: {sorted(rows)[:5]} vs "
             f"{sorted(want)[:5]}")
    errs = SLICE8_ERRS.setdefault(engine, {"p90_rank": 0.0, "moment": 0.0})
    for key, (cols, sorted_x) in want.items():
        r = rows[key]
        for col, (v, scale) in cols.items():
            mine = r[col]
            if isinstance(v, bool):
                if mine != v:
                    fail(f"orders_price_stats {key}: {col} {mine} != {v}")
                continue
            d = abs(mine - v)
            if col.startswith("sd"):
                d = abs(mine * mine - v * v)
            errs["moment"] = max(errs["moment"], d / scale)
            if not d <= 1e-9 * scale:
                fail(f"orders_price_stats {key}: {col} {mine} vs {v} "
                     f"(terms {scale})")
        e = _p90_rank_err(r["p90"], sorted_x)
        errs["p90_rank"] = max(errs["p90_rank"], e)
        if not e <= P90_RANK_TOL:
            fail(f"orders_price_stats {key}: p90 {r['p90']} is {e} off its "
                 "rank")


def check_daily_distinct(got, want) -> None:
    """Each day's count and distinct customers exact, its median within
    1e-12 relative."""
    import numpy as np

    import pyarrow as pa

    d = got.column("o_orderdate").cast(pa.int32()).to_numpy()
    n = got.column("n").to_numpy()
    c = got.column("customers").to_numpy()
    med = got.column("median").to_numpy()
    if sorted(d.tolist()) != sorted(want):
        fail("orders_daily_distinct: days differ")
    w = np.array([want[int(x)] for x in d], dtype=object)
    if not (n == np.array([v[0] for v in w])).all():
        fail("orders_daily_distinct: counts differ")
    if not (c == np.array([v[1] for v in w])).all():
        fail("orders_daily_distinct: distinct customers differ")
    wm = np.array([v[2] for v in w], dtype=np.float64)
    rel = np.abs(med - wm) / np.abs(wm)
    if not rel.max() <= 1e-12:
        fail(f"orders_daily_distinct: medians off by {rel.max()} relative")


def check_price_window(engine: str, got, want) -> None:
    """Every order's 100-row stddev (squared) and its priority's variance
    within 1e-9 of the size of their terms; the passed-through columns
    exact."""
    import numpy as np
    import pyarrow as pa

    keys = got.column("o_orderkey").to_numpy()
    row = (keys - 1) // 4
    if len(row) != len(want["price"]) or len(np.unique(row)) != len(row):
        fail("orders_price_window: rows differ")
    sd = got.column("sd100").to_numpy(zero_copy_only=False)
    pv = got.column("prio_var").to_numpy()
    n = want["n100"][row]
    v100 = want["var100"][row]
    d = np.where(n >= 2, np.abs(sd.astype(np.float64) ** 2 - v100), 0.0)
    if not (np.isnan(sd) == (n < 2)).all():
        fail("orders_price_window: the stddev's nulls differ")
    worst = float(np.max(d / np.where(n >= 2, want["scale100"][row], 1.0)))
    dp = np.abs(pv - want["pvar"][row]) / want["pscale"][row]
    worst = max(worst, float(dp.max()))
    errs = SLICE8_ERRS.setdefault(engine, {"p90_rank": 0.0, "moment": 0.0})
    errs["window"] = max(errs.get("window", 0.0), worst)
    if not worst <= 1e-9:
        fail(f"orders_price_window: variances off by {worst} of their "
             "terms")
    prio = got.column("o_orderpriority").combine_chunks().dictionary_encode()
    code = np.array([want["pname"].index(p)
                     for p in prio.dictionary.to_pylist()])[
        prio.indices.to_numpy()]
    if not ((got.column("o_totalprice").to_numpy() == want["price"][row]).all()
            and (got.column("o_orderdate").cast(pa.int32()).to_numpy()
                 == want["days"][row]).all()
            and (code == want["pcode"][row]).all()):
        fail("orders_price_window: passed-through columns differ")


def run_slice8(dev, root, oracles, fused: bool) -> dict:
    """Phase 10: the three statistical queries (q5.py) through the port's
    session with the fused engine on or off over the typed ORDERS cached on
    the card, at spark.rapids.sql.batchSizeRows 2^20. Returns {query:
    record}, each with its peak device bytes."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        orders_daily_distinct_query,
        orders_price_stats_query,
        orders_price_window_query,
    )

    engine = "fused" if fused else "aqe"
    builds = {"orders_price_stats": orders_price_stats_query,
              "orders_daily_distinct": orders_daily_distinct_query,
              "orders_price_window": orders_price_window_query}
    checks = {"orders_price_stats": lambda g: check_price_stats(
                  engine, g, oracles["orders_price_stats"]),
              "orders_daily_distinct": lambda g: check_daily_distinct(
                  g, oracles["orders_daily_distinct"]),
              "orders_price_window": lambda g: check_price_window(
                  engine, g, oracles["orders_price_window"])}
    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 20)
             .config("spark.rapids.sql.batchSizeRows", 1 << 20)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    out = {}
    t0 = time.monotonic()
    df = spark.read.parquet(os.path.join(root, "orders_dated")).cache(
        storage="device")
    spark.cache_manager.lookup(df._plan).materialize()
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0
    for name, build in builds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build(df).collect_arrow(), checks[name],
                         SLICE8_HOT_RUNS, count_syncs=False)
        ex = spark.last_execution
        want_engine = SLICE8_FUSED_ENGINE[name] if fused else "aqe"
        if ex["engine"] != want_engine:
            fail(f"{name} ran on {ex['engine']}, not {want_engine}: {ex}")
        fell = [e for e, _ in ex["fallbacks"]]
        if fell != (["fused"] if fused and want_engine == "aqe" else []):
            fail(f"{name}: unexpected fallbacks {ex['fallbacks']}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE8_PATH_KERNELS[name])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s, peak_device_bytes=int(
                       torch.cuda.max_memory_allocated(dev)))
        out[name] = rec
        torch.cuda.empty_cache()
    spark.stop()
    return out


#: the slice-9 kernels each query must launch (phase 11), by engine: K27's
#: probe marks on q13's conditional left join and the bands' nested loop,
#: its build marks on the bands' full join, its coverage on the
#: year-over-year full join, K29 on the segment join's two dictionaries,
#: K28 on the adaptive engine's round-robin exchange (the fused engine's
#: single-chip exchange is identity)
SLICE9_PATH_KERNELS = {
    "q13_outer": ("probe_marks", "dfa_match", "expand_gather_maps",
                  "probe_ranges"),
    "q22_anti": ("probe_ranges", "compact_perm", "str_rewrite"),
    "orders_yoy_full": ("build_coverage", "expand_gather_maps",
                        "probe_ranges"),
    "orders_price_bands": ("probe_marks", "build_marks",
                           "expand_gather_maps"),
    "customer_segments": ("codes_remap", "probe_ranges"),
    "orders_union_rr": ("round_robin_partition", "partition_by_ids"),
}
SLICE9_FUSED_KERNELS = dict(SLICE9_PATH_KERNELS,
                            orders_union_rr=("seg_sum_count",))
#: the nested-loop join has no fused lowering: its query runs on the
#: adaptive engine alone
SLICE9_AQE_ONLY = ("orders_price_bands",)


def slice9_oracles(paths) -> dict:
    """Phase 11's answers from the written tables, in pyarrow (Table.join:
    left outer, left anti, full outer) and numpy."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.q5 import PRICE_BANDS, SEGMENTS

    cust = pq.read_table(paths["customer"][0])
    orders = pa.concat_tables([pq.read_table(p)
                               for p in paths["orders_cust"]])
    out = {}
    # q13: the condition touches orders alone, so it filters them first
    kept = orders.filter(pc.invert(pc.match_substring_regex(
        orders.column("o_comment"), "special.*requests"))).select(
        ["o_orderkey", "o_custkey"])
    c13 = (cust.select(["c_custkey"])
           .join(kept, keys="c_custkey", right_keys="o_custkey",
                 join_type="left outer")
           .group_by("c_custkey").aggregate([("o_orderkey", "count")]))
    dist = c13.group_by("o_orderkey_count").aggregate(
        [("c_custkey", "count")])
    out["q13_outer"] = sorted(
        zip(dist.column("c_custkey_count").to_pylist(),
            dist.column("o_orderkey_count").to_pylist()), reverse=True)
    # q22: positive balances with no order, per country code
    pos = cust.filter(pc.greater(cust.column("c_acctbal"), 0.0))
    # (the distinct order keys: the same anti join, a smaller hash table)
    anti = pos.join(pa.table({"o_custkey": pc.unique(
        orders.column("o_custkey"))}), keys="c_custkey",
        right_keys="o_custkey", join_type="left anti")
    code = pc.utf8_slice_codeunits(anti.column("c_phone"), 0, 2)
    g = pa.table({"code": code, "bal": anti.column("c_acctbal")}).group_by(
        "code").aggregate([("bal", "count"), ("bal", "sum")])
    out["q22_anti"] = {c: (n, s) for c, n, s in zip(
        g.column("code").to_pylist(), g.column("bal_count").to_pylist(),
        g.column("bal_sum").to_pylist())}
    # year over year: per-customer revenue of 1995 and 1996, full outer
    days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    years = days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970
    price = orders.column("o_totalprice").to_numpy()
    ck = orders.column("o_custkey").to_numpy()

    def rev(y, key, name):
        sel = years == y
        t = pa.table({key: ck[sel], name: price[sel]})
        g = t.group_by(key).aggregate([(name, "sum")])
        return pa.table({key: g.column(key), name: g.column(f"{name}_sum")})

    both = rev(1995, "ck95", "rev95").join(
        rev(1996, "ck96", "rev96"), keys="ck95", right_keys="ck96",
        join_type="full outer", coalesce_keys=False)
    n = both.num_rows
    in95 = n - both.column("ck95").null_count
    in96 = n - both.column("ck96").null_count
    out["orders_yoy_full"] = dict(
        customers=n, only95=n - in96, only96=n - in95,
        rev95=float(np.sum(price[years == 1995])),
        rev96=float(np.sum(price[years == 1996])))
    out["orders_yoy_full"]["change"] = (out["orders_yoy_full"]["rev96"]
                                        - out["orders_yoy_full"]["rev95"])
    # price bands: [lo, hi) bands are disjoint; an order in none lands in
    # the null band, a band with no order counts 0
    los = np.array([lo for lo, _ in PRICE_BANDS])
    his = np.array([hi for _, hi in PRICE_BANDS])
    b = np.searchsorted(los, price, side="right") - 1
    inb = (b >= 0) & (price < his[np.clip(b, 0, None)])
    bands = {}
    for k in range(len(PRICE_BANDS)):
        sel = inb & (b == k)
        bands[k] = (int(sel.sum()),
                    float(price[sel].sum()) if sel.any() else None)
    bands[None] = (int((~inb).sum()), float(price[~inb].sum()))
    out["orders_price_bands"] = bands
    # segments: per (segment, nation)
    seg = cust.column("c_mktsegment").combine_chunks()
    segname = np.array(seg.dictionary.to_pylist())[seg.indices.to_numpy()]
    quota = {s: 1000.0 * (len(SEGMENTS) - i)
             for i, s in enumerate(SEGMENTS)}
    nation = cust.column("c_nationkey").to_numpy()
    bal = cust.column("c_acctbal").to_numpy()
    qv = np.array([quota[s] for s in SEGMENTS])[seg.indices.to_numpy()]
    t = pa.table({"s": segname, "n": nation, "b": bal, "e": bal - qv})
    g = t.group_by(["s", "n"]).aggregate(
        [("b", "count"), ("b", "sum"), ("e", "sum")])
    out["customer_segments"] = {
        (s, k): (c, b1, e1) for s, k, c, b1, e1 in zip(
            g.column("s").to_pylist(), g.column("n").to_pylist(),
            g.column("b_count").to_pylist(), g.column("b_sum").to_pylist(),
            g.column("e_sum").to_pylist())}
    # union_rr: the 1995 and 1997 orders per priority
    sel = (years == 1995) | (years == 1997)
    t = pa.table({"p": orders.column("o_orderpriority").filter(
        pa.array(sel)), "v": price[sel]})
    g = t.group_by("p").aggregate([("v", "count"), ("v", "sum")])
    out["orders_union_rr"] = {p: (c, s) for p, c, s in zip(
        g.column("p").to_pylist(), g.column("v_count").to_pylist(),
        g.column("v_sum").to_pylist())}
    return out


def _rel_close(what: str, got, want) -> None:
    if want is None or got is None:
        if got != want:
            fail(f"{what}: {got} != {want}")
        return
    if not abs(got - want) <= REL_TOL * max(abs(want), 1.0):
        fail(f"{what}: {got} vs {want}")


def check_slice9(name: str, got, want) -> None:
    """Counts exact, sums within REL_TOL relative."""
    rows = got.to_pylist()
    if name == "q13_outer":
        mine = [(r["custdist"], r["c_count"]) for r in rows]
        if mine != want:
            fail(f"q13_outer: {mine[:5]} vs {want[:5]}")
    elif name == "q22_anti":
        if {r["cntrycode"] for r in rows} != set(want):
            fail("q22_anti: country codes differ")
        for r in rows:
            n, s = want[r["cntrycode"]]
            if r["numcust"] != n:
                fail(f"q22_anti {r['cntrycode']}: {r['numcust']} != {n}")
            _rel_close(f"q22_anti {r['cntrycode']} balance",
                       r["totacctbal"], s)
    elif name == "orders_yoy_full":
        (r,) = rows
        for k in ("customers", "only95", "only96"):
            if r[k] != want[k]:
                fail(f"orders_yoy_full: {k} {r[k]} != {want[k]}")
        for k in ("rev95", "rev96"):
            _rel_close(f"orders_yoy_full {k}", r[k], want[k])
        if not abs(r["change"] - want["change"]) <= REL_TOL * want["rev96"]:
            fail(f"orders_yoy_full: change {r['change']} vs "
                 f"{want['change']}")
    elif name == "orders_price_bands":
        if {r["b_band"] for r in rows} != set(want):
            fail("orders_price_bands: bands differ")
        for r in rows:
            n, s = want[r["b_band"]]
            if r["n"] != n:
                fail(f"orders_price_bands {r['b_band']}: {r['n']} != {n}")
            _rel_close(f"orders_price_bands {r['b_band']}", r["revenue"], s)
    elif name == "customer_segments":
        if {(r["c_mktsegment"], r["c_nationkey"]) for r in rows} != set(want):
            fail("customer_segments: groups differ")
        for r in rows:
            n, b, e = want[(r["c_mktsegment"], r["c_nationkey"])]
            if r["n"] != n:
                fail(f"customer_segments: {r} vs {n}")
            _rel_close("customer_segments balance", r["acctbal"], b)
            _rel_close("customer_segments excess", r["excess"], e)
    else:
        if {r["o_orderpriority"] for r in rows} != set(want):
            fail("orders_union_rr: priorities differ")
        for r in rows:
            n, s = want[r["o_orderpriority"]]
            if r["n"] != n:
                fail(f"orders_union_rr: {r} vs {n}")
            _rel_close("orders_union_rr revenue", r["revenue"], s)


def customer_session(dev, root, fused: bool):
    """The session of phases 11 to 13, the fused engine on or off, every
    hash join shuffled (spark.sql.autoBroadcastJoinThreshold=-1), with
    CUSTOMER, ORDERS, the bands and the quotas, LINEITEM, the decimal
    CUSTOMER and phase 9's ORDERS text cached on the card: (the session,
    {table: DataFrame}, the upload's seconds)."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession

    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.sql.autoBroadcastJoinThreshold", -1)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 20)
             .config("spark.rapids.sql.batchSizeRows", 1 << 20)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    t0 = time.monotonic()
    tables = {}
    for name in ("customer", "orders_cust", "bands", "quota", "lineitem",
                 "customer_dec", "orders_tbl"):
        df = spark.read.parquet(os.path.join(root, name))
        if name in SLICE11_COLUMNS:  # the columns phase 13 reads
            df = df.select(*SLICE11_COLUMNS[name])
        df = df.cache(storage="device")
        spark.cache_manager.lookup(df._plan).materialize()
        tables[name] = df
    torch.cuda.synchronize()
    return spark, tables, time.monotonic() - t0


def run_slice9(dev, session, oracles, fused: bool) -> dict:
    """Phase 11: the six join queries (q5.py) in `customer_session`'s
    session. Returns {query: record}, each with its peak device bytes."""
    import torch

    from spark_rapids_tpu_torch.q5 import (
        customer_segments_query,
        orders_price_bands_query,
        orders_union_rr_query,
        orders_yoy_full_query,
        q13_outer_query,
        q22_anti_query,
    )

    engine = "fused" if fused else "aqe"
    spark, tables, upload_s = session
    c, o = tables["customer"], tables["orders_cust"]
    builds = {
        "q13_outer": lambda: q13_outer_query(c, o),
        "q22_anti": lambda: q22_anti_query(c, o),
        "orders_yoy_full": lambda: orders_yoy_full_query(o),
        "orders_price_bands": lambda: orders_price_bands_query(
            o, tables["bands"]),
        "customer_segments": lambda: customer_segments_query(
            tables["quota"], c),
        "orders_union_rr": lambda: orders_union_rr_query(o),
    }
    out = {}
    for name, build in builds.items():
        if fused and name in SLICE9_AQE_ONLY:
            continue
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build().collect_arrow(),
                         lambda g: check_slice9(name, g, oracles[name]),
                         LATER_HOT_RUNS)
        ex = spark.last_execution
        if ex["engine"] != engine:
            fail(f"{name} ran on {ex['engine']}, not {engine}: {ex}")
        if [e for e, _ in ex["fallbacks"]]:
            fail(f"{name}: unexpected fallbacks {ex['fallbacks']}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         (SLICE9_FUSED_KERNELS if fused
                          else SLICE9_PATH_KERNELS)[name])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s, peak_device_bytes=int(
                       torch.cuda.max_memory_allocated(dev)))
        out[name] = rec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- slice 10

def _byte_rows(dev, strings, width: int):
    """Byte strings as a zero-padded [n, width] uint8 matrix and lengths
    on the card."""
    import numpy as np
    import torch

    mat = np.zeros((len(strings), width), np.uint8)
    for k, s in enumerate(strings):
        mat[k, :len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([len(s) for s in strings], np.int32)
    return torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)


def check_slice10_kernels(dev):
    """Phase 2, slice 10: K30 at orders_hash_sample's shapes, 15,000,000
    rows each: the MinHash key (o_custkey int64, o_orderpriority's [n, 16]
    rows, o_comment's [n, 128] rows of 19-78 bytes, each with validity, as
    the path hands them over) and the sample's o_orderkey alone; K24's hex
    mode over 15,000,000 int64 values. Exact against the plain versions
    (in 2^20-row pieces). Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.expr import mathexpr as M
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.q5 import ORDER_PRIORITIES
    from spark_rapids_tpu_torch.sqltypes.datatypes import long

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    rng = np.random.default_rng(101)
    n = SF10_ORDERS
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    valid = torch.ones(n, dtype=torch.bool, device=dev)
    custkey = t(rng.integers(1, SF10_CUSTOMERS + 1, n))
    pdata, plens = _byte_rows(dev, [p.encode() for p in ORDER_PRIORITIES],
                              16)
    pick = t(rng.integers(0, len(ORDER_PRIORITIES), n))
    prio, plen = pdata[pick], plens[pick]
    comments, clen = _comment_rows(dev, n, 102)
    cols = [_col(long, custkey, valid), _strcol(prio, plen, valid),
            _strcol(comments, clen, valid)]

    def plain(cs):
        return _chunked(lambda lo, hi: H.xxhash64_columns_plain(
            [c.slice_rows(lo, hi) for c in cs]), n)

    got, want = H.xxhash64_columns(cols), plain(cols)
    torch.cuda.synchronize()
    exact("xxhash64", got, want)
    text_bytes = int(plen.sum().item()) + int(clen.sum().item())
    out["xxhash64"] = dict(
        route="cuda", source=src + "xxhash64.cu",
        replaces="spark_rapids_tpu/ops/hashing.py:308",
        max_abs_err=max_abs_err(got, want), counter="xxhash64",
        **timed("xxhash64", lambda: H.xxhash64_columns(cols),
                lambda: plain(cols), None, PLAIN_ITERS),
        # the key, each string row's own bytes and length, three validity
        # bytes read; the hash written
        bound_ms=bound_ms(8 * n + text_bytes + 8 * n + 3 * n + 8 * n),
        bound_by="bytes",
        shape=f"{n} rows of (int64, [n, 16] string, [n, 128] string of "
              f"19-78 bytes), {text_bytes} text bytes")
    del got, want, prio, plen, pick
    key = [_col(long, t(rng.integers(1, 4 * n, n)), valid)]
    got, want = H.xxhash64_columns(key), plain(key)
    torch.cuda.synchronize()
    exact("xxhash64 of o_orderkey", got, want)
    print(f"xxhash64 at the sample's o_orderkey, {n} int64 rows: "
          f"kernel_ms={device_ms(lambda: H.xxhash64_columns(key), 'k30'):.4f}"
          f" plain_ms={device_ms(lambda: plain(key), 'k30', 3):.4f} "
          f"bound_ms={bound_ms(8 * n + n + 8 * n):.6f}", flush=True)
    del got, want, key, comments, clen, cols
    v = t(rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                       dtype=np.int64))
    v[:4] = torch.tensor([0, -1, -2**63, 2**63 - 1], device=dev)

    def hex_plain():
        return _chunked(lambda lo, hi: M.hex_plain(v[lo:hi]), n)

    got, want = M.hex_text(v), hex_plain()
    torch.cuda.synchronize()
    err = _exact_all("hex", got, want)
    out["str_format_hex"] = dict(
        route="cuda", source=src + "str_format.cu",
        replaces="spark_rapids_tpu/expr/mathexpr.py:457",
        max_abs_err=err, counter="str_format_hex",
        **timed("str_format_hex", lambda: M.hex_text(v), hex_plain, None,
                PLAIN_ITERS),
        # int64 in; 16 bytes and an int32 length out
        bound_ms=bound_ms(8 * n + 16 * n + 4 * n), bound_by="bytes",
        shape=f"{n} int64 values into [n, 16] uint8 and lengths")
    del got, want, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def check_slice10_edges(dev) -> int:
    """Phase 2, slice 10 edge shapes against the plain versions: K30 over
    every key kind (int32, int64, float, double, boolean, date, timestamp,
    string) with int32 and int64 limits, -0.0, NaNs of several payloads and
    +-inf; strings of every length 0-130 at widths 136 (8-byte aligned
    rows) and 131 (rows at every alignment); nulls first, in the middle and
    last, and whole null columns, in chains of 1 to 11 columns (past
    kernels.MAX_HASH_COLS, which takes a second, seeded launch); a
    non-default seed; n = 1 to 70,001. K24's hex mode at 0, +-1, every
    power of 16 and its neighbours, INT64_MIN and INT64_MAX, n = 1 to
    70,001. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.expr import mathexpr as M
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.sqltypes.datatypes import (
        boolean, date, double, float_t, integer, long, string, timestamp)

    rng = np.random.default_rng(103)
    cases = 0
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
    nans = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                     0xFFF8000000000000, 0x7FFFFFFFFFFFFFFF],
                    np.uint64).view(np.float64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def columns(n):
        valid = rng.random(n) < 0.8
        valid[0] = False                      # null first
        valid[n // 2] = False                 # ... in the middle
        valid[-1] = False                     # ... and last
        v = t(valid)
        ints = rng.integers(i32.min, i32.max, n, dtype=np.int64)
        if n > 5:
            ints[1:5] = [i32.min, i32.max, 0, -1]
        longs = rng.integers(i64.min, i64.max, n, dtype=np.int64)
        if n > 5:
            longs[1:5] = [i64.min, i64.max, 0, -1]
        dbl = rng.normal(0, 1e6, n)
        if n > 9:
            dbl[1:9] = [-0.0, 0.0, np.inf, -np.inf, *nans]
        with np.errstate(invalid="ignore"):
            f32 = dbl.astype(np.float32)
        lens = np.arange(n) % 131
        strs = [bytes(rng.integers(0, 256, k).astype(np.uint8))
                for k in lens]
        s136, l136 = _byte_rows(dev, strs, 136)
        s131, l131 = _byte_rows(dev, strs, 131)
        return [
            _col(integer, t(ints.astype(np.int32)), v),
            _col(long, t(longs), v),
            _col(float_t, t(f32), v),
            _col(double, t(dbl), v),
            _col(boolean, t(rng.random(n) < 0.5), v),
            _col(date, t(ints.astype(np.int32) // 4096), v),
            _col(timestamp, t(longs // 7), v),
            _strcol(s136, l136, v),
            _strcol(s131, l131, v),
            _col(long, t(longs), torch.zeros(n, dtype=torch.bool,
                                             device=dev)),   # all null
            _strcol(s136, l136, torch.ones(n, dtype=torch.bool,
                                           device=dev)),
        ]

    for n in (1, 7, 262, 4097, 70001):
        cols = columns(n)
        for k, c in enumerate(cols):
            exact(f"xxhash64 kind {k} n={n}", H.xxhash64_columns([c]),
                  H.xxhash64_columns_plain([c]))
            cases += 1
        for width in (2, 8, 9, 11):
            chain = [cols[j] for j in rng.permutation(len(cols))[:width]]
            exact(f"xxhash64 chain of {width} n={n}",
                  H.xxhash64_columns(chain),
                  H.xxhash64_columns_plain(chain))
            cases += 1
        exact(f"xxhash64 seed n={n}", H.xxhash64_columns(cols[7:9], 7),
              H.xxhash64_columns_plain(cols[7:9], 7))
        cases += 1
    edges = [0, 1, -1, i64.min, i64.max]
    for p in range(1, 16):
        edges += [16 ** p - 1, 16 ** p, 16 ** p + 1, -16 ** p]
    for n in (1, len(edges), 4097, 70001):
        v = rng.integers(i64.min, i64.max, n, dtype=np.int64)
        v[:min(n, len(edges))] = edges[:n]
        tv = t(v)
        _exact_all(f"hex n={n}", M.hex_text(tv), M.hex_plain(tv))
        cases += 1
    torch.cuda.synchronize()
    return cases


#: the kernels each slice-10 query must launch on either engine: K30, K6
#: (hash()) and K24's hex mode on the hash sample; K20 (substring) on q22
SLICE10_PATH_KERNELS = {
    "q22_full": ("str_rewrite", "probe_ranges"),
    "orders_priority_split": ("seg_sum_count",),
    "orders_hash_sample": ("xxhash64", "murmur3", "str_format_hex"),
    "customer_value_bands": ("probe_ranges", "seg_sum_count"),
}
#: q22's scalar subquery is a crossJoin, a nested-loop join: the fused
#: engine hands q22 to the adaptive one, as the reference's does
SLICE10_FUSED_FALLBACK = ("q22_full",)

_XP1 = 0x9E3779B185EBCA87
_XP2 = 0xC2B2AE3D27D4EB4F
_XP3 = 0x165667B19E3779F9
_XP4 = 0x85EBCA77C2B2AE63
_XP5 = 0x27D4EB2F165667C5


def _np_rotl(x, r: int):
    import numpy as np

    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _np_fmix(h):
    import numpy as np

    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(_XP2)
    h = h ^ (h >> np.uint64(29))
    h = h * np.uint64(_XP3)
    return h ^ (h >> np.uint64(32))


def _np_xxh_long(v, seed):
    """Spark's XXH64.hashLong in numpy uint64 (which wraps as Java's long
    does)."""
    import numpy as np

    u = np.asarray(v).astype(np.int64).view(np.uint64)
    h = seed + np.uint64(_XP5) + np.uint64(8)
    h = h ^ (_np_rotl(u * np.uint64(_XP2), 31) * np.uint64(_XP1))
    return _np_fmix(_np_rotl(h, 27) * np.uint64(_XP1) + np.uint64(_XP4))


def _np_xxh_bytes(mat, lens, seed):
    """Spark's XXH64.hashUnsafeBytes in numpy over rows of a zero-padded
    [n, w] uint8 matrix (w a multiple of 32), the row's own length each:
    stripes, words, a 4-byte word, then single bytes, selected by mask."""
    import numpy as np

    u = np.uint64
    n, w = mat.shape
    words = np.ascontiguousarray(mat).view("<u8")
    lens = lens.astype(np.int64)
    stripes = lens // 32
    acc = [seed + u(_XP1) + u(_XP2), seed + u(_XP2), seed + u(0),
           seed - u(_XP1)]
    for s in range(w // 32):
        on = s < stripes
        for lane in range(4):
            nxt = _np_rotl(acc[lane] + words[:, 4 * s + lane] * u(_XP2),
                           31) * u(_XP1)
            acc[lane] = np.where(on, nxt, acc[lane])
    big = (_np_rotl(acc[0], 1) + _np_rotl(acc[1], 7) + _np_rotl(acc[2], 12)
           + _np_rotl(acc[3], 18))
    for a in acc:
        big = (big ^ (_np_rotl(a * u(_XP2), 31) * u(_XP1))) * u(_XP1) \
            + u(_XP4)
    h = np.where(lens >= 32, big, seed + u(_XP5)) + lens.astype(u)
    off = stripes * 32
    rows = np.arange(n)
    for _ in range(3):
        on = off + 8 <= lens
        wv = words[rows, np.minimum(off // 8, w // 8 - 1)]
        k = _np_rotl(wv * u(_XP2), 31) * u(_XP1)
        h = np.where(on, _np_rotl(h ^ k, 27) * u(_XP1) + u(_XP4), h)
        off = off + np.where(on, 8, 0)
    on = off + 4 <= lens
    b = [mat[rows, np.minimum(off + j, w - 1)].astype(u) for j in range(4)]
    k4 = b[0] | (b[1] << u(8)) | (b[2] << u(16)) | (b[3] << u(24))
    h = np.where(on, _np_rotl(h ^ (k4 * u(_XP1)), 23) * u(_XP2) + u(_XP3), h)
    off = off + np.where(on, 4, 0)
    for _ in range(3):
        on = off < lens
        byte = mat[rows, np.minimum(off, w - 1)].astype(u)
        h = np.where(on, _np_rotl(h ^ (byte * u(_XP5)), 11) * u(_XP1), h)
        off = off + np.where(on, 1, 0)
    return _np_fmix(h)


def _np_murmur3_long(v, seed: int = 42):
    """Spark's Murmur3_x86_32.hashLong in numpy uint32: the low word, then
    the high word; the int32 result."""
    import numpy as np

    u = np.uint32
    v = np.asarray(v).astype(np.int64).view(np.uint64)

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))

    def mix(h, k):
        k = rotl(k * u(0xCC9E2D51), 15) * u(0x1B873593)
        return rotl(h ^ k, 13) * u(5) + u(0xE6546B64)

    h = np.full(len(v), seed, u)
    h = mix(h, (v & np.uint64(0xFFFFFFFF)).astype(u))
    h = mix(h, (v >> np.uint64(32)).astype(u))
    h = h ^ u(8)
    h = (h ^ (h >> u(16))) * u(0x85EBCA6B)
    h = (h ^ (h >> u(13))) * u(0xC2B2AE35)
    return (h ^ (h >> u(16))).view(np.int32)


def _np_string_matrix(arr, width: int):
    """A pyarrow string array as a zero-padded [n, width] uint8 matrix and
    byte lengths."""
    import numpy as np

    arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
    offs = np.frombuffer(arr.buffers()[1], np.int32)[
        arr.offset:arr.offset + len(arr) + 1]
    raw = np.frombuffer(arr.buffers()[2], np.uint8)
    lens = np.diff(offs)
    mat = np.zeros((len(arr), width), np.uint8)
    col = np.arange(width)
    take = col[None, :] < lens[:, None]
    idx = np.minimum(offs[:-1, None] + col[None, :], len(raw) - 1)
    mat[take] = raw[idx[take]]
    return mat, lens


def slice10_oracles(paths) -> dict:
    """Phase 12's answers from the written tables in numpy and pyarrow:
    q22's codes, subquery and anti join; q12's split by year; the hash
    sample with numpy's XXH64 and Murmur3 over the column values (uint64
    and uint32 arithmetic, Spark's algorithms); the value bands with
    numpy's log10 and a pyarrow left join."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.q5 import Q22_CODES

    cust = pq.read_table(paths["customer"][0])
    orders = pa.concat_tables([pq.read_table(p)
                               for p in paths["orders_cust"]])
    out = {}
    # q22: candidates by code, the average positive balance, no order
    code = pc.utf8_slice_codeunits(cust.column("c_phone"), 0, 2)
    cand = pa.table({"code": code, "bal": cust.column("c_acctbal"),
                     "key": cust.column("c_custkey")}).filter(
        pc.is_in(code, pa.array(Q22_CODES)))
    bal = cand.column("bal").to_numpy()
    avg = float(np.mean(bal[bal > 0.0]))
    rich = cand.filter(pc.greater(cand.column("bal"), avg))
    anti = rich.join(pa.table({"key": pc.unique(orders.column(
        "o_custkey"))}), keys="key", join_type="left anti")
    g = anti.group_by("code").aggregate([("bal", "count"), ("bal", "sum")])
    out["q22_full"] = sorted(zip(g.column("code").to_pylist(),
                                 g.column("bal_count").to_pylist(),
                                 g.column("bal_sum").to_pylist()))
    # q12's split: per order year
    days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    years = (days.astype("datetime64[D]").astype("datetime64[Y]")
             .astype(np.int64) + 1970)
    prio = orders.column("o_orderpriority")
    high = pc.is_in(prio, pa.array(["1-URGENT", "2-HIGH"])).to_numpy(
        zero_copy_only=False)
    split = {}
    for y in np.unique(years):
        sel = years == y
        split[int(y)] = (int(high[sel].sum()), int((~high[sel]).sum()),
                         int(sel.sum()))
    out["orders_priority_split"] = split
    # the hash sample
    seed = np.uint64(42)
    okey = orders.column("o_orderkey").to_numpy()
    sample = np.mod(_np_xxh_long(okey, seed).view(np.int64), 100) < 5
    idx = np.nonzero(sample)[0]
    ck = orders.column("o_custkey").to_numpy()[idx]
    price = orders.column("o_totalprice").to_numpy()[idx]
    bucket = np.mod(_np_murmur3_long(ck).astype(np.int64), 64)
    h = _np_xxh_long(ck, seed)
    for name, width in (("o_orderpriority", 32), ("o_comment", 128)):
        mat, lens = _np_string_matrix(
            orders.column(name).take(pa.array(idx)).combine_chunks(), width)
        h = _np_xxh_bytes(mat, lens, h)
    mh = h.view(np.int64)
    sample_out = {}
    for b in np.unique(bucket):
        sel = bucket == b
        sample_out[int(b)] = (int(sel.sum()), float(price[sel].sum()),
                              format(int(mh[sel].min()) & (2**64 - 1), "X"))
    out["orders_hash_sample"] = sample_out
    # value bands: customers left-joined to their 1996 revenue
    y96 = years == 1996
    rev = pa.table({"k": orders.column("o_custkey").to_numpy()[y96],
                    "p": orders.column("o_totalprice").to_numpy()[y96]}
                   ).group_by("k").aggregate([("p", "sum")])
    j = pa.table({"k": cust.column("c_custkey"),
                  "bal": cust.column("c_acctbal"),
                  "seg": cust.column("c_mktsegment").cast(pa.string())}
                 ).join(rev, keys="k", join_type="left outer")
    cbal = j.column("bal").to_numpy()
    crev = j.column("p_sum").to_numpy(zero_copy_only=False)
    none = np.isnan(crev)
    keys = j.column("k").to_numpy()
    seg = j.column("seg").to_numpy(zero_copy_only=False)
    band = np.floor(np.log10(np.abs(cbal) + 1.0)).astype(np.int64)
    rev0 = np.where(none, 0.0, crev)
    top = np.where(none, cbal, np.maximum(crev, cbal))
    bands = {}
    for b in np.unique(band):
        sel = band == b
        s = float(rev0[sel].sum())
        bands[int(b)] = dict(
            customers=int(sel.sum()), without_orders=int(none[sel].sum()),
            industrial=int(np.isin(seg[sel], ["BUILDING",
                                              "MACHINERY"]).sum()),
            even_keys=int((keys[sel] % 2 == 0).sum()), revenue=s,
            avg_rev=s / int(sel.sum()), max_top=float(top[sel].max()))
    out["customer_value_bands"] = bands
    return out


def _round_half_up(x: float, places: int) -> float:
    """round(x, places) as the port and the reference compute it (HALF_UP
    judged on the binary double)."""
    import math

    f = 10.0 ** places
    s = x * f
    t = math.trunc(s)
    r = t + math.copysign(1.0, s) if abs(s - t) >= 0.5 else t
    return r / f


def _near_boundary(x: float, grid: float) -> bool:
    """x within 1e-9 relative of a multiple of grid, or of a half-way
    point between two: there a device sum's last bits may round or ceil
    the other way."""
    k = x / grid
    return min(abs(k - round(k)), abs(k - round(k - 0.5) - 0.5)) \
        <= 1e-9 * max(abs(k), 1.0)


def check_slice10(name: str, got, want) -> None:
    """Counts, codes, buckets and hashes exact; sums within REL_TOL
    relative; round and ceil of the average exact unless the oracle's
    average lies within 1e-9 of a rounding boundary."""
    rows = got.to_pylist()
    if name == "q22_full":
        mine = [r["cntrycode"] for r in rows]
        if mine != [c for c, _, _ in want]:
            fail(f"q22_full: codes {mine} vs {[c for c, _, _ in want]}")
        for r, (c, n, s) in zip(rows, want):
            if r["numcust"] != n:
                fail(f"q22_full {c}: {r['numcust']} != {n}")
            _rel_close(f"q22_full {c} balance", r["totacctbal"], s)
    elif name == "orders_priority_split":
        if [r["o_year"] for r in rows] != sorted(want):
            fail(f"orders_priority_split: years {[r['o_year'] for r in rows]}")
        for r in rows:
            w = want[r["o_year"]]
            g = (r["high_line_count"], r["low_line_count"], r["n"])
            if g != w:
                fail(f"orders_priority_split {r['o_year']}: {g} != {w}")
    elif name == "orders_hash_sample":
        if [r["bucket"] for r in rows] != sorted(want):
            fail("orders_hash_sample: buckets differ")
        for r in rows:
            n, s, hx = want[r["bucket"]]
            if r["n"] != n or r["minhash_hex"] != hx:
                fail(f"orders_hash_sample {r['bucket']}: "
                     f"{(r['n'], r['minhash_hex'])} != {(n, hx)}")
            _rel_close(f"orders_hash_sample {r['bucket']} revenue",
                       r["revenue"], s)
    else:
        if [r["band"] for r in rows] != sorted(want):
            fail(f"customer_value_bands: bands {[r['band'] for r in rows]}")
        for r in rows:
            w = want[r["band"]]
            for k in ("customers", "without_orders", "industrial",
                      "even_keys"):
                if r[k] != w[k]:
                    fail(f"customer_value_bands {r['band']} {k}: "
                         f"{r[k]} != {w[k]}")
            _rel_close(f"customer_value_bands {r['band']} revenue",
                       r["revenue"], w["revenue"])
            _rel_close(f"customer_value_bands {r['band']} max_top",
                       r["max_top"], w["max_top"])
            avg = w["avg_rev"]
            if not _near_boundary(avg, 0.01) and \
                    r["avg_revenue"] != _round_half_up(avg, 2):
                fail(f"customer_value_bands {r['band']} avg_revenue "
                     f"{r['avg_revenue']} vs {avg}")
            if not _near_boundary(avg, 1.0) and \
                    r["avg_revenue_ceil"] != math.ceil(avg):
                fail(f"customer_value_bands {r['band']} avg_revenue_ceil "
                     f"{r['avg_revenue_ceil']} vs {avg}")


def run_slice10(dev, session, oracles, fused: bool) -> dict:
    """Phase 12: the four expression queries (q5.py) in
    `customer_session`'s session, over phase 11's cached CUSTOMER and
    ORDERS. Returns {query: record}, each with its peak device bytes, its
    largest device items and its K30, K6 and hex launches."""
    import torch

    from spark_rapids_tpu_torch.q5 import (
        customer_value_bands_query,
        orders_hash_sample_query,
        orders_priority_split_query,
        q22_full_query,
    )

    engine = "fused" if fused else "aqe"
    spark, tables, upload_s = session
    c, o = tables["customer"], tables["orders_cust"]
    builds = {
        "q22_full": lambda: q22_full_query(c, o),
        "orders_priority_split": lambda: orders_priority_split_query(o),
        "orders_hash_sample": lambda: orders_hash_sample_query(o),
        "customer_value_bands": lambda: customer_value_bands_query(c, o),
    }
    out = {}
    for name, build in builds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build().collect_arrow(),
                         lambda g: check_slice10(name, g, oracles[name]),
                         LATER_HOT_RUNS)
        ex = spark.last_execution
        want_engine = ("aqe" if fused and name in SLICE10_FUSED_FALLBACK
                       else engine)
        if ex["engine"] != want_engine:
            fail(f"{name} ran on {ex['engine']}, not {want_engine}: {ex}")
        fell = [e for e, _ in ex["fallbacks"]]
        if fell != (["fused"] if want_engine != engine else []):
            fail(f"{name}: unexpected fallbacks {ex['fallbacks']}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE10_PATH_KERNELS[name])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s, peak_device_bytes=int(
                       torch.cuda.max_memory_allocated(dev)),
                   slice10_launches={k: rec["launches"].get(k, 0) for k in
                                     ("xxhash64", "murmur3",
                                      "str_format_hex")})
        out[name] = rec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- slice 11

def _limbs_of(vals, dev):
    """Python ints -> [n, 2] int64 limbs (hi, lo) on the card."""
    import numpy as np
    import torch

    hi = np.array([(v >> 64) for v in vals], dtype=np.int64)
    lo = np.array([((v & ((1 << 64) - 1)) ^ (1 << 63)) - (1 << 63)
                   for v in vals], dtype=np.int64)
    return torch.from_numpy(np.stack([hi, lo], axis=1)).to(dev)


def check_slice11_kernels(dev):
    """Phase 2, slice 11: K31 (decimal128), K32 (seg_sum128) and the
    decimal modes of K22 and K24 at the decimal queries' shapes, each
    against its plain version: K31's multiply over q1's 59,986,052
    l_extendedprice and 1 - l_discount cents (two int64 in, decimal(32,4)
    limbs out), its subtract (the 1 - l_discount itself, decimal(1,0) and
    decimal(15,2) into decimal(16,2) limbs), its rescale (decimal(15,2)
    widened to decimal(38,6), q22's comparison), its compare, its average
    (15,000,000 decimal(25,2) sums over counts of 1 to 10,000 into
    decimal(19,6)), to double and to long; K32 over the 59,986,052
    products in 6 groups (sorted ids) and in 1,024 bins (the binned
    partial); K22's decimal mode over ORDERS' 15,000,000 price texts into
    decimal(15,2); K24's wide mode over 15,000,000 decimal(25,2) sums and
    its narrow mode over 15,000,000 decimal(15,2) prices. The plain
    versions run in 2^20-row pieces, those with the 128-step division in
    one or two. Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.expr import cast as C
    from spark_rapids_tpu_torch.ops import decimal128 as D
    from spark_rapids_tpu_torch.ops import stringcast as SC
    from spark_rapids_tpu_torch.q5 import SF10_LINEITEM
    from spark_rapids_tpu_torch.sqltypes import DecimalType

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    ref = "spark_rapids_tpu/ops/decimal128.py:"
    rng = np.random.default_rng(111)
    n, m = SF10_LINEITEM, SF10_ORDERS
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def record(name, source, replaces, counter, kernel, plain, library,
               plain_iters, nbytes, shape, as_bits=False):
        """Check kernel() against plain() exactly, time both and keep the
        record (its device time held to its byte bound: every input here
        exceeds the L2); returns the kernel's output."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if as_bits:
            got, want = got.view(torch.int64), want.view(torch.int64)
        err = _exact_all(name, got, want)
        bound = bound_ms(nbytes)
        out[name] = dict(
            route="cuda", source=src + source, replaces=replaces,
            max_abs_err=err, counter=counter,
            **timed(name, kernel, plain, library, plain_iters, bound),
            bound_ms=bound, bound_by="bytes", shape=shape)
        return got

    qty = rng.integers(1, 51, n)
    key = rng.integers(1, 2_000_001, n)
    price = t(qty * (90_000 + (key // 10) % 20_001 + 100 * (key % 1_000)))
    disc = t(rng.integers(0, 11, n))
    one_minus = 100 - disc
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    del qty, key
    # two int64 and a validity in; [n, 2] limbs and a validity out
    products = record(
        "decimal128_mul", "decimal128.cu", ref + "74", "decimal128",
        lambda: D.multiply(price, one_minus, valid, 32),
        lambda: _chunked(lambda lo, hi: D.multiply_plain(
            price[lo:hi], one_minus[lo:hi], valid[lo:hi], 32), n),
        None, PLAIN_ITERS, n * (8 + 8 + 1 + 16 + 1),
        f"{n} int64 pairs -> decimal(32,4) limbs")[0]
    record("decimal128_sub", "decimal128.cu", ref + "54", "decimal128",
           lambda: D.add(ones, 2, disc, 0, valid, 16, subtract=True),
           lambda: _chunked(lambda lo, hi: D.add_plain(
               ones[lo:hi], 2, disc[lo:hi], 0, valid[lo:hi], 16, True), n),
           None, PLAIN_ITERS, n * (8 + 8 + 1 + 16 + 1),
           f"{n} rows: 1 - decimal(15,2) -> decimal(16,2) limbs")
    del disc, ones, one_minus, price
    bal = t(rng.integers(-99_999, 1_000_000, m))
    wide_bal = record(
        "decimal128_rescale", "decimal128.cu", ref + "161", "decimal128",
        lambda: D.rescale_data(bal, 4, None),
        lambda: _chunked(lambda lo, hi: D.rescale_plain(
            bal[lo:hi], 4, None, 0, True), m),
        None, PLAIN_ITERS, m * (8 + 16 + 1),
        f"{m} decimal(15,2) -> decimal(38,6) limbs")[0]
    avg = D.rescale_data(t(rng.integers(-10 ** 14, 10 ** 14, m)), 0,
                         None)[0]
    record("decimal128_cmp", "decimal128.cu", ref + "238", "decimal128",
           lambda: D.compare(wide_bal, avg),
           lambda: _chunked(lambda lo, hi: D.compare_plain(
               wide_bal[lo:hi], avg[lo:hi]), m),
           None, PLAIN_ITERS, m * (16 + 16 + 1),
           f"{m} pairs of decimal(38,6) limbs -> int8")
    del wide_bal, avg, bal
    sums = D.rescale_data(t(rng.integers(-10 ** 15, 10 ** 17, m)), 0,
                          None)[0]
    counts = t(rng.integers(1, 10_001, m))
    record("decimal128_avg", "decimal128.cu", ref + "146", "decimal128",
           lambda: D.average(sums, counts, 4, 19, True),
           lambda: D.average_plain(sums, counts, 4, 19, True),
           None, 1, m * (16 + 8 + 16 + 1),
           f"{m} decimal(25,2) sums / counts -> decimal(19,6)")
    del counts
    record("decimal128_f64", "decimal128.cu", ref + "207", "decimal128",
           lambda: D.to_double(sums, 2),
           lambda: _chunked(lambda lo, hi: D.to_double_plain(
               sums[lo:hi], 2), m),
           None, PLAIN_ITERS, m * (16 + 8),
           f"{m} decimal(25,2) limbs -> float64", as_bits=True)
    lo_limb = sums[:, 1].contiguous()
    record("decimal128_i64", "decimal128.cu",
           "spark_rapids_tpu/expr/cast.py:245", "decimal128",
           lambda: D.to_long(sums, 2), lambda: D.to_long_plain(sums, 2),
           lambda: torch.div(lo_limb, 100, rounding_mode="trunc"), 1,
           m * (16 + 8),
           f"{m} decimal(25,2) limbs -> int64 (values within int64)")
    del lo_limb
    # K32 over q1's products: sorted ids in 6 groups, and 1,024 bins
    for label, gid, nseg in (
            ("sorted", t(np.repeat(np.arange(6, dtype=np.int32),
                                   -(-n // 6))[:n]), 6),
            ("binned", t(rng.integers(0, 6, n).astype(np.int32) * 97 + 5),
             1024)):
        def k32(gid=gid, nseg=nseg):
            return D.seg_sum128(products, valid, gid, nseg)[0]

        def k32_plain(gid=gid, nseg=nseg):
            return D.join(*D.seg_sum128_plain(*D.split(products), valid,
                                              gid, nseg))

        # valid for every row; gid and the limbs for the valid rows; the
        # sums and counts written
        record("seg_sum128" if label == "sorted" else "seg_sum128_binned",
               "seg_sum128.cu", ref + "213", "seg_sum128", k32, k32_plain,
               None, 1, n * (1 + 4 + 16) + nseg * 24,
               f"{n} decimal(32,4) products into {nseg} segments "
               f"({label} ids)")
        del gid
    del products, valid
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # K22's decimal mode over ORDERS' price text, K24's decimal modes
    pdata, plens = _price_text(dev, m, 112)
    pcol = _strcol(pdata, plens, torch.ones(m, dtype=torch.bool,
                                            device=dev))
    dec152 = DecimalType(15, 2)

    def parse():
        r = SC.parse_decimal(pcol, dec152)
        return r.data, r.validity

    def parse_plain():
        def piece(lo, hi):
            r = SC.parse_decimal_plain(pcol.slice_rows(lo, hi), dec152)
            return r.data, r.validity
        return _chunked(piece, m)

    # each row's bytes (width 16), length and validity read; an int64 and
    # a validity written
    prices = record("str_parse_decimal", "str_parse.cu",
                    "spark_rapids_tpu/ops/stringcast.py:204",
                    "str_parse_decimal", parse, parse_plain, None, 1,
                    m * (16 + 4 + 1 + 8 + 1),
                    f"{m} price texts [n, 16] -> decimal(15,2)")[0]
    del pdata, plens, pcol
    pv = torch.ones(m, dtype=torch.bool, device=dev)

    def fmt(col):
        r = C._decimal_to_string(col)
        return r.data, r.lengths

    # an int64 in; 48 bytes and an int32 length out
    record("str_format_decimal", "str_format.cu",
           "spark_rapids_tpu/expr/cast.py:407", "str_format_decimal",
           lambda: fmt(DeviceColumn(dec152, prices, pv)),
           lambda: _chunked(lambda lo, hi: C._decimal_to_string_plain(
               prices[lo:hi], 2), m),
           None, 1, m * (8 + 48 + 4), f"{m} decimal(15,2) -> [n, 48] text")
    # [n, 2] limbs in; 48 bytes and an int32 length out
    record("str_format_decimal128", "str_format.cu", ref + "257",
           "str_format_decimal",
           lambda: fmt(DeviceColumn(DecimalType(25, 2), sums, pv)),
           lambda: _chunked(lambda lo, hi: D.decimal_string(
               *D.split(sums[lo:hi]), 2), m, 1 << 23),
           None, 1, m * (16 + 48 + 4),
           f"{m} decimal(25,2) limbs -> [n, 48] text")
    del sums, prices, pv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _months_between_oracle(end_us, start_us, round_off: bool):
    """Spark's months_between over UTC microseconds in numpy float64, every
    division a true IEEE division (the calendar from numpy's datetime64)."""
    import numpy as np

    def fields(us):
        days = us // US_PER_DAY
        tod = (us - days * US_PER_DAY).astype(np.float64) / 1e6
        d64 = days.astype("M8[D]")
        month = d64.astype("M8[M]")
        y = month.astype("M8[Y]").astype(np.int64) + 1970
        m = (month.astype(np.int64) % 12) + 1
        d = (d64 - month).astype(np.int64) + 1
        mlen = ((month + 1).astype("M8[D]") - month.astype("M8[D]")
                ).astype(np.int64)
        return y, m, d, tod, d == mlen

    y1, m1, d1, t1, last1 = fields(end_us)
    y2, m2, d2, t2, last2 = fields(start_us)
    months = ((y1 - y2) * 12 + (m1 - m2)).astype(np.float64)
    integral = (d1 == d2) | (last1 & last2)
    sec1 = d1.astype(np.float64) * 86400.0 + t1
    sec2 = d2.astype(np.float64) * 86400.0 + t2
    out = np.where(integral, months, months + (sec1 - sec2) / 2678400.0)
    if round_off:
        out = np.round(out * 1e8) / 1e8
    return out


def check_months_between(dev) -> int:
    """MonthsBetween on the card, over dates and timestamps (UTC), with and
    without roundOff, bit for bit against the numpy float64 oracle (true
    division): 1,000,000 random pairs over 1900-2100 and the month ends,
    same days and the days around them. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.expr.core import BoundReference, EvalContext
    from spark_rapids_tpu_torch.expr.datetimes import MonthsBetween
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import date, timestamp

    rng = np.random.default_rng(114)
    n = 1_000_000
    lo_day, hi_day = -25567, 47482  # 1900-01-01 .. 2099-12-31
    cases = 0
    for dt in (date, timestamp):
        d1 = rng.integers(lo_day, hi_day, n)
        d2 = rng.integers(lo_day, hi_day, n)
        # month ends, same days of month, neighbours
        ends = (np.arange(lo_day, hi_day).astype("M8[D]").astype("M8[M]")
                + 1).astype("M8[D]").astype(np.int64) - 1
        k = n // 4
        d1[:k] = rng.choice(ends, k)
        d2[:k] = rng.choice(ends, k) + rng.integers(-1, 2, k)
        d2[k:2 * k] = d1[k:2 * k] + 31 * rng.integers(-400, 400, k)
        if dt is date:
            e_us, s_us = d1 * US_PER_DAY, d2 * US_PER_DAY
            data = (torch.from_numpy(d1.astype(np.int32)).to(dev),
                    torch.from_numpy(d2.astype(np.int32)).to(dev))
        else:
            e_us = d1 * US_PER_DAY + rng.integers(0, US_PER_DAY, n)
            s_us = d2 * US_PER_DAY + rng.integers(0, US_PER_DAY, n)
            data = (torch.from_numpy(e_us).to(dev),
                    torch.from_numpy(s_us).to(dev))
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        schema = StructType([StructField("e", dt, True),
                             StructField("s", dt, True)])
        batch = ColumnBatch(schema, [_col(dt, data[0], valid),
                                     _col(dt, data[1], valid)], n)
        for round_off in (True, False):
            expr = MonthsBetween(BoundReference(0, dt), BoundReference(1, dt),
                                 round_off)
            got = expr.eval(EvalContext(batch)).data.cpu().numpy()
            want = _months_between_oracle(e_us, s_us, round_off)
            bad = np.flatnonzero(got.view(np.int64) != want.view(np.int64))
            if len(bad):
                i = bad[0]
                fail(f"months_between({dt}, roundOff={round_off}) differs "
                     f"from the IEEE oracle on {len(bad)} of {n} rows, e.g. "
                     f"{got[i]!r} for {want[i]!r}")
            cases += 1
    torch.cuda.synchronize()
    return cases


def check_slice11_edges(dev) -> int:
    """Phase 2, slice 11 edge shapes against the plain versions: K31 in
    every mode over values near +-10^38, +-2^63, +-2^64 and the 128-bit
    ends, 0, HALF_UP ties of both signs, narrow and wide operands, shifts
    -38 to 38, precisions 1 to 38, counts of 1 and 3 and up to 2^40 (past
    the two-step 32-bit division), nulls; K32 over sums that cross 2^64
    and wrap mod 2^128, nulls, ids outside the segments, empty segments,
    sorted and random ids, segments in and past shared memory, n = 1 to
    70,001; K22's decimal mode over hand-picked texts (signs, exponents,
    ties, 19+ digits, junk) at scales 0, 2 and 18; K24's decimal modes at
    -0.05, 0, the int64 and 10^38 ends, scales 0 to 18; K9's pack and sort
    of decimal(38, s) keys with nulls in both directions; and
    MonthsBetween against its IEEE oracle. Returns the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.expr import cast as C
    from spark_rapids_tpu_torch.ops import common as CM
    from spark_rapids_tpu_torch.ops import decimal128 as D
    from spark_rapids_tpu_torch.ops import stringcast as SC
    from spark_rapids_tpu_torch.sqltypes import DecimalType

    rng = np.random.default_rng(113)
    cases = 0
    edge = [0, 1, -1, 5, -5, 15, -15, 25, -25, 2 ** 63 - 1, -2 ** 63,
            2 ** 63, -2 ** 63 - 1, 2 ** 64 - 1, 2 ** 64, -2 ** 64,
            10 ** 18 - 1, 10 ** 18, -10 ** 18, 10 ** 38 - 1, -10 ** 38 + 1,
            10 ** 38, -10 ** 38, 2 ** 127 - 1, -2 ** 127, 5 * 10 ** 37,
            -5 * 10 ** 37, 123456789012345678901234567890,
            -500000000000000000005]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def wide_vals(n):
        vals = [int(x) for x in rng.integers(-2 ** 62, 2 ** 62, n)]
        big = rng.random(n) < 0.5
        for i in np.flatnonzero(big):
            vals[i] = vals[i] * int(rng.integers(1, 2 ** 62)) \
                * int(rng.integers(1, 2 ** 10))
        vals = [((v + 2 ** 127) % 2 ** 128) - 2 ** 127 for v in vals]
        vals[:min(n, len(edge))] = [((v + 2 ** 127) % 2 ** 128) - 2 ** 127
                                    for v in edge[:n]]
        return _limbs_of(vals, dev)

    def same(name, got, want):
        _exact_all(name, got, want)

    for n in (1, 37, 70001):
        a, b = wide_vals(n), wide_vals(n)
        na = t(rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64))
        nb = t(rng.integers(-10 ** 18, 10 ** 18, n))
        vm = t(rng.random(n) < 0.9)
        for x, y in ((a, b), (na, b), (a, nb), (na, nb)):
            for sa, sb in ((0, 0), (2, 0), (19, 5)):
                for p in (1, 38):
                    for sub in (False, True):
                        same(f"d128 add n={n}",
                             D.add(x, sa, y, sb, vm, p, sub),
                             D.add_plain(x, sa, y, sb, vm, p, sub))
                        cases += 1
        same(f"d128 mul n={n}", D.multiply(na, nb, vm, 38),
             D.multiply_plain(na, nb, vm, 38))
        same(f"d128 mul p=19 n={n}", D.multiply(na, na, None, 19),
             D.multiply_plain(na, na, None, 19))
        cases += 2
        for x in (a, na):
            for delta in (-38, -20, -19, -18, -17, -1, 0, 4, 19, 38):
                for p, wide in ((0, True), (19, True), (18, False)):
                    same(f"d128 rescale {delta} p={p} n={n}",
                         D.rescale_data(x, delta, vm, p, wide),
                         D.rescale_plain(x, delta, vm, p, wide))
                    cases += 1
        for cnt in (t(np.ones(n, np.int64)), t(np.full(n, 3, np.int64)),
                    t(rng.integers(-2, 2 ** 40, n))):
            for up in (0, 4, 20):
                for p, wide in ((19, True), (18, False)):
                    same(f"d128 avg up={up} n={n}",
                         D.average(a, cnt, up, p, wide),
                         D.average_plain(a, cnt, up, p, wide))
                    cases += 1
        same(f"d128 neg n={n}", D.negate(a), D.negate_plain(a))
        same(f"d128 abs n={n}", D.absolute(a), D.absolute_plain(a))
        same(f"d128 cmp n={n}", D.compare(a, b), D.compare_plain(a, b))
        same(f"d128 cmp self n={n}", D.compare(a, a), D.compare_plain(a, a))
        cases += 4
        for sc in (0, 1, 2, 6, 18, 19, 22, 36, 38):
            g, w = D.to_double(a, sc), D.to_double_plain(a, sc)
            same(f"d128 f64 s={sc} n={n}", g.view(torch.int64),
                 w.view(torch.int64))
            cases += 1
            if sc <= D.MAX_TO_LONG_SCALE:
                same(f"d128 i64 s={sc} n={n}", D.to_long(a, sc),
                     D.to_long_plain(a, sc))
                cases += 1
        # K32: wrapping sums, nulls, ids outside the segments
        for nseg in (1, 7, 1024, 9000):
            for sorted_ids in (True, False):
                gid = rng.integers(-1, nseg + 1, n).astype(np.int32)
                if sorted_ids:
                    gid.sort()
                tg = t(gid)
                for data in (a, na):
                    g = D.seg_sum128(data, vm, tg, nseg)
                    hi, lo = D.widen(data)
                    w = (D.join(*D.seg_sum128_plain(hi, lo, vm, tg, nseg)),
                         port_count(vm, tg, nseg))
                    same(f"seg_sum128 nseg={nseg} n={n}", g, w)
                    cases += 1
        # K24's decimal modes
        for sc in (0, 1, 2, 9, 18):
            wcol = DeviceColumn(DecimalType(38, sc), a, vm)
            r = C._decimal_to_string(wcol)
            same(f"d128 text s={sc} n={n}", (r.data, r.lengths),
                 D.decimal_string(*D.split(a), sc))
            cases += 1
        nvals = nb.clone()
        nvals[:min(n, 4)] = torch.tensor([-5, 0, 5, -105][:min(n, 4)],
                                         device=dev)
        for sc in (1, 2, 9, 18):
            r = C._decimal_to_string(DeviceColumn(DecimalType(18, sc), nvals,
                                                  vm))
            same(f"decimal text s={sc} n={n}", (r.data, r.lengths),
                 C._decimal_to_string_plain(nvals, sc))
            cases += 1
        # K9 over decimal(38, s) keys
        live = t(rng.random(n) < 0.95)
        for asc in (True, False):
            spec = [CM.KeySpec(DeviceColumn(DecimalType(38, 2), a, vm), asc,
                               not asc)]
            g, _ = CM.pack_keys(spec, live)
            w, _ = CM.pack_keys_plain(spec, live)
            same(f"pack d128 asc={asc} n={n}", g, w)
            same(f"sort d128 asc={asc} n={n}", CM.sort_words(g),
                 CM.sort_permutation_plain(list(w.unbind(0)), n))
            cases += 2
    # K22's decimal mode
    texts = ["0", "1", "-1", "+1.5", "-1.5", "2.5", "-2.5", "0.005",
             "-0.005", "0.0049", "1e3", "1E-2", "-1.25e1", " 12.345 ",
             "12.344999", "99999999999999999999", "123456789012345678.9",
             "1234567890123456789012", "9.9999999999999999999", ".5", "5.",
             "1.2.3", "abc", "", " ", "--1", "1e", "1e+", "1e400", "1e-400",
             "0.000000000000000000000001", "-0", "00012.50", "7E18",
             "9223372036854775807", "-9223372036854775808"]
    import pyarrow as pa
    for width in (8, 32):
        sel = [x for x in texts if len(x) <= width]
        reps = sel * 50
        data, lens = _text_rows(dev, pa.array(reps), width)
        valid = t(np.arange(len(reps)) % 7 != 3)
        col = _strcol(data, lens, valid)
        for sc, p in ((0, 18), (2, 15), (2, 4), (18, 18), (6, 18)):
            dt = DecimalType(p, sc)
            g = SC.parse_decimal(col, dt)
            w = SC.parse_decimal_plain(col, dt)
            same(f"parse decimal({p},{sc}) width={width}",
                 (g.data, g.validity), (w.data, w.validity))
            cases += 1
    torch.cuda.synchronize()
    return cases + check_months_between(dev)


def port_count(valid, gid, nseg):
    """The plain count of K32: the valid rows with 0 <= gid < nseg."""
    from spark_rapids_tpu_torch.ops import segmented

    return segmented.seg_sum_count_plain([], valid, gid, nseg).count


#: the kernels each slice-11 query must launch on either engine: K31 and
#: K32 on every query, K22's and K24's decimal modes on the ingest, and
#: its descending sort by the wide revenue (K9)
SLICE11_PATH_KERNELS = {
    "lineitem_q1": ("decimal128", "seg_sum128"),
    "orders_tbl_decimal": ("str_parse_decimal", "str_format_decimal",
                           "decimal128", "seg_sum128", "pack_keys",
                           "sort_words"),
    "q22_decimal": ("decimal128", "seg_sum128", "gather_leaves"),
}
#: q22's crossJoin is a nested-loop join: the fused engine hands it to the
#: adaptive one, as the reference's does
SLICE11_FUSED_FALLBACK = ("q22_decimal",)
#: the columns of phase 13's tables its queries read (q1 without
#: sum_charge reads no l_tax), the only ones cached on the card
SLICE11_COLUMNS = {
    "lineitem": ("l_quantity", "l_extendedprice", "l_discount",
                 "l_returnflag", "l_linestatus", "l_shipdate"),
    "orders_tbl": ("o_totalprice", "o_orderdate"),
}
SLICE11_COUNTERS = ("decimal128", "seg_sum128", "str_parse_decimal",
                    "str_format_decimal")


def _half_up(num: int, den: int) -> int:
    """num / den rounded HALF_UP (away from zero on ties), exact."""
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def _dec_text(v: int, scale: int) -> str:
    sign = "-" if v < 0 else ""
    whole, frac = divmod(abs(v), 10 ** scale)
    return f"{sign}{whole}.{frac:0{scale}d}" if scale else f"{sign}{whole}"


def slice11_oracles(lines=None) -> dict:
    """The three decimal queries' answers in exact Python integers (each
    decimal as its unscaled value), from the writers' seeded draws
    (`lines`: LINEITEM's, when the caller has them): no float anywhere."""
    import numpy as np

    from spark_rapids_tpu_torch.q5 import (
        Q1_SHIP_CUTOFF,
        Q22_CODES,
        SF10_LINEITEM,
        customer_draws,
        lineitem_draws,
        orders_dated_draws,
    )

    cutoff = int(np.datetime64(Q1_SHIP_CUTOFF, "D").astype(np.int64))
    acc = {}
    for d in lines or lineitem_draws(SF10_LINEITEM, FILES, seed=0):
        keep = d["shipdate"] <= cutoff
        g = d["flag"] * 2 + d["status"]
        disc_price = d["price_c"] * (100 - d["disc_c"])
        for k in np.unique(g[keep]):
            m = keep & (g == k)
            a = acc.setdefault(int(k), [0] * 5)
            for j, col in enumerate((d["qty_c"], d["price_c"], disc_price,
                                     d["disc_c"])):
                a[j] += int(col[m].sum())
            a[4] += int(m.sum())
    q1 = []
    for k in sorted(acc):
        qty, price, dprice, disc, n = acc[k]
        q1.append(dict(l_returnflag="ANR"[k // 2], l_linestatus="FO"[k % 2],
                       sum_qty=qty, sum_base_price=price,
                       sum_disc_price=dprice,
                       avg_qty=_half_up(qty * 10 ** 4, n),
                       avg_price=_half_up(price * 10 ** 4, n),
                       avg_disc=_half_up(disc * 10 ** 4, n),
                       count_order=n))
    years = {}
    o_custkeys = []
    for d in orders_dated_draws(ORDERS_ROWS, FILES, seed=0):
        o_custkeys.append(d["o_custkey"])
        cents = d["cents"]
        keep = cents > 10_000_000
        yr = (d["o_orderdate"].astype("M8[D]").astype("M8[Y]")
              .astype(np.int64) + 1970)
        for y in np.unique(yr[keep]):
            c = cents[keep & (yr == y)]
            a = years.setdefault(int(y), [0, 0, None, None])
            a[0] += int(c.sum())
            a[1] += len(c)
            a[2] = int(c.min()) if a[2] is None else min(a[2], int(c.min()))
            a[3] = int(c.max()) if a[3] is None else max(a[3], int(c.max()))
    tbl = [dict(o_year=y, revenue=s, avg_price=_half_up(s * 10 ** 4, n),
                min_price=lo, max_price=hi, n=n,
                revenue_text=_dec_text(s, 2), min_text=_dec_text(lo, 2),
                max_text=_dec_text(hi, 2))
           for y, (s, n, lo, hi) in years.items()]
    tbl.sort(key=lambda r: -r["revenue"])
    c = customer_draws(SF10_CUSTOMERS, seed=0)
    code = c["nation"] + 10
    cand = np.isin(code, [int(x) for x in Q22_CODES])
    cents = c["cents"]
    pos = cand & (cents > 0)
    avg6 = _half_up(int(cents[pos].sum()) * 10 ** 4, int(pos.sum()))
    ordered = np.zeros(SF10_CUSTOMERS + 1, dtype=bool)
    ordered[np.concatenate(o_custkeys)] = True
    keep = cand & (cents * 10_000 > avg6) & ~ordered[1:]
    q22 = [dict(cntrycode=str(k), numcust=int((keep & (code == k)).sum()),
                totacctbal=int(cents[keep & (code == k)].sum()))
           for k in sorted(np.unique(code[keep]))]
    return {"lineitem_q1": q1, "orders_tbl_decimal": tbl,
            "q22_decimal": q22}


def check_slice11(name: str, got, want) -> None:
    """The query's rows, in order, equal to the oracle's exactly: every
    decimal as its unscaled integer, texts and counts as they are."""
    import decimal

    rows = got.to_pylist()
    ctx = decimal.Context(prec=50)
    if len(rows) != len(want):
        fail(f"{name}: {len(rows)} rows, the oracle {len(want)}")
    types = {f.name: f.type for f in got.schema}
    for r, w in zip(rows, want):
        for k, v in w.items():
            g = r[k]
            if isinstance(g, decimal.Decimal):
                g = int(g.scaleb(types[k].scale, ctx))
            if g != v:
                fail(f"{name}: {k} = {r[k]!r}, the oracle {v!r} (row {r})")


def run_slice11(dev, session, oracles, fused: bool) -> dict:
    """Phase 13: the three decimal queries (q5.py) in `customer_session`'s
    session, over LINEITEM, customer_dec, phase 9's ORDERS text and phase
    11's ORDERS, cached on the card. Returns {query: record}, each with
    its peak device bytes, its largest device items and the launches of
    K31, K32 and the decimal modes of K22 and K24."""
    import torch

    from spark_rapids_tpu_torch.q5 import (
        lineitem_q1_query,
        orders_tbl_decimal_query,
        q22_decimal_query,
    )

    engine = "fused" if fused else "aqe"
    spark, tables, upload_s = session
    builds = {
        "lineitem_q1": lambda: lineitem_q1_query(tables["lineitem"]),
        "orders_tbl_decimal": lambda: orders_tbl_decimal_query(
            tables["orders_tbl"]),
        "q22_decimal": lambda: q22_decimal_query(tables["customer_dec"],
                                                 tables["orders_cust"]),
    }
    out = {}
    for name, build in builds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build().collect_arrow(),
                         lambda g: check_slice11(name, g, oracles[name]),
                         SLICE11_HOT_RUNS)
        ex = spark.last_execution
        want_engine = ("aqe" if fused and name in SLICE11_FUSED_FALLBACK
                       else engine)
        if ex["engine"] != want_engine:
            fail(f"{name} ran on {ex['engine']}, not {want_engine}: {ex}")
        fell = [e for e, _ in ex["fallbacks"]]
        if fell != (["fused"] if want_engine != engine else []):
            fail(f"{name}: unexpected fallbacks {ex['fallbacks']}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE11_PATH_KERNELS[name])
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s, peak_device_bytes=int(
                       torch.cuda.max_memory_allocated(dev)),
                   slice11_launches={k: rec["launches"].get(k, 0)
                                     for k in SLICE11_COUNTERS})
        out[name] = rec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- slice 12

#: hot runs of each phase-14 query (its 15M-row window and 1M-customer
#: lists download the most of any phase)
SLICE12_HOT_RUNS = 1
#: slice 12's kernel counters, printed with each phase-14 query
SLICE12_COUNTERS = ("frame_collect", "array_compact", "array_distinct",
                    "array_sort", "expand_gather_maps", "collect_scatter")
#: the kernels each phase-14 query must launch on either engine
SLICE12_PATH_KERNELS = {
    "nested_explode": ("expand_gather_maps", "gather_leaves",
                       "seg_sum_count"),
    "nested_item_stats": ("array_compact", "array_distinct", "array_sort",
                          "gather_leaves", "seg_sum_count"),
    "customer_order_lists": ("collect_rank", "collect_scatter",
                             "array_sort", "sort_words"),
    "recent_orders_window": ("frame_collect", "pack_keys", "sort_words"),
}
#: phase-14 queries the fused engine hands to the adaptive one (collect
#: results, as the reference's fused engine does)
SLICE12_FUSED_FALLBACK = ("customer_order_lists",)


def _bits(x):
    """A float tensor as its integer bits (NaN compared by payload)."""
    import torch

    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _exact_bits(name: str, got, want) -> None:
    """exact() over a tuple of outputs, floats bit for bit."""
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        exact(f"{name} output {k}", _bits(g), _bits(w))


def _nested_window(dev, custkey, date, orderkey, cap: int, live: int):
    """The window's sorted view of the recent-orders frame: partitions by
    customer, ordered by (date, key), over cap rows of which `live` live
    (K9, K10, K12 build it, as TpuWindowExec does)."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import windowops as W
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import date as date_t
    from spark_rapids_tpu_torch.sqltypes.datatypes import long as long_t

    cols = [_col(long_t, custkey, torch.ones(cap, dtype=torch.bool,
                                             device=dev)),
            _col(date_t, date, torch.ones(cap, dtype=torch.bool,
                                          device=dev)),
            _col(long_t, orderkey, torch.ones(cap, dtype=torch.bool,
                                              device=dev))]
    batch = ColumnBatch(StructType([StructField(n, c.dtype) for n, c in
                                    zip(("c", "d", "k"), cols)]), cols, live)
    return W.sort_for_window(batch, [cols[0]],
                             [(cols[1], True, True), (cols[2], True, True)])


def check_slice12_kernels(dev):
    """Phase 2, slice 12: K33 (frame_collect), K34 (array_compact and
    array_distinct) and K35 (array_sort) at the nested queries' shapes,
    each against its plain version: K33 over 15,000,000 orders in about
    1,000,000 customers sorted by (date, key), collect_list of float64
    prices over ROWS 2 PRECEDING (W = 3) and collect_set of int32 years
    over 5 PRECEDING (W = 6); K34 over the [15M, 8] int32 quantities of
    1-7 lines (filter x > 25 and array_distinct); K35 over them
    descending. The plain versions run in 2^20-row pieces (K33's in one,
    its frames crossing pieces). Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.expr import collections as CX
    from spark_rapids_tpu_torch.ops import windowops as W

    src = "spark_rapids_tpu_torch/kernels/csrc/"
    rng = np.random.default_rng(121)
    n = SF10_ORDERS
    cap = 1 << (n - 1).bit_length()
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def record(name, source, replaces, counter, kernel, plain, library,
               plain_iters, nbytes, shape):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        _exact_bits(name, got, want)
        bound = bound_ms(nbytes)
        out[name] = dict(
            route="cuda", source=src + source, replaces=replaces,
            max_abs_err=0.0, counter=counter,
            **timed(name, kernel, plain, library, plain_iters, bound),
            bound_ms=bound, bound_by="bytes", shape=shape)

    custkey = np.zeros(cap, dtype=np.int64)
    custkey[:n] = rng.integers(1, 1_000_001, n)
    date = np.zeros(cap, dtype=np.int32)
    date[:n] = rng.integers(8035, 10_591, n)
    orderkey = np.arange(cap, dtype=np.int64) * 4 + 1
    sw = _nested_window(dev, t(custkey), t(date), t(orderkey), cap, n)
    price = t(rng.integers(85_000, 55_000_000, cap) / 100.0)
    year = t(1992 + (date - 8035) // 366)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n] = True
    del custkey, date, orderkey
    for name, vals, lo, distinct in (("frame_collect_list", price, -2, False),
                                     ("frame_collect_set", year, -5, True)):
        w = 1 - lo
        esize = vals.element_size()
        # values and validity once, perm, live and the partition bounds
        # once; out [n, W] values and flags and the lengths
        record(name, "frame_collect.cu",
               "spark_rapids_tpu/ops/windowops.py:355", "frame_collect",
               lambda v=vals, lo=lo, d=distinct: W.frame_collect(
                   v, valid, sw, lo, 0, d),
               lambda v=vals, lo=lo, d=distinct: W.frame_collect_plain(
                   v, valid, sw, lo, 0, d),
               None, 1, cap * (esize + 1 + 4 + 1 + 4 + 4)
               + cap * (w * (esize + 1) + 4),
               f"{n} live of {cap} rows, W = {w}, "
               f"{'distinct int32' if distinct else 'float64'}")
    del sw, price, year, valid
    lens = rng.integers(1, 8, cap).astype(np.int32)
    in_row = np.arange(8)[None, :] < lens[:, None]
    qty = t(np.where(in_row, rng.integers(1, 51, (cap, 8)), 0)
            .astype(np.int32))
    ev = t(in_row)
    lengths = t(lens)
    keep = (qty > 25) & ev
    del lens, in_row
    rows_b = cap * 8 * (4 + 1)  # a [cap, 8] int32 matrix and its flags

    def sort_rows_library():
        s = torch.sort(qty, dim=1, descending=True, stable=True)
        return s.values, torch.gather(ev, 1, s.indices)

    record("array_compact", "array_rows.cu",
           "spark_rapids_tpu/expr/collections.py:625", "array_compact",
           lambda: CX.array_compact(qty, ev, keep),
           lambda: _chunked(lambda lo, hi: CX.array_compact_plain(
               qty[lo:hi], ev[lo:hi], keep[lo:hi])[:3], cap),
           lambda: torch.gather(qty, 1, torch.sort(
               (~keep).to(torch.int8), dim=1, stable=True).indices),
           3, rows_b + cap * 8 + rows_b + cap * 4,
           f"[{cap}, 8] int32 of 1-7 elements, keep x > 25")
    record("array_distinct", "array_rows.cu",
           "spark_rapids_tpu/expr/collections.py:944", "array_distinct",
           lambda: CX.array_distinct(qty, ev, lengths),
           lambda: _chunked(lambda lo, hi: CX.array_distinct_plain(
               qty[lo:hi], ev[lo:hi], lengths[lo:hi]), cap),
           None, 3, rows_b + cap * 4 + rows_b + cap * 4,
           f"[{cap}, 8] int32 of 1-7 elements")
    record("array_sort", "array_rows.cu",
           "spark_rapids_tpu/expr/collections.py:391", "array_sort",
           lambda: CX.array_sort(qty, ev, lengths, False),
           lambda: _chunked(lambda lo, hi: CX.array_sort_plain(
               qty[lo:hi], ev[lo:hi], lengths[lo:hi], False), cap),
           # values 1-50 and dead slots 0: a stable descending row sort
           # puts the dead last, as sort_array(desc) does
           sort_rows_library, 3, rows_b + cap * 4 + rows_b,
           f"[{cap}, 8] int32 of 1-7 elements, descending")
    _exact_bits("array_sort library", sort_rows_library(),
                CX.array_sort(qty, ev, lengths, False))
    return out


def check_slice12_edges(dev) -> int:
    """Phase 2, slice 12 edge shapes against the plain versions: K33 at
    W = 1, 3, 6 and 1,024 (frames past the partition and past the batch)
    over every element type with nulls, NaN, +-inf, -0.0, INT_MIN, dead
    rows, one-row and all-null partitions, as lists and as sets; K34's
    compact and distinct and K35 in both directions over empty arrays,
    all-null rows, NaN, +-inf, -0.0, INT_MIN and INT_MAX, lengths past the
    width, max_elems 1 to 64 of every element type, and K34's compact of
    array<string> cubes of empty strings and of 12-byte strings. Returns
    the number of cases."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.expr import collections as CX
    from spark_rapids_tpu_torch.ops import windowops as W

    rng = np.random.default_rng(122)
    cases = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def values(dtype, shape):
        if dtype in (np.float32, np.float64):
            pool = np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf,
                             7.0], dtype=dtype)
        elif dtype == np.bool_:
            pool = np.array([False, True])
        else:
            info = np.iinfo(dtype)
            pool = np.array([0, 1, -1, info.min, info.max, 3, 3, 9],
                            dtype=dtype)
        return pool[rng.integers(0, len(pool), shape)]

    kinds = (np.int8, np.int16, np.int32, np.int64, np.float32, np.float64)
    for n in (1, 37, 5_000):
        cap = 1 << max(n - 1, 1).bit_length()
        live = max(n - 3, 1)
        for parts in (1, 7, n):
            custkey = t(np.sort(rng.integers(0, parts, cap)))
            date = t(rng.integers(0, 40, cap).astype(np.int32))
            sw = _nested_window(dev, custkey, date,
                                t(np.arange(cap, dtype=np.int64)), cap,
                                live)
            for dtype in kinds:
                vals = t(values(dtype, cap))
                # W = 1,024 over one integer and one float type
                los = ((0, -2, -5, -1023) if dtype in (np.int32, np.float64)
                       else (0, -2, -5))
                for valid in (t(rng.random(cap) < 0.8),
                              torch.zeros(cap, dtype=torch.bool,
                                          device=dev)):
                    for lo in los:
                        for distinct in (False, True):
                            _exact_bits(
                                f"frame_collect n={n} W={1 - lo}",
                                W.frame_collect(vals, valid, sw, lo, 0,
                                                distinct),
                                W.frame_collect_plain(vals, valid, sw, lo,
                                                      0, distinct))
                            cases += 1
    for rows in (1, 33, 4_099):
        for me in (1, 2, 8, 64):
            for dtype in kinds + (np.bool_,):
                data = t(values(dtype, (rows, me)))
                for ev in (t(rng.random((rows, me)) < 0.7),
                           torch.zeros((rows, me), dtype=torch.bool,
                                       device=dev)):
                    lengths = t(rng.integers(0, me + 2, rows)
                                .astype(np.int32))
                    keep = ev | t(rng.random((rows, me)) < 0.3)
                    got = CX.array_compact(data, ev, keep)
                    want = CX.array_compact_plain(data, ev, keep)
                    _exact_bits(f"array_compact {rows}x{me}", got, want)
                    cases += 1
                    if dtype != np.bool_:
                        lens = lengths.clamp(max=me)
                        _exact_bits(f"array_distinct {rows}x{me}",
                                    CX.array_distinct(data, ev, lens),
                                    CX.array_distinct_plain(data, ev, lens))
                        cases += 1
                    for asc in (True, False):
                        lens = lengths.clamp(max=me)
                        _exact_bits(f"array_sort {rows}x{me} asc={asc}",
                                    CX.array_sort(data, ev, lens, asc),
                                    CX.array_sort_plain(data, ev, lens, asc))
                        cases += 1
    for width in (8, 12):
        rows, me = 1_000, 4
        lens = rng.integers(0, width + 1, (rows, me)).astype(np.int32)
        if width == 8:
            lens[:] = 0  # cubes of empty strings
        cube = t(np.where(np.arange(width)[None, None, :] < lens[:, :, None],
                          rng.integers(97, 123, (rows, me, width)), 0)
                 .astype(np.uint8))
        ev = t(rng.random((rows, me)) < 0.8)
        keep = ev & t(rng.random((rows, me)) < 0.6)
        _exact_bits(f"array_compact cube width={width}",
                    CX.array_compact(cube, ev, keep, t(lens)),
                    CX.array_compact_plain(cube, ev, keep, t(lens)))
        cases += 1
    return cases


def _days_year(days):
    """Each day's year (days since 1970-01-01), proleptic Gregorian."""
    import numpy as np

    return (np.asarray(days).astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970).astype(np.int32)


def slice12_oracles(draws) -> dict:
    """numpy oracles of the four nested queries from NESTED_ORDERS' draws
    (`nested_orders_draws`): the exploded sums and counts by (status,
    position); the per-priority sums and counts of the item statistics;
    each customer's sorted order keys and sorted distinct years; each
    order's frame of prices (oldest first) and its frame's distinct
    years, by order key."""
    import numpy as np

    from spark_rapids_tpu_torch.q5 import ORDER_PRIORITIES

    o, counts, lines, modes, _ = draws
    n = len(counts)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    starts = offsets[:-1]
    qty = (lines["qty_c"] // 100).astype(np.int64)
    price = lines["price_c"] / 100.0
    open_lines = np.add.reduceat(lines["status"], starts)
    status = np.where(open_lines == 0, 0, np.where(open_lines == counts,
                                                    1, 2))
    oid = np.repeat(np.arange(n), counts)
    pos = np.arange(len(qty)) - np.repeat(starts, counts)
    key = status[oid] * 8 + pos
    explode = {}
    q_sum = np.bincount(key, weights=qty, minlength=24)
    q_cnt = np.bincount(key, minlength=24)
    for k in np.flatnonzero(q_cnt):
        explode[("FOP"[k // 8], int(k % 8))] = (int(q_sum[k]),
                                                int(q_cnt[k]))
    n_distinct = _popcount(np.bitwise_or.reduceat(
        np.left_shift(np.uint64(1), qty.astype(np.uint64)), starts))
    per_order = dict(
        lines=counts.astype(np.int64),
        sum_max_price=np.maximum.reduceat(price, starts),
        air_orders=np.logical_or.reduceat(modes == 1, starts).astype(
            np.int64),
        sum_top_qty=np.maximum.reduceat(qty, starts),
        sum_distinct=n_distinct,
        big_lines=np.add.reduceat((qty > 25).astype(np.int64), starts),
        sum_first_price=price[starts],
        seven_line_orders=(counts >= 7).astype(np.int64))
    prio = o["priority"]
    stats = {}
    for p, name in enumerate(ORDER_PRIORITIES):
        sel = prio == p
        stats[name] = dict(orders=int(sel.sum()),
                           **{k: v[sel].sum() for k, v in per_order.items()})
    # each customer's order keys and distinct years, customers ascending
    cust, okey = o["o_custkey"], o["o_orderkey"]
    years = _days_year(o["o_orderdate"])
    # orders by (customer, key) and by (customer, date, key): one argsort
    # of the fields packed in an int64 (customers < 2^21, days since the
    # first order date < 2^12, order keys' ranks < 2^26)
    by_okey = np.argsort(okey, kind="stable")
    krank = np.empty(n, dtype=np.int64)
    krank[by_okey] = np.arange(n)
    day = (o["o_orderdate"].astype(np.int64)
           - int(o["o_orderdate"].min()))
    by_cust = np.argsort((cust.astype(np.int64) << 26) | krank)
    cs = cust[by_cust]
    first = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    ykey = np.unique(cust.astype(np.int64) * 4096 + years)
    lists = dict(custkey=cs[first],
                 n_orders=np.diff(np.r_[first, len(cs)]),
                 order_keys=okey[by_cust],
                 years=(ykey % 4096).astype(np.int32),
                 n_years=np.bincount(np.searchsorted(cs[first],
                                                     ykey // 4096),
                                     minlength=len(first)))
    # the frames: orders by (customer, date, key)
    order = np.argsort((cust.astype(np.int64) << 38) | (day << 26) | krank)
    cs = cust[order]
    seg = np.maximum.accumulate(np.where(
        np.r_[True, cs[1:] != cs[:-1]], np.arange(n), 0))
    j = np.arange(n)
    start3 = np.maximum(seg, j - 2)
    len3 = j - start3 + 1
    flat3 = np.repeat(start3, len3) + (np.arange(len3.sum())
                                       - np.repeat(np.cumsum(len3) - len3,
                                                   len3))
    ysorted = years[order]
    ymask = np.zeros(n, dtype=np.int64)
    for k in range(6):
        src = np.maximum(j - k, seg)
        ymask |= np.int64(1) << (ysorted[src] - 1990).astype(np.int64)
    # by order key: the rank of each sorted row's key
    inv_order = np.empty(n, dtype=np.int64)
    inv_order[order] = np.arange(n)
    by_key = inv_order[by_okey]
    len3k = len3[by_key]
    starts3k = (np.cumsum(len3) - len3)[by_key]
    flat3k = flat3[np.repeat(starts3k, len3k) + (
        np.arange(len3k.sum()) - np.repeat(np.cumsum(len3k) - len3k,
                                           len3k))]
    window = dict(orderkey=okey[order][by_key], len3=len3k,
                  prices=o["cents"][order][flat3k] / 100.0,
                  ymask=ymask[by_key])
    return dict(explode=explode, stats=stats, lists=lists, window=window)


def _list_parts(col):
    """(offsets int64 from 0, flat values numpy) of an Arrow list column."""
    import numpy as np

    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    offs = np.asarray(arr.offsets).astype(np.int64)
    vals = np.asarray(arr.values.to_numpy(zero_copy_only=False))
    return offs - offs[0], vals[offs[0]:offs[-1]]


def _take_lists(offs, vals, order):
    """The lists of rows `order` in that order: (offsets, flat values),
    one numpy gather of the values (no Arrow take)."""
    import numpy as np

    lens = np.diff(offs)[order]
    new = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=new[1:])
    idx = np.repeat(offs[:-1][order] - new[:-1], lens) + np.arange(new[-1])
    return new, vals[idx]


def _popcount(x):
    """Set bits of each int64 (SWAR)."""
    import numpy as np

    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = ((x & np.uint64(0x3333333333333333))
         + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def check_slice12(name: str, got, want) -> None:
    """The nested queries against their oracles: counts, sizes, maxima
    and orders exact, double sums within 1e-9 relative, each customer's
    order keys as a multiset (Spark leaves collect order open) and its
    years as a set, each order's price frame in frame order and its
    years as a set."""
    import numpy as np

    if name == "nested_explode":
        rows = {(r["o_orderstatus"], r["pos"]): (r["qty"], r["lines"])
                for r in got.to_pylist()}
        if rows != want["explode"]:
            fail(f"{name}: {rows} != {want['explode']}")
        return
    if name == "nested_item_stats":
        rows = {r["priority"]: r for r in got.to_pylist()}
        if set(rows) != set(want["stats"]):
            fail(f"{name}: priorities {sorted(rows)}")
        for p, w in want["stats"].items():
            for k, v in w.items():
                g = rows[p][k]
                if isinstance(v, (float, np.floating)):
                    if not math.isclose(g, float(v), rel_tol=REL_TOL):
                        fail(f"{name} {p} {k}: {g} != {v}")
                elif g != int(v):
                    fail(f"{name} {p} {k}: {g} != {v}")
        return
    if name == "customer_order_lists":
        w = want["lists"]
        cust = got.column("o_custkey").to_numpy()
        order = np.argsort(cust, kind="stable")
        cust = cust[order]
        if not np.array_equal(cust, w["custkey"]):
            fail(f"{name}: customers differ")
        for k in ("n_orders", "n_years"):
            if not np.array_equal(got.column(k).to_numpy()[order], w[k]):
                fail(f"{name}: {k} differs")
        offs, vals = _take_lists(*_list_parts(got.column("order_keys")),
                                 order)
        # each list sorted: one sort of (row, key) pairs packed in int64
        row = np.repeat(np.arange(len(offs) - 1, dtype=np.int64),
                        np.diff(offs))
        packed = np.sort((row << 32) | vals.astype(np.int64))
        if not (np.array_equal(np.diff(offs), w["n_orders"])
                and np.array_equal(packed & 0xFFFFFFFF, w["order_keys"])):
            fail(f"{name}: order_keys differ as multisets")
        offs, vals = _take_lists(*_list_parts(got.column("years_sorted")),
                                 order)
        if not np.array_equal(vals, w["years"]):
            fail(f"{name}: years_sorted differ")
        summary = got.column("summary").combine_chunks()
        if not (np.array_equal(summary.field("o_custkey").to_numpy()[order],
                               cust)
                and np.array_equal(summary.field("n").to_numpy()[order],
                                   w["n_orders"])):
            fail(f"{name}: summary differs")
        return
    w = want["window"]
    okey = got.column("o_orderkey").to_numpy()
    order = np.argsort(okey, kind="stable")
    if not np.array_equal(okey[order], w["orderkey"]):
        fail(f"{name}: orders differ")
    offs, vals = _take_lists(*_list_parts(got.column("last3_prices")),
                             order)
    if not (np.array_equal(np.diff(offs), w["len3"])
            and np.array_equal(vals, w["prices"])):
        fail(f"{name}: last3_prices differ")
    offs, vals = _list_parts(got.column("recent_years"))
    if (np.diff(offs) < 1).any():  # every frame holds its own row's year
        fail(f"{name}: an empty recent_years")
    mask = np.bitwise_or.reduceat(
        np.int64(1) << (vals.astype(np.int64) - 1990), offs[:-1])
    if not (np.array_equal(mask[order], w["ymask"])
            and np.array_equal(np.diff(offs), _popcount(mask))):
        fail(f"{name}: recent_years differ as sets")


def _rank_oracle(vals, valid, live):
    """numpy oracle of column_ranks: each row's position in a stable sort
    by (null rank: null 0, value 1, dead 2; the value in Java's order,
    -0.0 below 0.0 and NaN above +inf, zeroed for null and dead rows)."""
    import numpy as np

    if vals.dtype.kind == "f":
        wide = vals.dtype == np.float64
        bits = vals.view(np.int64 if wide else np.int32).astype(np.int64)
        top = np.int64(0x7FF8000000000000 if wide else 0x7FC00000)
        least = np.int64(-(1 << 63) if wide else -(1 << 31))
        bits = np.where(np.isnan(vals), top, bits)
        with np.errstate(over="ignore"):
            key = np.where(bits < 0, least - bits - 1, bits)
    else:
        key = vals.astype(np.int64)
        if np.array_equal(valid, live):
            # no nulls: one stable sort, dead rows after every live value
            order = np.argsort(np.where(live, key, np.iinfo(np.int64).max),
                               kind="stable")
            ranks = np.empty(len(order), dtype=np.int32)
            ranks[order] = np.arange(len(order), dtype=np.int32)
            return ranks
    rank_key = np.where(~live, 2, np.where(valid, 1, 0))
    key = np.where(valid & live, key, 0)
    order = np.lexsort((key, rank_key))
    ranks = np.empty(len(order), dtype=np.int32)
    ranks[order] = np.arange(len(order), dtype=np.int32)
    return ranks


def _morton_oracle(ranks, rank_bits):
    """numpy oracle of K36: the reference's double loop in int64."""
    import numpy as np

    n = len(ranks)
    use = min(rank_bits, max(1, 63 // n))
    shift = max(0, rank_bits - use)
    z = np.zeros(len(ranks[0]), dtype=np.uint64)
    for c, r in enumerate(ranks):
        v = r.astype(np.int64) >> shift
        for b in range(use):
            pos = b * n + c
            if pos >= 64:
                break
            z |= ((v >> b) & 1).astype(np.uint64) << np.uint64(pos)
    return z.view(np.int64)


#: phase 2's slice-13 shape: SF10 ORDERS' 15,000,000 rows in their
#: capacity, ranked by (o_custkey, o_orderdate)
ZORDER_CAP = 1 << 24


def _same_rows(name: str, got, want) -> None:
    """Two Arrow tables row for row: validity equal, floats bit for bit
    (NaN by NaN), everything else equal."""
    import numpy as np
    import pyarrow as pa

    if got.num_rows != want.num_rows or got.column_names != want.column_names:
        fail(f"{name}: {got.num_rows} rows {got.column_names}, expected "
             f"{want.num_rows} {want.column_names}")
    for c in want.column_names:
        a, b = got.column(c).combine_chunks(), want.column(c).combine_chunks()
        va = a.is_valid().to_numpy(zero_copy_only=False)
        vb = b.is_valid().to_numpy(zero_copy_only=False)
        if pa.types.is_floating(b.type):
            xa = a.fill_null(0).to_numpy()
            xb = b.fill_null(0).to_numpy()
            ints = np.int64 if xb.dtype == np.float64 else np.int32
            zero = xb.dtype.type(0)
            ok = (xa.dtype == xb.dtype
                  and np.array_equal(np.isnan(xa), np.isnan(xb))
                  and np.array_equal(
                      np.where(np.isnan(xa), zero, xa).view(ints),
                      np.where(np.isnan(xb), zero, xb).view(ints)))
        else:
            ok = a.equals(b)
        if not (np.array_equal(va, vb) and ok):
            fail(f"{name}: column {c} differs")


def check_slice13_kernels(dev):
    """Phase 2, slice 13: K36 (the Z-order interleave) against its plain
    version at OPTIMIZE ZORDER BY (o_custkey, o_orderdate)'s shape: the
    ranks of 15,000,000 live rows of capacity 2^24 (o_custkey int64 over
    1,500,000 customers, o_orderdate date32 over 2,406 days: ties in
    both), ranked by column_ranks (K9, K14's inverse), which must equal a
    numpy stable-argsort oracle. Returns {record name: record}."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.ops import zorder as Z
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType
    from spark_rapids_tpu_torch.sqltypes.datatypes import date, long

    # slice 12's tensors leave blocks of other sizes in the allocator's
    # cache; without them the 2^24-row outputs below need no cudaMalloc
    torch.cuda.empty_cache()
    rng = np.random.default_rng(131)
    n, cap = SF10_ORDERS, ZORDER_CAP
    live = np.arange(cap) < n
    cust = np.where(live, rng.integers(1, SF10_CUSTOMERS + 1, cap), 0)
    day = np.where(live, rng.integers(8035, 8035 + 2406, cap),
                   0).astype(np.int32)
    valid = torch.from_numpy(live).to(dev)
    schema = StructType([StructField("o_custkey", long),
                         StructField("o_orderdate", date)])
    batch = ColumnBatch(schema, [
        _col(long, torch.from_numpy(cust).to(dev), valid.clone()),
        _col(date, torch.from_numpy(day).to(dev), valid.clone())], n)
    ranks = [Z.column_ranks(batch, i) for i in range(2)]
    for k, vals in enumerate((cust, day)):
        want = _rank_oracle(vals, live, live)
        if not np.array_equal(ranks[k].cpu().numpy(), want):
            fail(f"column_ranks column {k} differs from the numpy oracle")
    rank_bits = (cap - 1).bit_length()
    got = Z.interleave_bits(ranks, rank_bits)
    want = Z.interleave_bits_plain(ranks, rank_bits)
    torch.cuda.synchronize()
    exact("zorder_interleave", got, want)
    if not np.array_equal(got.cpu().numpy(),
                          _morton_oracle([r.cpu().numpy() for r in ranks],
                                         rank_bits)):
        fail("zorder_interleave differs from the numpy oracle")
    return {"zorder_interleave": dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/zorder.cu",
        replaces="spark_rapids_tpu/ops/zorder.py:34",
        max_abs_err=max_abs_err(got, want), counter="zorder_interleave",
        **timed("zorder_interleave",
                lambda: Z.interleave_bits(ranks, rank_bits),
                lambda: Z.interleave_bits_plain(ranks, rank_bits), None,
                floor_ms=bound_ms(cap * (2 * 4 + 8))),
        # two int32 ranks read and one int64 key written a row
        bound_ms=bound_ms(cap * (2 * 4 + 8)), bound_by="bytes",
        shape=f"2 int32 rank vectors of {cap} rows ({n} live) -> int64 z")}


def check_slice13_edges(dev) -> int:
    """Phase 2, slice 13 edge shapes: K36 against its plain version at
    n = 1-5, 8, 63, 64 and 65 rank columns and capacities 1,024 and 2^24
    (n = 1 and 3 at 2^24 drop low bits: shift > 0 for n = 3; n >= 64 puts
    column 63 on the sign bit and drops the rest); column_ranks against
    the numpy oracle over every key type with nulls, NaN, +-inf, -0.0,
    ties and dead rows, all-dead batches included; zorder_sort over
    those batches against the numpy Morton order. Returns the number of
    cases."""
    import numpy as np
    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.columnar.arrow_bridge import (
        arrow_to_device,
        device_to_arrow,
    )
    from spark_rapids_tpu_torch.ops import zorder as Z

    g = torch.Generator(device=dev)
    g.manual_seed(132)
    cases = 0
    for cap in (1024, ZORDER_CAP):
        rank_bits = (cap - 1).bit_length()
        for n in ((1, 2, 3, 4, 5, 8, 63, 64, 65) if cap == 1024
                  else (1, 3, 8, 64, 65)):
            ranks = [torch.randint(0, cap, (cap,), generator=g, device=dev,
                                   dtype=torch.int32) for _ in range(n)]
            exact(f"zorder_interleave n={n} cap={cap}",
                  Z.interleave_bits(ranks, rank_bits),
                  Z.interleave_bits_plain(ranks, rank_bits))
            cases += 1
            del ranks
    torch.cuda.empty_cache()
    rng = np.random.default_rng(133)
    pools = {
        "double": np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf,
                            7.0, 1.5]),
        "float": np.array([0.0, -0.0, 1.5, np.nan, -np.inf, 3.0],
                          dtype=np.float32),
        "long": np.array([0, 1, -1, -(1 << 63), (1 << 63) - 1, 5, 5]),
        "int": np.array([0, 7, -3, -(1 << 31), 7], dtype=np.int32),
        "short": np.array([0, 2, -2, 2], dtype=np.int16),
        "date": np.arange(40, dtype=np.int32),
    }
    for rows in (1, 700, 5_000):
        for dead in sorted({0, min(3, rows), rows}):
            cols, host = {}, []
            for name, pool in pools.items():
                vals = pool[rng.integers(0, len(pool), rows)]
                valid = rng.random(rows) >= 0.2
                cols[name] = pa.array(
                    vals, mask=~valid,
                    type=pa.date32() if name == "date" else None)
                host.append((vals, valid))
            table = pa.table(cols)
            batch = arrow_to_device(table, device=dev)
            live_rows = rows - dead
            batch.num_rows = live_rows
            cap = batch.capacity
            live = np.arange(cap) < live_rows
            ranks = []
            for i, (vals, valid) in enumerate(host):
                v = np.zeros(cap, dtype=vals.dtype)
                ok = np.zeros(cap, dtype=bool)
                v[:rows], ok[:rows] = vals, valid
                want = _rank_oracle(v, ok, live)
                if not np.array_equal(Z.column_ranks(batch, i).cpu().numpy(),
                                      want):
                    fail(f"column_ranks {table.column_names[i]} rows={rows} "
                         f"dead={dead} differs from the numpy oracle")
                ranks.append(want)
                cases += 1
            for ords in ((0, 5), (1, 2, 3), (4,)):
                z = _morton_oracle([ranks[i] for i in ords],
                                   max(1, (cap - 1).bit_length()))
                order = np.lexsort((z, ~live))[:live_rows]
                got = device_to_arrow(Z.zorder_sort(batch, list(ords)))
                _same_rows(f"zorder_sort {ords} rows={rows} dead={dead}",
                           got, table.take(pa.array(order.astype(np.int64))))
                cases += 1
    return cases


#: rows of each data file a Delta write or rewrite lands
DELTA_FILE_ROWS = 1 << 20
#: the kernels phase 15's steps must launch: the Z-order's K9 (keys and
#: sort), K14's inverse, K36 and K8; the MERGEs' joins (K2's probe)
SLICE13_PATH_KERNELS = {
    "delta_zorder": ("pack_keys", "sort_words", "window_inverse",
                     "zorder_interleave", "gather_leaves"),
    "delta_rf1": ("probe_ranges",),
    "delta_rf2": ("probe_ranges",),
}


def _days(iso: str) -> int:
    import numpy as np

    return int(np.datetime64(iso, "D").astype(np.int64))


def _probe_hits(cust, day, lo: int, hi: int) -> int:
    """Files of DELTA_FILE_ROWS consecutive rows whose min/max statistics
    overlap zorder_probe (as the log's statistics would say)."""
    from spark_rapids_tpu_torch.q5 import ZORDER_PROBE_MONTH

    d_lo, d_hi = (_days(x) for x in ZORDER_PROBE_MONTH)
    hits = 0
    for s in range(0, len(cust), DELTA_FILE_ROWS):
        c, d = cust[s:s + DELTA_FILE_ROWS], day[s:s + DELTA_FILE_ROWS]
        hits += bool(c.min() <= hi and c.max() >= lo and d.min() <= d_hi
                     and d.max() >= d_lo)
    return hits


def _orders_columns():
    """Phase 9's typed ORDERS (`write_orders_dated`, seed 0) as numpy
    columns, in the written order."""
    import numpy as np

    from spark_rapids_tpu_torch.q5 import orders_dated_draws

    draws = orders_dated_draws(ORDERS_ROWS, FILES, seed=0)
    return {k: np.concatenate([d[k] for d in draws])
            for k in ("o_orderkey", "priority", "o_orderdate", "cents",
                      "o_custkey")}


def host_delta_orders(root: str) -> dict:
    """Phase 15's oracles that need no run on the card: the priority
    summary of ORDERS as written, and the table after RF1, RF2, both
    deletes and the update (its keys in order with their priorities, and
    its summary)."""
    import numpy as np

    from spark_rapids_tpu_torch.q5 import (
        DELTA_RETENTION_DATE,
        ORDER_PRIORITIES,
        refresh_draws,
        request_delete_custkey,
        update_price_cutoff,
    )

    o = _orders_columns()

    def summary(prio, price):
        return {ORDER_PRIORITIES[k]: (int((prio == k).sum()),
                                      float(price[prio == k].sum()))
                for k in range(len(ORDER_PRIORITIES))}

    base = summary(o["priority"], o["cents"] / 100.0)
    rf = refresh_draws(ORDERS_ROWS, seed=0)
    rf1 = rf["rf1"]
    rf1_prio = np.array([ORDER_PRIORITIES.index(p) for p in
                         rf1.column("o_orderpriority").to_pylist()])
    key = np.concatenate([o["o_orderkey"],
                          rf1.column("o_orderkey").to_numpy()])
    prio = np.concatenate([o["priority"], rf1_prio])
    day = np.concatenate([o["o_orderdate"], rf1.column(
        "o_orderdate").cast("int32").to_numpy()])
    price = np.concatenate([o["cents"] / 100.0,
                            rf1.column("o_totalprice").to_numpy()])
    cust = np.concatenate([o["o_custkey"],
                           rf1.column("o_custkey").to_numpy()])
    keep = ~np.isin(key, rf["rf2"].column("o_orderkey").to_numpy())
    keep &= day >= _days(DELTA_RETENTION_DATE)
    keep &= cust >= request_delete_custkey(ORDERS_ROWS)
    prio = np.where(price > update_price_cutoff(), 0, prio)
    key, prio, price = key[keep], prio[keep], price[keep]
    order = np.argsort(key, kind="stable")
    return dict(base=base, final=summary(prio, price),
                final_keys=key[order], final_prio=prio[order].astype(np.int8))


def host_zorder_oracle(root: str, piece_order) -> dict:
    """The numpy Morton order of phase 15's OPTIMIZE ZORDER BY (o_custkey,
    o_orderdate): ORDERS as written, its files of DELTA_FILE_ROWS rows
    taken in the snapshot's file order (`piece_order`: each snapshot
    file's place in the write), stable-argsort ranks of both columns, 24
    bits of each interleaved (capacity 2^24), a stable sort by z. Returns
    the keys in that order and zorder_probe's file hits before and after
    the rewrite."""
    import numpy as np

    from spark_rapids_tpu_torch.q5 import zorder_probe_bounds

    o = _orders_columns()
    n = len(o["o_orderkey"])
    idx = np.concatenate([np.arange(j * DELTA_FILE_ROWS,
                                    min(n, (j + 1) * DELTA_FILE_ROWS))
                          for j in piece_order])
    key, cust, day = (o[k][idx] for k in ("o_orderkey", "o_custkey",
                                          "o_orderdate"))
    lo, hi = zorder_probe_bounds(ORDERS_ROWS)
    before = _probe_hits(cust, day, lo, hi)
    ranks = []
    for col in (cust, day):
        r = np.empty(n, dtype=np.int64)
        r[np.argsort(col, kind="stable")] = np.arange(n)
        ranks.append(r)
    z = _morton_oracle(ranks, (ZORDER_CAP - 1).bit_length())
    order = np.argsort(z, kind="stable")
    return dict(keys=key[order], before=before,
                after=_probe_hits(cust[order], day[order], lo, hi))


def _log_actions(path: str, version: int) -> list:
    from spark_rapids_tpu_torch.lakehouse.delta import _commit_file

    with open(_commit_file(path, version)) as f:
        return [json.loads(line) for line in f if line.strip()]


def _check_add_stats(path: str, adds) -> None:
    """Each add action's stats equal pyarrow's row count, min, max and
    null count of its file."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    def iso(v):
        return v.isoformat() if hasattr(v, "isoformat") else v

    for add in adds:
        st = json.loads(add["stats"])
        t = pq.read_table(os.path.join(path, add["path"]))
        if st["numRecords"] != t.num_rows:
            fail(f"{add['path']}: numRecords {st['numRecords']} of "
                 f"{t.num_rows} rows")
        for name in t.column_names:
            col = t.column(name)
            want = (col.null_count, iso(pc.min(col).as_py()),
                    iso(pc.max(col).as_py()))
            got = (st["nullCount"].get(name), st["minValues"].get(name),
                   st["maxValues"].get(name))
            if got != want:
                fail(f"{add['path']} {name}: stats {got}, pyarrow {want}")


def _check_summary(what: str, got, want) -> None:
    rows = {r["o_orderpriority"]: (r["orders"], r["revenue"])
            for r in got.to_pylist()}
    if set(rows) != set(want):
        fail(f"{what}: priorities {sorted(rows)}")
    for p, (cnt, rev) in want.items():
        g_cnt, g_rev = rows[p]
        if g_cnt != cnt or abs(g_rev - rev) > REL_TOL * abs(rev):
            fail(f"{what} {p}: ({g_cnt}, {g_rev}), expected ({cnt}, {rev})")


def delta_sessions():
    """Phase 15's two sessions over one device: the fused engine on (the
    default, which runs the DML) and off (the adaptive engine)."""
    from spark_rapids_tpu_torch.api.session import TpuSparkSession

    out = []
    for fused in (True, False):
        out.append(TpuSparkSession.builder
                   .config("spark.sql.shuffle.partitions", 8)
                   .config("spark.rapids.sql.reader.batchSizeRows", 1 << 20)
                   .config("spark.rapids.sql.batchSizeRows", 1 << 20)
                   .config("spark.rapids.shuffle.mode", "DEVICE")
                   .config("spark.rapids.sql.fusedExec.enabled", fused)
                   .getOrCreate())
    return out


def run_slice13(dev, root: str, oracles: dict, morton_job) -> dict:
    """Phase 15: ORDERS' upkeep as a Delta table through the port's
    session (q5.py): the write with deletion vectors enabled (15 files;
    each add's stats against pyarrow; the priority summary read back on
    both engines), OPTIMIZE ZORDER BY (o_custkey, o_orderdate) (its row
    order against the numpy Morton order, zorder_probe's file candidates
    against the oracle's files, before and after), RF1 and RF2 as MERGEs,
    the retention and the request DELETE through deletion vectors (no
    data file rewritten; the second's vectors hold the first's), the
    UPDATE, and the read-back on both engines against the oracle. Each
    step's launches are counted over its cold run; `morton_job(piece
    order)` starts the Morton oracle in a worker once the write has named
    its files. Returns ({step: record}, the phase's seconds)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device
    from spark_rapids_tpu_torch.lakehouse import deletion_vectors as DV
    from spark_rapids_tpu_torch.lakehouse.delta import (
        DeltaTable,
        load_snapshot,
    )
    from spark_rapids_tpu_torch.ops.zorder import zorder_sort
    from spark_rapids_tpu_torch.q5 import (
        ORDER_PRIORITIES,
        delta_priority_summary_query,
        delta_request_delete,
        delta_retention_delete,
        delta_rf1,
        delta_rf2,
        delta_update,
        delta_write,
        delta_zorder,
        refresh_draws,
        zorder_probe,
    )

    t_phase = time.monotonic()
    spark, spark_aqe = delta_sessions()
    path = os.path.join(root, "orders_delta")
    rf = refresh_draws(ORDERS_ROWS, seed=0)
    out = {}

    def step(name, run):
        kernels.reset_launches()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        rec = dict(cold_s=time.monotonic() - t0,
                   version=load_snapshot(path).version,
                   launches=dict(kernels.launches))
        missing_launches(name, rec["launches"],
                         SLICE13_PATH_KERNELS.get(name, ()))
        out[name] = rec
        return rec

    def read_back(what: str, want_summary):
        for engine, s in (("fused", spark), ("aqe", spark_aqe)):
            got = delta_priority_summary_query(s.read.delta(path)
                                               ).collect_arrow()
            if s.last_execution["engine"] != engine:
                fail(f"{what}: ran on {s.last_execution['engine']}, not "
                     f"{engine}: {s.last_execution}")
            _check_summary(f"{what} ({engine})", got, want_summary)

    step("delta_write", lambda: delta_write(
        spark.read.parquet(os.path.join(root, "orders_dated")), path))
    adds0 = [a["add"] for a in _log_actions(path, 0) if "add" in a]
    snap = load_snapshot(path)
    written = [a["path"] for a in adds0]
    morton = morton_job([written.index(p) for p in snap.file_paths])
    if len(adds0) != -(-ORDERS_ROWS // DELTA_FILE_ROWS):
        fail(f"delta_write: {len(adds0)} data files")
    _check_add_stats(path, adds0)
    read_back("delta_write read-back", oracles["base"])
    probe = zorder_probe(ORDERS_ROWS).expr
    table = DeltaTable.forPath(spark, path)
    before = len(table._candidates(snap, probe))

    rec = step("delta_zorder", lambda: delta_zorder(spark, path))
    adds = [a["add"] for a in _log_actions(path, rec["version"])
            if "add" in a]
    keys = np.concatenate([pq.read_table(
        os.path.join(path, a["path"]), columns=["o_orderkey"]).column(
            0).to_numpy() for a in adds])
    after = len(table._candidates(load_snapshot(path), probe))
    t0 = time.monotonic()
    want = morton.get()
    rec.update(oracle_wait_s=time.monotonic() - t0,
               oracle_s=want["seconds"], candidates_before=before,
               candidates_after=after, oracle_before=want["before"],
               oracle_after=want["after"], files=len(adds))
    if not np.array_equal(keys, want["keys"]):
        bad = (int(np.argmax(keys != want["keys"]))
               if len(keys) == len(want["keys"]) else -1)
        fail(f"delta_zorder: row order differs from the Morton oracle "
             f"(first at {bad} of {len(keys)})")
    if (before, after) != (want["before"], want["after"]):
        fail(f"delta_zorder: candidates {before} -> {after}, the oracle's "
             f"files {want['before']} -> {want['after']}")
    del keys, want
    # the Z-order's device work alone, profiled: the table as the rewrite
    # left it, uploaded once, sorted along its curve
    cur = pa.concat_tables([pq.read_table(os.path.join(path, a["path"]))
                     for a in adds])
    batch = arrow_to_device(cur, device=dev)
    ords = [cur.column_names.index(c) for c in ("o_custkey", "o_orderdate")]
    del cur
    rec["profile"] = profile_run(lambda: zorder_sort(batch, ords))
    del batch
    torch.cuda.empty_cache()

    step("delta_rf1", lambda: delta_rf1(spark, path, rf["rf1"]))
    step("delta_rf2", lambda: delta_rf2(spark, path, rf["rf2"]))
    files = set(load_snapshot(path).file_paths)
    for name, run in (
            ("delta_dv_delete", lambda: delta_retention_delete(spark,
                                                                path)),
            ("delta_dv_delete2", lambda: delta_request_delete(
                spark, path, ORDERS_ROWS))):
        prev = load_snapshot(path)
        rec = step(name, run)
        actions = _log_actions(path, rec["version"])
        new = [a["add"] for a in actions if "add" in a]
        if any(a["path"] not in files or not a.get("deletionVector")
               for a in new):
            fail(f"{name}: a data file was written, or an add has no "
                 "deletion vector")
        grown = 0
        for a in new:
            old = prev.files[a["path"]].get("deletionVector")
            if old is None:
                continue
            was = DV.load_descriptor(path, old)
            now = DV.load_descriptor(path, a["deletionVector"])
            if not np.isin(was, now).all():
                fail(f"{name}: {a['path']}'s new vector drops rows")
            grown += 1
        rec.update(vectors=len(new), unioned=grown,
                   removed=sum("remove" in a for a in actions) - len(new))
        if name == "delta_dv_delete2" and not grown:
            fail("delta_dv_delete2: no file's vector unioned with the "
                 "first's")
    step("delta_update", lambda: delta_update(spark, path))

    read_back("final read-back", oracles["final"])
    codes = pa.array(ORDER_PRIORITIES)
    for engine, s in (("fused", spark), ("aqe", spark_aqe)):
        got = s.read.delta(path).select("o_orderkey", "o_orderpriority"
                                        ).collect_arrow()
        key = got.column(0).to_numpy()
        order = np.argsort(key, kind="stable")
        prio = pc.index_in(got.column(1), value_set=codes).to_numpy(
            zero_copy_only=False)[order]
        if not (np.array_equal(key[order], oracles["final_keys"])
                and np.array_equal(prio, oracles["final_prio"])):
            fail(f"final read-back ({engine}): the orders of some "
                 "priority differ from the oracle's")
    for s in (spark, spark_aqe):
        s.stop()
    return out, time.monotonic() - t_phase


def host_q5_orders(root: str) -> dict:
    """Phases 3-8's host work: q5's fact and dimension tables and ORDERS
    with comments written under root, and the q5, dupjoin and slice 4-6
    oracles."""
    from spark_rapids_tpu_torch.q5 import write_orders_data, write_q5_data

    fact_paths, dim_path = write_q5_data(
        root, ROWS, STORES, REGIONS, FILES, seed=0,
        dup_per_store=DUP_PER_STORE)
    want_q5 = q5_oracle(fact_paths, dim_path)
    want_dup = dupjoin_oracle(
        fact_paths, os.path.join(root, "dup", "dup-0.parquet"))
    order_paths = write_orders_data(root, ORDERS_ROWS, FILES, seed=0)
    return dict(fact_paths=fact_paths, dim_path=dim_path, want_q5=want_q5,
                want_dup=want_dup,
                oracles4=slice4_oracles(fact_paths, want_q5),
                oracles5=slice5_oracles(fact_paths),
                oracles6=slice6_oracles(order_paths, want_q5, want_dup))


def host_dated_customers(root: str) -> dict:
    """Phases 9-12's host work: the dated ORDERS (typed and as text) and
    CUSTOMER with its ORDERS written under root, and the slice 7-10
    oracles."""
    from spark_rapids_tpu_torch.q5 import (
        write_customer_data,
        write_orders_dated,
    )

    typed_paths, _ = write_orders_dated(root, ORDERS_ROWS, FILES, seed=0)
    paths9 = write_customer_data(root, SF10_CUSTOMERS, ORDERS_ROWS, FILES,
                                 seed=0)
    return dict(oracles7=slice7_oracles(typed_paths),
                oracles8=slice8_oracles(typed_paths),
                oracles9=slice9_oracles(paths9),
                oracles10=slice10_oracles(paths9))


def host_lines(root: str) -> dict:
    """Phases 13-14's host work: LINEITEM's draws once, LINEITEM with
    CUSTOMER's decimal balance and NESTED_ORDERS (the same lines) written
    under root, and the slice 11 and 12 oracles."""
    from spark_rapids_tpu_torch.q5 import (
        SF10_LINEITEM,
        lineitem_draws,
        nested_orders_draws,
        write_decimal_data,
        write_nested_orders,
    )

    lines = lineitem_draws(SF10_LINEITEM, FILES, seed=0)
    draws = nested_orders_draws(ORDERS_ROWS, SF10_LINEITEM, FILES, seed=0,
                                lines=lines)
    write_nested_orders(root, ORDERS_ROWS, SF10_LINEITEM, FILES, seed=0,
                        draws=draws)
    oracles12 = slice12_oracles(draws)
    del draws
    write_decimal_data(root, SF10_LINEITEM, SF10_CUSTOMERS, FILES, seed=0,
                       lines=lines)
    return dict(oracles11=slice11_oracles(lines), oracles12=oracles12)


#: the host's work for phases 3-15 (the seeded data and the oracles), one
#: worker process each, all started before phase 1's build: none of it
#: then stands between two phases on the card
HOST_JOBS = (host_q5_orders, host_dated_customers, host_lines)


def host_job(job, root: str, *args) -> dict:
    """job(root, *args) with its seconds, in a worker process. fail()
    exits, and a worker of multiprocessing.Pool that exits leaves its
    result unset: every exception comes back as a RuntimeError."""
    t0 = time.monotonic()
    try:
        out = job(root, *args)
    except BaseException as e:
        raise RuntimeError(f"{job.__name__}: {e!r}") from None
    out["seconds"] = time.monotonic() - t0
    return out


def nested_session(dev, root, fused: bool):
    """The session of phase 14, the fused engine on or off, with
    NESTED_ORDERS cached on the card: (the session, its DataFrame, the
    upload's seconds)."""
    import torch

    from spark_rapids_tpu_torch.api.session import TpuSparkSession

    spark = (TpuSparkSession.builder
             .config("spark.sql.shuffle.partitions", 8)
             .config("spark.rapids.sql.reader.batchSizeRows", 1 << 20)
             .config("spark.rapids.sql.batchSizeRows", 1 << 20)
             .config("spark.rapids.shuffle.mode", "DEVICE")
             .config("spark.rapids.sql.fusedExec.enabled", fused)
             .getOrCreate())
    t0 = time.monotonic()
    df = spark.read.parquet(os.path.join(root, "nested_orders"))
    df = df.cache(storage="device")
    spark.cache_manager.lookup(df._plan).materialize()
    torch.cuda.synchronize()
    return spark, df, time.monotonic() - t0


def run_slice12(dev, session, oracles, fused: bool) -> dict:
    """Phase 14: the four nested queries (q5.py) over NESTED_ORDERS cached
    on the card. Returns {query: record}, each with its peak device bytes,
    its largest device items and the launches of slice 12's kernels."""
    import torch

    from spark_rapids_tpu_torch.q5 import (
        customer_order_lists_query,
        nested_explode_query,
        nested_item_stats_query,
        recent_orders_window_query,
    )

    engine = "fused" if fused else "aqe"
    spark, df, upload_s = session
    builds = {
        "nested_explode": lambda: nested_explode_query(df),
        "nested_item_stats": lambda: nested_item_stats_query(df),
        "customer_order_lists": lambda: customer_order_lists_query(df),
        "recent_orders_window": lambda: recent_orders_window_query(df),
    }
    out = {}
    for name, build in builds.items():
        torch.cuda.reset_peak_memory_stats(dev)
        rec = timed_runs(lambda: build().collect_arrow(),
                         lambda g: check_slice12(name, g, oracles),
                         SLICE12_HOT_RUNS)
        ex = spark.last_execution
        want_engine = ("aqe" if fused and name in SLICE12_FUSED_FALLBACK
                       else engine)
        if ex["engine"] != want_engine:
            fail(f"{name} ran on {ex['engine']}, not {want_engine}: {ex}")
        fell = [e for e, _ in ex["fallbacks"]]
        if fell != (["fused"] if want_engine != engine else []):
            fail(f"{name}: unexpected fallbacks {ex['fallbacks']}")
        missing_launches(f"{engine} {name}", rec["launches"],
                         SLICE12_PATH_KERNELS[name])
        mode = (_window_mode(build()) if name == "recent_orders_window"
                else None)
        if mode is not None and not fused and mode != (True, 5, None):
            fail(f"{name}: window mode {mode}, not the halo of 5")
        rec.update(engine=ex["engine"], aqe=ex["aqe"], fused=ex["fused"],
                   upload_s=upload_s, window_mode=mode,
                   peak_device_bytes=int(
                       torch.cuda.max_memory_allocated(dev)),
                   slice12_launches={k: rec["launches"].get(k, 0)
                                     for k in SLICE12_COUNTERS})
        out[name] = rec
        torch.cuda.empty_cache()
    return out


def check_cache_devices(dev, root: str) -> dict:
    """The relation cache across devices: in one process a CPU session
    caches and queries a small NESTED_ORDERS, then a CUDA session, the CPU
    one still open, caches the same parquet plan and runs the same query.
    The CUDA session's cached parts must be CUDA tensors and its run must
    launch the path's kernels (the CPU run none), both answers equal; a
    query over the CPU session's DataFrame, run after the CUDA session
    was made, still runs on the CPU (no launch: a DataFrame runs in the
    session that made it), and a DataFrame of the one session cannot be
    combined with the other's.
    Returns a record of both runs."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        nested_explode_query,
        write_nested_orders,
    )

    write_nested_orders(root, 20_000, 80_000, files=2, seed=3)
    path = os.path.join(root, "nested_orders")
    runs, sessions = {}, []
    for name, conf in (("cpu", {"spark.rapids.torch.device": "cpu"}),
                       ("cuda", {})):
        spark = TpuSparkSession(conf)
        sessions.append(spark)
        df = spark.read.parquet(path).cache(storage="device")
        entry = spark.cache_manager.lookup(df._plan)
        kernels.reset_launches()
        got = nested_explode_query(df).collect_arrow()
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.launches.items() if v}
        devices = sorted({x.device.type for p in entry.device_parts()
                          for c in p.columns for x in c.leaves()})
        runs[name] = dict(devices=devices, launches=launched,
                          engine=spark.last_execution["engine"],
                          rows=sorted((r["o_orderstatus"], r["pos"],
                                       r["qty"], r["lines"])
                                      for r in got.to_pylist()),
                          df=df)
    if runs["cpu"]["devices"] != ["cpu"] or runs["cpu"]["launches"]:
        fail(f"cache check: the CPU session's run: {runs['cpu']}")
    if runs["cuda"]["devices"] != ["cuda"]:
        fail(f"cache check: the CUDA session's parts on "
             f"{runs['cuda']['devices']}")
    missing_launches("cache check (CUDA session)", runs["cuda"]["launches"],
                     SLICE12_PATH_KERNELS["nested_explode"])
    if runs["cuda"]["rows"] != runs["cpu"]["rows"]:
        fail("cache check: the two sessions' answers differ")
    # the route of the observed fault: a query built over the CPU
    # session's DataFrame runs in that session, on the CPU, whatever
    # session was made after it
    kernels.reset_launches()
    nested_explode_query(runs["cpu"]["df"]).collect_arrow()
    if any(kernels.launches.values()):
        fail("cache check: the CPU session's query launched kernels")
    try:
        runs["cuda"]["df"].union(runs["cpu"]["df"])
    except ValueError:
        pass
    else:
        fail("cache check: a CUDA DataFrame was combined with a CPU one")
    for spark in sessions:
        spark.stop()
    return {k: {f: v for f, v in r.items() if f not in ("df", "rows")}
            for k, r in runs.items()}


def _window_mode(df):
    def find(node):
        if type(node).__name__ == "TpuWindowExec":
            return node
        for c in node.children:
            w = find(c)
            if w is not None:
                return w
        return None

    w = find(df._physical()[0])
    return (w.presorted, w.halo, w.mode)


def profile_run(run) -> dict:
    """One more hot run under torch.profiler: the device's busy time (its
    kernels and copies, one stream, so they do not overlap) against the
    run's wall time, and the device time by operation name."""
    events, wall_ms = traced(run, "a profiled hot run")
    if events is None:
        return dict(wall_ms=wall_ms, device_busy_ms=None,
                    device_idle_share=None, top=[], library_sorts=[])
    # a library sort or scan (torch.sort, torch.cumsum, CUB's radix sort
    # and scans) must not run on any path: K9 and the scans of K1, K3,
    # K10, K11 and K14 (the port's own kernels, in namespace srtpu)
    # replaced them
    sorts = sorted({e.name for e in events
                    if ("sort" in e.name.lower() or "scan" in e.name.lower())
                    and "srtpu::" not in e.name})
    if sorts:
        fail(f"library sort or scan kernels ran on the path: {sorts}")
    by_name = {}
    busy_us = 0.0
    for e in events:
        us = e.time_range.elapsed_us()
        busy_us += us
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + us, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                device_idle_share=1 - busy_us / 1e3 / wall_ms,
                top=[dict(name=n[:80], ms=t / 1e3, calls=c)
                     for n, (t, c) in top], library_sorts=sorts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "spark_rapids_tpu_torch")):
        print("chip_smoke: spark_rapids_tpu_torch is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from spark_rapids_tpu_torch import resolve_device
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.q5 import SF10_LINEITEM

    t_start = time.monotonic()

    def stamp(what: str) -> None:
        print(f"{what} at {time.monotonic() - t_start:.1f} s of the run",
              flush=True)

    # phases 3-15's data and oracles are made while the card builds and
    # checks the kernels, in worker processes (daemons: an exit stops
    # them). pyarrow is imported here first: imported by the pool's thread
    # that unpickles the results, its later reads crash
    import pyarrow.compute  # noqa: F401
    import pyarrow.parquet  # noqa: F401

    data_dir = tempfile.TemporaryDirectory(prefix="srtpu_smoke_")
    host_pool = multiprocessing.get_context("spawn").Pool(len(HOST_JOBS))
    host = {job.__name__: host_pool.apply_async(host_job,
                                                (job, data_dir.name))
            for job in HOST_JOBS}

    # phase 1: the card, the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = resolve_device()
    name = torch.cuda.get_device_name(dev)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    build.lib()
    print(f"kernels built in {time.monotonic() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)", flush=True)
    # the profiler's device tracing starts up lazily: one throwaway trace
    traced(lambda: torch.ones(1 << 20, device=dev).sum(), "a warm-up")
    PROFILER_MISSES.clear()

    # phase 2: each kernel against its plain version
    records = {}
    for k, check in enumerate((
            check_kernels, check_slice2_kernels, check_slice3_kernels,
            check_slice4_kernels, check_slice5_kernels,
            check_slice6_kernels, check_slice7_kernels,
            check_slice8_kernels, check_slice9_kernels,
            check_slice10_kernels, check_slice11_kernels,
            check_slice12_kernels, check_slice13_kernels)):
        records.update(check(dev))
        stamp(f"phase 2: slice {k + 1}'s kernels checked")
    for kname, r in records.items():
        lib = r["library_ms"]
        print(f"{kname}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"event_ms={r['event_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={r['bound_ms']:.6f} "
              f"max_abs_err={r['max_abs_err']}"
              + (f" rel_err={r['rel_err']}" if "rel_err" in r else "")
              + (f"; {r['extra']}" if "extra" in r else ""), flush=True)
    for r in time_large_sorts(dev):
        print(f"sort_words at {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f}", flush=True)
    cases = 0
    for k, check in enumerate((
            check_edge_shapes, check_slice2_edges, check_slice3_edges,
            check_slice4_edges, check_slice5_edges, check_slice6_edges,
            check_slice7_edges, check_slice8_edges, check_slice9_edges,
            check_slice10_edges, check_slice11_edges, check_slice12_edges,
            check_slice13_edges)):
        cases += check(dev)
        stamp(f"phase 2: slice {k + 1}'s edge shapes checked")
    print(f"edge shapes: {cases} cases exact against the plain versions",
          flush=True)

    stamp("phase 2 done")

    # phases 3-5 at full size: slice 1's plan, the session on the
    # adaptive engine, the session on the fused engine
    with data_dir as tmp:

        def host_result(job):
            t0 = time.monotonic()
            out = host.pop(job.__name__).get()
            print(f"{job.__name__}: made in {out['seconds']:.1f} s of a "
                  f"worker, waited for {time.monotonic() - t0:.1f} s",
                  flush=True)
            return out

        done = host_result(host_q5_orders)
        fact_paths, dim_path = done["fact_paths"], done["dim_path"]
        want_q5, want_dup = done["want_q5"], done["want_dup"]
        print(f"data: {ROWS} fact rows in {FILES} files, a {STORES}-row "
              f"dimension and a {STORES * DUP_PER_STORE}-row duplicate-key "
              f"dimension, and ORDERS: {ORDERS_ROWS} rows in {FILES} files",
              flush=True)
        plan_rec = run_q5_plan(dev, fact_paths, dim_path, want_q5)
        print("q5_plan: " + json.dumps(plan_rec), flush=True)
        runs = {"q5_plan": plan_rec}
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_session(dev, tmp, want_q5, want_dup, fused)
            for qname in ("q5", "dupjoin"):
                rec = session[qname]
                runs[f"{engine} {qname}"] = rec
                print(f"{engine} {qname}: fused={json.dumps(rec['fused'])} "
                      f"aqe={json.dumps(rec['aqe'])} "
                      f"upload_s={rec['upload_s']:.3f} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={rec['profile']['device_busy_ms']} "
                      f"idle_share={rec['profile']['device_idle_share']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec), flush=True)
            print(f"{engine} peak device bytes: "
                  f"{session['peak_device_bytes']}", flush=True)

        stamp("phases 3-5 done")

        # phase 6: slice 4's sort, TopN, distinct and window queries
        oracles, oracles5 = done["oracles4"], done["oracles5"]
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_slice4(dev, tmp, oracles, fused)
            for qname, rec in session.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: rows={rec['result_rows']} "
                      f"fused={json.dumps(rec['fused'])} "
                      f"aqe={json.dumps(rec['aqe'])} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec), flush=True)
            print(f"{engine} window run_amount vs the oracle, largest "
                  f"relative difference per run: {WINDOW_REL_ERR}",
                  flush=True)
            WINDOW_REL_ERR.clear()

        stamp("phase 6 done")

        # phase 7: slice 5's window modes
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_slice5(dev, tmp, oracles5, fused)
            for qname, rec in session.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: mode={rec['mode']} "
                      f"rows={rec['result_rows']} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec), flush=True)
            print(f"{engine} slice 5 sums and averages vs the oracles, "
                  f"largest relative difference per check: "
                  f"{json.dumps(SLICE5_REL_ERR)}", flush=True)
            SLICE5_REL_ERR.clear()
        del oracles5

        stamp("phase 7 done")

        # phase 8: slice 6's string queries, with TPC-H ORDERS at SF10
        oracles6 = done.pop("oracles6")
        del done
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_slice6(dev, tmp, oracles6, fused)
            for qname, rec in session.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: rows={rec['result_rows']} "
                      f"fused={json.dumps(rec['fused'])} "
                      f"upload_s={rec['upload_s']:.3f} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec), flush=True)
        del oracles6

        stamp("phase 8 done")

        # phase 9: slice 7's casts, dates and session zones over the dated
        # ORDERS at SF10, typed and as .tbl text
        done = host_result(host_dated_customers)
        oracles7 = done.pop("oracles7")
        print(f"dated orders: {ORDERS_ROWS} rows in {FILES} files, typed "
              f"and as text", flush=True)
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_slice7(dev, tmp, oracles7, fused)
            for qname, rec in session.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: zone={rec['zone']} "
                      f"rows={rec['result_rows']} "
                      f"fused={json.dumps(rec['fused'])} "
                      f"upload_s={rec['upload_s']:.3f} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec, default=str),
                      flush=True)
        del oracles7

        stamp("phase 9 done")

        # phase 10: slice 8's statistical, distinct and percentile
        # aggregates and variance windows over the same dated ORDERS
        oracles8 = done.pop("oracles8")
        for engine, fused in (("aqe", False), ("fused", True)):
            session = run_slice8(dev, tmp, oracles8, fused)
            for qname, rec in session.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: engine={rec['engine']} "
                      f"rows={rec['result_rows']} "
                      f"fused={json.dumps(rec['fused'])} "
                      f"upload_s={rec['upload_s']:.3f} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec, default=str),
                      flush=True)
        print("slice 8 largest deviations (p90 rank error; moments and "
              "window variances as a share of their terms): "
              + json.dumps(SLICE8_ERRS), flush=True)
        del oracles8
        stamp("phase 10 done")

        # phases 11 and 12: slice 9's joins, union and repartition, and
        # slice 10's predicates, conditionals, math and hashes, over
        # CUSTOMER and ORDERS at SF10, uploaded once an engine for both
        oracles9, oracles10 = done["oracles9"], done["oracles10"]
        del done
        done = host_result(host_lines)
        # phase 15's oracles on the worker that host_lines freed, while
        # phases 11-14 run
        host[host_delta_orders.__name__] = host_pool.apply_async(
            host_job, (host_delta_orders, tmp))
        oracles11, oracles12 = done["oracles11"], done["oracles12"]
        del done
        print(f"customer: {SF10_CUSTOMERS} rows, orders with customers and "
              f"comments: {ORDERS_ROWS} rows in {FILES} files, lineitem: "
              f"{SF10_LINEITEM} rows in {FILES} files, customer_dec: "
              f"{SF10_CUSTOMERS} rows", flush=True)
        for engine, fused in (("aqe", False), ("fused", True)):
            session = customer_session(dev, tmp, fused)
            for phase, fn, oracles in ((11, run_slice9, oracles9),
                                       (12, run_slice10, oracles10),
                                       (13, run_slice11, oracles11)):
                done = fn(dev, session, oracles, fused)
                for qname, rec in done.items():
                    runs[f"{engine} {qname}"] = rec
                    prof = rec["profile"]
                    print(f"{engine} {qname}: engine={rec['engine']} "
                          f"rows={rec['result_rows']} "
                          f"aqe={json.dumps(rec['aqe'])} "
                          f"fused={json.dumps(rec['fused'])} "
                          f"upload_s={rec['upload_s']:.3f} "
                          f"cold_s={rec['cold_s']:.4f} "
                          f"hot_median_s={_secs(rec['hot_median_s'])} "
                          f"host_syncs={rec['host_syncs']} "
                          f"device_busy_ms={prof['device_busy_ms']} "
                          f"idle_share={prof['device_idle_share']} "
                          f"peak_device_bytes={rec['peak_device_bytes']}"
                          + (f" k30_k6_hex_launches="
                             f"{json.dumps(rec['slice10_launches'])}"
                             if phase == 12 else "")
                          + (f" k31_k32_k22_k24_decimal_launches="
                             f"{json.dumps(rec['slice11_launches'])}"
                             if phase == 13 else ""), flush=True)
                    if phase >= 12:
                        print(f"{engine} {qname} largest device items: "
                              + json.dumps(prof["top"][:5]), flush=True)
                    print(f"{engine} {qname} launches per query: "
                          + json.dumps(rec["launches"]), flush=True)
                    print(f"{engine} {qname}: "
                          + json.dumps(rec, default=str), flush=True)
                stamp(f"phase {phase} ({engine}) done")
            session[0].stop()
            del session
        del oracles9, oracles10, oracles11

        # phase 14: slice 12's nested columns over NESTED_ORDERS, after
        # the relation cache's device check
        cache_rec = check_cache_devices(dev, os.path.join(tmp, "cache"))
        print("relation cache across devices: " + json.dumps(cache_rec),
              flush=True)
        stamp("phase 14: the relation cache's device check done")
        print(f"nested_orders: {ORDERS_ROWS} orders carrying "
              f"{SF10_LINEITEM} lines in {FILES} files", flush=True)
        for engine, fused in (("aqe", False), ("fused", True)):
            session = nested_session(dev, tmp, fused)
            done = run_slice12(dev, session, oracles12, fused)
            for qname, rec in done.items():
                runs[f"{engine} {qname}"] = rec
                prof = rec["profile"]
                print(f"{engine} {qname}: engine={rec['engine']} "
                      f"rows={rec['result_rows']} "
                      f"window_mode={rec['window_mode']} "
                      f"fused={json.dumps(rec['fused'])} "
                      f"upload_s={rec['upload_s']:.3f} "
                      f"cold_s={rec['cold_s']:.4f} "
                      f"hot_median_s={_secs(rec['hot_median_s'])} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={prof['device_busy_ms']} "
                      f"idle_share={prof['device_idle_share']} "
                      f"peak_device_bytes={rec['peak_device_bytes']} "
                      f"slice12_launches="
                      f"{json.dumps(rec['slice12_launches'])}", flush=True)
                print(f"{engine} {qname} largest device items: "
                      + json.dumps(prof["top"][:5]), flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
            stamp(f"phase 14 ({engine}) done")
            session[0].stop()
            del session
        del oracles12

        # phase 15: slice 13's Delta Lake upkeep of phase 9's typed ORDERS
        done = host_result(host_delta_orders)
        steps, phase_s = run_slice13(
            dev, tmp, done, lambda order: host_pool.apply_async(
                host_job, (host_zorder_oracle, tmp, order)))
        host_pool.close()
        host_pool.join()
        del done
        for sname, rec in steps.items():
            runs[f"phase 15 {sname}"] = rec
            extra = {k: v for k, v in rec.items()
                     if k not in ("launches", "profile")}
            print(f"{sname}: " + json.dumps(extra), flush=True)
            if "profile" in rec:
                prof = rec["profile"]
                print(f"{sname} zorder_sort profiled: device_busy_ms="
                      f"{prof['device_busy_ms']} wall_ms={prof['wall_ms']} "
                      f"idle_share={prof['device_idle_share']} top="
                      + json.dumps(prof["top"][:6]), flush=True)
            print(f"{sname} launches: " + json.dumps(
                {k: v for k, v in rec["launches"].items() if v}),
                flush=True)
        print(f"phase 15: {phase_s:.1f} s", flush=True)
        stamp("phase 15 done")

    # each kernel's launches: the sum over every path's cold run (phases
    # 3-14) and phase 15's steps, each read right after it
    launches = {k: sum(r["launches"].get(rec.get("counter", k), 0)
                       for r in runs.values())
                for k, rec in records.items()}
    kernels_line = [
        dict(name=k, route=r["route"], source=r["source"],
             replaces=r["replaces"], launches=launches[k],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"])
        for k, r in records.items()]
    print("device times by CUDA events (the profiler traced nothing): "
          + json.dumps(PROFILER_MISSES), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
