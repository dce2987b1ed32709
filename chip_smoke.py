"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit; build the port's CUDA kernels from
   spark_rapids_tpu_torch/kernels/csrc with nvcc (sm_90a, one process
   per source, all started together);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the q5 path gives it (bench.py's full size: 8 parts of 4.5M
   rows): K1-K4, K5 (bloom build and might_contain), K6 (murmur3
   partition ids), K7 (partition_by_ids), K8 (the batch gather), K9
   (orderable key words and their stable radix sort), K10 (group
   boundaries) and K11 (dense bin permutation), with the device time of
   the kernel, the plain version and, where one exists, one PyTorch
   library call computing the same function (torch.profiler: the summed
   durations of what each call runs on the card, so host dispatch is not
   counted; CUDA events where three traces in a row hold no device
   events, named in the output), and the kernel's bound (the bytes this
   run's data needs, at 3.35 TB/s, the H100 SXM's rate); K9's sort also
   at the 65,536-row build sort, 2^24 rows of heavy ties and 2^22 random
   keys; then edge shapes (partial tiles, several key words, null keys,
   dead rows, every string tail length, -0.0 and NaN, INT64_MIN, 1 to 7
   sort keys of every kind in both directions, 1 to 200 partitions, leaf
   widths no multiple of 4), exact;
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
   the lookup bet, and equal the oracles.

For each query run (phases 3-5) the kernels' launch counts are reset
just before the cold run and read just after it; every kernel of that
path must have run. One more hot run counts the host syncs (torch.cuda's
sync debug mode) and one, under torch.profiler, gives the device's busy
time against wall time and must hold no library sort kernel.

The line before the last holds the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Needs a CUDA device and the repository
around this file; the port never falls back to the CPU.
"""

import json
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
HOT_RUNS = 5
TIMING_ITERS = 20
DUP_PER_STORE = 2       # rows per store in the duplicate-key dimension
REL_TOL = 1e-9          # sums and averages against the oracles
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


def device_ms(fn, what: str, iters: int = TIMING_ITERS) -> float:
    """Mean device milliseconds per call after one warm-up: the summed
    durations of the kernels, copies and memsets the calls put on the card,
    as torch.profiler traces them. They run on one stream, so they do not
    overlap; host dispatch between them is not counted. Where the profiler
    traces nothing, the CUDA-event time (dispatch included)."""
    import torch

    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    events, _ = traced(calls, what)
    if events is None:
        return time_ms(fn, iters)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


def timed(name: str, kernel, plain, library) -> dict:
    """Device times of a kernel's wrapper, its plain version and the
    library call (None where no one PyTorch call computes the function),
    and the CUDA-event time of the wrapper."""
    return dict(ms=device_ms(kernel, name),
                plain_ms=device_ms(plain, f"{name} plain"),
                library_ms=None if library is None
                else device_ms(library, f"{name} library"),
                event_ms=time_ms(kernel))


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
    out["group_bounds"] = dict(
        route="cuda",
        source="spark_rapids_tpu_torch/kernels/csrc/group_bounds.cu",
        replaces="spark_rapids_tpu/ops/segmented.py:306",
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(gb, gb_p)),
        **timed("group_bounds",
                lambda: segmented.group_bounds(words, perm, live),
                lambda: segmented.group_bounds_plain(words, perm, live),
                None),
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


def timed_runs(run, check) -> dict:
    """Reset the launch counts, one cold run, read the counts; then
    HOT_RUNS hot runs, each checked against the oracle; one run counting
    its host syncs; one profiled run."""
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
    for _ in range(HOT_RUNS):
        t0 = time.monotonic()
        got = run()
        torch.cuda.synchronize()
        hot.append(time.monotonic() - t0)
        check(got)
    return dict(result_rows=got.num_rows, cold_s=cold_s,
                hot_median_s=statistics.median(hot), hot_s=hot,
                launches=launches, host_syncs=count_host_syncs(run),
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


def profile_run(run) -> dict:
    """One more hot run under torch.profiler: the device's busy time (its
    kernels and copies, one stream, so they do not overlap) against the
    run's wall time, and the device time by operation name."""
    events, wall_ms = traced(run, "a profiled hot run")
    if events is None:
        return dict(wall_ms=wall_ms, device_busy_ms=None,
                    device_idle_share=None, top=[], library_sorts=[])
    # a library sort (torch.sort, CUB's radix sort) must not run on any
    # path: K9 (the port's own kernels, in namespace srtpu) replaced them
    sorts = sorted({e.name for e in events if "sort" in e.name.lower()
                    and "srtpu::" not in e.name})
    if sorts:
        fail(f"library sort kernels ran on the path: {sorts}")
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
    from spark_rapids_tpu_torch.q5 import write_q5_data

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
    records = check_kernels(dev)
    records.update(check_slice2_kernels(dev))
    records.update(check_slice3_kernels(dev))
    for kname, r in records.items():
        lib = r["library_ms"]
        print(f"{kname}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"event_ms={r['event_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={r['bound_ms']:.6f} "
              f"max_abs_err={r['max_abs_err']}", flush=True)
    for r in time_large_sorts(dev):
        print(f"sort_words at {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.6f}", flush=True)
    cases = (check_edge_shapes(dev) + check_slice2_edges(dev)
             + check_slice3_edges(dev))
    print(f"edge shapes: {cases} cases exact against the plain versions",
          flush=True)

    # phases 3-5 at full size: slice 1's plan, the session on the
    # adaptive engine, the session on the fused engine
    with tempfile.TemporaryDirectory(prefix="srtpu_q5_") as tmp:
        t0 = time.monotonic()
        fact_paths, dim_path = write_q5_data(
            tmp, ROWS, STORES, REGIONS, FILES, seed=0,
            dup_per_store=DUP_PER_STORE)
        print(f"data: {ROWS} fact rows in {FILES} files, a {STORES}-row "
              f"dimension and a {STORES * DUP_PER_STORE}-row duplicate-key "
              f"dimension, written in {time.monotonic() - t0:.1f} s",
              flush=True)
        t0 = time.monotonic()
        want_q5 = q5_oracle(fact_paths, dim_path)
        want_dup = dupjoin_oracle(
            fact_paths, os.path.join(tmp, "dup", "dup-0.parquet"))
        print(f"pyarrow oracles in {time.monotonic() - t0:.1f} s",
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
                      f"hot_median_s={rec['hot_median_s']:.4f} "
                      f"host_syncs={rec['host_syncs']} "
                      f"device_busy_ms={rec['profile']['device_busy_ms']} "
                      f"idle_share={rec['profile']['device_idle_share']}",
                      flush=True)
                print(f"{engine} {qname} launches per query: "
                      + json.dumps(rec["launches"]), flush=True)
                print(f"{engine} {qname}: " + json.dumps(rec), flush=True)
            print(f"{engine} peak device bytes: "
                  f"{session['peak_device_bytes']}", flush=True)

    # each kernel's launches: the sum over every path's cold run (q5_plan,
    # aqe q5 and dupjoin, fused q5 and dupjoin), each read right after it
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in records}
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
