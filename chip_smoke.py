"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit; build the port's CUDA kernels from
   spark_rapids_tpu_torch/kernels/csrc with nvcc (sm_90a);
2. each kernel K1-K4 against its plain PyTorch version on the card, at the
   shapes the q5 path gives it (bench.py's full size: 8 parts of 4.5M
   rows, capacity 8,388,608), with the device time of the kernel, the
   plain version and one PyTorch library call computing the same function
   (torch.profiler: the summed durations of what each call runs on the
   card, so host dispatch is not counted), and the kernel's bound (the
   bytes this run's data needs, at 3.35 TB/s, the H100 SXM's rate);
   then small edge shapes (partial tiles, W=2 and 3 key words, several
   matches per row, ids out of range, bins beyond shared memory), exact;
3. the q5 star query at the bench's full size (36M fact rows in 8
   parquet files, a 2,000-row dimension with a dictionary-encoded
   `region`): upload into device-cached relations, one cold run and 5 hot
   runs of the port's physical plan, checked against a pyarrow oracle
   (region set equal, counts exact, sums and averages within 1e-9
   relative). The kernels' launch counts are reset just before the cold
   run and read just after it; every kernel must have run. One more hot
   run under torch.profiler gives the device's busy time against wall.

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
REL_TOL = 1e-9          # q5 sums and averages against the oracle
F64_ATOMIC_TOL = 1e-12  # K4's float64 sums: atomic order varies


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


def device_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Mean device milliseconds per call after one warm-up: the summed
    durations of the kernels, copies and memsets the calls put on the card,
    as torch.profiler traces them. They run on one stream, so they do not
    overlap; host dispatch between them is not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if not us > 0:
        fail("torch.profiler traced no device activity")
    return us / 1e3 / iters


def timed(kernel, plain, library) -> dict:
    """Device times of a kernel's wrapper, its plain version and the
    library call, and the CUDA-event time of the wrapper."""
    return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                library_ms=device_ms(library), event_ms=time_ms(kernel))


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
        **timed(lambda: filterops.compact_perm(keep, cap),
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
        **timed(lambda: joinops.probe_bounds(*args),
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
        **timed(lambda: joinops.expand_gather_maps(lo, counts, out_cap),
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
        **timed(k4, k4_plain,
                lambda: zeros.clone().index_add_(0, gid64, stacked)),
        # valid for every row; gid and both masks for the valid rows; each
        # value where its mask holds (every valid row here); the outputs
        bound_ms=bound_ms(n + n_valid * (4 + 2) + 2 * n_valid * 8
                          + nseg * 8 * (2 * 2 + 1)),
        bound_by="bytes",
        shape=f"gid [{n}] int32, 2 float64 vectors with masks, {n_valid} "
              f"valid rows, {nseg} bins")
    return out


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


def run_q5(dev, tmp):
    """Phase 3. Returns (launch counts of the cold run, timing record)."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.exec.relation_cache import DeviceCacheEntry
    from spark_rapids_tpu_torch.q5 import q5_plan, write_q5_data

    t0 = time.monotonic()
    fact_paths, dim_path = write_q5_data(tmp, ROWS, STORES, REGIONS, FILES,
                                         seed=0)
    gen_s = time.monotonic() - t0
    print(f"q5 data: {ROWS} fact rows in {FILES} files, written in "
          f"{gen_s:.1f} s", flush=True)
    t0 = time.monotonic()
    want = q5_oracle(fact_paths, dim_path)
    oracle_s = time.monotonic() - t0

    t0 = time.monotonic()
    fact = DeviceCacheEntry(fact_paths, device=dev)
    dim = DeviceCacheEntry([dim_path], device=dev)
    fact.materialize()
    dim.materialize()
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0

    kernels.reset_launches()
    t0 = time.monotonic()
    got = q5_plan(fact, dim, REGIONS).collect()
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    launches = dict(kernels.launches)
    check_q5(got, want)
    hot = []
    for _ in range(HOT_RUNS):
        t0 = time.monotonic()
        got = q5_plan(fact, dim, REGIONS).collect()
        torch.cuda.synchronize()
        hot.append(time.monotonic() - t0)
        check_q5(got, want)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"q5 never launched {missing}: {launches}")
    rec = dict(rows=ROWS, files=FILES, result_rows=got.num_rows,
               upload_s=upload_s, cold_s=cold_s,
               hot_median_s=statistics.median(hot), hot_s=hot,
               oracle_s=oracle_s, peak_device_bytes=int(
                   torch.cuda.max_memory_allocated(dev)))
    rec["profile"] = profile_q5(lambda: q5_plan(fact, dim, REGIONS).collect())
    return launches, rec


def profile_q5(run) -> dict:
    """One more hot run under torch.profiler: the device's busy time (its
    kernels and copies, one stream, so they do not overlap) against the
    run's wall time, and the device time by operation name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + us, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                device_idle_share=(1 - busy_us / 1e3 / wall_ms
                                   if busy_us else None),
                top=[dict(name=n[:80], ms=t / 1e3, calls=c)
                     for n, (t, c) in top])


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
    from spark_rapids_tpu_torch import kernels, resolve_device
    from spark_rapids_tpu_torch.kernels import build

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

    # phase 2: each kernel against its plain version
    records = check_kernels(dev)
    for kname, r in records.items():
        print(f"{kname}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"event_ms={r['event_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} "
              f"max_abs_err={r['max_abs_err']}", flush=True)

    print(f"edge shapes: {check_edge_shapes(dev)} cases exact against "
          "the plain versions", flush=True)

    # phase 3: q5 at full size
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="srtpu_q5_") as tmp:
        launches, q5 = run_q5(dev, tmp)
    print("q5: " + json.dumps(q5), flush=True)
    print("q5 launches per query: " + json.dumps(launches), flush=True)

    kernels_line = [
        dict(name=k, route=r["route"], source=r["source"],
             replaces=r["replaces"], launches=launches[k],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"])
        for k, r in records.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
