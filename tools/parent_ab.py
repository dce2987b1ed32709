"""Time this tree's redesigned kernels against another tree's on one card,
in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/parent_ab.py build/parent [--hot-runs 5] [--kernels-only]
        [--out runs.json]

The other tree (say, the parent commit, unpacked into a directory that
.gitignore lists) and this one each run in their own processes, in the
order other, this, this, other, over the same data: each process builds
its tree's kernels into its tree's build directory, then

- K2 (`probe_bounds`) at q5's shape (a 2,048-row build, 8,388,608 probe
  rows, as chip_smoke.py's phase 2 makes them) and at TPC-H q13's (the
  1,500,000 c_custkey of CUSTOMER against 15,000,000 o_custkey);
- K15 (`range_bounds`) at range_query's shape (37,748,736 rows through
  the window's permutation, offset -6), whole, and its two launches
  alone from torch.profiler's records, beside one `index_select` of the
  key and one of its validity through the permutation;
- K11 (`dense_bin_perm`) at q5's 4,096 bins (2,000 occupied) and at the
  binned path's largest 2^20 (three in ten occupied), with its device
  kernels a call from torch.profiler's records, beside
  `torch.nonzero`; where the tree's K11 takes a route, its one-block
  kernel and its three launches each at 2^12 and 2^14-2^17 and 2^20
  bins;
- K14's inverse (`inverse_permutation`) at range_query's permutation,
  and over random permutations of 2^22 rows (16 MiB of destinations, in
  the L2), 2^24 (OPTIMIZE ZORDER BY's ranks of ORDERS' capacity) and
  37,748,736, beside `torch.argsort`; where the tree plans the inverse
  in destination windows, each of 8, 16, 20, 24, 28, 32, 40 and 48 MiB
  windows at 2^24 and 37,748,736 rows;
- the cold and hot times (median of --hot-runs) of q5 and dupjoin
  (phases 4-5's conf, which run K11) and of range_query and moving_query
  (phase 7's, which run K14's inverse on both engines) on the adaptive
  and the fused engine, through the session over relations cached on
  the device, with each query's launches of K2, K11, K14's inverse and
  K15 (not with --kernels-only).

Every kernel output is checked against its plain version before it is
timed. Kernel times are means of CUDA-event timed calls after a warm-up
(and the profiler's device time where named so). Prints one JSON line a
process and a summary, and with --out writes every record to that JSON
file. Needs one CUDA device and no network.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ITERS = 20


def event_ms(fn, iters: int = KERNEL_ITERS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def profiled_kernels(fn, kernel: str = "", iters: int = KERNEL_ITERS):
    """(mean device ms, device kernels) a call of the kernels named like
    `kernel`, from torch.profiler; (None, None) where it traced none."""
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
    picked = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and kernel in e.name]
    if not picked:
        return None, None
    return (sum(e.time_range.elapsed_us() for e in picked) / 1e3 / iters,
            len(picked) / iters)


def profiled_ms(fn, kernel: str, iters: int = KERNEL_ITERS):
    """Mean device ms a call of the kernels named like `kernel`."""
    return profiled_kernels(fn, kernel, iters)[0]


def _first(x):
    return x[0] if isinstance(x, tuple) else x


def _same(what: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: kernel differs from its plain version")


def dense_times(dev) -> dict:
    """K11 at q5's and the binned path's largest shapes, and its two
    designs apart where the tree has both."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.ops import segmented

    out = {}
    rng = np.random.default_rng(11)
    q5 = np.zeros(4096, bool)
    q5[1:2001] = True  # bin 0 is the null key; 2,000 stores
    for label, occ_np in (("k11_q5", q5),
                          ("k11_2^20", rng.random(1 << 20) < 0.3)):
        occ = torch.from_numpy(occ_np).to(dev)
        bins = occ_np.size
        got = segmented.dense_bin_perm(occ, bins)
        want = segmented.dense_bin_perm_plain(occ, bins)
        _same(label, _first(got), _first(want))
        if isinstance(got, tuple):
            _same(f"{label} count", got[1], want[1])
        out[f"{label}_ms"] = event_ms(
            lambda: segmented.dense_bin_perm(occ, bins))
        out[f"{label}_device_ms"], out[f"{label}_kernels"] = (
            profiled_kernels(lambda: segmented.dense_bin_perm(occ, bins)))
        out[f"{label}_nonzero_device_ms"] = profiled_kernels(
            lambda: torch.nonzero(occ))[0]
    if len(build._SIGNATURES["srtpu_dense_bin_perm"]) < 7:
        return out  # a K11 without routes
    lib = build.lib()
    for bins in (1 << 12, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 20):
        occ = torch.from_numpy(rng.random(bins) < 0.3).to(dev)
        want = segmented.dense_bin_perm_plain(occ, bins)
        perm = torch.empty(bins, dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        scratch = torch.empty(2 * -(-bins // kernels.TILE_ROWS),
                              dtype=torch.int32, device=dev)
        for route, name in ((1, "one_block"), (2, "three_launches")):
            def call(route=route):
                build.check(lib.srtpu_dense_bin_perm(
                    occ.data_ptr(), bins, perm.data_ptr(), count.data_ptr(),
                    scratch.data_ptr(), route, kernels.stream_ptr(occ)),
                    "dense_bin_perm")

            call()
            _same(f"k11 {name} {bins}", perm, want[0])
            _same(f"k11 {name} {bins} count", count, want[1])
            out[f"k11_{name}_{bins}_device_ms"] = profiled_kernels(call)[0]
    return out


def inverse_times(dev, range_perm) -> dict:
    """K14's inverse at range_query's permutation and over random ones
    (the L2 check and Z-order's shape), beside argsort; the window sweep
    where the tree plans windows."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.ops import windowops as W

    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    perms = {"range": range_perm}
    for n in (1 << 22, 1 << 24, 37_748_736):
        perms[f"random_{n}"] = torch.randperm(n, generator=g,
                                              device=dev).to(torch.int32)
    for label, perm in perms.items():
        _same(f"k14 inverse {label}", W.inverse_permutation(perm),
              W.inverse_permutation_plain(perm))
        ms = event_ms(lambda: W.inverse_permutation(perm))
        out[f"k14_inverse_{label}_ms"] = ms
        out[f"k14_inverse_{label}_ns_a_row"] = ms * 1e6 / perm.numel()
        out[f"k14_inverse_{label}_argsort_ms"] = event_ms(
            lambda: torch.argsort(perm))
    if hasattr(W, "inverse_windows"):
        lib = build.lib()
        for label in ("random_16777216", "random_37748736"):
            perm = perms[label]
            n = perm.numel()
            want = W.inverse_permutation_plain(perm)
            inv = torch.empty_like(perm)
            for mib in (8, 16, 20, 24, 28, 32, 40, 48):
                windows = W.inverse_windows(n, mib << 18)

                def passes(windows=windows):
                    for lo, hi in windows:
                        build.check(lib.srtpu_window_inverse(
                            perm.data_ptr(), n, inv.data_ptr(), lo, hi,
                            kernels.sm_count(perm),
                            kernels.stream_ptr(perm)), "window_inverse")

                passes()
                _same(f"k14 inverse {label} {mib} MiB", inv, want)
                out[f"k14_inverse_{label}_{mib}MiB_ms"] = event_ms(passes)
    del perms
    return out


def kernel_times(cs) -> dict:
    """K2 at q5's and q13's shapes, K15 and K14's inverse at range_query's
    and K11 at q5's."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.exec.fused import bucket_capacity
    from spark_rapids_tpu_torch.ops import joinops
    from spark_rapids_tpu_torch.ops import windowops as W

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    # K2 at q5's shape, as chip_smoke.py's check_kernels draws it
    rng = np.random.default_rng(1)
    part_rows = cs.ROWS // cs.FILES
    cap = next_capacity(part_rows)
    amount = rng.random(part_rows) * 100.0
    n_kept = int((amount > 10.0).sum())
    bcap = next_capacity(cs.STORES)
    build = np.zeros(bcap, np.int64)
    build[:cs.STORES] = np.arange(cs.STORES)
    store = rng.integers(0, cs.STORES, part_rows)
    probe = np.zeros(cap, np.int64)
    probe[:n_kept] = store[amount > 10.0]
    args = ([torch.from_numpy(build).to(dev)],
            [torch.from_numpy(probe).to(dev)],
            torch.tensor(cs.STORES, dtype=torch.int32, device=dev),
            torch.from_numpy(np.arange(cap) < n_kept).to(dev), bcap)
    out["k2_q5_ms"] = event_ms(lambda: joinops.probe_bounds(*args))
    out["k2_q5_device_ms"] = profiled_ms(
        lambda: joinops.probe_bounds(*args), "")
    # K2 at q13's shape
    ncust, norders = 1_500_000, 15_000_000
    bcap, pcap = next_capacity(ncust), next_capacity(norders)
    build = torch.zeros(bcap, dtype=torch.int64, device=dev)
    build[:ncust] = torch.arange(1, ncust + 1, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    k = torch.randint(1, ncust + 1, (pcap,), generator=g, device=dev)
    k = k + (k % 3 == 0)
    k = torch.where(k > ncust, ncust - 1, k)
    live = torch.arange(pcap, device=dev) < norders
    args = ([build], [torch.where(live, k, 0)],
            torch.tensor(ncust, dtype=torch.int32, device=dev), live, bcap)
    out["k2_q13_ms"] = event_ms(lambda: joinops.probe_bounds(*args))
    del args, build, k, live
    # K15 at range_query's shape
    cap = cs.FILES * bucket_capacity(cs.ROWS // cs.FILES)
    batch = cs._fact_batch(dev, cap, cs.ROWS, 21)
    store, day = batch.columns[0], batch.columns[1]
    sw = W.sort_for_window(batch, [store], [(day, True, True)])

    def k15():
        W.range_bounds(sw, day.data, day.validity, sw.perm, -6, None, True)

    out["k15_ms"] = event_ms(k15)
    out["k15_search_device_ms"] = profiled_ms(k15, "range_search_kernel")
    out["k15_values_device_ms"] = profiled_ms(k15, "range_values_kernel")
    # the values launch's floor: one library gather of each through perm
    out["gather_key_ms"] = event_ms(
        lambda: day.data.index_select(0, sw.perm))
    out["gather_valid_ms"] = event_ms(
        lambda: day.validity.index_select(0, sw.perm))
    range_perm = sw.perm
    del batch, sw, store, day
    out.update(inverse_times(dev, range_perm))
    del range_perm
    out.update(dense_times(dev))
    torch.cuda.empty_cache()
    return out


def query_times(cs, root: str, hot_runs: int) -> dict:
    """Cold and hot seconds of q5, dupjoin, range and moving a engine."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    from spark_rapids_tpu_torch.q5 import (
        dupjoin_query,
        engine_query,
        moving_query,
        range_query,
    )

    out = {}
    for fused in (False, True):
        engine = "fused" if fused else "aqe"
        for batch_rows, names in ((1 << 23, ("q5", "dupjoin")),
                                  (1 << 20, ("range", "moving"))):
            spark = (TpuSparkSession.builder
                     .config("spark.sql.shuffle.partitions", 8)
                     .config("spark.rapids.sql.reader.batchSizeRows",
                             1 << 23)
                     .config("spark.rapids.sql.batchSizeRows", batch_rows)
                     .config("spark.rapids.shuffle.mode", "DEVICE")
                     .config("spark.rapids.sql.fusedExec.enabled", fused)
                     .getOrCreate())
            frames = {}
            for name in ("fact", "dim", "dup"):
                df = spark.read.parquet(os.path.join(root, name)).cache(
                    storage="device")
                spark.cache_manager.lookup(df._plan).materialize()
                frames[name] = df
            queries = {
                "q5": lambda: engine_query(frames["fact"], frames["dim"],
                                           cs.REGIONS),
                "dupjoin": lambda: dupjoin_query(frames["fact"],
                                                 frames["dup"]),
                "range": lambda: range_query(frames["fact"]),
                "moving": lambda: moving_query(frames["fact"]),
            }
            for name in names:
                kernels.reset_launches()
                t0 = time.monotonic()
                got = queries[name]().collect_arrow()
                torch.cuda.synchronize()
                cold = time.monotonic() - t0
                launches = {k: kernels.launches[k]
                            for k in ("probe_ranges", "range_bounds",
                                      "dense_bin_perm", "window_inverse")}
                hot = []
                for _ in range(hot_runs):
                    t0 = time.monotonic()
                    queries[name]().collect_arrow()
                    torch.cuda.synchronize()
                    hot.append(time.monotonic() - t0)
                out[f"{engine} {name}"] = dict(
                    rows=got.num_rows, cold_s=cold,
                    hot_median_s=statistics.median(hot), hot_s=hot,
                    launches=launches)
            spark.stop()
            del frames
            torch.cuda.empty_cache()
    return out


def worker(tree: str, data: str, hot_runs: int, kernels_only: bool
           ) -> None:
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the tree's own: its shapes and batches
    import torch

    from spark_rapids_tpu_torch.kernels import build

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"{cs.__file__} is not {tree}'s chip_smoke.py")
    t0 = time.monotonic()
    build.lib()
    rec = dict(tree=tree, build_s=time.monotonic() - t0,
               device=torch.cuda.get_device_name(0))
    rec.update(kernel_times(cs))
    rec["queries"] = {} if kernels_only else query_times(cs, data,
                                                         hot_runs)
    print("RESULT " + json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the tree to time this one against")
    ap.add_argument("--hot-runs", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels alone, no queries")
    ap.add_argument("--out", help="write every run's record to this file")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "DATA"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(os.path.abspath(a.worker[0]), a.worker[1], a.hot_runs,
               a.kernels_only)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("parent_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from spark_rapids_tpu_torch.q5 import write_q5_data

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = os.path.abspath(a.other)
    results = []
    with tempfile.TemporaryDirectory(prefix="parent_ab_") as data:
        if not a.kernels_only:
            write_q5_data(data, cs.ROWS, stores=cs.STORES,
                          regions=cs.REGIONS, files=cs.FILES,
                          dup_per_store=cs.DUP_PER_STORE)
        for label, tree in (("other", other), ("this", HERE),
                            ("this", HERE), ("other", other)):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), other,
                 "--hot-runs", str(a.hot_runs), "--worker", tree, data]
                + (["--kernels-only"] if a.kernels_only else []),
                capture_output=True, text=True)
            lines = [x for x in proc.stdout.splitlines()
                     if x.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            rec = json.loads(lines[-1][len("RESULT "):])
            rec.update(label=label, seconds=time.monotonic() - t0)
            print(json.dumps(rec), flush=True)
            results.append(rec)

    def pair(get):
        return ([get(r) for r in results if r["label"] == "other"],
                [get(r) for r in results if r["label"] == "this"])

    summary = {}
    skip = ("label", "tree", "device", "seconds", "build_s", "queries")
    for key in results[0]:
        if key not in skip:
            summary[key] = pair(lambda r, k=key: r.get(k))
    for key in results[1]:
        if key not in summary and key not in skip:
            summary[key] = pair(lambda r, k=key: r.get(k))
    for q in results[0]["queries"]:
        summary[f"{q} hot_median_s"] = pair(
            lambda r, q=q: r["queries"][q]["hot_median_s"])
        summary[f"{q} launches"] = pair(
            lambda r, q=q: r["queries"][q]["launches"])
        summary[f"{q} rows"] = pair(lambda r, q=q: r["queries"][q]["rows"])
    for key, (o, t) in summary.items():
        print(f"{key}: other {o} this {t}", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(card=smi, runs=results, summary=summary), f,
                      indent=1)
    print(json.dumps(dict(card=smi, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
