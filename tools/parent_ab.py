"""Time this tree's redesigned kernels against another tree's on one card,
in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/parent_ab.py build/parent [--hot-runs 5] [--kernels-only]
        [--groups k4,k16,...] [--queries nested_explode,...]
        [--out runs.json]

The other tree (say, the parent commit, unpacked into a directory that
.gitignore lists) and this one each run in their own processes, in the
order other, this, this, other, over the same data: each process builds
its tree's kernels into its tree's build directory, then times the
kernel groups named by --groups (all by default):

- k4: K4 (`seg_sum_count_multi`) at chip_smoke.py's two sorted shapes
  (K4_SORTED: the fused posexplode's sums, 59,986,052 rows in 21 groups,
  and orders_ingest's, 15,000,000 rows in 7), at K4 multi's (corr's five
  float64 sums of 2^20 rows in 35 sorted groups) and at q5's binned
  partial (4,194,304 rows into 1,024 unsorted bins), each beside
  `torch.segment_reduce` over the same masked values with the lengths
  made beforehand (`index_add_` for the binned shape);
- k16: K16 (`frame_minmax_eval`) at range_query's RANGE frame
  (37,748,736 rows, offset -6) and moving_query's ROWS 6 PRECEDING max,
  and the L2 check: K16 alone right after
  K14's inverse (which leaves its window's lines marked evict-last)
  against K16 alone after a memset of 128 MiB (past the 50 MB L2);
- k2: K2 (`probe_bounds`) at q5's shape (a 2,048-row build, 8,388,608
  probe rows, as chip_smoke.py's phase 2 makes them) and at TPC-H q13's
  (the 1,500,000 c_custkey of CUSTOMER against 15,000,000 o_custkey);
- k15: K15 (`range_bounds`) at range_query's shape, whole, and its two
  launches alone from torch.profiler's records, beside one
  `index_select` of the key and one of its validity through the
  permutation;
- k14inv: K14's inverse (`inverse_permutation`) at range_query's
  permutation, and over random permutations of 2^22 rows, 2^24 and
  37,748,736, beside `torch.argsort`; where the tree plans the inverse
  in destination windows, each of 8-48 MiB windows at 2^24 and
  37,748,736 rows;
- k11: K11 (`dense_bin_perm`) at q5's 4,096 bins (2,000 occupied) and
  at the binned path's largest 2^20, beside `torch.nonzero`; where the
  tree's K11 takes a route, its two designs apart at 2^12-2^20 bins;
- k20: K20 (`_rewrite`, `_char_count`) at chip_smoke.py's shapes: trim,
  upper and length over the 15,000,000 ORDERS comments [n, 128], and
  substring(8, 2), upper and length over 36,000,000 decoded region rows
  [n, 16], beside the row-wise stable `argsort(~keep)` + `gather` idiom
  for trim and substring;
- k14eval: K14's evaluation (`window_eval`) at chip_smoke.py's shapes:
  row_number, rank, dense_rank and the running sum over the window
  query's 37,748,736 sorted rows, and percent_rank, cume_dist and
  ntile(4) over range_query's, each with `inv` given, as the path calls
  it, and with the inverse included (perm alone), with the device time of
  each kernel it launches.

Then (not with --kernels-only) the cold and hot times (median of
--hot-runs) of the queries named by --queries on the adaptive and the
fused engine, through the session over relations cached on the device
as chip_smoke.py's phases cache them: nested_explode (phase 14's
NESTED_ORDERS at SF10), orders_price_stats (phase 10's typed ORDERS),
orders_ingest (phase 9's .tbl text, America/Los_Angeles), range and
moving, running and u2u (phase 7's fact table), window (phase 6's), q5
and dupjoin (phases 4-5's), string_q5, string_dup, orders_q13 and
orders_words (phase 8's fact tables and ORDERS), orders_price_window
(phase 10's typed ORDERS), with each query's launches of K2, K4 (and of
its runs route), K11, K14's inverse and evaluation, K15, K16 and K20.

Every kernel output is checked against its plain version before it is
timed. Kernel times are means of CUDA-event timed calls after a warm-up
(and the profiler's device time where named so). Prints one JSON line a
process and a summary, and with --out writes every record to that JSON
file. Needs one CUDA device and no network.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ITERS = 20
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM peak device-memory rate
GROUPS = ("k4", "k16", "k2", "k15", "k14inv", "k11", "k20", "k14eval")
QUERIES = ("nested_explode", "orders_price_stats", "orders_ingest", "range",
           "moving")
#: the launch counters read after each query's cold run
COUNTERS = ("seg_sum_count", "seg_sum_count_runs", "frame_minmax",
            "probe_ranges", "range_bounds", "dense_bin_perm",
            "window_inverse", "window_eval", "str_rewrite")


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


def profiled_by_name(fn, iters: int = KERNEL_ITERS) -> dict:
    """Mean device ms a call of each device kernel, memset and copy fn
    puts on the card, by name (torch.profiler)."""
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
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / iters for k, v in out.items()}


def profiled_ms(fn, kernel: str, iters: int = KERNEL_ITERS):
    """Mean device ms a call of the kernels named like `kernel`."""
    return profiled_kernels(fn, kernel, iters)[0]


def _first(x):
    return x[0] if isinstance(x, tuple) else x


def _same(what: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: kernel differs from its plain version")


def _close(what: str, got, want, rel: float = 1e-9) -> None:
    import torch

    if not torch.allclose(got, want, rtol=rel, atol=0.0, equal_nan=True):
        raise RuntimeError(f"{what}: kernel differs from its plain version")


def _same_bits(what: str, got, want) -> None:
    import torch

    if got.dtype.is_floating_point:
        ity = {torch.float32: torch.int32, torch.float64: torch.int64}
        got, want = got.view(ity[got.dtype]), want.view(ity[want.dtype])
    _same(what, got, want)


def _here_smoke():
    """This tree's chip_smoke.py, whichever tree the process runs: its
    K4_SORTED shapes and their inputs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k4_times(cs, dev) -> dict:
    """K4 at the two sorted shapes, K4 multi's and q5's binned one, each
    beside its library call."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.ops import segmented as S

    out = {}
    for which in ("explode", "ingest"):
        d = _here_smoke().k4_sorted_inputs(dev, which)
        valid, gid, vals, nseg = d["valid"], d["gid"], d["vals"], d["nseg"]

        def k4():
            return S.seg_sum_count_multi([vals], valid, gid, nseg)

        got = k4()
        want = S.seg_sum_count_plain([vals], valid, gid, nseg)
        _same(f"k4 {which} count", got.count, want.count)
        _close(f"k4 {which} sum", got.sums[0].double(), want.sums[0].double())
        masked = torch.where(valid, vals, 0).to(torch.float64)
        lengths = torch.from_numpy(np.append(d["sizes"], d["cap"] - d["rows"])
                                   ).to(dev)
        out[f"k4_{which}_ms"] = event_ms(k4)
        out[f"k4_{which}_device_ms"], out[f"k4_{which}_kernels"] = (
            profiled_kernels(k4))
        out[f"k4_{which}_by_kernel_ms"] = profiled_by_name(k4)
        out[f"k4_{which}_segment_reduce_ms"] = event_ms(
            lambda: torch.segment_reduce(masked, "sum", lengths=lengths))
        out[f"k4_{which}_bound_ms"] = (
            d["cap"] + d["rows"] * 12 + nseg * 16) / HBM_BYTES_PER_MS
        del d, valid, gid, vals, masked, lengths, got, want
        torch.cuda.empty_cache()
    # K4 multi: corr's five sums of one 2^20-row part in 35 sorted groups
    rng = np.random.default_rng(81)
    n, ngroups = cs.STAT_PART_ROWS, cs.STAT_GROUPS
    gid_np = np.sort(rng.integers(0, ngroups, n)).astype(np.int32)
    gid = torch.from_numpy(gid_np).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    price = torch.from_numpy(rng.integers(85_771, 55_528_517, n) / 100.0).to(
        dev)
    day = torch.from_numpy(rng.integers(0, 2406, n).astype(np.float64)).to(
        dev)
    vecs = [price, day, price * day, price * price, day * day]

    def multi():
        return S.seg_sum_count_multi(vecs, valid, gid, ngroups)

    got, want = multi(), S.seg_sum_count_plain(vecs, valid, gid, ngroups)
    _same("k4 multi count", got.count, want.count)
    for j in range(5):
        _close(f"k4 multi sum {j}", got.sums[j], want.sums[j])
    stacked = torch.stack(vecs, 1)
    lengths = torch.from_numpy(np.bincount(gid_np, minlength=ngroups)).to(dev)
    out["k4_multi_ms"] = event_ms(multi)
    out["k4_multi_device_ms"], out["k4_multi_kernels"] = profiled_kernels(
        multi)
    out["k4_multi_segment_reduce_ms"] = event_ms(
        lambda: torch.segment_reduce(stacked, "sum", lengths=lengths))
    out["k4_multi_bound_ms"] = (n + n * (4 + 40) + ngroups * 48
                                ) / HBM_BYTES_PER_MS
    # q5's binned partial: 2 float64 vectors into 1,024 unsorted bins
    n, nseg = 1 << 22, 1024
    live = torch.arange(n, device=dev) < n * 11 // 12
    gid = torch.from_numpy(rng.integers(1, 12, n).astype(np.int32)).to(dev)
    amount = torch.from_numpy(10.0 + rng.random(n) * 90.0).to(dev)
    vals = [amount * 3.0, amount]
    masks = [live.clone(), live.clone()]

    def binned():
        with S.unsorted_gids():
            return S.seg_sum_count_multi(vals, live, gid, nseg, masks,
                                         value_counts=True)

    got = binned()
    want = S.seg_sum_count_plain(vals, live, gid, nseg, masks,
                                 value_counts=True)
    _same("k4 binned count", got.count, want.count)
    for j in range(2):
        _close(f"k4 binned sum {j}", got.sums[j], want.sums[j])
    gid64 = gid.to(torch.int64)
    zeros = torch.zeros((nseg, 4), dtype=torch.float64, device=dev)
    stacked = torch.stack([torch.where(live, vals[0], 0.0),
                           live.to(torch.float64),
                           torch.where(live, vals[1], 0.0),
                           live.to(torch.float64)], 1)
    out["k4_binned_ms"] = event_ms(binned)
    out["k4_binned_device_ms"] = profiled_kernels(binned)[0]
    out["k4_binned_index_add_ms"] = event_ms(
        lambda: zeros.clone().index_add_(0, gid64, stacked))
    torch.cuda.empty_cache()
    return out


def k16_times(cs, dev) -> dict:
    """K16 at range_query's RANGE frame and moving_query's ROWS frame,
    and the L2 check."""
    import statistics as st

    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.exec.fused import bucket_capacity
    from spark_rapids_tpu_torch.ops import windowops as W

    out = {}
    cap = cs.FILES * bucket_capacity(cs.ROWS // cs.FILES)
    batch = cs._fact_batch(dev, cap, cs.ROWS, 21)
    store, day, amount = batch.columns[:3]
    sw = W.sort_for_window(batch, [store], [(day, True, True)])
    inv = W.inverse_permutation(sw.perm)
    start, _ = W.range_bounds(sw, day.data, day.validity, sw.perm, -6, None,
                              True)
    fr = W.Frame(kernels.WIN_GIVEN, kernels.WIN_PEER, start=start)
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)

    def k16():
        return W.frame_minmax_eval(amount.data, amount.validity, sw, fr,
                                   False, pcnt, sw.perm, inv)

    got = k16()
    want = W.frame_minmax_plain(amount.data, amount.validity, sw, fr, False,
                                pcnt, sw.perm)
    _same_bits("k16 range", got[0], want[0])
    _same("k16 range validity", got[1], want[1])
    out["k16_range_ms"] = event_ms(k16)
    out["k16_range_kernels"] = profiled_kernels(k16)[1]
    out["k16_range_by_kernel_ms"] = profiled_by_name(k16)
    # the L2 check: K16 alone right after K14's inverse or a 128 MiB
    # memset, the host's enqueueing hidden behind a device sleep
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def after(prep):
        times = []
        for _ in range(KERNEL_ITERS):
            torch.cuda._sleep(2_000_000)
            prep()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            k16()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return st.mean(times), st.pstdev(times)

    out["k16_after_inverse_ms"], out["k16_after_inverse_sd"] = after(
        lambda: W.inverse_permutation(sw.perm))
    out["k16_after_flush_ms"], out["k16_after_flush_sd"] = after(
        lambda: scratch.zero_())
    del scratch, sw, inv, start, fr, pcnt, want
    torch.cuda.empty_cache()
    # moving_query's max over ROWS 6 PRECEDING, by (store, day, amount)
    sw = W.sort_for_window(batch, [store], [(day, True, True),
                                            (amount, True, True)])
    inv = W.inverse_permutation(sw.perm)
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)
    week = W.Frame(kernels.WIN_OFFSET, kernels.WIN_OFFSET, -6, 0)

    def moving():
        return W.frame_minmax_eval(amount.data, amount.validity, sw, week,
                                   True, pcnt, sw.perm, inv)

    got = moving()
    want = W.frame_minmax_plain(amount.data, amount.validity, sw, week, True,
                                pcnt, sw.perm)
    _same_bits("k16 moving", got[0], want[0])
    _same("k16 moving validity", got[1], want[1])
    out["k16_moving_ms"] = event_ms(moving)
    del batch, sw, inv, pcnt, got, want
    torch.cuda.empty_cache()
    return out


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


def k20_times(cs, dev) -> dict:
    """K20 at the ORDERS comments' and the region rows' shapes, beside the
    row-wise argsort idiom for trim and substring."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.expr import strings as S

    out = {}
    space = np.zeros(256, dtype=np.int16)
    space[ord(" ")] = -1
    upper = S.Rewrite(kernels.REWRITE_MAP, S._UPPER)
    for label, (data, lens, _), rw in (
            ("comment", (*cs._comment_rows(dev, cs.ORDERS_ROWS, 31), None),
             S.Rewrite(kernels.REWRITE_TRIM, space, 1, 1)),
            ("region", cs._region_rows(dev, cs.ROWS, 32),
             S.Rewrite(kernels.REWRITE_CHARS, a=8, b=2))):
        n, mb = data.shape
        held = int(lens.sum().item())
        name = "trim" if rw.kind == kernels.REWRITE_TRIM else "substring"
        cases = ((name, lambda: S._rewrite(data, lens, rw),
                  lambda lo, hi: S._rewrite_plain(data[lo:hi], lens[lo:hi],
                                                  rw),
                  held + n * (4 + mb + 4)),
                 ("upper", lambda: S._rewrite(data, lens, upper, False),
                  lambda lo, hi: (S._rewrite_plain(data[lo:hi], lens[lo:hi],
                                                   upper)[0], lens[lo:hi]),
                  held + n * (4 + mb)),
                 ("length", lambda: S._char_count(data, lens),
                  lambda lo, hi: S._char_count_plain(data[lo:hi],
                                                     lens[lo:hi]),
                  held + n * (4 + 4)))
        for what, fn, plain, nbytes in cases:
            got = fn()
            want = cs._chunked(plain, n)
            got, want = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
            for k, (g, w) in enumerate(zip(got, want)):
                _same(f"k20 {label} {what} {k}", g, w)
            del got, want
            key = f"k20_{label}_{what}"
            out[f"{key}_ms"] = event_ms(fn)
            out[f"{key}_device_ms"] = profiled_ms(fn, "str_rewrite")
            out[f"{key}_bound_ms"] = nbytes / HBM_BYTES_PER_MS
        # the library idiom: a row-wise stable argsort of ~keep, a gather
        pos = torch.arange(mb, device=dev)[None, :]
        inside = pos < lens[:, None]
        if name == "trim":
            body = (inside & (data != ord(" "))).to(torch.uint8)
            first = torch.argmax(body, dim=1, keepdim=True)
            last = mb - 1 - torch.argmax(torch.flip(body, dims=[1]), dim=1,
                                         keepdim=True)
            keep = (body.amax(dim=1, keepdim=True) > 0) & (
                pos >= first) & (pos <= last)
            del body, first, last
        else:
            keep = (pos >= 7) & (pos < 9) & inside
        del inside
        out[f"k20_{label}_{name}_argsort_ms"] = event_ms(
            lambda: torch.gather(data, 1, torch.argsort(
                (~keep).to(torch.uint8), dim=1, stable=True)), 3)
        del data, lens, keep, pos
        torch.cuda.empty_cache()
    return out


def k14eval_times(cs, dev) -> dict:
    """K14's evaluation at the window query's and range_query's shapes,
    with inv given and with the inverse included."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.exec.fused import bucket_capacity
    from spark_rapids_tpu_torch.ops import windowops as W

    out = {}
    cap = cs.FILES * bucket_capacity(cs.ROWS // cs.FILES)
    # the window query's rn, rk, drk and running sum (chip_smoke phase 2)
    batch = cs._window_inputs(dev, cap, cs.ROWS, 8)
    store, day, amount = batch.columns
    sw = W.sort_for_window(batch, [store], [(day, True, True)])
    p = W.window_prefix(amount.data, amount.validity, sw.live, sw.perm,
                        torch.float64, sw.seg_start)
    pcnt = W.window_prefix(None, amount.validity, sw.live, sw.perm,
                           torch.int64)
    reqs4 = [W.WinRequest(kernels.WIN_ROW_NUMBER),
             W.WinRequest(kernels.WIN_RANK),
             W.WinRequest(kernels.WIN_DENSE_RANK),
             W.WinRequest(kernels.WIN_SUM_F64, W.frame_of(None, True), p,
                          pcnt)]
    cases = [("k14eval_window", sw, reqs4, cap * (5 * 4 + 2 * 8)
              + cap * (3 * 5 + 9))]
    # range_query's percent_rank, cume_dist and ntile(4)
    batch5 = cs._fact_batch(dev, cap, cs.ROWS, 21)
    sw5 = W.sort_for_window(batch5, [batch5.columns[0]],
                            [(batch5.columns[1], True, True)])
    reqs3 = [W.WinRequest(kernels.WIN_PERCENT_RANK),
             W.WinRequest(kernels.WIN_CUME_DIST),
             W.WinRequest(kernels.WIN_NTILE, buckets=4)]
    cases.append(("k14eval_ranks", sw5, reqs3,
                  cap * (4 + 4 * 4) + cap * (9 + 9 + 5)))
    del batch, batch5
    for label, s, reqs, nbytes in cases:
        inv = W.inverse_permutation(s.perm)
        got = W.window_eval(s, reqs, s.perm, inv)
        want = W.window_eval_plain(s, reqs, s.perm)
        for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
            _same(f"{label} validity {k}", gv, wv)
            if gd.dtype.is_floating_point:
                _close(f"{label} {k}", gd, wd)
            else:
                _same(f"{label} {k}", gd, wd)
        del got, want

        def with_inv(s=s, reqs=reqs, inv=inv):
            return W.window_eval(s, reqs, s.perm, inv)

        def with_inverse(s=s, reqs=reqs):
            return W.window_eval(s, reqs, s.perm)

        out[f"{label}_ms"] = event_ms(with_inv)
        out[f"{label}_by_kernel_ms"] = profiled_by_name(with_inv)
        out[f"{label}_with_inverse_ms"] = event_ms(with_inverse)
        out[f"{label}_with_inverse_by_kernel_ms"] = profiled_by_name(
            with_inverse)
        out[f"{label}_bound_ms"] = nbytes / HBM_BYTES_PER_MS
        del inv
    del sw, sw5, p, pcnt, reqs4, reqs3, cases
    torch.cuda.empty_cache()
    return out


def kernel_times(cs, groups) -> dict:
    """The named kernel groups (module docstring)."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    if "k4" in groups:
        out.update(k4_times(cs, dev))
    if "k16" in groups:
        out.update(k16_times(cs, dev))
    if "k2" in groups:
        out.update(k2_times(cs, dev))
    if "k15" in groups or "k14inv" in groups:
        out.update(range_times(cs, dev, groups))
    if "k11" in groups:
        out.update(dense_times(dev))
    if "k20" in groups:
        out.update(k20_times(cs, dev))
    if "k14eval" in groups:
        out.update(k14eval_times(cs, dev))
    torch.cuda.empty_cache()
    return out


def k2_times(cs, dev) -> dict:
    """K2 at q5's and q13's shapes."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import next_capacity
    from spark_rapids_tpu_torch.ops import joinops

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
    return out


def range_times(cs, dev, groups) -> dict:
    """K15 and K14's inverse at range_query's shapes."""
    import torch

    from spark_rapids_tpu_torch.exec.fused import bucket_capacity
    from spark_rapids_tpu_torch.ops import windowops as W

    out = {}
    # K15 at range_query's shape
    cap = cs.FILES * bucket_capacity(cs.ROWS // cs.FILES)
    batch = cs._fact_batch(dev, cap, cs.ROWS, 21)
    store, day = batch.columns[0], batch.columns[1]
    sw = W.sort_for_window(batch, [store], [(day, True, True)])

    def k15():
        W.range_bounds(sw, day.data, day.validity, sw.perm, -6, None, True)

    if "k15" in groups:
        out["k15_ms"] = event_ms(k15)
        out["k15_search_device_ms"] = profiled_ms(k15, "range_search_kernel")
        out["k15_values_device_ms"] = profiled_ms(k15, "range_values_kernel")
        # the values launch's floor: one library gather of each through
        # perm
        out["gather_key_ms"] = event_ms(
            lambda: day.data.index_select(0, sw.perm))
        out["gather_valid_ms"] = event_ms(
            lambda: day.validity.index_select(0, sw.perm))
    range_perm = sw.perm
    del batch, sw, store, day
    if "k14inv" in groups:
        out.update(inverse_times(dev, range_perm))
    return out


#: query -> (the tables it reads, the reader's and the engine's batch rows,
#: the session zone), as chip_smoke.py's phases run it
QUERY_SESSIONS = {
    "q5": (("fact", "dim"), 1 << 23, 1 << 23, None),
    "dupjoin": (("fact", "dup"), 1 << 23, 1 << 23, None),
    "window": (("fact",), 1 << 23, 1 << 23, None),
    "string_q5": (("fact", "dim"), 1 << 23, 1 << 23, None),
    "string_dup": (("fact", "dup"), 1 << 23, 1 << 23, None),
    "orders_q13": (("orders",), 1 << 23, 1 << 23, None),
    "orders_words": (("orders",), 1 << 23, 1 << 23, None),
    "range": (("fact",), 1 << 23, 1 << 20, None),
    "moving": (("fact",), 1 << 23, 1 << 20, None),
    "running": (("fact",), 1 << 23, 1 << 20, None),
    "u2u": (("fact",), 1 << 23, 1 << 20, None),
    "orders_price_window": (("orders_dated",), 1 << 20, 1 << 20, None),
    "nested_explode": (("nested_orders",), 1 << 20, 1 << 20, None),
    "orders_price_stats": (("orders_dated",), 1 << 20, 1 << 20, None),
    "orders_ingest": (("orders_tbl",), 1 << 23, 1 << 23,
                      "America/Los_Angeles"),
}


def query_times(cs, root: str, hot_runs: int, queries) -> dict:
    """Cold and hot seconds of the named queries on each engine."""
    import torch

    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch import q5 as Q
    from spark_rapids_tpu_torch.api.session import TpuSparkSession

    builds = {
        "q5": lambda f: Q.engine_query(f["fact"], f["dim"], cs.REGIONS),
        "dupjoin": lambda f: Q.dupjoin_query(f["fact"], f["dup"]),
        "range": lambda f: Q.range_query(f["fact"]),
        "moving": lambda f: Q.moving_query(f["fact"]),
        "running": lambda f: Q.running_query(f["fact"]),
        "u2u": lambda f: Q.u2u_query(f["fact"]),
        "window": lambda f: Q.window_query(f["fact"]),
        "string_q5": lambda f: Q.string_q5_query(f["fact"], f["dim"]),
        "string_dup": lambda f: Q.string_dup_query(f["fact"], f["dup"]),
        "orders_q13": lambda f: Q.orders_q13_query(f["orders"]),
        "orders_words": lambda f: Q.orders_words_query(f["orders"]),
        "orders_price_window": lambda f: Q.orders_price_window_query(
            f["orders_dated"]),
        "nested_explode": lambda f: Q.nested_explode_query(
            f["nested_orders"]),
        "orders_price_stats": lambda f: Q.orders_price_stats_query(
            f["orders_dated"]),
        "orders_ingest": lambda f: Q.orders_ingest_query(f["orders_tbl"]),
    }
    sessions = {}
    for name in queries:
        sessions.setdefault(QUERY_SESSIONS[name][1:], []).append(name)
    out = {}
    for fused in (False, True):
        engine = "fused" if fused else "aqe"
        for (reader_rows, batch_rows, zone), names in sessions.items():
            b = (TpuSparkSession.builder
                 .config("spark.sql.shuffle.partitions", 8)
                 .config("spark.rapids.sql.reader.batchSizeRows",
                         reader_rows)
                 .config("spark.rapids.sql.batchSizeRows", batch_rows)
                 .config("spark.rapids.shuffle.mode", "DEVICE")
                 .config("spark.rapids.sql.fusedExec.enabled", fused))
            if zone is not None:
                b = b.config("spark.sql.session.timeZone", zone)
            spark = b.getOrCreate()
            frames = {}
            for table in sorted({t for q in names
                                 for t in QUERY_SESSIONS[q][0]}):
                df = spark.read.parquet(os.path.join(root, table)).cache(
                    storage="device")
                spark.cache_manager.lookup(df._plan).materialize()
                frames[table] = df
            for name in names:
                kernels.reset_launches()
                t0 = time.monotonic()
                got = builds[name](frames).collect_arrow()
                torch.cuda.synchronize()
                cold = time.monotonic() - t0
                launches = {k: kernels.launches[k] for k in COUNTERS
                            if k in kernels.launches}
                hot = []
                for _ in range(hot_runs):
                    t0 = time.monotonic()
                    builds[name](frames).collect_arrow()
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


def worker(tree: str, data: str, hot_runs: int, kernels_only: bool,
           groups, queries) -> None:
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
    rec.update(kernel_times(cs, groups))
    rec["queries"] = {} if kernels_only else query_times(
        cs, data, hot_runs, queries)
    print("RESULT " + json.dumps(rec), flush=True)


def write_tables(cs, root: str, queries) -> None:
    """The tables the named queries read, as chip_smoke.py writes them."""
    from spark_rapids_tpu_torch import q5 as Q

    tables = {t for q in queries for t in QUERY_SESSIONS[q][0]}
    if tables & {"fact", "dim", "dup"}:
        Q.write_q5_data(root, cs.ROWS, stores=cs.STORES, regions=cs.REGIONS,
                        files=cs.FILES, dup_per_store=cs.DUP_PER_STORE)
    if "orders" in tables:
        Q.write_orders_data(root, cs.ORDERS_ROWS, cs.FILES, seed=0)
    if tables & {"orders_dated", "orders_tbl"}:
        Q.write_orders_dated(root, cs.ORDERS_ROWS, cs.FILES, seed=0)
    if "nested_orders" in tables:
        Q.write_nested_orders(root, cs.ORDERS_ROWS, Q.SF10_LINEITEM,
                              cs.FILES, seed=0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the tree to time this one against")
    ap.add_argument("--hot-runs", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels alone, no queries")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="kernel groups to time: " + ", ".join(GROUPS))
    ap.add_argument("--queries", default=",".join(QUERIES),
                    help="queries to time: " + ", ".join(QUERY_SESSIONS))
    ap.add_argument("--out", help="write every run's record to this file")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "DATA"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    groups = [g for g in a.groups.split(",") if g]
    queries = [q for q in a.queries.split(",") if q]
    bad = ([g for g in groups if g not in GROUPS]
           + [q for q in queries if q not in QUERY_SESSIONS])
    if bad:
        ap.error(f"unknown groups or queries: {bad}")
    if a.worker:
        worker(os.path.abspath(a.worker[0]), a.worker[1], a.hot_runs,
               a.kernels_only, groups, queries)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("parent_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = os.path.abspath(a.other)
    results = []
    with tempfile.TemporaryDirectory(prefix="parent_ab_") as data:
        if not a.kernels_only:
            t0 = time.monotonic()
            write_tables(cs, data, queries)
            print(f"tables written in {time.monotonic() - t0:.1f} s",
                  flush=True)
        for label, tree in (("other", other), ("this", HERE),
                            ("this", HERE), ("other", other)):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), other,
                 "--hot-runs", str(a.hot_runs), "--groups", a.groups,
                 "--queries", a.queries, "--worker", tree, data]
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
