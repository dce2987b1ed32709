"""Window evaluation over a (partition, order)-sorted domain — counterpart
of `spark_rapids_tpu/ops/windowops.py`.

As in the reference, the window family rests on a few primitives:

1. segment structure: one stable multi-key sort (kernel K9) puts
   partitions contiguous; the partition and peer-run ids come from the
   sorted key words (K10), their bounds from segmented min/max (K12);
2. prefix sums answer every sum/count/avg frame in O(1) a row;
3. range extrema answer min/max frames, a binary search locates RANGE
   value bounds, and first/last/lead/lag read one source row each;
4. results go back to input order, since window operators preserve their
   input rows.

Kernel K14 (kernels/csrc/window_frames.cu) does 2 and 4 and the rank
family: `window_prefix` takes the inclusive prefix of a contribution
vector read through the sort permutation, `inverse_permutation` scatters
the reference's `inv`, and `window_eval` computes up to eight outputs a
launch (row_number, rank, dense_rank, percent_rank, cume_dist, ntile,
frame sums, counts and averages) and writes each at its input row:
input row i is evaluated from sorted row inv[i] (the reference's
inverse-permutation scatter followed by a take). K15 (`range_bounds`)
finds RANGE frame bounds, K16 (`frame_minmax_eval`) answers min/max
frames in sorted order from keys staged in shared memory and a sparse
table over 1,024-row blocks instead of the reference's full sparse
table, and K17 (`frame_pick`) gives first/last and lead/lag
their source rows, which K8 gathers. `frame_count`, `frame_sum`,
`frame_minmax`, `frame_first_last`, `lead_lag`, `range_frame_bounds` and
the rank functions keep the reference's sorted-domain shapes on top of
them.

Frames are inclusive position ranges [start, end] in the sorted domain:
the default frame, ROWS frames (offsets clipped to the partition) and
RANGE frames over one ascending numeric key. K33 (`frame_collect`)
collects each bounded ROWS frame's values into an array row
(collect_list, collect_set), written at its input row.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    gather_leaves,
)
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops import segmented
from spark_rapids_tpu_torch.ops.common import (
    KeySpec,
    pack_keys,
    pack_ready,
    sort_words,
    spec_words,
)

class SortedWindow(NamedTuple):
    """Sorted-domain view: positions/segments for one window spec. The
    reference's `inv` is not kept: K14 scatters it where it writes the
    results back. `pid` (the peer-run id of each sorted row) is the
    port's addition, from which K14 takes dense_rank."""

    perm: torch.Tensor        # [cap] sorted j <- original perm[j]
    live: torch.Tensor        # [cap] live mask in sorted order
    pos: torch.Tensor         # [cap] iota
    seg_start: torch.Tensor   # [cap] first position of the row's partition
    seg_end: torch.Tensor     # [cap] last position (inclusive)
    seg_len: torch.Tensor     # [cap]
    peer_start: torch.Tensor  # [cap] first position of the ORDER BY peers
    peer_end: torch.Tensor    # [cap] last position of the peer run
    pid: torch.Tensor         # [cap] peer-run id (partition id unordered)


def sort_for_window(batch: ColumnBatch,
                    part_cols: Sequence[DeviceColumn],
                    order_cols: Sequence[Tuple[DeviceColumn, bool, bool]],
                    ) -> SortedWindow:
    cap = batch.capacity
    device = batch.device
    live = batch.live_mask()
    pos = torch.arange(cap, dtype=torch.int32, device=device)
    part_specs = pack_ready([KeySpec(c, True, True, True, False, True)
                             for c in part_cols])
    order_specs = pack_ready([KeySpec(c, asc, nulls_first)
                              for c, asc, nulls_first in order_cols])
    specs = part_specs + order_specs
    if specs:
        words, _ = pack_keys(specs, live)
        perm = sort_words(words)
    else:
        perm = pos  # dead rows already trail in the original layout
    if part_specs:
        nparts = sum(spec_words(s) for s in part_specs)
        gb = segmented.group_bounds(words[:nparts], perm, live)
        gid, live_s = gb.gid, gb.live
    else:
        gid = torch.zeros(cap, dtype=torch.int32, device=device)
        live_s = live if not specs else live.index_select(
            0, perm.to(torch.int64))
    pid = (segmented.group_bounds(words, perm, live).gid if order_specs
           else gid)
    live_pos = torch.where(live_s, pos, cap)
    dead_neg = torch.where(live_s, pos, -1)
    mins = [segmented.seg_min(live_pos, None, gid, cap)]
    maxs = [segmented.seg_max(dead_neg, None, gid, cap)]
    idx = [gid, gid]
    if order_specs:
        mins.append(segmented.seg_min(live_pos, None, pid, cap))
        maxs.append(segmented.seg_max(dead_neg, None, pid, cap))
        idx += [pid, pid]
    # every take by a row's segment or peer id in one K8 launch
    taken = gather_leaves([mins[0], maxs[0]] + [x for pair in
                                                 zip(mins[1:], maxs[1:])
                                                 for x in pair], idx)
    seg_start, seg_end = taken[0], taken[1]
    peer_start, peer_end = (taken[2], taken[3]) if order_specs else (
        seg_start, seg_end)
    return SortedWindow(perm, live_s, pos, seg_start, seg_end,
                        seg_end - seg_start + 1, peer_start, peer_end, pid)


# ------------------------------------------------------------ frame bounds

class Frame(NamedTuple):
    """Where a frame starts and ends, as K14, K16 and K17 take it: each
    side a kernels.WIN_* bound kind, the offset of a WIN_OFFSET side, or
    the [cap] int32 positions of a WIN_GIVEN side (K15's RANGE bounds)."""

    start_kind: int
    end_kind: int
    lower: int = 0
    upper: int = 0
    start: Optional[torch.Tensor] = None
    end: Optional[torch.Tensor] = None

    def struct(self) -> "kernels.WinFrame":
        return kernels.WinFrame(
            self.start_kind, self.end_kind, int(self.lower),
            int(self.upper),
            None if self.start is None else self.start.data_ptr(),
            None if self.end is None else self.end.data_ptr())


def _range_side(v) -> int:
    """A RANGE side: the partition's (unbounded, None), the peer run's
    (0), or K15's (a value offset)."""
    if v is None:
        return kernels.WIN_SEG
    return kernels.WIN_PEER if v == 0 else kernels.WIN_GIVEN


def frame_of(frame, has_order: bool, sw: Optional[SortedWindow] = None,
             order: Optional[Tuple[DeviceColumn, bool]] = None) -> Frame:
    """The frame of a window spec (expr/windows.WindowFrame, None for
    Spark's implicit one): RANGE UNBOUNDED PRECEDING..CURRENT ROW when
    ordered, the whole partition otherwise; ROWS offsets clip to the
    partition; a RANGE side is the partition's when unbounded, the peer
    run's at offset 0, and K15's search otherwise, over `order` (the
    single ORDER BY key in input order, read through sw.perm, and whether
    its nulls sort first)."""
    if frame is None:
        return Frame(kernels.WIN_SEG,
                     kernels.WIN_PEER if has_order else kernels.WIN_SEG)
    if frame.frame_type == "rows":
        return Frame(
            kernels.WIN_SEG if frame.lower is None else kernels.WIN_OFFSET,
            kernels.WIN_SEG if frame.upper is None else kernels.WIN_OFFSET,
            0 if frame.lower is None else int(frame.lower),
            0 if frame.upper is None else int(frame.upper))
    sk = _range_side(frame.lower)
    ek = _range_side(frame.upper)
    start = end = None
    if kernels.WIN_GIVEN in (sk, ek):
        col, nulls_first = order
        start, end = range_bounds(
            sw, col.data, col.validity, sw.perm,
            frame.lower if sk == kernels.WIN_GIVEN else None,
            frame.upper if ek == kernels.WIN_GIVEN else None, nulls_first)
    return Frame(sk, ek, start=start, end=end)


def frame_bounds(sw: SortedWindow, fr: Frame
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive [start, end] of every sorted row's frame."""
    if fr.start_kind == kernels.WIN_GIVEN:
        start = fr.start
    elif fr.start_kind == kernels.WIN_SEG:
        start = sw.seg_start
    elif fr.start_kind == kernels.WIN_PEER:
        start = sw.peer_start
    else:
        start = torch.maximum(sw.pos + fr.lower, sw.seg_start)
    if fr.end_kind == kernels.WIN_GIVEN:
        end = fr.end
    elif fr.end_kind == kernels.WIN_SEG:
        end = sw.seg_end
    elif fr.end_kind == kernels.WIN_PEER:
        end = sw.peer_end
    else:
        end = torch.minimum(sw.pos + fr.upper, sw.seg_end)
    return start, end


def rows_frame_bounds(sw: SortedWindow, lower: Optional[int],
                      upper: Optional[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROWS BETWEEN lower AND upper (None = unbounded; offsets relative,
    negative = preceding), clipped to the partition."""
    return frame_bounds(sw, Frame(
        kernels.WIN_SEG if lower is None else kernels.WIN_OFFSET,
        kernels.WIN_SEG if upper is None else kernels.WIN_OFFSET,
        lower or 0, upper or 0))


def default_frame_bounds(sw: SortedWindow, has_order: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark's implicit frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW when
    ordered (current row's full peer run included), whole partition
    otherwise."""
    return frame_bounds(sw, frame_of(None, has_order))


def _check_bounds(sw: SortedWindow, n: int) -> Tuple[torch.Tensor, ...]:
    dev = sw.pos.device
    bounds = (sw.seg_start, sw.seg_end, sw.peer_start, sw.peer_end)
    for name, x in zip(("seg_start", "seg_end", "peer_start", "peer_end"),
                       bounds):
        kernels.require(x, name, torch.int32, dev)
        if x.shape[0] != n:
            raise ValueError(f"{name} of {x.shape[0]} rows for {n}")
    return bounds


def _check_frame(fr: Frame, dev: torch.device, n: int) -> None:
    for x in (fr.start, fr.end):
        if x is not None:
            kernels.require(x, "frame bound", torch.int32, dev)
            if x.shape[0] != n:
                raise ValueError(f"frame bound of {x.shape[0]} for {n}")


# ------------------------------------------------------------------ K15

def _range_domain(data: torch.Tensor, lower, upper):
    """The reference's search domain: (dtype, low sentinel, high
    sentinel): int64 and iinfo(int64).min // 2, max // 2 for an integer
    key with integer offsets; float64 and -inf, +inf otherwise."""
    floats = isinstance(lower, float) or isinstance(upper, float)
    if not data.dtype.is_floating_point and not floats:
        info = torch.iinfo(torch.int64)
        return torch.int64, info.min // 2, info.max // 2
    return torch.float64, float("-inf"), float("inf")


def range_bounds_plain(sw: SortedWindow, data: torch.Tensor,
                       valid: torch.Tensor, perm: Optional[torch.Tensor],
                       lower, upper, nulls_first: bool
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """Plain PyTorch version of K15: the reference's sentinel-filled
    values and its `_lower_bound`, a binary search of all rows by
    (segment, value), clipped to the segment."""
    n = int(sw.pos.shape[0])
    idx = None if perm is None else perm.to(torch.int64)

    def take(x):
        return x[:n] if idx is None else x.index_select(0, idx)

    dtype, neg, pos = _range_domain(data, lower, upper)
    valid_s = take(valid)
    full = torch.full((n,), pos, dtype=dtype, device=data.device)
    null_v = torch.full_like(full, neg if nulls_first else pos)
    val = torch.where(valid_s & sw.live, take(data).to(dtype),
                      torch.where(sw.live, null_v, full))
    gid = sw.seg_start

    def search(target, strict):
        lo = torch.zeros(n, dtype=torch.int64, device=val.device)
        hi = torch.full_like(lo, n)
        for _ in range(max(1, n.bit_length())):
            mid = (lo + hi) >> 1
            safe = mid.clamp(0, n - 1)
            mg, mv = gid.index_select(0, safe), val.index_select(0, safe)
            less = (mg < gid) | ((mg == gid) & (
                (mv <= target) if strict else (mv < target)))
            less = less & (mid < hi)
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        return lo

    start = end = None
    if lower is not None:
        s = torch.maximum(search(val + lower, False), sw.seg_start)
        start = torch.where(valid_s, s, sw.peer_start).to(torch.int32)
    if upper is not None:
        e = torch.minimum(search(val + upper, True) - 1, sw.seg_end)
        end = torch.where(valid_s, e, sw.peer_end).to(torch.int32)
    return start, end


def range_bounds(sw: SortedWindow, data: torch.Tensor, valid: torch.Tensor,
                 perm: Optional[torch.Tensor], lower, upper,
                 nulls_first: bool
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel K15: the RANGE frame bounds of every sorted row, [n] int32
    each, for the sides whose offset is given (None: not computed), over
    one ascending numeric key (its data and validity, read through perm;
    without perm already sorted): the first row of the row's partition
    whose value is at least its value + lower, and the last whose value
    is at most its value + upper (the reference's search of all rows by
    (segment, value), clipped to the segment); a null key frames its null
    peer run."""
    if sw.pos.device.type == "cpu":
        return range_bounds_plain(sw, data, valid, perm, lower, upper,
                                  nulls_first)
    dev = sw.pos.device
    n = int(sw.pos.shape[0])
    kind = kernels.RANGE_TYPES.get(data.dtype)
    if kind is None:
        raise TypeError(f"K15 searches integer or float keys, got "
                        f"{data.dtype}")
    kernels.require(data, "data", data.dtype, dev)
    kernels.require(valid, "valid", torch.bool, dev)
    kernels.require(sw.live, "live_s", torch.bool, dev)
    bounds = _check_bounds(sw, n)
    if perm is not None:
        kernels.require(perm, "perm", torch.int32, dev)
    elif data.shape[0] < n or valid.shape[0] < n:
        raise ValueError(f"a key of {data.shape[0]} rows for {n}")
    dtype, _, _ = _range_domain(data, lower, upper)
    start = None if lower is None else torch.empty(n, dtype=torch.int32,
                                                   device=dev)
    end = None if upper is None else torch.empty(n, dtype=torch.int32,
                                                 device=dev)
    # the sorted values (int64 or float64), then a null byte a row
    scratch = torch.empty(n * 9, dtype=torch.uint8, device=dev)
    as_float = dtype == torch.float64
    _build.check(_build.lib().srtpu_range_bounds(
        kind, int(as_float), data.data_ptr(), valid.data_ptr(),
        sw.live.data_ptr(), None if perm is None else perm.data_ptr(), n,
        int(nulls_first), 0 if as_float or lower is None else int(lower),
        0 if as_float or upper is None else int(upper),
        float(lower or 0) if as_float else 0.0,
        float(upper or 0) if as_float else 0.0,
        *[x.data_ptr() for x in bounds],
        None if start is None else start.data_ptr(),
        None if end is None else end.data_ptr(), scratch.data_ptr(),
        kernels.sm_count(data), kernels.stream_ptr(data)), "range_bounds")
    kernels.launches["range_bounds"] += 1
    return start, end


def range_frame_bounds(sw: SortedWindow, order_col_sorted: DeviceColumn,
                       lower, upper, nulls_first: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANGE BETWEEN value offsets over a single ascending numeric key, in
    sorted order. lower/upper: None = unbounded, 0 = current row (peer
    bounds), other numbers = value offsets (negative preceding). Rows
    whose order value is NULL frame over exactly their null peer run
    (Spark semantics). The reference's third argument, the sorted segment
    ids, is sw.seg_start, which K15 reads itself."""
    sk = _range_side(lower)
    ek = _range_side(upper)
    start, end = range_bounds(
        sw, order_col_sorted.data, order_col_sorted.validity, None,
        lower if sk == kernels.WIN_GIVEN else None,
        upper if ek == kernels.WIN_GIVEN else None, nulls_first)
    return frame_bounds(sw, Frame(sk, ek, start=start, end=end))


# ------------------------------------------------------------------ K14

def _prefix(vals: torch.Tensor) -> torch.Tensor:
    """The reference's prefix: p[i] = sum(vals[:i]), length cap + 1, so
    frame sums are p[end + 1] - p[start]."""
    z = torch.zeros(1, dtype=vals.dtype, device=vals.device)
    return torch.cat([z, torch.cumsum(vals, 0, dtype=vals.dtype)])


def _segmented_prefix(vals: torch.Tensor,
                      seg_start: torch.Tensor) -> torch.Tensor:
    """p[0] = 0 and p[j + 1] = sum(vals[seg_start[j]:j + 1]): the prefix
    restarted at each partition, by doubling steps inside partitions
    (rows j and j - k share a partition exactly when their seg_start
    does)."""
    x = vals.clone()
    n = int(x.shape[0])
    k = 1
    while k < n:
        same = seg_start[k:] == seg_start[:-k]
        x = torch.cat([x[:k], x[k:] + torch.where(same, x[:-k],
                                                  torch.zeros_like(x[k:]))])
        k <<= 1
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x])


def window_prefix_plain(vals: Optional[torch.Tensor],
                        valid: Optional[torch.Tensor],
                        live_s: torch.Tensor, perm: Optional[torch.Tensor],
                        dtype: torch.dtype,
                        seg_start: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of K14's prefix: the contributions gathered
    through perm, masked, and the reference's `_prefix`, or with seg_start
    the prefix restarted at each partition."""
    n = int(live_s.shape[0])
    idx = None if perm is None else perm.to(torch.int64)

    def take(x):
        return x[:n] if idx is None else x.index_select(0, idx)

    use = live_s if valid is None else live_s & take(valid)
    if vals is None:
        c = use.to(dtype)
    else:
        v = take(vals).to(dtype)
        c = torch.where(use, v, torch.zeros_like(v))
    return _prefix(c) if seg_start is None else _segmented_prefix(
        c, seg_start)


def window_prefix(vals: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor], live_s: torch.Tensor,
                  perm: Optional[torch.Tensor], dtype: torch.dtype,
                  seg_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K14, the prefix: p [n + 1] of dtype (int64 or float64) with
    p[0] = 0 and p[j + 1] = p[j] + c[j] over the n sorted rows, where c[j]
    is vals[perm[j]] (1 without vals, a count) if live_s[j] and
    valid[perm[j]] (every row without valid), else 0; without perm the
    inputs are in sorted order already. With seg_start (the float64 sums
    and averages) the prefix restarts at each partition: p[j + 1] =
    c[seg_start[j]] + ... + c[j]. The reference keeps one whole-batch
    prefix there, and a frame's sum, a difference of two prefixes, then
    loses up to the prefix's rounding (about 2e-7 relative for a small
    first amount of a store at 37.7M rows); inside a partition the
    prefixes stay small."""
    if live_s.device.type == "cpu":
        return window_prefix_plain(vals, valid, live_s, perm, dtype,
                                   seg_start)
    dev = live_s.device
    if dtype not in (torch.int64, torch.float64):
        raise TypeError(f"K14 prefixes are int64 or float64, got {dtype}")
    kernels.require(live_s, "live_s", torch.bool, dev)
    n = int(live_s.shape[0])
    if vals is not None:
        kernels.require(vals, "vals", dtype, dev)
    if valid is not None:
        kernels.require(valid, "valid", torch.bool, dev)
    if perm is not None:
        kernels.require(perm, "perm", torch.int32, dev)
        if perm.shape[0] != n:
            raise ValueError(f"perm of {perm.shape[0]} rows for {n}")
    if seg_start is not None:
        kernels.require(seg_start, "seg_start", torch.int32, dev)
        if seg_start.shape[0] != n:
            raise ValueError(f"seg_start of {seg_start.shape[0]} for {n}")
    for x in (vals, valid):
        if x is not None and x.shape[0] < n:
            raise ValueError(f"{x.shape[0]} input rows for {n}")
    p = torch.empty(n + 1, dtype=dtype, device=dev)
    tiles = -(-n // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles + 1, dtype=dtype, device=dev)
    flags = torch.empty(tiles, dtype=torch.bool, device=dev)
    _build.check(_build.lib().srtpu_window_prefix(
        int(dtype == torch.float64),
        None if vals is None else vals.data_ptr(),
        None if valid is None else valid.data_ptr(), live_s.data_ptr(),
        None if perm is None else perm.data_ptr(),
        None if seg_start is None else seg_start.data_ptr(), n,
        p.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
        kernels.stream_ptr(live_s)), "window_prefix")
    kernels.launches["window_prefix"] += 1
    return p


def inverse_permutation_plain(perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K14's inverse: inv[perm[j]] = j."""
    n = int(perm.shape[0])
    pos = torch.arange(n, dtype=torch.int32, device=perm.device)
    return torch.empty_like(pos).index_copy_(0, perm.to(torch.int64), pos)


#: Rows of one destination window of K14's inverse passes: 32 MiB of
#: int32 (its lines held by evict-last stores in the H100's 50 MB L2).
#: tools/parent_ab.py's sweep on one H100 80GB HBM3 at 700.00 W, ms over
#: random permutations of 37,748,736 / 2^24 rows: 8 MiB 1.373 / 0.458,
#: 16 MiB 1.153 / 0.446, 20 MiB 1.125 / 0.441, 24 MiB 1.054 / 0.431,
#: 28 MiB 1.059 / 0.418, 32 MiB 1.025 / 0.401, 40 MiB 1.046 / 0.408,
#: 48 MiB 1.436 / 0.524 (PERF.md section 6).
INVERSE_WINDOW_ROWS = 8 << 20


def inverse_windows(n: int, rows: int = INVERSE_WINDOW_ROWS):
    """The [lo, hi) destination windows of K14's inverse passes over n
    rows: consecutive windows of `rows`, the last one ragged."""
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Kernel K14, the inverse permutation (the reference's `inv`) that
    K14, K16 and K17 write their results back through: one launch a
    destination window of `inverse_windows` (one call, one count)."""
    if perm.device.type == "cpu":
        return inverse_permutation_plain(perm)
    kernels.require(perm, "perm", torch.int32, perm.device)
    n = int(perm.shape[0])
    inv = torch.empty(n, dtype=torch.int32, device=perm.device)
    lib, sms, stream = (_build.lib(), kernels.sm_count(perm),
                        kernels.stream_ptr(perm))
    for lo, hi in inverse_windows(n):
        _build.check(lib.srtpu_window_inverse(
            perm.data_ptr(), n, inv.data_ptr(), lo, hi, sms, stream),
            "window_inverse")
    kernels.launches["window_inverse"] += 1
    return inv


def _scatter_back(perm: Optional[torch.Tensor], *xs: torch.Tensor):
    """The plain versions' write-back: out[perm[j]] = x[j]."""
    if perm is None:
        return xs
    idx = perm.to(torch.int64)
    return tuple(torch.empty_like(x).index_copy_(0, idx, x) for x in xs)


class WinRequest(NamedTuple):
    """One output of a K14 evaluation: its kernels.WIN_* kind, the frame
    (sums, counts, averages) and the prefixes it reads, or ntile's bucket
    count. A float64 sum's or average's psum restarts at each partition
    (`window_prefix` with seg_start), and its frames lie inside the row's
    partition, as every window frame does."""

    kind: int
    frame: Optional[Frame] = None
    psum: Optional[torch.Tensor] = None   # [n + 1] float64 or int64
    pcnt: Optional[torch.Tensor] = None   # [n + 1] int64
    buckets: int = 0


_RANK_KINDS = (kernels.WIN_ROW_NUMBER, kernels.WIN_RANK,
               kernels.WIN_DENSE_RANK, kernels.WIN_PERCENT_RANK,
               kernels.WIN_CUME_DIST, kernels.WIN_NTILE)


def _out_dtype(req: WinRequest) -> torch.dtype:
    if req.kind in (kernels.WIN_PERCENT_RANK, kernels.WIN_CUME_DIST):
        return torch.float64
    if req.kind in _RANK_KINDS:
        return torch.int32
    if req.kind in (kernels.WIN_SUM_I64, kernels.WIN_COUNT):
        return torch.int64
    return torch.float64


def _rank_plain(sw: SortedWindow, req: WinRequest) -> torch.Tensor:
    """The reference's rank-family arithmetic."""
    n = int(sw.pos.shape[0])
    if req.kind == kernels.WIN_ROW_NUMBER:
        return sw.pos - sw.seg_start + 1
    if req.kind == kernels.WIN_RANK:
        return sw.peer_start - sw.seg_start + 1
    if req.kind == kernels.WIN_DENSE_RANK:
        first = sw.pid.index_select(
            0, sw.seg_start.clamp(0, n - 1).to(torch.int64))
        return sw.pid - first + 1
    if req.kind == kernels.WIN_PERCENT_RANK:
        r = (sw.peer_start - sw.seg_start + 1).to(torch.float64)
        d = (sw.seg_len - 1).clamp(min=1).to(torch.float64)
        return torch.where(sw.seg_len > 1, (r - 1.0) / d,
                           torch.zeros_like(r))
    if req.kind == kernels.WIN_CUME_DIST:
        return ((sw.peer_end - sw.seg_start + 1).to(torch.float64)
                / sw.seg_len.to(torch.float64))
    idx = (sw.pos - sw.seg_start).to(torch.int64)
    size = sw.seg_len.to(torch.int64)
    q = size // req.buckets
    r = size % req.buckets
    threshold = r * (q + 1)
    small = idx // (q + 1).clamp(min=1)
    large = r + (idx - threshold) // q.clamp(min=1)
    return torch.where(idx < threshold, small, large).to(torch.int32) + 1


def window_eval_plain(sw: SortedWindow, reqs: Sequence[WinRequest],
                      perm: Optional[torch.Tensor] = None
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K14's evaluation: the reference's rank and
    frame formulas in sorted order, then, with perm, a scatter of each
    result to its input row."""
    n = int(sw.pos.shape[0])
    dev = sw.pos.device
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    outs = []
    for req in reqs:
        if req.kind in _RANK_KINDS:
            d, v = _rank_plain(sw, req), ones
        else:
            start, end = frame_bounds(sw, req.frame)
            hi = (end.to(torch.int64) + 1).clamp(0, n)
            lo = start.to(torch.int64).clamp(0, n)
            anyrow = end >= start

            at_seg = lo == sw.seg_start.to(torch.int64)

            def diff(p, segmented=False):
                below = p.index_select(0, lo)
                if segmented:  # a partition-restarted float64 prefix
                    below = torch.where(at_seg, torch.zeros_like(below),
                                        below)
                s = p.index_select(0, hi) - below
                return torch.where(anyrow, s, torch.zeros_like(s))

            cnt = (diff(req.pcnt) if req.pcnt is not None
                   else torch.zeros(n, dtype=torch.int64, device=dev))
            if req.kind == kernels.WIN_COUNT:
                d, v = cnt, ones
            elif req.kind == kernels.WIN_AVG:
                d = (diff(req.psum, True)
                     / cnt.clamp(min=1).to(torch.float64))
                v = cnt > 0
            else:
                d = diff(req.psum, req.kind == kernels.WIN_SUM_F64)
                v = cnt > 0
        outs.append(_scatter_back(perm, d.to(_out_dtype(req)), v))
    return outs


#: K14's row record: one 32-byte sector (16 bytes where they suffice)
WIN_RECORD_BYTES = 32
#: outputs whose validity is data's (a sum's or an average's count > 0);
#: every other output is always valid
_VALIDITY_KINDS = (kernels.WIN_SUM_F64, kernels.WIN_SUM_I64,
                   kernels.WIN_AVG)


class RecordLayout(NamedTuple):
    """Where K14's sorted pass parks one launch's outputs for its gather
    (WinOut.slot in csrc/window_frames.cu): each output's byte offset in
    its row's records (offset // 32 the record), the validity word's (-1
    where every output is always valid), the record count and each
    record's 32-bit words (4 or 8)."""

    slots: Tuple[int, ...]
    valid_slot: int
    records: int
    words: int


def record_layout(kinds: Sequence[int]) -> RecordLayout:
    """The records of one launch's outputs (at most MAX_WIN_OUTS): 8-byte
    values first, then 4-byte ones, then the validity word (a bit an
    output), packed in order into 32-byte records, so 8-byte values stay
    8-byte aligned, nothing straddles a record and the validity word lies
    in the last record; 16-byte records where everything fits one."""
    if not 1 <= len(kinds) <= kernels.MAX_WIN_OUTS:
        raise ValueError(f"{len(kinds)} outputs in one launch")
    sizes = [4 if k in _RANK_KINDS and k not in (
        kernels.WIN_PERCENT_RANK, kernels.WIN_CUME_DIST) else 8
        for k in kinds]
    order = sorted(range(len(kinds)), key=lambda k: -sizes[k])
    slots = [0] * len(kinds)
    at = 0
    for k in order:
        if at % WIN_RECORD_BYTES + sizes[k] > WIN_RECORD_BYTES:
            at += WIN_RECORD_BYTES - at % WIN_RECORD_BYTES
        slots[k] = at
        at += sizes[k]
    valid_slot = -1
    if any(k in _VALIDITY_KINDS for k in kinds):
        if at % WIN_RECORD_BYTES + 4 > WIN_RECORD_BYTES:
            at += WIN_RECORD_BYTES - at % WIN_RECORD_BYTES
        valid_slot = at
        at += 4
    records = -(-at // WIN_RECORD_BYTES)
    words = 4 if at <= 16 else WIN_RECORD_BYTES // 4
    return RecordLayout(tuple(slots), valid_slot, records, words)


def window_eval(sw: SortedWindow, reqs: Sequence[WinRequest],
                perm: Optional[torch.Tensor] = None,
                inv: Optional[torch.Tensor] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Kernel K14, the evaluation: (data, validity) of every request, in
    sorted order, or with perm at each sorted row's input row (out[perm[j]]
    = v[j]; `inv`, perm's inverse, when the caller has it), up to eight
    outputs a call of the kernel: in sorted order one launch; with perm
    two (the sorted pass packs each row's results into records, the
    gather writes them through inv), one count."""
    if sw.pos.device.type == "cpu":
        return window_eval_plain(sw, reqs, perm)
    dev = sw.pos.device
    n = int(sw.pos.shape[0])
    bounds = _check_bounds(sw, n)
    kernels.require(sw.pid, "pid", torch.int32, dev)
    if perm is not None and inv is None:
        inv = inverse_permutation(perm)
    if inv is not None:
        kernels.require(inv, "inv", torch.int32, dev)
    outs, frames = [], []
    for req in reqs:
        d = torch.empty(n, dtype=_out_dtype(req), device=dev)
        v = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((d, v))
        fr = req.frame or Frame(kernels.WIN_SEG, kernels.WIN_SEG)
        if req.kind == kernels.WIN_NTILE:
            if req.buckets < 1:
                raise ValueError(f"ntile({req.buckets})")
            fr = fr._replace(lower=req.buckets)
        elif req.kind not in _RANK_KINDS:
            if req.kind != kernels.WIN_COUNT:
                want = (torch.int64 if req.kind == kernels.WIN_SUM_I64
                        else torch.float64)
                kernels.require(req.psum, "psum", want, dev)
            if req.pcnt is not None:
                kernels.require(req.pcnt, "pcnt", torch.int64, dev)
            elif req.kind in (kernels.WIN_COUNT, kernels.WIN_AVG):
                raise ValueError("counts and averages need a count prefix")
            for x in (req.psum, req.pcnt):
                if x is not None and x.shape[0] != n + 1:
                    raise ValueError(f"prefix of {x.shape[0]} for {n} rows")
            _check_frame(fr, dev, n)
        frames.append(fr)
    lib = _build.lib()
    for lo in range(0, len(reqs), kernels.MAX_WIN_OUTS):
        hi = min(len(reqs), lo + kernels.MAX_WIN_OUTS)
        layout = None if inv is None else record_layout(
            [r.kind for r in reqs[lo:hi]])
        rec = None if layout is None else torch.empty(
            layout.records * n * layout.words, dtype=torch.int32, device=dev)
        descs = []
        for k in range(lo, hi):
            req, fr, (d, v) = reqs[k], frames[k], outs[k]
            descs.append(kernels.WinOut(
                req.kind, fr.start_kind, fr.end_kind,
                -1 if layout is None else layout.slots[k - lo],
                int(fr.lower), int(fr.upper),
                None if fr.start is None else fr.start.data_ptr(),
                None if fr.end is None else fr.end.data_ptr(),
                None if req.psum is None else req.psum.data_ptr(),
                None if req.pcnt is None else req.pcnt.data_ptr(),
                d.data_ptr(), v.data_ptr()))
        ptr, _arr = kernels.struct_array(kernels.WinOut, descs)
        _build.check(lib.srtpu_window_eval(
            ptr, len(descs), n, *[x.data_ptr() for x in bounds],
            sw.pid.data_ptr(), None if inv is None else inv.data_ptr(),
            None if rec is None else rec.data_ptr(),
            0 if layout is None else layout.words,
            0 if layout is None else layout.records,
            -1 if layout is None else layout.valid_slot,
            kernels.sm_count(sw.pos), kernels.stream_ptr(sw.pos)),
            "window_eval")
        kernels.launches["window_eval"] += 1
    return outs


# ------------------------------------------------------------------ K16

_I64 = torch.iinfo(torch.int64)
_F64_NAN_KEY = 0x7FF8000000000000
_F32_NAN_KEY = 0x7FC00000


def _mm_ident(dtype: torch.dtype, is_max: bool):
    """The reference's identity: -inf/+inf, the integer min/max, or for
    booleans (taken as int32) 0/1."""
    if dtype == torch.bool:
        return 0 if is_max else 1
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _mm_keys(v: torch.Tensor, use: torch.Tensor, is_max: bool
             ) -> torch.Tensor:
    """K16's int64 order keys: an integer's value, a float's total-order
    bits (NaN canonical, above +inf); a row not in `use` takes the
    identity's key, for floats INT64_MIN (MAX) / INT64_MAX (MIN)."""
    if v.dtype.is_floating_point:
        bits_t, nan, width = ((torch.int64, _F64_NAN_KEY, 64)
                              if v.dtype == torch.float64
                              else (torch.int32, _F32_NAN_KEY, 32))
        b = torch.where(torch.isnan(v), torch.full_like(v.view(bits_t), nan),
                        v.view(bits_t))
        k = (b ^ ((b >> (width - 1)) & torch.iinfo(bits_t).max)).to(
            torch.int64)
        off = _I64.min if is_max else _I64.max
    else:
        k = v.to(torch.int64)
        off = _mm_ident(v.dtype, is_max)
    return torch.where(use, k, torch.full_like(k, off))


def _mm_values(r: torch.Tensor, empty: torch.Tensor, dtype: torch.dtype,
               is_max: bool) -> torch.Tensor:
    """Keys back to values: the identity for an empty frame; for floats
    -inf where no valid row was seen under MAX and the canonical NaN for
    a NaN key or above (MIN with no valid non-NaN value)."""
    if not dtype.is_floating_point:
        ident = torch.full_like(r, _mm_ident(dtype, is_max))
        out = torch.where(empty, ident, r)
        return out != 0 if dtype == torch.bool else out.to(dtype)
    if dtype == torch.float64:
        bits_t, nan, width = torch.int64, _F64_NAN_KEY, 64
    else:
        bits_t, nan, width = torch.int32, _F32_NAN_KEY, 32
    info = torch.iinfo(bits_t)
    kk = r.clamp(info.min, info.max).to(bits_t)
    b = kk ^ ((kk >> (width - 1)) & info.max)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype).view(bits_t).item()
    ident = torch.tensor(_mm_ident(dtype, is_max), dtype=dtype).view(
        bits_t).item()
    b = torch.where(r >= nan, torch.full_like(b, nan), b)
    b = torch.where(r == _I64.min, torch.full_like(b, neg_inf), b)
    b = torch.where(empty, torch.full_like(b, ident), b)
    return b.view(dtype)


def frame_minmax_plain(vals: torch.Tensor, valid: Optional[torch.Tensor],
                       sw: SortedWindow, fr: Frame, is_max: bool,
                       pcnt: Optional[torch.Tensor] = None,
                       perm: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K16: the reference's `_sparse_table` (a
    [log2(n) + 1, n] doubling table) and its two lookups a row, over
    K16's order keys, so floats keep the reference's NaN and -0.0 rules;
    then, with perm, a scatter of each result to its input row."""
    n = int(sw.pos.shape[0])
    idx = None if perm is None else perm.to(torch.int64)

    def take(x):
        return x[:n] if idx is None else x.index_select(0, idx)

    use = sw.live if valid is None else sw.live & take(valid)
    keys = _mm_keys(take(vals), use, is_max)
    ext = torch.maximum if is_max else torch.minimum
    neutral = _I64.min if is_max else _I64.max
    table = [keys]
    step = 1
    while step < n:
        prev = table[-1]
        shifted = torch.cat([prev[step:], torch.full((step,), neutral,
                                                     dtype=torch.int64,
                                                     device=keys.device)])
        table.append(ext(prev, shifted))
        step <<= 1
    table = torch.stack(table)
    start, end = (x.to(torch.int64) for x in frame_bounds(sw, fr))
    length = (end - start + 1).clamp(min=1)
    k = torch.frexp(length.to(torch.float64)).exponent.to(torch.int64) - 1
    flat = table.reshape(-1)
    left = flat.index_select(0, k * n + start.clamp(0, n - 1))
    right = flat.index_select(
        0, k * n + (end - (torch.ones_like(k) << k) + 1).clamp(0, n - 1))
    empty = end < start
    data = _mm_values(ext(left, right), empty, vals.dtype, is_max)
    if pcnt is None:
        return _scatter_back(perm, data)[0], None
    hi, lo = (end + 1).clamp(0, n), start.clamp(0, n)
    cnt = pcnt.index_select(0, hi) - pcnt.index_select(0, lo)
    return _scatter_back(perm, data, (cnt > 0) & ~empty)


class MinmaxPlan(NamedTuple):
    """K16's scratch over n sorted rows (csrc/frame_minmax.cu): the keys,
    one extremum a 32-row subtile, a sparse table of `levels` levels over
    the 1,024-row blocks and, when the results are gathered through inv,
    a 16-byte pair a row; `words` int64 words in all."""

    subtiles: int
    blocks: int
    levels: int
    words: int


#: rows of K16's blocks (kMmBlockRows in csrc/frame_minmax.cu)
MINMAX_BLOCK_ROWS = 1024


def minmax_plan(n: int, pairs: bool) -> MinmaxPlan:
    """K16's scratch layout over n >= 1 rows (mm_levels and the offsets
    of srtpu_frame_minmax): keys [n], subtile extrema [ceil(n / 32)],
    levels = the bit length of the block count, each [blocks], then the
    pairs [2n] from an even word."""
    subtiles = -(-n // 32)
    blocks = -(-n // MINMAX_BLOCK_ROWS)
    levels = blocks.bit_length()
    words = n + subtiles + levels * blocks
    if pairs:
        words = (words + 1) // 2 * 2 + 2 * n
    return MinmaxPlan(subtiles, blocks, levels, words)


def frame_minmax_eval(vals: torch.Tensor, valid: Optional[torch.Tensor],
                      sw: SortedWindow, fr: Frame, is_max: bool,
                      pcnt: Optional[torch.Tensor] = None,
                      perm: Optional[torch.Tensor] = None,
                      inv: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K16: MIN (MAX) of every sorted row's frame over the live
    rows where `valid` holds (None: every row), with the reference's
    identity for an empty frame and its float rules; with `pcnt` (K14's
    count prefix of the valid live rows) also the validity, the frame's
    count > 0. Values are read through perm and results written at input
    rows (through `inv`, perm's inverse, computed here when the caller
    has none); without perm both are in sorted order. With perm and
    pcnt the kernel reads "valid and live" from pcnt instead of gathering
    valid through perm."""
    if sw.pos.device.type == "cpu":
        return frame_minmax_plain(vals, valid, sw, fr, is_max, pcnt, perm)
    dev = sw.pos.device
    n = int(sw.pos.shape[0])
    kind = kernels.MINMAX_TYPES.get(vals.dtype)
    if kind is None:
        raise TypeError(f"K16 takes integer, float or bool values, got "
                        f"{vals.dtype}")
    kernels.require(vals, "vals", vals.dtype, dev)
    if valid is not None:
        kernels.require(valid, "valid", torch.bool, dev)
    kernels.require(sw.live, "live_s", torch.bool, dev)
    bounds = _check_bounds(sw, n)
    _check_frame(fr, dev, n)
    if perm is not None:
        kernels.require(perm, "perm", torch.int32, dev)
        if inv is None:
            inv = inverse_permutation(perm)
        kernels.require(inv, "inv", torch.int32, dev)
    elif vals.shape[0] < n:
        raise ValueError(f"{vals.shape[0]} values for {n} rows")
    if pcnt is not None:
        kernels.require(pcnt, "pcnt", torch.int64, dev)
        if pcnt.shape[0] != n + 1:
            raise ValueError(f"prefix of {pcnt.shape[0]} for {n} rows")
    scratch = torch.empty(minmax_plan(n, perm is not None).words,
                          dtype=torch.int64, device=dev)
    out = torch.empty(n, dtype=vals.dtype, device=dev)
    out_valid = (None if pcnt is None
                 else torch.empty(n, dtype=torch.bool, device=dev))
    frame = fr.struct()
    _build.check(_build.lib().srtpu_frame_minmax(
        kind, int(is_max), vals.data_ptr(),
        None if valid is None else valid.data_ptr(), sw.live.data_ptr(),
        None if perm is None else perm.data_ptr(), n,
        ctypes.addressof(frame), *[x.data_ptr() for x in bounds],
        None if pcnt is None else pcnt.data_ptr(),
        None if inv is None else inv.data_ptr(), out.data_ptr(),
        None if out_valid is None else out_valid.data_ptr(),
        scratch.data_ptr(), kernels.sm_count(vals),
        kernels.stream_ptr(vals)), "frame_minmax")
    kernels.launches["frame_minmax"] += 1
    return out, out_valid


# ------------------------------------------------------------------ K17

class Pick(NamedTuple):
    """One output of a K17 launch: its kernels.PICK_* kind, the frame of a
    first/last pick, the signed offset of a shift (lead; lag negated),
    and the count prefix of valid live rows an ignore-nulls pick
    searches."""

    kind: int
    frame: Optional[Frame] = None
    offset: int = 0
    pcnt: Optional[torch.Tensor] = None


def frame_pick_plain(sw: SortedWindow, picks: Sequence[Pick],
                     perm: Optional[torch.Tensor] = None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K17: the reference's positions (the frame
    side, a search of the count prefix, pos + offset), then the input row
    through perm and, with perm, a scatter to the input rows."""
    n = int(sw.pos.shape[0])
    pos = sw.pos.to(torch.int64)
    outs = []
    for pk in picks:
        if pk.kind == kernels.PICK_SHIFT:
            t = pos + pk.offset
            has = (t >= sw.seg_start) & (t <= sw.seg_end)
            p = t
        else:
            start, end = (x.to(torch.int64) for x in frame_bounds(sw,
                                                                  pk.frame))
            has = end >= start
            last = pk.kind in (kernels.PICK_LAST, kernels.PICK_LAST_VALID)
            if pk.kind in (kernels.PICK_FIRST, kernels.PICK_LAST):
                p = torch.where(has, end if last else start,
                                torch.zeros_like(start))
            else:
                lo, hi = start.clamp(0, n), (end + 1).clamp(0, n)
                before = pk.pcnt.index_select(0, lo)
                upto = pk.pcnt.index_select(0, hi)
                has = has & (upto > before)
                target = upto if last else before + 1
                a, b = lo.clone(), (hi - 1).clamp(min=0)
                for _ in range(n.bit_length() + 1):
                    active = a < b
                    mid = (a + b) >> 1
                    below = pk.pcnt.index_select(0, (mid + 1).clamp(0, n)) \
                        < target
                    a = torch.where(active & below, mid + 1, a)
                    b = torch.where(active & ~below, mid, b)
                p = torch.where(has, a, lo)
        p = p.clamp(0, n - 1)
        src = (p if perm is None else perm.to(torch.int64).index_select(
            0, p)).to(torch.int32)
        outs.append(_scatter_back(perm, src, has))
    return outs


def frame_pick(sw: SortedWindow, picks: Sequence[Pick],
               perm: Optional[torch.Tensor] = None,
               inv: Optional[torch.Tensor] = None
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Kernel K17: for each pick, (src, has) of every row: the row its
    value comes from (the input row perm[p] of sorted position p; p
    without perm) and whether it has one. first/last: the frame's first
    (last) row, or with an ignore-nulls kind its first (last) valid live
    row; a shift: the row `offset` rows on, inside the partition. With
    perm the results land at input rows (`inv`, perm's inverse, when the
    caller has it), up to eight picks a launch. K8 gathers the values."""
    if sw.pos.device.type == "cpu":
        return frame_pick_plain(sw, picks, perm)
    dev = sw.pos.device
    n = int(sw.pos.shape[0])
    bounds = _check_bounds(sw, n)
    if perm is not None:
        kernels.require(perm, "perm", torch.int32, dev)
        if inv is None:
            inv = inverse_permutation(perm)
    if inv is not None:
        kernels.require(inv, "inv", torch.int32, dev)
    outs, descs = [], []
    for pk in picks:
        src = torch.empty(n, dtype=torch.int32, device=dev)
        has = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((src, has))
        fr = pk.frame or Frame(kernels.WIN_SEG, kernels.WIN_SEG)
        _check_frame(fr, dev, n)
        if pk.kind in (kernels.PICK_FIRST_VALID, kernels.PICK_LAST_VALID):
            kernels.require(pk.pcnt, "pcnt", torch.int64, dev)
            if pk.pcnt.shape[0] != n + 1:
                raise ValueError(f"prefix of {pk.pcnt.shape[0]} for {n}")
        descs.append(kernels.PickOut(
            pk.kind, 0, fr.struct(), int(pk.offset),
            None if pk.pcnt is None else pk.pcnt.data_ptr(),
            src.data_ptr(), has.data_ptr()))
    lib = _build.lib()
    for lo in range(0, len(descs), kernels.MAX_PICK_OUTS):
        chunk = descs[lo:lo + kernels.MAX_PICK_OUTS]
        ptr, _arr = kernels.struct_array(kernels.PickOut, chunk)
        _build.check(lib.srtpu_frame_pick(
            ptr, len(chunk), n, *[x.data_ptr() for x in bounds],
            None if perm is None else perm.data_ptr(),
            None if inv is None else inv.data_ptr(),
            kernels.sm_count(sw.pos), kernels.stream_ptr(sw.pos)),
            "frame_pick")
        kernels.launches["frame_pick"] += 1
    return outs


# --------------------------------------------------- frame aggregations

def _given(start, end) -> Frame:
    return Frame(kernels.WIN_GIVEN, kernels.WIN_GIVEN, start=start, end=end)


def frame_count(valid: torch.Tensor, sw: SortedWindow, start, end
                ) -> torch.Tensor:
    """COUNT over frames: number of valid live rows in [start, end]."""
    p = window_prefix(None, valid, sw.live, None, torch.int64)
    return window_eval(sw, [WinRequest(kernels.WIN_COUNT, _given(start, end),
                                       pcnt=p)])[0][0]


def frame_sum(vals: torch.Tensor, valid: torch.Tensor, sw: SortedWindow,
              start, end, acc_dtype: torch.dtype) -> torch.Tensor:
    """SUM over frames inside each row's partition; float64 sums from the
    partition-restarted prefix."""
    f64 = acc_dtype == torch.float64
    p = window_prefix(vals.to(acc_dtype), valid, sw.live, None, acc_dtype,
                      sw.seg_start if f64 else None)
    kind = (kernels.WIN_SUM_F64 if acc_dtype == torch.float64
            else kernels.WIN_SUM_I64)
    return window_eval(sw, [WinRequest(kind, _given(start, end),
                                       psum=p)])[0][0]


def frame_minmax(vals: torch.Tensor, valid: torch.Tensor, sw: SortedWindow,
                 start, end, maximum: bool) -> torch.Tensor:
    """MIN/MAX over frames of sorted values (K16); booleans come back as
    booleans, where the reference returns the int32 it computes in."""
    return frame_minmax_eval(vals, valid, sw, _given(start, end),
                             maximum)[0]


def frame_first_last(vals: torch.Tensor, valid: torch.Tensor,
                     sw: SortedWindow, start, end, last: bool,
                     ignore_nulls: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """first_value/last_value over frames of sorted values; returns
    (values, validity): K17's source rows and K8's gather."""
    if ignore_nulls:
        kind = kernels.PICK_LAST_VALID if last else kernels.PICK_FIRST_VALID
        pcnt = window_prefix(None, valid, sw.live, None, torch.int64)
    else:
        kind = kernels.PICK_LAST if last else kernels.PICK_FIRST
        pcnt = None
    src, has = frame_pick(sw, [Pick(kind, _given(start, end),
                                    pcnt=pcnt)])[0]
    v, ok = gather_leaves([vals, valid], [src, src])
    return v, ok & has


def lead_lag(vals: torch.Tensor, valid: torch.Tensor, sw: SortedWindow,
             offset: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """lead(+offset)/lag(-offset) of sorted values -> (values, validity,
    inside_partition); out-of-partition rows take the caller's default."""
    src, inside = frame_pick(sw, [Pick(kernels.PICK_SHIFT,
                                       offset=offset)])[0]
    v, ok = gather_leaves([vals, valid], [src, src])
    return v, ok & inside, inside


# --------------------------------------------------------- ranking family

def _rank_of(sw: SortedWindow, kind: int, buckets: int = 0) -> torch.Tensor:
    return window_eval(sw, [WinRequest(kind, buckets=buckets)])[0][0]


def row_number(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_ROW_NUMBER)


def rank(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_RANK)


def dense_rank(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_DENSE_RANK)


def percent_rank(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_PERCENT_RANK)


def cume_dist(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_CUME_DIST)


def ntile(sw: SortedWindow, n: int) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_NTILE, n)


# ------------------------------------------------------------------ K33

def _nan_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b, NaN equal to NaN for floating values."""
    eq = a == b
    if a.dtype.is_floating_point:
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq


def frame_collect_plain(vals: torch.Tensor, valid: torch.Tensor,
                        sw: SortedWindow, lower: int, upper: int,
                        distinct: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K33: the reference's `frame_collect` (a
    [cap, W] take of each frame through the permutation, the duplicate
    test of a set with NaN equal to NaN, a left-pack of the kept slots in
    order), its dropped slots zeroed, written back to input order."""
    n = int(sw.pos.shape[0])
    width = int(upper) - int(lower) + 1
    start, end = rows_frame_bounds(sw, int(lower), int(upper))
    idx = start.to(torch.int64)[:, None] + torch.arange(
        width, dtype=torch.int64, device=vals.device)[None, :]
    inside = idx <= end.to(torch.int64)[:, None]
    safe = idx.clamp(0, max(n - 1, 0))
    src = sw.perm.to(torch.int64)[safe]
    elem = vals[src]
    ok = inside & valid[src] & sw.live[safe]
    if distinct:
        dup = torch.zeros_like(ok)
        for j in range(1, width):
            prev = _nan_eq(elem[:, :j], elem[:, j:j + 1]) & ok[:, :j]
            dup[:, j] = prev.any(dim=1)
        ok = ok & ~dup
    from spark_rapids_tpu_torch.expr.collections import _left_pack

    packed, kept = _left_pack(elem, ok), _left_pack(ok, ok)
    lengths = ok.sum(dim=1).to(torch.int32)
    dst = sw.perm.to(torch.int64)
    out = torch.empty_like(packed)
    out_ev = torch.empty_like(kept)
    out_len = torch.empty_like(lengths)
    out[dst], out_ev[dst], out_len[dst] = packed, kept, lengths
    return out, out_ev, out_len


def frame_collect(vals: torch.Tensor, valid: torch.Tensor,
                  sw: SortedWindow, lower: int, upper: int, distinct: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K33: collect_list (or, with `distinct`, collect_set) of each
    row's ROWS BETWEEN lower AND upper frame (both bounded, W = upper -
    lower + 1 <= 1,024): (data [cap, W], elem_validity [cap, W], lengths
    [cap]) at each row's input position, the frame's valid values of
    live rows left-packed in frame order, a set keeping first occurrences
    (NaN equal to NaN). vals and valid are in input order; the rows are
    read through sw.perm."""
    if vals.device.type == "cpu":
        return frame_collect_plain(vals, valid, sw, lower, upper, distinct)
    dev = vals.device
    width = int(upper) - int(lower) + 1
    if not 1 <= width <= 1024:
        raise ValueError(f"K33 takes frames of 1 to 1,024 rows, not {width}")
    kind = kernels.ELEM_KINDS.get(vals.dtype)
    if kind is None or vals.dim() != 1:
        raise TypeError(f"K33 collects flat scalar values, not "
                        f"{vals.dtype} of {vals.dim()} dims")
    n = int(vals.shape[0])
    vals, valid = vals.contiguous(), valid.contiguous()
    kernels.require(vals, "vals", vals.dtype, dev)
    kernels.require(valid, "valid", torch.bool, dev)
    for name, x in (("live", sw.live), ("perm", sw.perm),
                    ("seg_start", sw.seg_start), ("seg_end", sw.seg_end)):
        kernels.require(x, name, torch.bool if name == "live"
                        else torch.int32, dev)
        if x.shape[0] != n:
            raise ValueError(f"{name} of {x.shape[0]} rows for {n}")
    out = torch.empty((n, width), dtype=vals.dtype, device=dev)
    out_ev = torch.empty((n, width), dtype=torch.bool, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    _build.check(_build.lib().srtpu_frame_collect(
        vals.data_ptr(), kind, valid.data_ptr(), sw.live.data_ptr(),
        sw.perm.data_ptr(), sw.seg_start.data_ptr(), sw.seg_end.data_ptr(),
        n, int(lower), int(upper), width, int(distinct), out.data_ptr(),
        out_ev.data_ptr(), out_len.data_ptr(), kernels.sm_count(vals),
        kernels.stream_ptr(vals)), "frame_collect")
    kernels.launches["frame_collect"] += 1
    return out, out_ev, out_len
