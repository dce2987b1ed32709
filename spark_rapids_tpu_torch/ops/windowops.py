"""Window evaluation over a (partition, order)-sorted domain — the part of
`spark_rapids_tpu/ops/windowops.py` that the port's slice runs.

As in the reference, the window family rests on a few primitives:

1. segment structure: one stable multi-key sort (kernel K9) puts
   partitions contiguous; the partition and peer-run ids come from the
   sorted key words (K10), their bounds from segmented min/max (K12);
2. prefix sums answer every sum/count/avg frame in O(1) a row;
3. results go back to input order, since window operators preserve their
   input rows.

Kernel K14 (kernels/csrc/window_frames.cu) does 2 and 3 and the rank
family: `window_prefix` takes the inclusive prefix of a contribution
vector read through the sort permutation, and `window_eval` computes up to
eight outputs a launch (row_number, rank, dense_rank, frame sums, counts
and averages) and writes each at its input row: it scatters the inverse
permutation once, then evaluates input row i from sorted row inv[i] (the
reference's inverse-permutation scatter followed by a take).
`frame_count`, `frame_sum`, `row_number`, `rank` and `dense_rank` keep
the reference's sorted-domain shapes on top of them.

Frames are inclusive position ranges [start, end] in the sorted domain:
the default frame and ROWS frames (offsets clipped to the partition).
RANGE frames (`range_frame_bounds`), min/max frames (`_sparse_table`,
`frame_minmax`), first/last/collect frames, percent_rank, cume_dist,
ntile and lead/lag are not ported yet (ROADMAP A11b).
"""

from __future__ import annotations

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

#: ROADMAP item of the window features this slice does not port
NOT_PORTED = "A11b"


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
    """Where a frame starts and ends, as K14 takes it: each side a
    kernels.WIN_* bound kind, the offset of a WIN_OFFSET side, or the
    [cap] int32 positions of a WIN_GIVEN side."""

    start_kind: int
    end_kind: int
    lower: int = 0
    upper: int = 0
    start: Optional[torch.Tensor] = None
    end: Optional[torch.Tensor] = None


def frame_of(frame, has_order: bool) -> Frame:
    """The K14 frame of a window spec's frame (expr/windows.WindowFrame,
    None for Spark's implicit one): RANGE UNBOUNDED PRECEDING..CURRENT
    ROW when ordered, the whole partition otherwise; ROWS offsets clip to
    the partition. Explicit RANGE frames raise (ROADMAP A11b)."""
    if frame is None:
        return Frame(kernels.WIN_SEG,
                     kernels.WIN_PEER if has_order else kernels.WIN_SEG)
    if frame.frame_type != "rows":
        raise NotImplementedError(
            f"RANGE frames ({frame!r}) are not ported yet (ROADMAP "
            f"{NOT_PORTED})")
    return Frame(
        kernels.WIN_SEG if frame.lower is None else kernels.WIN_OFFSET,
        kernels.WIN_SEG if frame.upper is None else kernels.WIN_OFFSET,
        0 if frame.lower is None else int(frame.lower),
        0 if frame.upper is None else int(frame.upper))


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


# ------------------------------------------------------------------ K14

def _prefix(vals: torch.Tensor) -> torch.Tensor:
    """The reference's prefix: p[i] = sum(vals[:i]), length cap + 1, so
    frame sums are p[end + 1] - p[start]."""
    z = torch.zeros(1, dtype=vals.dtype, device=vals.device)
    return torch.cat([z, torch.cumsum(vals, 0, dtype=vals.dtype)])


def window_prefix_plain(vals: Optional[torch.Tensor],
                        valid: Optional[torch.Tensor],
                        live_s: torch.Tensor, perm: Optional[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K14's prefix: the contributions gathered
    through perm, masked, and the reference's `_prefix`."""
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
    return _prefix(c)


def window_prefix(vals: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor], live_s: torch.Tensor,
                  perm: Optional[torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
    """Kernel K14, the prefix: p [n + 1] of dtype (int64 or float64) with
    p[0] = 0 and p[j + 1] = p[j] + c[j] over the n sorted rows, where c[j]
    is vals[perm[j]] (1 without vals, a count) if live_s[j] and
    valid[perm[j]] (every row without valid), else 0; without perm the
    inputs are in sorted order already."""
    if live_s.device.type == "cpu":
        return window_prefix_plain(vals, valid, live_s, perm, dtype)
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
    for x in (vals, valid):
        if x is not None and x.shape[0] < n:
            raise ValueError(f"{x.shape[0]} input rows for {n}")
    p = torch.empty(n + 1, dtype=dtype, device=dev)
    tiles = -(-n // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles + 1, dtype=dtype, device=dev)
    _build.check(_build.lib().srtpu_window_prefix(
        int(dtype == torch.float64),
        None if vals is None else vals.data_ptr(),
        None if valid is None else valid.data_ptr(), live_s.data_ptr(),
        None if perm is None else perm.data_ptr(), n, p.data_ptr(),
        scratch.data_ptr(), kernels.stream_ptr(live_s)), "window_prefix")
    kernels.launches["window_prefix"] += 1
    return p


class WinRequest(NamedTuple):
    """One output of a K14 evaluation: its kernels.WIN_* kind, the frame
    (sums, counts, averages) and the prefixes it reads."""

    kind: int
    frame: Optional[Frame] = None
    psum: Optional[torch.Tensor] = None   # [n + 1] float64 or int64
    pcnt: Optional[torch.Tensor] = None   # [n + 1] int64


_RANK_KINDS = (kernels.WIN_ROW_NUMBER, kernels.WIN_RANK,
               kernels.WIN_DENSE_RANK)


def _out_dtype(req: WinRequest) -> torch.dtype:
    if req.kind in _RANK_KINDS:
        return torch.int32
    if req.kind in (kernels.WIN_SUM_I64, kernels.WIN_COUNT):
        return torch.int64
    return torch.float64


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
        if req.kind == kernels.WIN_ROW_NUMBER:
            d, v = sw.pos - sw.seg_start + 1, ones
        elif req.kind == kernels.WIN_RANK:
            d, v = sw.peer_start - sw.seg_start + 1, ones
        elif req.kind == kernels.WIN_DENSE_RANK:
            first = sw.pid.index_select(
                0, sw.seg_start.clamp(0, n - 1).to(torch.int64))
            d, v = sw.pid - first + 1, ones
        else:
            start, end = frame_bounds(sw, req.frame)
            hi = (end.to(torch.int64) + 1).clamp(0, n)
            lo = start.to(torch.int64).clamp(0, n)
            anyrow = end >= start

            def diff(p):
                s = p.index_select(0, hi) - p.index_select(0, lo)
                return torch.where(anyrow, s, torch.zeros_like(s))

            cnt = (diff(req.pcnt) if req.pcnt is not None
                   else torch.zeros(n, dtype=torch.int64, device=dev))
            if req.kind == kernels.WIN_COUNT:
                d, v = cnt, ones
            elif req.kind == kernels.WIN_AVG:
                d = diff(req.psum) / cnt.clamp(min=1).to(torch.float64)
                v = cnt > 0
            else:
                d, v = diff(req.psum), cnt > 0
        d = d.to(_out_dtype(req))
        if perm is not None:
            idx = perm.to(torch.int64)
            d = torch.empty_like(d).index_copy_(0, idx, d)
            v = torch.empty_like(v).index_copy_(0, idx, v)
        outs.append((d, v))
    return outs


def window_eval(sw: SortedWindow, reqs: Sequence[WinRequest],
                perm: Optional[torch.Tensor] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Kernel K14, the evaluation: (data, validity) of every request, in
    sorted order, or with perm at each sorted row's input row (out[perm[j]]
    = v[j]), up to eight outputs a launch."""
    if sw.pos.device.type == "cpu":
        return window_eval_plain(sw, reqs, perm)
    dev = sw.pos.device
    n = int(sw.pos.shape[0])
    bounds = (sw.seg_start, sw.seg_end, sw.peer_start, sw.peer_end, sw.pid)
    for name, x in zip(("seg_start", "seg_end", "peer_start", "peer_end",
                        "pid"), bounds):
        kernels.require(x, name, torch.int32, dev)
        if x.shape[0] != n:
            raise ValueError(f"{name} of {x.shape[0]} rows for {n}")
    if perm is not None:
        kernels.require(perm, "perm", torch.int32, dev)
    outs, descs = [], []
    for req in reqs:
        d = torch.empty(n, dtype=_out_dtype(req), device=dev)
        v = torch.empty(n, dtype=torch.bool, device=dev)
        outs.append((d, v))
        fr = req.frame or Frame(kernels.WIN_SEG, kernels.WIN_SEG)
        if req.kind not in _RANK_KINDS:
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
            for x in (fr.start, fr.end):
                if x is not None:
                    kernels.require(x, "frame bound", torch.int32, dev)
        descs.append(kernels.WinOut(
            req.kind, fr.start_kind, fr.end_kind, 0, int(fr.lower),
            int(fr.upper),
            None if fr.start is None else fr.start.data_ptr(),
            None if fr.end is None else fr.end.data_ptr(),
            None if req.psum is None else req.psum.data_ptr(),
            None if req.pcnt is None else req.pcnt.data_ptr(),
            d.data_ptr(), v.data_ptr()))
    lib = _build.lib()
    inv = None if perm is None else torch.empty(n, dtype=torch.int32,
                                                device=dev)
    for lo in range(0, len(descs), kernels.MAX_WIN_OUTS):
        chunk = descs[lo:lo + kernels.MAX_WIN_OUTS]
        ptr, _arr = kernels.struct_array(kernels.WinOut, chunk)
        _build.check(lib.srtpu_window_eval(
            ptr, len(chunk), n, *[x.data_ptr() for x in bounds],
            None if perm is None else perm.data_ptr(),
            None if inv is None else inv.data_ptr(), int(lo == 0),
            kernels.sm_count(sw.pos), kernels.stream_ptr(sw.pos)),
            "window_eval")
        kernels.launches["window_eval"] += 1
    return outs


# --------------------------------------------------- frame aggregations

def frame_count(valid: torch.Tensor, sw: SortedWindow, start, end
                ) -> torch.Tensor:
    """COUNT over frames: number of valid live rows in [start, end]."""
    p = window_prefix(None, valid, sw.live, None, torch.int64)
    fr = Frame(kernels.WIN_GIVEN, kernels.WIN_GIVEN, start=start, end=end)
    return window_eval(sw, [WinRequest(kernels.WIN_COUNT, fr, pcnt=p)])[0][0]


def frame_sum(vals: torch.Tensor, valid: torch.Tensor, sw: SortedWindow,
              start, end, acc_dtype: torch.dtype) -> torch.Tensor:
    p = window_prefix(vals.to(acc_dtype), valid, sw.live, None, acc_dtype)
    fr = Frame(kernels.WIN_GIVEN, kernels.WIN_GIVEN, start=start, end=end)
    kind = (kernels.WIN_SUM_F64 if acc_dtype == torch.float64
            else kernels.WIN_SUM_I64)
    return window_eval(sw, [WinRequest(kind, fr, psum=p)])[0][0]


# --------------------------------------------------------- ranking family

def _rank_of(sw: SortedWindow, kind: int) -> torch.Tensor:
    return window_eval(sw, [WinRequest(kind)])[0][0]


def row_number(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_ROW_NUMBER)


def rank(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_RANK)


def dense_rank(sw: SortedWindow) -> torch.Tensor:
    return _rank_of(sw, kernels.WIN_DENSE_RANK)
