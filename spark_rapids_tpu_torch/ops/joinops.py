"""Equi-join kernels: sorted build, per-row range search, gather maps —
counterpart of `spark_rapids_tpu/ops/joinops.py`, with its gather-map
contract:

  phase 1: sort the build side by orderable join keys, null-keyed rows
    last (kernel K9: `pack_keys` writes the key words, `sort_words` sorts
    them; the batch and its keys gather with K8); each probe row finds
    its matching build range
    [lo, lo + count) by binary search (kernel K2, `probe_bounds`); null
    or dead probe rows get count 0.
  host: read the total match count, pick the output capacity bucket.
  phase 2: expand (lo, count) into (probe_idx, build_idx) gather maps of
    that capacity (kernel K3, `expand_gather_maps`), then gather both
    sides.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import ColumnBatch, gather_leaves
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.common import KeySpec, pack_keys, sort_words


class BuildTable(NamedTuple):
    """Build side prepared for probing (device-resident)."""

    batch: ColumnBatch          # sorted by join keys, null-keyed rows last
    keys: List[torch.Tensor]    # sorted orderable keys (excl. null rank)
    valid_bound: torch.Tensor   # 0-d int32: rows with non-null keys


def _join_keys(batch: ColumnBatch, key_idxs: Sequence[int],
               live: torch.Tensor, lead_rank: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(orderable value key words [W, n] — rank words excluded, validity is
    handled by the bound / count-0 rules — led with `lead_rank` by one word
    that is 1 for null-keyed or dead rows, and the "all keys valid" mask)."""
    return pack_keys([KeySpec(batch.columns[i], with_rank=False,
                              normalize_zero=True) for i in key_idxs],
                     live, lead_rank=lead_rank, want_all_valid=True)


def build_side(batch: ColumnBatch, key_idxs: Sequence[int]) -> BuildTable:
    live = batch.live_mask()
    # null-keyed / dead rows sort to the end: leading rank 0 valid, 1 not
    words, all_valid = _join_keys(batch, key_idxs, live, lead_rank=True)
    perm = sort_words(words)
    sorted_batch = batch.gather(perm, batch.num_rows)
    vals = list(words[1:].unbind(0))
    sorted_keys = gather_leaves(vals, [perm] * len(vals))
    valid_bound = all_valid.sum().to(torch.int32)
    return BuildTable(sorted_batch, sorted_keys, valid_bound)


def _tuple_cmp_at(build_keys: List[torch.Tensor], mid: torch.Tensor,
                  probe_keys: List[torch.Tensor], strict: bool
                  ) -> torch.Tensor:
    """Lexicographic: build[mid] < probe (strict) or <= probe."""
    lt = torch.zeros(mid.shape, dtype=torch.bool, device=mid.device)
    decided = torch.zeros_like(lt)
    for bk, pk in zip(build_keys, probe_keys):
        bv = bk.index_select(0, mid)
        lt = lt | (~decided & (bv < pk))
        decided = decided | (bv != pk)
    return lt if strict else (lt | ~decided)


def _binary_search(build_keys: List[torch.Tensor],
                   probe_keys: List[torch.Tensor], bound: torch.Tensor,
                   build_cap: int, upper: bool) -> torch.Tensor:
    """First index in [0, bound) where build[idx] >= probe (lower) or
    > probe (upper); vectorised over probe rows."""
    n = probe_keys[0].shape[0]
    device = probe_keys[0].device
    lo = torch.zeros(n, dtype=torch.int32, device=device)
    hi = bound.to(torch.int32).expand(n).clone()
    for _ in range(max(1, build_cap.bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        # inactive rows may sit at mid == build_cap: clamp the gather
        # (jnp.take clamps; index_select would raise)
        safe = mid.clamp(max=build_cap - 1).to(torch.int64)
        go_right = _tuple_cmp_at(build_keys, safe, probe_keys,
                                 strict=not upper)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def probe_bounds_plain(build_keys: List[torch.Tensor],
                       probe_keys: Sequence[torch.Tensor],
                       valid_bound: torch.Tensor, all_valid: torch.Tensor,
                       build_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: two vectorised binary searches."""
    lo = _binary_search(build_keys, probe_keys, valid_bound, build_cap,
                        upper=False)
    hi = _binary_search(build_keys, probe_keys, valid_bound, build_cap,
                        upper=True)
    counts = torch.where(all_valid, hi - lo, 0).to(torch.int32)
    return lo, counts


def probe_bounds(build_keys: List[torch.Tensor],
                 probe_keys: Sequence[torch.Tensor],
                 valid_bound: torch.Tensor,
                 all_valid: torch.Tensor,
                 build_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2: per probe row, (lo, count) of the build rows in
    [0, valid_bound) whose W key words equal the row's; count is 0 for
    rows with all_valid False. lo and count are [n] int32. The probe
    words may come as one [W, n] tensor (K9's pack)."""
    if all_valid.device.type == "cpu":
        return probe_bounds_plain(build_keys, list(probe_keys), valid_bound,
                                  all_valid, build_cap)
    dev = all_valid.device
    w = len(build_keys)
    if w == 0 or len(probe_keys) != w:
        raise ValueError(f"{w} build key words, {len(probe_keys)} probe")
    n = all_valid.shape[0]
    build = torch.stack(build_keys) if w > 1 else build_keys[0][None]
    if isinstance(probe_keys, torch.Tensor):
        probe = probe_keys
    else:
        probe = torch.stack(probe_keys) if w > 1 else probe_keys[0][None]
    kernels.require(build, "build_keys", torch.int64, dev, ndim=2)
    kernels.require(probe, "probe_keys", torch.int64, dev, ndim=2)
    kernels.require(all_valid, "all_valid", torch.bool, dev)
    kernels.require(valid_bound, "valid_bound", torch.int32, dev, ndim=0)
    if build.shape[1] != build_cap or probe.shape[1] != n:
        raise ValueError(f"build keys {tuple(build.shape)} / probe keys "
                         f"{tuple(probe.shape)} do not match {build_cap}, {n}")
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    index = torch.empty(kernels.PROBE_INDEX_SLOTS, dtype=torch.int32,
                        device=dev)
    _build.check(_build.lib().srtpu_probe_ranges(
        build.data_ptr(), build_cap, w, valid_bound.data_ptr(),
        probe.data_ptr(), n, all_valid.data_ptr(), lo.data_ptr(),
        counts.data_ptr(), index.data_ptr(), kernels.sm_count(all_valid),
        kernels.stream_ptr(all_valid)), "probe_ranges")
    kernels.launches["probe_ranges"] += 1
    return lo, counts


def probe_ranges(build: BuildTable, probe: ColumnBatch,
                 key_idxs: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row (lo, count) of matching build rows."""
    live = probe.live_mask()
    words, all_valid = _join_keys(probe, key_idxs, live)
    return probe_bounds(build.keys, words, build.valid_bound, all_valid,
                        build.batch.capacity)


def expand_gather_maps_plain(lo: torch.Tensor, counts: torch.Tensor,
                             out_capacity: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of K3: the reference's int64 cumsum plus a
    searchsorted of every output slot; slots >= total get (n-1, 0)."""
    n = counts.shape[0]
    csum = torch.cumsum(counts.to(torch.int64), 0)
    total = csum[-1]
    j = torch.arange(out_capacity, dtype=torch.int64, device=lo.device)
    probe_idx = torch.searchsorted(csum, j, right=True)
    probe_safe = probe_idx.clamp(0, n - 1)
    excl = csum - counts.to(torch.int64)
    within = j - excl.index_select(0, probe_safe)
    build_idx = lo.index_select(0, probe_safe).to(torch.int64) + within
    live = j < total
    pi = torch.where(live, probe_safe, n - 1).to(torch.int32)
    bi = torch.where(live, build_idx, 0).to(torch.int32)
    return pi, bi, total.to(torch.int32)


def expand_gather_maps(lo: torch.Tensor, counts: torch.Tensor,
                       out_capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K3: (lo, counts) -> (probe_idx, build_idx, total) gather
    maps of static size out_capacity (int32; total 0-d int32 on the
    device). Slots >= total hold (n-1, 0), in range for any gather."""
    if lo.device.type == "cpu":
        return expand_gather_maps_plain(lo, counts, out_capacity)
    dev = lo.device
    kernels.require(lo, "lo", torch.int32, dev)
    kernels.require(counts, "counts", torch.int32, dev)
    n = counts.shape[0]
    if lo.shape[0] != n or n == 0:
        raise ValueError(f"lo has {lo.shape[0]} rows, counts {n}")
    pi = torch.empty(out_capacity, dtype=torch.int32, device=dev)
    bi = torch.empty(out_capacity, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    tiles = -(-n // kernels.TILE_ROWS)
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int64, device=dev)
    _build.check(_build.lib().srtpu_expand_gather_maps(
        lo.data_ptr(), counts.data_ptr(), n, out_capacity, pi.data_ptr(),
        bi.data_ptr(), total.data_ptr(), scratch.data_ptr(),
        kernels.sm_count(lo), kernels.stream_ptr(lo)), "expand_gather_maps")
    kernels.launches["expand_gather_maps"] += 1
    return pi, bi, total


def _mark_pairs_plain(idx: torch.Tensor, ok: torch.Tensor, n_marks: int,
                      clip: bool) -> torch.Tensor:
    """The reference's marks: zeros(n).at[idx].max(where(ok, 1, 0)) > 0."""
    i = idx.to(torch.int64)
    if clip:
        i = i.clamp(0, n_marks - 1)
    m = torch.zeros(n_marks, dtype=torch.int32, device=idx.device)
    m.scatter_reduce_(0, i, ok.to(torch.int32), "amax")
    return m > 0


def _launch_marks(name: str, idx: torch.Tensor, ok: torch.Tensor,
                  n_marks: int, clip: bool,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    dev = idx.device
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: index dtype {idx.dtype}")
    kernels.require(idx, "idx", idx.dtype, dev)
    kernels.require(ok, "ok", torch.bool, dev)
    if ok.shape[0] != idx.shape[0] or n_marks < 1:
        raise ValueError(f"{name}: {idx.shape[0]} indices, {ok.shape[0]} "
                         f"flags, {n_marks} marks")
    zero = out is None
    if out is None:
        out = torch.empty(n_marks, dtype=torch.bool, device=dev)
    else:
        kernels.require(out, "out", torch.bool, dev)
        if out.shape[0] != n_marks:
            raise ValueError(f"{name}: out has {out.shape[0]} marks")
    _build.check(_build.lib().srtpu_join_marks(
        idx.data_ptr(), idx.element_size(), ok.data_ptr(), idx.shape[0],
        n_marks, int(clip), int(zero), out.data_ptr(),
        kernels.sm_count(idx), kernels.stream_ptr(idx)), "join_marks")
    kernels.launches[name] += 1
    return out


def probe_marks_plain(pi: torch.Tensor, ok: torch.Tensor,
                      n_marks: int) -> torch.Tensor:
    """Plain PyTorch version of K27's probe marks."""
    return _mark_pairs_plain(pi, ok, n_marks, clip=False)


def probe_marks(pi: torch.Tensor, ok: torch.Tensor,
                n_marks: int) -> torch.Tensor:
    """Kernel K27, probe marks (`exec/joins.py:151-152`,
    `parallel/plan_compiler.py:215-216`): [n_marks] bool, True at every
    probe row some ok pair (pi[j], ok[j]) names. pi is int32 or int64 in
    [0, n_marks) (K3's maps are)."""
    if pi.device.type == "cpu":
        return probe_marks_plain(pi, ok, n_marks)
    return _launch_marks("probe_marks", pi, ok, n_marks, False, None)


def build_marks_plain(bi: torch.Tensor, ok: torch.Tensor, n_marks: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K27's build marks."""
    m = _mark_pairs_plain(bi, ok, n_marks, clip=True)
    return m if out is None else out | m


def build_marks(bi: torch.Tensor, ok: torch.Tensor, n_marks: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K27, build marks (`exec/joins.py:178-180` and `:585-587`,
    `parallel/plan_compiler.py:236-238`): as probe_marks over
    clip(bi, 0, n_marks - 1). With `out`, the marks are ORed into it (the
    nested-loop join's marks across probe chunks, `:588`); the result is
    then `out` itself on the card and a new tensor on the CPU."""
    if bi.device.type == "cpu":
        return build_marks_plain(bi, ok, n_marks, out)
    return _launch_marks("build_marks", bi, ok, n_marks, True, out)


def build_coverage_plain(lo: torch.Tensor, counts: torch.Tensor,
                         n_build: int) -> torch.Tensor:
    """Plain PyTorch version of K27's coverage: the reference's difference
    array and cumsum."""
    has = (counts > 0).to(torch.int32)
    delta = torch.zeros(n_build + 1, dtype=torch.int32, device=lo.device)
    hi = lo.to(torch.int64) + counts.to(torch.int64)
    delta.scatter_add_(0, lo.to(torch.int64).clamp(0, n_build), has)
    delta.scatter_add_(0, hi.clamp(0, n_build), -has)
    return torch.cumsum(delta[:-1], 0) > 0


def build_coverage(lo: torch.Tensor, counts: torch.Tensor,
                   n_build: int) -> torch.Tensor:
    """Kernel K27, coverage (`exec/joins.py:254-262`
    `_matched_build_mask`): [n_build] bool, True at every build row some
    probe range [lo, lo + counts) with counts > 0 holds."""
    if lo.device.type == "cpu":
        return build_coverage_plain(lo, counts, n_build)
    dev = lo.device
    kernels.require(lo, "lo", torch.int32, dev)
    kernels.require(counts, "counts", torch.int32, dev)
    if counts.shape[0] != lo.shape[0] or n_build < 1:
        raise ValueError(f"build_coverage: lo {lo.shape[0]}, counts "
                         f"{counts.shape[0]}, {n_build} build rows")
    covered = torch.empty(n_build, dtype=torch.bool, device=dev)
    tiles = -(-n_build // kernels.TILE_ROWS)
    scratch = torch.empty(n_build + 2 * tiles, dtype=torch.int32,
                          device=dev)
    _build.check(_build.lib().srtpu_build_coverage(
        lo.data_ptr(), counts.data_ptr(), lo.shape[0], n_build,
        covered.data_ptr(), scratch.data_ptr(), kernels.sm_count(lo),
        kernels.stream_ptr(lo)), "build_coverage")
    kernels.launches["build_coverage"] += 1
    return covered
