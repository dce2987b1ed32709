"""The port's hand-written CUDA kernels (csrc/*.cu) and their launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in the ops
module that the JAX package keeps the function in:

- K1 `ops.filterops.compact_perm`        (csrc/compact_perm.cu)
- K2 `ops.joinops.probe_bounds`          (csrc/probe_ranges.cu)
- K3 `ops.joinops.expand_gather_maps`    (csrc/expand_gather_maps.cu)
- K4 `ops.segmented.seg_sum_count_multi` (csrc/seg_sum_count.cu)
- K5 `ops.bloom.build`, `ops.bloom.might_contain` (csrc/bloom.cu)
- K6 `ops.hashing.murmur3_columns` and the hashes and `pmod` beside it
  (csrc/murmur3_partition.cu, with csrc/murmur3.cuh shared with K5)
- K7 `ops.partition.partition_by_ids`   (csrc/partition_by_ids.cu)
- K8 `columnar.batch.gather_columns`, behind `ColumnBatch.gather`,
  `DeviceColumn.gather` and `columnar.encoding.decode_column`
  (csrc/gather_leaves.cu)
- K9 `ops.common.pack_keys` (the orderable key words) and
  `ops.common.sort_words` (their stable radix sort), behind
  `orderable_keys`, `sort_permutation`, `group_by` and `build_side`
  (csrc/sort_keys.cu)
- K10 `ops.segmented.group_bounds`, the segment structure behind
  `group_by` (csrc/group_bounds.cu)
- K11 `ops.segmented.dense_bin_perm` (csrc/dense_bin_perm.cu)
- K12 `ops.segmented.seg_min`, `ops.segmented.seg_max` (csrc/seg_minmax.cu)
- K13 `ops.sortops.merge_runs`, behind `merge_sorted`
  (csrc/merge_runs.cu, with the key search of csrc/search.cuh shared
  with K2)
- K14 `ops.windowops.window_prefix` (the frame prefix sums),
  `ops.windowops.inverse_permutation` (the write-back's inverse
  permutation) and `ops.windowops.window_eval` (frames, the rank family
  with percent_rank, cume_dist and ntile, and the write-back to input
  order) (csrc/window_frames.cu, with the frame sides of
  csrc/window_frame.cuh shared with K15-K17)
- K15 `ops.windowops.range_bounds`, behind `range_frame_bounds` and the
  RANGE frames of `frame_of` (csrc/range_bounds.cu)
- K16 `ops.windowops.frame_minmax` (csrc/frame_minmax.cu)
- K17 `ops.windowops.frame_pick`, behind `frame_first_last` and
  `lead_lag` (csrc/frame_pick.cu)
- K18 `ops.regexops.dfa_match`, behind RLike (csrc/dfa_match.cu)
- K19 `expr.strings._contains`, `_first_match_charpos`,
  `_select_nonoverlapping` and `_substring_index_bounds`: a literal
  needle's matches (csrc/str_find.cu)
- K20 `expr.strings._rewrite` and `_char_count`: byte maps, the kept
  bytes of a rule left-packed (Substring, the trim family, Translate,
  SubstringIndex), Reverse, InitCap and Length (csrc/str_rewrite.cu)
- K21 `expr.strings._assemble`: Concat, ConcatWs, the pads, Repeat and
  Replace's emission (csrc/str_assemble.cu)

- K22 `ops.stringcast.parse_long`, `parse_double`, `parse_bool`,
  `parse_date`, `parse_timestamp` and `parse_decimal`: Spark's string
  parse, one mode a target type (csrc/str_parse.cu)
- K23 `ops.tzdb.utc_to_local` and `local_to_utc`: the time-zone rebase
  through the zone's transition table (csrc/tz_rebase.cu)
- K24 `expr.cast._int_to_string`, `_date_to_string`,
  `_timestamp_to_string` and `expr.datetimes._pattern_to_string`
  (DateFormat): integral, date and timestamp text, in its hex mode
  `expr.mathexpr.hex_text` (Hex), and in its decimal modes
  `expr.cast._decimal_to_string` (csrc/str_format.cu; the hex mode's
  launches count apart, as "str_format_hex", and the decimal modes' as
  "str_format_decimal")

- K25 `expr.aggregates.rank_select` and `rank_interp`: the percentile
  aggregates' rank selection over rows sorted by (group, value)
  (csrc/rank_select.cu)
- K26 `expr.aggregates.collect_rank` and `collect_scatter`: the collect
  family's ranks within a group (with the set's duplicate test) and its
  [groups, max_elems] buffers (csrc/collect_scatter.cu)

- K27 `ops.joinops.probe_marks`, `build_marks` and `build_coverage`:
  the join's match marks of probe and build rows and the build rows the
  probe ranges cover (csrc/join_marks.cu)
- K28 `ops.partition.round_robin_perm`, behind `round_robin_partition`:
  K7's stable partition with each row's partition computed inline
  (csrc/partition_by_ids.cu)
- K29 `columnar.encoding.remap_codes`, behind `CodesOf`: dictionary codes
  re-encoded through a remap table (csrc/codes_remap.cu)

- K30 `ops.hashing.xxhash64_columns`, behind XxHash64: Spark's xxhash64
  chained over key columns (csrc/xxhash64.cu, with the HashCol layout of
  csrc/murmur3.cuh shared with K5 and K6)

- K31 `ops.decimal128.add`, `multiply`, `rescale`, `average`, `negate`,
  `absolute`, `compare`, `to_double` and `to_long`: 128-bit decimal
  arithmetic, one mode a function (csrc/decimal128.cu)
- K32 `ops.decimal128.seg_sum128`: the segmented 128-bit sum with its
  counts (csrc/seg_sum128.cu)

- K33 `ops.windowops.frame_collect`: collect_list and collect_set over
  bounded ROWS frames, written back to input order (csrc/frame_collect.cu)
- K34 `expr.collections.array_compact` and `array_distinct`: kept
  elements left-packed in each row, and the first occurrences of each
  row (csrc/array_rows.cu; their launches count apart, as
  "array_compact" and "array_distinct")
- K35 `expr.collections.array_sort`: each row's elements sorted stably
  (csrc/array_rows.cu)

- K36 `ops.zorder.interleave_bits`: the Morton key of rank columns, the
  top bits of each interleaved round-robin (csrc/zorder.cu)

K18-K22 and K24 share the row reader and writer of csrc/strings.cuh, K22
and K24 the calendar of csrc/calendar.cuh, K24, K31 and K32 the 128-bit
arithmetic of csrc/decimal128.cuh.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (adding one to its count in `launches`) or
raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import torch

#: rows one block of the scan kernels owns (kTile in csrc/common.cuh);
#: the wrappers size those kernels' scratch by it
TILE_ROWS = 4096

#: kernel name -> launches since the last `reset_launches()`
launches: Dict[str, int] = {
    "compact_perm": 0,
    "probe_ranges": 0,
    "expand_gather_maps": 0,
    "seg_sum_count": 0,
    "bloom_build": 0,
    "bloom_might_contain": 0,
    "murmur3": 0,
    "partition_by_ids": 0,
    "gather_leaves": 0,
    "pack_keys": 0,
    "sort_words": 0,
    "group_bounds": 0,
    "dense_bin_perm": 0,
    "seg_minmax": 0,
    "merge_runs": 0,
    "window_prefix": 0,
    "window_inverse": 0,
    "window_eval": 0,
    "range_bounds": 0,
    "frame_minmax": 0,
    "frame_pick": 0,
    "dfa_match": 0,
    "str_find": 0,
    "str_rewrite": 0,
    "str_assemble": 0,
    "str_parse": 0,
    "tz_rebase": 0,
    "str_format": 0,
    "rank_select": 0,
    "rank_interp": 0,
    "collect_rank": 0,
    "collect_scatter": 0,
    "probe_marks": 0,
    "build_marks": 0,
    "build_coverage": 0,
    "round_robin_partition": 0,
    "codes_remap": 0,
    "xxhash64": 0,
    "str_format_hex": 0,
    "decimal128": 0,
    "seg_sum128": 0,
    "str_parse_decimal": 0,
    "str_format_decimal": 0,
    "frame_collect": 0,
    "array_compact": 0,
    "array_distinct": 0,
    "array_sort": 0,
    "zorder_interleave": 0,
}


class HashCol(ctypes.Structure):
    """One key column as K5, K6 and K30 hash it (HashCol in
    csrc/murmur3.cuh)."""

    _fields_ = [("data", ctypes.c_void_p), ("validity", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("row_bytes", ctypes.c_int)]


#: HashCol.kind values (HashKind in csrc/murmur3.cuh)
HASH_I32, HASH_I64, HASH_F32, HASH_F64, HASH_STR = range(5)
#: key columns one K5/K6/K30 launch chains over (kMaxHashCols)
MAX_HASH_COLS = 8


class GatherLeaf(ctypes.Structure):
    """One leaf of a K8 launch (GatherLeaf in csrc/gather_leaves.cu)."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("idx", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("src_rows", ctypes.c_longlong), ("row_bytes", ctypes.c_int),
                ("unit", ctypes.c_int), ("idx_bytes", ctypes.c_int),
                ("clamp", ctypes.c_int)]


#: leaves one K8 launch gathers (kMaxLeaves)
MAX_LEAVES = 32


class PackCol(ctypes.Structure):
    """One key column as K9 packs it (PackCol in csrc/sort_keys.cu)."""

    _fields_ = [("data", ctypes.c_void_p), ("validity", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("row_bytes", ctypes.c_int), ("word0", ctypes.c_int),
                ("with_rank", ctypes.c_int), ("descending", ctypes.c_int),
                ("nulls_first", ctypes.c_int),
                ("normalize_zero", ctypes.c_int), ("pad", ctypes.c_int)]


#: PackCol.kind values (PackKind in csrc/sort_keys.cu)
(PACK_I8, PACK_I16, PACK_I32, PACK_I64, PACK_F32, PACK_F64, PACK_STR,
 PACK_BOOL, PACK_D128) = range(9)
#: key columns one K9 pack launch takes (kMaxPackCols)
MAX_PACK_COLS = 16


class MergeLeaf(ctypes.Structure):
    """One leaf of a K13 scatter (MergeLeaf in csrc/merge_runs.cu)."""

    _fields_ = [("src_a", ctypes.c_void_p), ("src_b", ctypes.c_void_p),
                ("dst", ctypes.c_void_p), ("row_bytes", ctypes.c_int),
                ("unit", ctypes.c_int)]


#: leaves one K13 scatter launch moves (kMaxMergeLeaves)
MAX_MERGE_LEAVES = 32


class WinOut(ctypes.Structure):
    """One output of a K14 evaluation (WinOut in csrc/window_frames.cu)."""

    _fields_ = [("kind", ctypes.c_int), ("start_kind", ctypes.c_int),
                ("end_kind", ctypes.c_int), ("pad", ctypes.c_int),
                ("lower", ctypes.c_longlong), ("upper", ctypes.c_longlong),
                ("start", ctypes.c_void_p), ("end", ctypes.c_void_p),
                ("psum", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("out_valid", ctypes.c_void_p)]


#: WinOut.kind values (WinKind in csrc/window_frames.cu); WIN_NTILE takes
#: its bucket count in WinOut.lower
(WIN_ROW_NUMBER, WIN_RANK, WIN_DENSE_RANK, WIN_SUM_F64, WIN_SUM_I64,
 WIN_COUNT, WIN_AVG, WIN_PERCENT_RANK, WIN_CUME_DIST, WIN_NTILE) = range(10)
#: frame side kinds, WinOut.start_kind / end_kind and WinFrame's
#: (WinBound in csrc/window_frame.cuh)
WIN_SEG, WIN_PEER, WIN_OFFSET, WIN_GIVEN = range(4)
#: outputs one K14 evaluation launch writes (kMaxWinOuts)
MAX_WIN_OUTS = 8


class WinFrame(ctypes.Structure):
    """One frame as K16 and K17 take it (WinFrame in
    csrc/window_frame.cuh)."""

    _fields_ = [("start_kind", ctypes.c_int), ("end_kind", ctypes.c_int),
                ("lower", ctypes.c_longlong), ("upper", ctypes.c_longlong),
                ("start", ctypes.c_void_p), ("end", ctypes.c_void_p)]


#: K15's key types (RangeKeyType in csrc/range_bounds.cu)
RANGE_TYPES = {torch.int16: 0, torch.int32: 1, torch.int64: 2,
               torch.float32: 3, torch.float64: 4, torch.int8: 5}
#: K16's value types (MmType in csrc/frame_minmax.cu)
MINMAX_TYPES = {torch.int16: 0, torch.int32: 1, torch.int64: 2,
                torch.float32: 3, torch.float64: 4, torch.bool: 5,
                torch.int8: 6}


class PickOut(ctypes.Structure):
    """One output of a K17 launch (PickOut in csrc/frame_pick.cu)."""

    _fields_ = [("kind", ctypes.c_int), ("pad", ctypes.c_int),
                ("frame", WinFrame), ("offset", ctypes.c_longlong),
                ("pcnt", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("has", ctypes.c_void_p)]


#: PickOut.kind values (PickKind in csrc/frame_pick.cu)
PICK_FIRST, PICK_LAST, PICK_FIRST_VALID, PICK_LAST_VALID, PICK_SHIFT = \
    range(5)
#: outputs one K17 launch picks (kMaxPickOuts)
MAX_PICK_OUTS = 8


#: K19's modes (FindMode in csrc/str_find.cu)
FIND_ANY, FIND_FIRST, FIND_SELECT, FIND_SPLIT = range(4)
#: K20's kinds (RewriteKind in csrc/str_rewrite.cu)
(REWRITE_MAP, REWRITE_CHARS, REWRITE_TRIM, REWRITE_RANGE, REWRITE_REVERSE,
 REWRITE_INITCAP, REWRITE_LENGTH) = range(7)
#: K21's kinds (AssembleKind in csrc/str_assemble.cu)
(ASSEMBLE_CONCAT, ASSEMBLE_CONCAT_WS, ASSEMBLE_LPAD, ASSEMBLE_RPAD,
 ASSEMBLE_REPEAT, ASSEMBLE_REPLACE) = range(6)


class StrCol(ctypes.Structure):
    """One input column of a K21 launch (StrCol in csrc/str_assemble.cu)."""

    _fields_ = [("data", ctypes.c_void_p), ("lengths", ctypes.c_void_p),
                ("validity", ctypes.c_void_p), ("width", ctypes.c_int),
                ("pad", ctypes.c_int)]


#: input columns one K21 launch takes (kMaxStrCols)
MAX_STR_COLS = 16

#: K26's element kinds (ElemKind in csrc/collect_scatter.cu)
ELEM_KINDS = {torch.int8: 0, torch.uint8: 0, torch.bool: 0, torch.int16: 1,
              torch.int32: 2, torch.int64: 3, torch.float32: 4,
              torch.float64: 5}
#: targets one K25 select launch takes (kRsMaxK in csrc/rank_select.cu)
MAX_RANK_TARGETS = 128

#: K22's modes (ParseMode in csrc/str_parse.cu)
(PARSE_LONG, PARSE_DOUBLE, PARSE_BOOL, PARSE_DATE, PARSE_TIMESTAMP,
 PARSE_DECIMAL) = range(6)
#: K24's modes (FormatMode in csrc/str_format.cu)
(FORMAT_INT, FORMAT_DATE, FORMAT_TIMESTAMP, FORMAT_PATTERN, FORMAT_HEX,
 FORMAT_DECIMAL, FORMAT_DECIMAL128) = range(7)
#: K34's and K35's modes and the opaque element kind (ArrMode, ArrKind in
#: csrc/array_rows.cu)
ARR_COMPACT, ARR_DISTINCT, ARR_SORT_ASC, ARR_SORT_DESC = range(4)
ARR_BYTES = 6
#: K31's modes (D128Mode in csrc/decimal128.cu)
(D128_ADD, D128_SUB, D128_MUL, D128_RESCALE, D128_AVG, D128_NEG, D128_ABS,
 D128_CMP, D128_TO_F64, D128_TO_I64) = range(10)


def struct_array(cls, items) -> ctypes.c_void_p:
    """(pointer, array): a ctypes array of structures and the pointer a C
    entry takes; the caller keeps the array alive across the call."""
    arr = (cls * len(items))(*items)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


#: the raw current-stream lookup of PyTorch's CUDA build: one C call,
#: where torch.cuda.current_stream builds a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the kernels take it."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


@lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return (int(props.multi_processor_count),
            int(props.shared_memory_per_block_optin))


def sm_count(t: torch.Tensor) -> int:
    return _device_limits(t.device.index)[0]


def smem_optin(t: torch.Tensor) -> int:
    """Dynamic shared memory one block may opt into on t's device."""
    return _device_limits(t.device.index)[1]


def byte_rows(data: torch.Tensor) -> torch.Tensor:
    """A string byte matrix as K18-K21 read it: contiguous, its rows
    starting 8-byte aligned (a copy where a view is not)."""
    data = data.contiguous()
    if data.data_ptr() % 8:
        data = data.clone()
    return data


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int = 1) -> None:
    """The wrappers' argument check: device, dtype, rank, contiguity."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
