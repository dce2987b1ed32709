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
}


class HashCol(ctypes.Structure):
    """One key column as K5 and K6 hash it (HashCol in csrc/murmur3.cuh)."""

    _fields_ = [("data", ctypes.c_void_p), ("validity", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("row_bytes", ctypes.c_int)]


#: HashCol.kind values (HashKind in csrc/murmur3.cuh)
HASH_I32, HASH_I64, HASH_F32, HASH_F64, HASH_STR = range(5)
#: key columns one K5/K6 launch chains over (kMaxHashCols)
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
 PACK_BOOL) = range(8)
#: key columns one K9 pack launch takes (kMaxPackCols)
MAX_PACK_COLS = 16


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
