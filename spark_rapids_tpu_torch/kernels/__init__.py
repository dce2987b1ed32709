"""The port's hand-written CUDA kernels (csrc/*.cu) and their launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in the ops
module that the JAX package keeps the function in:

- K1 `ops.filterops.compact_perm`        (csrc/compact_perm.cu)
- K2 `ops.joinops.probe_bounds`          (csrc/probe_ranges.cu)
- K3 `ops.joinops.expand_gather_maps`    (csrc/expand_gather_maps.cu)
- K4 `ops.segmented.seg_sum_count_multi` (csrc/seg_sum_count.cu)

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (adding one to its count in `launches`) or
raises.
"""

from __future__ import annotations

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
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the kernels take it."""
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
