"""Device bloom filter — counterpart of `spark_rapids_tpu/ops/bloom.py`.

The filter is the reference's flat bool[m] bit array. k probe positions
come from double hashing over Spark-exact murmur3 (h_i = h1 + i*h2, with
h1 and h2 the key columns' Murmur3Hash under two seeds), so build and
probe agree by construction. Null keys never set or pass the filter —
appropriate for the inner/semi joins it prefilters, where null keys
cannot match.

Kernel K5 (kernels/csrc/bloom.cu) runs `build` and `might_contain` on the
card, hashing inside the kernel; CPU tensors take the plain versions.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn, row_mask
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.hashing import (
    key_col_descs,
    murmur3_columns_plain,
    pmod_plain,
)

# int32-signed views of the classic murmur constants (the chain seeds)
_SEED_A = 0x9747b28c - (1 << 32)
_SEED_B = 0x85ebca6b - (1 << 32)
DEFAULT_K = 4


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (XLA's astype(int32))."""
    u = x & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _positions(key_cols: List[DeviceColumn], m_bits: int, k: int):
    """The plain versions' k bit positions of every row."""
    h1 = murmur3_columns_plain(key_cols, seed=_SEED_A).to(torch.int64)
    h2 = murmur3_columns_plain(key_cols, seed=_SEED_B).to(torch.int64)
    # odd step avoids degenerate cycles on power-of-two m
    h2 = h2 | 1
    return [pmod_plain(_wrap32(h1 + i * h2), m_bits) for i in range(k)]


def all_keys_valid(key_cols: List[DeviceColumn]) -> torch.Tensor:
    ok = key_cols[0].validity
    for c in key_cols[1:]:
        ok = ok & c.validity
    return ok


def build_plain(key_cols: List[DeviceColumn], live: torch.Tensor,
                m_bits: int, k: int = DEFAULT_K) -> torch.Tensor:
    """Plain PyTorch version of K5's build: the reference's scatter-set,
    with rows that set nothing aimed at a spare slot m_bits."""
    ok = live & all_keys_valid(key_cols)
    bits = torch.zeros(m_bits + 1, dtype=torch.bool, device=live.device)
    for idx in _positions(key_cols, m_bits, k):
        bits[torch.where(ok, idx, m_bits).to(torch.int64)] = True
    return bits[:m_bits]


def might_contain_plain(bits: torch.Tensor, key_cols: List[DeviceColumn],
                        k: int = DEFAULT_K) -> torch.Tensor:
    """Plain PyTorch version of K5's might_contain."""
    m_bits = int(bits.shape[0])
    ok = all_keys_valid(key_cols)
    for idx in _positions(key_cols, m_bits, k):
        ok = ok & bits.index_select(0, idx.to(torch.int64))
    return ok


def might_contain_count_plain(bits: torch.Tensor,
                              key_cols: List[DeviceColumn],
                              num_rows: Union[int, torch.Tensor],
                              k: int = DEFAULT_K
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5's counting might_contain."""
    keep = might_contain_plain(bits, key_cols, k)
    keep = keep & row_mask(int(keep.shape[0]), num_rows, keep.device)
    return keep, keep.sum()


def build(key_cols: List[DeviceColumn], live: torch.Tensor,
          m_bits: int, k: int = DEFAULT_K) -> torch.Tensor:
    """-> bool[m_bits] with k bits set per live, fully-non-null key."""
    if live.device.type == "cpu":
        return build_plain(key_cols, live, m_bits, k)
    dev = live.device
    kernels.require(live, "live", torch.bool, dev)
    n = int(live.shape[0])
    descs, _keep = key_col_descs(key_cols)
    bits = torch.zeros(m_bits, dtype=torch.bool, device=dev)
    ptr, _arr = kernels.struct_array(kernels.HashCol, descs)
    _build.check(_build.lib().srtpu_bloom_build(
        ptr, len(descs), n, live.data_ptr(), m_bits, k, bits.data_ptr(),
        kernels.stream_ptr(live)), "bloom_build")
    kernels.launches["bloom_build"] += 1
    return bits


def _probe(bits: torch.Tensor, key_cols: List[DeviceColumn], k: int,
           num_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K5 might_contain launch; with num_rows it tests only the rows
    below num_rows (keep is False past them) and counts the kept ones
    (int64, on the device)."""
    dev = bits.device
    kernels.require(bits, "bits", torch.bool, dev)
    m_bits = int(bits.shape[0])
    if m_bits % 32:
        raise ValueError(f"bloom filter of {m_bits} bits: K5 packs 32 bits "
                         "a word")
    n = key_cols[0].capacity
    descs, _keep = key_col_descs(key_cols)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    count = None
    nrows_dev, nrows_host = None, 0
    if num_rows is not None:
        count = torch.zeros((), dtype=torch.int64, device=dev)
        if isinstance(num_rows, torch.Tensor):
            nrows_dev = num_rows.to(torch.int32)
            kernels.require(nrows_dev, "num_rows", torch.int32, dev, ndim=0)
        else:
            nrows_host = int(num_rows)
    ptr, _arr = kernels.struct_array(kernels.HashCol, descs)
    _build.check(_build.lib().srtpu_bloom_probe(
        ptr, len(descs), n, bits.data_ptr(), m_bits, k, keep.data_ptr(),
        None if nrows_dev is None else nrows_dev.data_ptr(), nrows_host,
        None if count is None else count.data_ptr(), kernels.sm_count(bits),
        kernels.stream_ptr(bits)), "bloom_might_contain")
    kernels.launches["bloom_might_contain"] += 1
    return keep, count


def might_contain(bits: torch.Tensor, key_cols: List[DeviceColumn],
                  k: int = DEFAULT_K) -> torch.Tensor:
    """bool[cap]: False only when the key is PROVABLY absent (or any key
    column is null)."""
    if bits.device.type == "cpu":
        return might_contain_plain(bits, key_cols, k)
    return _probe(bits, key_cols, k, None)[0]


def might_contain_count(bits: torch.Tensor, key_cols: List[DeviceColumn],
                        num_rows: Union[int, torch.Tensor],
                        k: int = DEFAULT_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(might_contain over the rows below num_rows, False past them; how
    many rows it keeps): the join's prefilter reads the count on the host
    and compacts by keep, which it ANDs with its live mask in any case, so
    the dead rows are never hashed. One K5 launch."""
    if bits.device.type == "cpu":
        return might_contain_count_plain(bits, key_cols, num_rows, k)
    return _probe(bits, key_cols, k, num_rows)


def size_for(build_rows: int, bits_per_key: int = 10,
             lo: int = 1 << 13, hi: int = 1 << 23) -> int:
    """Power-of-two bit count targeting ~1% false positives."""
    m = 1
    while m < build_rows * bits_per_key:
        m <<= 1
    return max(lo, min(m, hi))
