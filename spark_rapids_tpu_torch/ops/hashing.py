"""Spark-exact Murmur3_x86_32 and XxHash64 — counterpart of
`spark_rapids_tpu/ops/hashing.py` (`hash_int` to `pmod`, :63-163, and
`xxh64_int` to `xxhash64_columns`, :185-315).

Spark's `org.apache.spark.unsafe.hash.Murmur3_x86_32`, with its
one-byte-at-a-time tail in `hashUnsafeBytes`, chained over key columns as
Spark's `Murmur3Hash` does: a null input leaves the running hash
unchanged, and the seed chains left to right (42 for partitioning). Hash
partitioning must agree with CPU Spark's, so the bits are Spark's.

Kernel K6 (kernels/csrc/murmur3_partition.cu) computes every function
here for CUDA tensors, and `murmur3_pmod` (the exchange's partition ids)
in one launch. For CPU tensors each runs its plain PyTorch version: the
uint32 arithmetic is carried in int64 and masked to 32 bits, so no
signed overflow happens anywhere.

Kernel K30 (kernels/csrc/xxhash64.cu) computes `xxhash64_columns`, Spark's
XxHash64 (seed 42, an int64 a row) chained over key columns the same way.
Its plain PyTorch version carries the uint64 arithmetic in int64, whose
multiplies and adds wrap mod 2^64 as uint64's do; the right shifts are
masked to act as logical ones, and the primes above 2^63 are written as
their signed values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes import (
    BooleanType,
    DoubleType,
    FloatType,
    StringType,
)

DEFAULT_SEED = 42

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 0xE6546B64
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35

Seed = Union[int, torch.Tensor]


# ------------------------------------------------------- plain versions

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64."""
    return x.to(torch.int64) & _M32


def _s32(u: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 -> the int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32, in 16-bit halves so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    return _mul(_rotl(_mul(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    return (_mul(_rotl(h1 ^ k1, 13), 5) + _M5) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul(h1, _F1)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul(h1, _F2)
    return h1 ^ (h1 >> 16)


def _seed_u32(seed: Seed, n: int, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return _u32(seed)
    return torch.full((n,), int(seed) & _M32, dtype=torch.int64,
                      device=device)


def _hash_int_u32(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return _fmix(_mix_h1(h, _mix_k1(_u32(v))), 4)


def _hash_long_u32(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    h = _mix_h1(h, _mix_k1(v & _M32))
    h = _mix_h1(h, _mix_k1((v >> 32) & _M32))
    return _fmix(h, 8)


def _hash_string_u32(data: torch.Tensor, lengths: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    n, mb = data.shape
    full = lengths.to(torch.int64) // 4
    tail = lengths.to(torch.int64) - full * 4
    d = data.to(torch.int64)
    for ci in range(mb // 4):
        chunk = (d[:, 4 * ci] | (d[:, 4 * ci + 1] << 8)
                 | (d[:, 4 * ci + 2] << 16) | (d[:, 4 * ci + 3] << 24))
        h = torch.where(ci < full, _mix_h1(h, _mix_k1(chunk)), h)
    signed = torch.where(d >= 128, d - 256, d)   # the byte as int8
    base = full * 4
    for ti in range(3):
        pos = (base + ti).clamp(0, mb - 1)
        byte = torch.gather(signed, 1, pos[:, None])[:, 0] & _M32
        h = torch.where(ti < tail, _mix_h1(h, _mix_k1(byte)), h)
    return _fmix(h, lengths.to(torch.int64) & _M32)


def _hash_input(col: DeviceColumn, plain: bool = False):
    """(kind, data, lengths) of a key column as Spark hashes it: strings by
    their bytes (an encoded column decodes first, through K8 or with
    `plain` its plain version: hashes must agree across batches whose
    dictionaries differ), floats by their normalised bits, integers at 32
    or 64 bits by their type's width."""
    dt = col.dtype
    if isinstance(dt, StringType):
        if col.encoding is not None:
            from spark_rapids_tpu_torch.columnar import encoding as _enc

            decode = _enc.decode_column_plain if plain else _enc.decode_column
            col = decode(col)
        return kernels.HASH_STR, col.data, col.lengths
    if isinstance(dt, BooleanType):
        return kernels.HASH_I32, col.data.to(torch.int32), None
    if isinstance(dt, FloatType):
        return kernels.HASH_F32, col.data.to(torch.float32), None
    if isinstance(dt, DoubleType):
        return kernels.HASH_F64, col.data.to(torch.float64), None
    if dt.np_dtype.itemsize <= 4:
        return kernels.HASH_I32, col.data.to(torch.int32), None
    return kernels.HASH_I64, col.data.to(torch.int64), None


def _float_bits(data: torch.Tensor, kind: int) -> torch.Tensor:
    """Spark's float normalisation: -0.0 -> 0.0, every NaN -> one NaN."""
    if kind == kernels.HASH_F32:
        f = torch.where(data == 0.0, torch.zeros_like(data), data)
        bits = f.view(torch.int32)
        return torch.where(torch.isnan(f), torch.full_like(bits, 0x7FC00000),
                           bits)
    f = torch.where(data == 0.0, torch.zeros_like(data), data)
    bits = f.view(torch.int64)
    return torch.where(torch.isnan(f),
                       torch.full_like(bits, 0x7FF8000000000000), bits)


def _hash_kind_u32(kind: int, data, lengths, h):
    if kind == kernels.HASH_STR:
        return _hash_string_u32(data, lengths, h)
    if kind in (kernels.HASH_F32, kernels.HASH_F64):
        data = _float_bits(data, kind)
    if kind in (kernels.HASH_I32, kernels.HASH_F32):
        return _hash_int_u32(data, h)
    return _hash_long_u32(data, h)


def hash_column_plain(col: DeviceColumn, seed: Seed) -> torch.Tensor:
    """Plain PyTorch version of K6 for `hash_column`."""
    kind, data, lengths = _hash_input(col, plain=True)
    h = _seed_u32(seed, int(data.shape[0]), data.device)
    return _s32(_hash_kind_u32(kind, data, lengths, h))


def murmur3_columns_plain(cols: Sequence[DeviceColumn],
                          seed: Seed = DEFAULT_SEED) -> torch.Tensor:
    """Plain PyTorch version of K6's chain: Murmur3Hash(cols, seed)."""
    cap = cols[0].capacity
    h = _seed_u32(seed, cap, cols[0].device)
    for c in cols:
        kind, data, lengths = _hash_input(c, plain=True)
        h = torch.where(c.validity, _hash_kind_u32(kind, data, lengths, h), h)
    return _s32(h)


def pmod_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of Pmod: torch's % is a floor modulo, so the
    remainder is already non-negative for n > 0; the branch stays as the
    reference writes it."""
    r = torch.remainder(x, n)
    return torch.where(r < 0, r + n, r).to(torch.int32)


# ------------------------------------------------------------ kernel K6

def _signed32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def hash_col_desc(kind: int, data: torch.Tensor,
                  validity: Optional[torch.Tensor],
                  lengths: Optional[torch.Tensor]) -> "kernels.HashCol":
    """The K5/K6 descriptor of one key column on the card."""
    dev = data.device
    if kind == kernels.HASH_STR:
        kernels.require(data, "string data", torch.uint8, dev, ndim=2)
        kernels.require(lengths, "string lengths", torch.int32, dev)
    else:
        want = {kernels.HASH_I32: torch.int32, kernels.HASH_I64: torch.int64,
                kernels.HASH_F32: torch.float32,
                kernels.HASH_F64: torch.float64}[kind]
        kernels.require(data, "key data", want, dev)
    if validity is not None:
        kernels.require(validity, "key validity", torch.bool, dev)
    return kernels.HashCol(
        data.data_ptr(), None if validity is None else validity.data_ptr(),
        None if lengths is None else lengths.data_ptr(), kind,
        int(data.shape[1]) if data.dim() == 2 else 0)


def key_col_descs(cols: Sequence[DeviceColumn]) -> List:
    """(descriptors, tensors to keep alive) for key columns, validity
    included; at most kernels.MAX_HASH_COLS of them."""
    if len(cols) > kernels.MAX_HASH_COLS:
        raise ValueError(f"{len(cols)} key columns; a hash kernel chains "
                         f"at most {kernels.MAX_HASH_COLS}")
    descs, keep = [], []
    for c in cols:
        kind, data, lengths = _hash_input(c)
        data = data.contiguous()
        lengths = None if lengths is None else lengths.contiguous()
        keep += [data, lengths]
        descs.append(hash_col_desc(kind, data, c.validity, lengths))
    return descs, keep


def _launch_k6(descs, n: int, seed: int, seed_vec: Optional[torch.Tensor],
               nparts: int, device) -> torch.Tensor:
    if seed_vec is not None:
        kernels.require(seed_vec, "seed", torch.int32, device)
        if seed_vec.shape[0] != n:
            raise ValueError(f"seed has {seed_vec.shape[0]} rows, not {n}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    ptr, _arr = kernels.struct_array(kernels.HashCol, descs)
    _build.check(_build.lib().srtpu_murmur3(
        ptr, len(descs), n, _signed32(seed),
        None if seed_vec is None else seed_vec.data_ptr(), nparts,
        out.data_ptr(), kernels.sm_count(out), kernels.stream_ptr(out)),
        "murmur3")
    kernels.launches["murmur3"] += 1
    return out


def _one_col(kind: int, data: torch.Tensor, lengths, seed: Seed
             ) -> torch.Tensor:
    """hash_int / hash_long / hash_string / hash_column for one column
    whose every row is hashed (validity is the caller's business)."""
    n = int(data.shape[0])
    if data.device.type == "cpu":
        h = _seed_u32(seed, n, data.device)
        return _s32(_hash_kind_u32(kind, data, lengths, h))
    desc = hash_col_desc(kind, data.contiguous(), None,
                         None if lengths is None else lengths.contiguous())
    if isinstance(seed, torch.Tensor):
        return _launch_k6([desc], n, 0, seed.to(torch.int32).contiguous(), 0,
                          data.device)
    return _launch_k6([desc], n, int(seed), None, 0, data.device)


def hash_int(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Murmur3_x86_32.hashInt — v int32, seed int32 (per row or one)."""
    return _one_col(kernels.HASH_I32, v.to(torch.int32), None, seed)


def hash_long(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Murmur3_x86_32.hashLong — low word then high word."""
    return _one_col(kernels.HASH_I64, v.to(torch.int64), None, seed)


def hash_string(data: torch.Tensor, lengths: torch.Tensor,
                seed: Seed) -> torch.Tensor:
    """Murmur3_x86_32.hashUnsafeBytes over the padded byte matrix: 4-byte
    little-endian chunks for the aligned prefix, then the remaining bytes
    one at a time as sign-extended ints (Spark's tail rule)."""
    return _one_col(kernels.HASH_STR, data, lengths.to(torch.int32), seed)


def hash_column(col: DeviceColumn, seed: Seed) -> torch.Tensor:
    """Per-row murmur3 update for one column (ignores validity; the caller
    masks nulls)."""
    kind, data, lengths = _hash_input(col)
    return _one_col(kind, data, lengths, seed)


def murmur3_pmod(cols: Sequence[DeviceColumn], num_partitions: int,
                 seed: int = DEFAULT_SEED) -> torch.Tensor:
    """pmod(murmur3_columns(cols, seed), num_partitions); num_partitions 0
    leaves the hash as it is. One K6 launch on the card."""
    if cols[0].device.type == "cpu":
        h = murmur3_columns_plain(cols, seed)
        return pmod_plain(h, num_partitions) if num_partitions else h
    descs, _keep = key_col_descs(cols)
    return _launch_k6(descs, cols[0].capacity, seed, None, num_partitions,
                      cols[0].device)


def murmur3_columns(cols: Sequence[DeviceColumn],
                    seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Spark Murmur3Hash(cols, seed): chain seeds, skip nulls."""
    return murmur3_pmod(cols, 0, seed)


def pmod(x: torch.Tensor, n: int) -> torch.Tensor:
    """Positive modulus, Spark's Pmod used by HashPartitioning."""
    if n <= 0:
        raise ValueError(f"pmod by {n}")
    if x.device.type == "cpu":
        return pmod_plain(x, n)
    return _launch_k6([], int(x.shape[0]), 0,
                      x.to(torch.int32).contiguous(), n, x.device)


# --------------------------------------------- xxhash64: plain versions

def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_XP1 = _i64(0x9E3779B185EBCA87)
_XP2 = _i64(0xC2B2AE3D27D4EB4F)
_XP3 = 0x165667B19E3779F9
_XP4 = _i64(0x85EBCA77C2B2AE63)
_XP5 = 0x27D4EB2F165667C5
_XP12 = _i64((0x9E3779B185EBCA87 + 0xC2B2AE3D27D4EB4F) % (1 << 64))

XXHASH_DEFAULT_SEED = 42


def _seed64(seed: int) -> int:
    """A seed as the int64 with its uint64 bits."""
    return _i64(int(seed) % (1 << 64))


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr64(x, 64 - r)


def _xxh_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr64(h, 33)
    h = h * _XP2
    h = h ^ _lsr64(h, 29)
    h = h * _XP3
    return h ^ _lsr64(h, 32)


def _xxh_round(acc, w: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + w * _XP2, 31) * _XP1


def xxh64_int_plain(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashInt: v int32 (its bits as uint32), seed int64 a row."""
    h = seed + (_XP5 + 4)
    h = h ^ ((v.to(torch.int64) & _M32) * _XP1)
    h = _rotl64(h, 23) * _XP2 + _XP3
    return _xxh_fmix(h)


def xxh64_long_plain(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashLong: v int64, seed int64 a row."""
    h = seed + (_XP5 + 8)
    h = h ^ (_rotl64(v.to(torch.int64) * _XP2, 31) * _XP1)
    h = _rotl64(h, 27) * _XP1 + _XP4
    return _xxh_fmix(h)


def _le_words(data: torch.Tensor, width: int) -> torch.Tensor:
    """[n, width / 8] little-endian int64 words of a byte matrix padded
    to `width` bytes (a view of the bytes, not one int64 a byte)."""
    n, mb = data.shape
    if mb != width:
        data = torch.nn.functional.pad(data, (0, width - mb))
    return data.contiguous().view(torch.int64)


def xxh64_bytes_plain(data: torch.Tensor, lengths: torch.Tensor,
                      seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashUnsafeBytes over a zero-padded [n, mb] byte matrix: the
    reference's masked passes over every possible 32-byte stripe, 8-byte
    word, 4-byte word and tail byte."""
    n, mb = data.shape
    pad_mb = max(32, (mb + 31) // 32 * 32)
    words = _le_words(data, pad_mb)
    bytes_ = torch.nn.functional.pad(data, (0, pad_mb - mb)).to(torch.int64)
    nw = pad_mb // 8
    lens = lengths.to(torch.int64)
    nblocks = lens // 32
    vs = [seed + _XP12, seed + _XP2, seed, seed - _XP1]
    for bi in range(pad_mb // 32):
        active = bi < nblocks
        for lane in range(4):
            upd = _xxh_round(vs[lane], words[:, bi * 4 + lane])
            vs[lane] = torch.where(active, upd, vs[lane])
    hash_ge = (_rotl64(vs[0], 1) + _rotl64(vs[1], 7) + _rotl64(vs[2], 12)
               + _rotl64(vs[3], 18))
    for v in vs:
        hash_ge = (hash_ge ^ _xxh_round(0, v)) * _XP1 + _XP4
    h = torch.where(lens >= 32, hash_ge, seed + _XP5) + lens
    base_w = nblocks * 4
    n8 = (lens - nblocks * 32) // 8
    for wi in range(3):
        w = torch.gather(words, 1, (base_w + wi).clamp(0, nw - 1)[:, None])
        upd = _rotl64(h ^ _xxh_round(0, w[:, 0]), 27) * _XP1 + _XP4
        h = torch.where(wi < n8, upd, h)
    off = nblocks * 32 + n8 * 8
    has4 = lens - off >= 4
    idx = (off[:, None] + torch.arange(4, device=data.device)[None, :]
           ).clamp(0, pad_mb - 1)
    b4 = torch.gather(bytes_, 1, idx)
    u32 = b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    upd = _rotl64(h ^ (u32 * _XP1), 23) * _XP2 + _XP3
    h = torch.where(has4, upd, h)
    off = off + has4.to(torch.int64) * 4
    for ti in range(3):
        byte = torch.gather(bytes_, 1,
                            (off + ti).clamp(0, pad_mb - 1)[:, None])[:, 0]
        upd = _rotl64(h ^ (byte * _XP5), 11) * _XP1
        h = torch.where(off + ti < lens, upd, h)
    return _xxh_fmix(h)


def _xxh_kind(kind: int, data, lengths, h):
    if kind == kernels.HASH_STR:
        return xxh64_bytes_plain(data, lengths, h)
    if kind in (kernels.HASH_F32, kernels.HASH_F64):
        data = _float_bits(data, kind)
    if kind in (kernels.HASH_I32, kernels.HASH_F32):
        return xxh64_int_plain(data, h)
    return xxh64_long_plain(data, h)


def xxh64_column_plain(col: DeviceColumn, seed: torch.Tensor
                       ) -> torch.Tensor:
    """One column's xxhash64 update of the running hash (validity
    ignored), dispatched on its type as K30 does."""
    kind, data, lengths = _hash_input(col, plain=True)
    return _xxh_kind(kind, data, lengths, seed)


def xxhash64_columns_plain(cols: Sequence[DeviceColumn],
                           seed: Seed = XXHASH_DEFAULT_SEED
                           ) -> torch.Tensor:
    """Plain PyTorch version of K30: XxHash64(cols, seed), seeds chained,
    nulls skipped; int64."""
    cap = cols[0].capacity
    if isinstance(seed, torch.Tensor):
        h = seed.to(torch.int64)
    else:
        h = torch.full((cap,), _seed64(seed), dtype=torch.int64,
                       device=cols[0].device)
    for c in cols:
        h = torch.where(c.validity, xxh64_column_plain(c, h), h)
    return h


# ----------------------------------------------------------- kernel K30

def xxhash64_columns(cols: Sequence[DeviceColumn],
                     seed: int = XXHASH_DEFAULT_SEED) -> torch.Tensor:
    """Spark XxHash64(cols, seed): seeds chained left to right, a null
    leaves the running hash; int64. One K30 launch a kernels.MAX_HASH_COLS
    columns on the card, each later one seeded by the one before."""
    if cols[0].device.type == "cpu":
        return xxhash64_columns_plain(cols, seed)
    n = cols[0].capacity
    dev = cols[0].device
    out = None
    for at in range(0, len(cols), kernels.MAX_HASH_COLS):
        descs, _keep = key_col_descs(cols[at:at + kernels.MAX_HASH_COLS])
        nxt = torch.empty(n, dtype=torch.int64, device=dev)
        ptr, _arr = kernels.struct_array(kernels.HashCol, descs)
        _build.check(_build.lib().srtpu_xxhash64(
            ptr, len(descs), n, _seed64(seed),
            None if out is None else out.data_ptr(), nxt.data_ptr(),
            kernels.sm_count(nxt), kernels.stream_ptr(nxt)), "xxhash64")
        kernels.launches["xxhash64"] += 1
        out = nxt
    return out
