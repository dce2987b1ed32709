"""Orderable sort keys and row-wise equality — counterpart of
`spark_rapids_tpu/ops/common.py`.

Every column lowers to int64 tensors whose signed order is the SQL order
("orderable keys"), so a stable multi-key sort implements multi-column
ORDER BY / GROUP BY / join-key ordering:

- integrals/date/timestamp/decimal64: sign-extended int64;
- double: the IEEE-754 total-order bit trick on the exact f64 bits, NaN
  canonicalised, so NaN sorts above +inf and -0.0 below 0.0 (Java's
  Double.compare); float: the same on f32 bits. The reference's f32 bits
  for doubles are a TPU limit and are not copied;
- strings: zero-padded bytes packed big-endian 4 per int64 word, with the
  length as the final tie-break;
- a leading "null rank" key orders NULLS FIRST/LAST and forces dead rows
  (index >= num_rows) after every live row.

Descending order is bitwise NOT of the key.

Kernel K9 (kernels/csrc/sort_keys.cu) computes both halves on the card:
`pack_keys` writes the key words of several columns in one launch
([nwords, n] int64; `orderable_keys` is its one-column shape), and
`sort_words` sorts rows by them with a stable LSD radix sort. The
elementwise chain below and the chain of stable `torch.sort`s are their
plain versions, which run only for tensors on the CPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes import DoubleType, FloatType, StringType

_I64_MIN = -0x8000000000000000
_I32_MIN = -0x80000000


def _float_orderable(data: torch.Tensor) -> torch.Tensor:
    """float -> int64 whose signed order is Java's Double.compare order."""
    if data.dtype == torch.float64:
        b = data.view(torch.int64)
        b = torch.where(torch.isnan(data),
                        torch.full_like(b, 0x7FF8000000000000), b)
        # flip the negative range: MIN - b - 1 maps descending negatives
        # to ascending, the classic bit trick in signed space
        return torch.where(b < 0, _I64_MIN - b - 1, b)
    f = data.to(torch.float32)
    b = f.view(torch.int32)
    b = torch.where(torch.isnan(f), torch.full_like(b, 0x7FC00000), b)
    b = torch.where(b < 0, _I32_MIN - b - 1, b)
    return b.to(torch.int64)


def _string_orderable(col: DeviceColumn) -> List[torch.Tensor]:
    """Packed big-endian 4-byte int64 words (relies on the zero-padding
    invariant), then the length as the final tie-break key."""
    mb = col.max_bytes
    nwords = (mb + 3) // 4
    data = col.data
    if nwords * 4 != mb:
        data = torch.nn.functional.pad(data, (0, nwords * 4 - mb))
    words = data.reshape(data.shape[0], nwords, 4).to(torch.int64)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=data.device)
    packed = (words << shifts[None, None, :]).sum(dim=-1)
    return [packed[:, i] for i in range(nwords)] + [
        col.lengths.to(torch.int64)]


def normalize_floating(col: DeviceColumn) -> DeviceColumn:
    """Spark's NormalizeFloatingNumbers: -0.0 -> 0.0 for group/join keys
    (NaNs are canonicalised by the total-order key transform)."""
    if isinstance(col.dtype, (FloatType, DoubleType)):
        data = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                           col.data)
        return DeviceColumn(col.dtype, data, col.validity, col.lengths)
    return col


def _null_rank(valid: torch.Tensor, live: torch.Tensor,
               nulls_first: bool) -> torch.Tensor:
    rank = valid.to(torch.int64) if nulls_first else (~valid).to(torch.int64)
    return torch.where(live, rank, torch.full_like(rank, 2))


def orderable_keys_plain(col: DeviceColumn, ascending: bool, nulls_first: bool,
                   live: torch.Tensor,
                   codes_ok: bool = False) -> List[torch.Tensor]:
    """Plain PyTorch version of K9's pack for one column."""
    if col.encoding is not None:
        if codes_ok:
            valid = col.validity
            vals = [torch.where(valid & live, col.data.to(torch.int64), 0)]
            if not ascending:
                vals = [~v for v in vals]
            return [_null_rank(valid, live, nulls_first)] + vals
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        col = _enc.decode_column_plain(col)
    valid = col.validity
    rank = _null_rank(valid, live, nulls_first)
    dt = col.dtype
    if isinstance(dt, StringType):
        vals = _string_orderable(col)
    elif isinstance(dt, (FloatType, DoubleType)):
        vals = [_float_orderable(col.data)]
    else:
        vals = [col.data.to(torch.int64)]
    # null/dead rows: zero the value keys so order within them is stable
    vals = [torch.where(valid & live, v, 0) for v in vals]
    if not ascending:
        vals = [~v for v in vals]
    return [rank] + vals


def orderable_keys(col: DeviceColumn, ascending: bool, nulls_first: bool,
                   live: torch.Tensor,
                   codes_ok: bool = False) -> List[torch.Tensor]:
    """Lower one column (+ sort direction) to signed-orderable int64 keys:
    [null_rank_key, value_key...]; dead rows rank last in any direction.

    Dictionary-encoded columns: with `codes_ok` (equality-only contexts,
    where interned dictionaries make code equality == value equality) the
    key is the code; otherwise the column decodes on the device first."""
    if live.device.type == "cpu":
        return orderable_keys_plain(col, ascending, nulls_first, live,
                                    codes_ok)
    words, _ = pack_keys([KeySpec(col, ascending, nulls_first, True,
                                  codes_ok)], live)
    return list(words.unbind(0))


def equality_keys(col: DeviceColumn, live: torch.Tensor,
                  codes_ok: bool = False) -> List[torch.Tensor]:
    """Keys whose tuple equality == SQL group/join-key equality (null ==
    null for grouping; normalise float zeros first in the caller)."""
    return orderable_keys(col, True, True, live, codes_ok=codes_ok)


def rows_equal_adjacent(keys: List[torch.Tensor]) -> torch.Tensor:
    """For sorted keys: eq[i] = keys[i] == keys[i-1] (eq[0] = False)."""
    eq = None
    for k in keys:
        e = torch.cat([torch.zeros(1, dtype=torch.bool, device=k.device),
                       k[1:] == k[:-1]])
        eq = e if eq is None else (eq & e)
    return eq


def sort_permutation_plain(key_arrays: Sequence[torch.Tensor],
                           capacity: int) -> torch.Tensor:
    """Plain PyTorch version of K9's sort: the reference's one
    `lax.sort(num_keys=k, is_stable=True)` as a chain of stable sorts, from
    the least significant key to the most."""
    device = key_arrays[0].device
    perm = torch.arange(capacity, dtype=torch.int64, device=device)
    for k in reversed(list(key_arrays)):
        order = torch.sort(k.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, order)
    return perm.to(torch.int32)


def sort_permutation(key_arrays: List[torch.Tensor],
                     capacity: int) -> torch.Tensor:
    """Stable multi-key sort; returns the int32 gather permutation."""
    if key_arrays[0].device.type == "cpu":
        return sort_permutation_plain(key_arrays, capacity)
    return sort_words(torch.stack(list(key_arrays)))


# ------------------------------------------------------------------- K9

class KeySpec(NamedTuple):
    """One key column of a K9 pack: its direction, whether it leads with
    its null-rank word, whether encoded columns key on their codes
    (`codes_ok`) and whether -0.0 folds into 0.0 first
    (`normalize_floating`, for group and join keys)."""

    col: DeviceColumn
    ascending: bool = True
    nulls_first: bool = True
    with_rank: bool = True
    codes_ok: bool = False
    normalize_zero: bool = False


def _pack_ready(spec: KeySpec, plain: bool = False) -> KeySpec:
    """An encoded column that may not key on its codes decodes first (K8,
    or its plain version for a plain pack)."""
    col = spec.col
    if col.encoding is not None and not spec.codes_ok:
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        decode = _enc.decode_column_plain if plain else _enc.decode_column
        return spec._replace(col=decode(col))
    return spec


def _value_words(col: DeviceColumn) -> int:
    if col.encoding is None and isinstance(col.dtype, StringType):
        return (col.max_bytes + 3) // 4 + 1
    return 1


def pack_keys_plain(specs: Sequence[KeySpec], live: torch.Tensor,
                    lead_rank: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K9's pack: (words [nwords, n] int64, the
    all-keys-valid mask of the live rows)."""
    words: List[torch.Tensor] = []
    all_valid = live
    for spec in specs:
        spec = _pack_ready(spec, plain=True)
        col = spec.col
        if spec.normalize_zero:
            col = normalize_floating(col)
        all_valid = all_valid & col.validity
        ks = orderable_keys_plain(col, spec.ascending, spec.nulls_first,
                                  live, codes_ok=spec.codes_ok)
        words.extend(ks if spec.with_rank else ks[1:])
    if lead_rank:
        words.insert(0, (~all_valid).to(torch.int64))
    return torch.stack(words), all_valid


_PACK_KIND = {torch.int8: kernels.PACK_I8, torch.int16: kernels.PACK_I16,
              torch.int32: kernels.PACK_I32, torch.int64: kernels.PACK_I64,
              torch.float32: kernels.PACK_F32,
              torch.float64: kernels.PACK_F64, torch.bool: kernels.PACK_BOOL}


def pack_keys(specs: Sequence[KeySpec], live: torch.Tensor,
              lead_rank: bool = False, want_all_valid: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K9's pack: the orderable key words of every spec's column,
    word-major in one [nwords, n] int64 tensor (per column its null-rank
    word when `with_rank`, then its value words), in one launch. With
    `lead_rank` word 0 is 1 where some key is null or the row is dead (a
    join build side's leading key). Returns (words, the all-keys-valid mask
    of the live rows when `want_all_valid`, else None)."""
    if live.device.type == "cpu":
        words, all_valid = pack_keys_plain(specs, live, lead_rank)
        return words, all_valid if want_all_valid else None
    dev = live.device
    n = int(live.shape[0])
    kernels.require(live, "live", torch.bool, dev)
    specs = [_pack_ready(s) for s in specs]
    if len(specs) > kernels.MAX_PACK_COLS:
        raise ValueError(f"K9 packs at most {kernels.MAX_PACK_COLS} key "
                         f"columns, got {len(specs)}")
    cols, keep = [], []
    word = 1 if lead_rank else 0
    for spec in specs:
        c = spec.col
        data = c.data if c.data.is_contiguous() else c.data.contiguous()
        kernels.require(c.validity, "validity", torch.bool, dev)
        if data.device != dev or data.shape[0] != n:
            raise ValueError(f"key column of {tuple(data.shape)} on "
                             f"{data.device}: expected {n} rows on {dev}")
        is_str = c.encoding is None and isinstance(c.dtype, StringType)
        if is_str:
            kernels.require(data, "string data", torch.uint8, dev, ndim=2)
            kernels.require(c.lengths, "lengths", torch.int32, dev)
            kind, row_bytes = kernels.PACK_STR, int(data.shape[1])
        else:
            kind = _PACK_KIND.get(data.dtype)
            if kind is None or data.dim() != 1:
                raise TypeError(f"K9 cannot pack {data.dtype} "
                                f"{tuple(data.shape)} keys")
            row_bytes = 0
        keep.append(data)
        cols.append(kernels.PackCol(
            data.data_ptr(), c.validity.data_ptr(),
            c.lengths.data_ptr() if is_str else None, kind, row_bytes,
            word, int(spec.with_rank), int(not spec.ascending),
            int(spec.nulls_first), int(spec.normalize_zero), 0))
        word += int(spec.with_rank) + _value_words(c)
    words = torch.empty((word, n), dtype=torch.int64, device=dev)
    all_valid = (torch.empty(n, dtype=torch.bool, device=dev)
                 if want_all_valid else None)
    ptr, _arr = kernels.struct_array(kernels.PackCol, cols)
    _build.check(_build.lib().srtpu_pack_keys(
        ptr, len(cols), int(lead_rank), live.data_ptr(), n,
        words.data_ptr(), None if all_valid is None else all_valid.data_ptr(),
        kernels.sm_count(live), kernels.stream_ptr(live)), "pack_keys")
    kernels.launches["pack_keys"] += 1
    return words, all_valid


def sort_words(words: torch.Tensor) -> torch.Tensor:
    """Kernel K9's sort: the stable int32 permutation that orders the
    columns of words [nwords, n] int64 lexicographically (word 0 most
    significant, signed order), as the reference's stable lax.sort."""
    if words.device.type == "cpu":
        return sort_permutation_plain(list(words.unbind(0)),
                                      int(words.shape[1]))
    dev = words.device
    kernels.require(words, "words", torch.int64, dev, ndim=2)
    nwords, n = int(words.shape[0]), int(words.shape[1])
    if nwords == 0 or n == 0 or n >= 1 << 31:
        raise ValueError(f"K9 sorts 1..2^31-1 rows of at least one word, "
                         f"got {tuple(words.shape)}")
    lib = _build.lib()
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.srtpu_sort_scratch_bytes(nwords, n)),
                          dtype=torch.uint8, device=dev)
    _build.check(lib.srtpu_sort_words(
        words.data_ptr(), nwords, n, perm.data_ptr(), scratch.data_ptr(),
        kernels.sm_count(words), kernels.stream_ptr(words)), "sort_words")
    kernels.launches["sort_words"] += 1
    return perm
