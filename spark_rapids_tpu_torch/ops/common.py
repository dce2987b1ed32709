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

Descending order is bitwise NOT of the key. These run as plain torch on
the device: B4 in the port's kernel table, a hand kernel still to write.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
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


def orderable_keys(col: DeviceColumn, ascending: bool, nulls_first: bool,
                   live: torch.Tensor,
                   codes_ok: bool = False) -> List[torch.Tensor]:
    """Lower one column (+ sort direction) to signed-orderable int64 keys:
    [null_rank_key, value_key...]; dead rows rank last in any direction.

    Dictionary-encoded columns: with `codes_ok` (equality-only contexts,
    where interned dictionaries make code equality == value equality) the
    key is the code; otherwise the column decodes on the device first."""
    if col.encoding is not None:
        if codes_ok:
            valid = col.validity
            vals = [torch.where(valid & live, col.data.to(torch.int64), 0)]
            if not ascending:
                vals = [~v for v in vals]
            return [_null_rank(valid, live, nulls_first)] + vals
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        col = _enc.decode_column(col)
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


def sort_permutation(key_arrays: List[torch.Tensor],
                     capacity: int) -> torch.Tensor:
    """Stable multi-key sort; returns the int32 gather permutation. The
    reference's one `lax.sort(num_keys=k, is_stable=True)` is a chain of
    stable sorts here, from the least significant key to the most."""
    device = key_arrays[0].device
    perm = torch.arange(capacity, dtype=torch.int64, device=device)
    for k in reversed(key_arrays):
        order = torch.sort(k.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, order)
    return perm.to(torch.int32)
