"""Host (Arrow) <-> device (ColumnBatch) transitions in the port.

Counterpart of `spark_rapids_tpu/columnar/arrow_bridge.py` for primitive,
decimal, string, dictionary-string, array, map and struct columns:

- `arrow_to_device` builds each column's leaves in numpy (the string byte
  matrix vectorised, no per-row Python), writes every leaf of the batch
  into ONE pinned host staging buffer and uploads it with ONE
  `non_blocking` copy; the columns are views into that one device buffer.
  Dictionary-encoded string columns upload as codes plus an interned
  dictionary (columnar/encoding.py); a decimal column's values are read
  from Arrow's 16-byte words (an int64, or [n, 2] limbs past 18 digits).
  A list becomes the padded [n, max_elems] element matrix (a list<string>
  the [n, max_elems, max_bytes] cube), a map its key and value matrices,
  a struct one child column a field, each from the offsets in one
  vectorised gather (the reference's `_list_to_matrix`,
  `_strlist_to_cube`, `_map_to_matrices`).
- `device_to_arrow` fetches the live rows and rebuilds Arrow arrays,
  decoding encoded columns on the host from codes plus dictionary and
  decimal columns from their words in one vectorised step, and lists,
  maps and structs from their in-row elements with no per-element
  Python;
  `device_to_arrow_fused` fetches a small batch, its row count and the
  fused engine's flags in ONE device-to-host copy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    next_capacity,
)
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    DecimalType,
    MapType,
    StringType,
    StructField,
    StructType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    from_arrow_type,
    is_wide,
    to_arrow_type,
    torch_dtype,
)

#: alignment of each leaf inside the staging buffer (keeps every typed
#: view of the device buffer aligned)
_LEAF_ALIGN = 256


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c <<= 1
    return c


def schema_from_arrow(schema: pa.Schema) -> StructType:
    return StructType([
        StructField(f.name, from_arrow_type(f.type), f.nullable)
        for f in schema
    ])


def _string_to_matrix(arr: pa.Array, pad_to: Optional[int] = None):
    """Arrow utf8 array -> ([n, max_bytes] uint8, lengths int32)."""
    arr = arr.cast(pa.large_string()) if pa.types.is_string(arr.type) else arr
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                            count=len(arr) + arr.offset + 1)
    offsets = offsets[arr.offset:arr.offset + len(arr) + 1].astype(np.int64)
    data_buf = arr.buffers()[2]
    flat = (np.frombuffer(data_buf, dtype=np.uint8)
            if data_buf is not None and len(data_buf) else
            np.zeros(1, dtype=np.uint8))
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    max_len = int(lengths.max()) if len(lengths) else 0
    mb = _round_up_pow2(max(max_len, 1), minimum=pad_to or 8)
    idx = offsets[:-1, None] + np.arange(mb, dtype=np.int64)[None, :]
    mask = np.arange(mb, dtype=np.int32)[None, :] < lengths[:, None]
    out = np.where(mask, flat[np.clip(idx, 0, len(flat) - 1)], 0).astype(
        np.uint8)
    return out, lengths


def _matrix_to_string(data: np.ndarray, lengths: np.ndarray,
                      validity: np.ndarray) -> pa.Array:
    """([n, mb] uint8, lengths, validity) -> Arrow utf8 array."""
    n = len(lengths)
    if n == 0:
        return pa.array([], type=pa.string())
    mb = data.shape[1]
    lengths = np.minimum(lengths.astype(np.int64), mb)
    mask = np.arange(mb)[None, :] < lengths[:, None]
    flat = data[mask]
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    arr = pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()), pa.py_buffer(flat.tobytes()))
    if not validity.all():
        arr = pa.compute.if_else(pa.array(validity), arr,
                                 pa.nulls(n, pa.string()))
    return arr


def _decimal_np(arr: pa.Array, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """An Arrow decimal array -> (values, validity) from the decimal128
    buffer's 16-byte little-endian two's-complement words, read directly:
    a decimal(<= 18)'s value is the low word, a wider one's the [n, 2]
    (hi, lo) limb matrix. Nulls are zero-filled."""
    validity = np.asarray(arr.is_valid())
    # every decimal128 holds 16-byte words whatever its precision; only
    # another width (decimal256) is cast
    arr128 = arr if pa.types.is_decimal128(arr.type) else arr.cast(
        pa.decimal128(38, arr.type.scale))
    buf = arr128.buffers()[1]
    off, n = arr128.offset, len(arr128)
    if buf is None:
        words = np.zeros(2 * n, dtype=np.int64)
    else:
        words = np.frombuffer(buf, dtype=np.int64,
                              count=(off + n) * 2)[off * 2:]
    lo = words[0::2].copy()
    lo[~validity] = 0
    if not is_wide(dtype):
        return lo, validity
    hi = words[1::2].copy()
    hi[~validity] = 0
    return np.stack([hi, lo], axis=1), validity


def _decimal_array(data: np.ndarray, validity: np.ndarray, dtype
                   ) -> pa.Array:
    """A decimal column's fetched values ([n] int64 or [n, 2] limbs) ->
    an Arrow decimal128 array, built from one 16-byte word pair a row in
    one vectorised step (the reference builds a Python Decimal a row)."""
    n = len(validity)
    words = np.empty((n, 2), dtype=np.int64)
    if data.ndim == 2:
        words[:, 0], words[:, 1] = data[:, 1], data[:, 0]
    else:
        words[:, 0] = data
        words[:, 1] = data >> 63
    bitmap = None
    if not validity.all():
        words[~validity] = 0
        bitmap = pa.py_buffer(np.packbits(validity, bitorder="little"))
    return pa.Array.from_buffers(
        pa.decimal128(dtype.precision, dtype.scale), n,
        [bitmap, pa.py_buffer(words)])


def _primitive_np(arr: pa.Array, np_dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Arrow primitive array -> (values with nulls zero-filled, validity)."""
    validity = np.asarray(arr.is_valid())
    vals = np.asarray(arr.fill_null(False if pa.types.is_boolean(arr.type)
                                    else 0))
    return vals.astype(np_dtype, copy=False), validity


def _leaf_np(arr: pa.Array, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(values, validity) of a flat primitive or decimal(<= 18) array."""
    if isinstance(dtype, DecimalType):
        return _decimal_np(arr, dtype)
    return _primitive_np(arr, dtype.np_dtype)


def _offsets_rows(arr: pa.Array, width_min: int):
    """A list or map array's element positions: (index [n, me] into its
    flat child, in_row [n, me], lengths int32) with me the power of two
    >= the longest row (at least width_min)."""
    offsets = np.asarray(arr.offsets).astype(np.int64)[:len(arr) + 1]
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    max_len = int(lengths.max()) if len(lengths) else 0
    me = _round_up_pow2(max(max_len, 1), minimum=width_min)
    idx = offsets[:-1, None] + np.arange(me, dtype=np.int64)[None, :]
    in_row = np.arange(me, dtype=np.int32)[None, :] < lengths[:, None]
    return idx, in_row, lengths


def _take_rows(flat: np.ndarray, idx: np.ndarray, in_row: np.ndarray):
    """flat[idx] where in_row, zeros elsewhere (an empty child gives all
    zeros)."""
    if len(flat) == 0:
        return np.zeros(idx.shape + flat.shape[1:], dtype=flat.dtype)
    got = flat[np.clip(idx, 0, len(flat) - 1)]
    keep = in_row.reshape(in_row.shape + (1,) * (flat.ndim - 1))
    return np.where(keep, got, np.zeros((), dtype=flat.dtype))


def _list_to_matrix(arr: pa.Array, elem_dtype):
    """Arrow list<primitive> -> ([n, max_elems] element matrix, lengths
    int32, elem_validity [n, max_elems]); max_elems is a power of two of
    at least 4."""
    idx, in_row, lengths = _offsets_rows(arr, 4)
    vals, valid = _leaf_np(arr.values, elem_dtype)
    return (_take_rows(vals, idx, in_row), lengths,
            _take_rows(valid, idx, in_row))


def _strlist_to_cube(arr: pa.Array):
    """Arrow list<string> -> ([n, max_elems, max_bytes] uint8 cube, row
    lengths, elem_validity [n, max_elems], element byte lengths
    [n, max_elems]); max_elems is a power of two of at least 2."""
    idx, in_row, lengths = _offsets_rows(arr, 2)
    smat, slens = _string_to_matrix(arr.values)
    svalid = np.asarray(arr.values.is_valid(), dtype=bool)
    return (_take_rows(smat, idx, in_row), lengths,
            _take_rows(svalid, idx, in_row),
            _take_rows(slens, idx, in_row).astype(np.int32))


def _map_to_matrices(arr: pa.Array, dt):
    """Arrow map<k, v> -> (key matrix, value matrix, lengths, value
    validity) in the padded layout."""
    idx, in_row, lengths = _offsets_rows(arr, 4)
    kvals, _ = _leaf_np(arr.keys, dt.keyType)
    vvals, vvalid = _leaf_np(arr.items, dt.valueType)
    return (_take_rows(kvals, idx, in_row), _take_rows(vvals, idx, in_row),
            lengths, _take_rows(vvalid, idx, in_row))


def _nested_from_arrow(arr: pa.Array, field: StructField) -> DeviceColumn:
    """An array, map or struct Arrow array -> its host leaves."""
    dt = field.dataType
    validity = np.asarray(arr.is_valid(), dtype=bool)
    if isinstance(dt, ArrayType) and isinstance(dt.elementType, StringType):
        cube, lengths, ev, el = _strlist_to_cube(arr)
        return DeviceColumn(dt, cube, validity, lengths, elem_validity=ev,
                           elem_lengths=el)
    if isinstance(dt, ArrayType):
        mat, lengths, ev = _list_to_matrix(arr, dt.elementType)
        return DeviceColumn(dt, mat, validity, lengths, elem_validity=ev)
    if isinstance(dt, MapType):
        kmat, vmat, lengths, ev = _map_to_matrices(arr, dt)
        return DeviceColumn(dt, kmat, validity, lengths, elem_validity=ev,
                           map_values=vmat)
    # a struct: one child a field, the parent's validity for the row
    kids = [column_from_arrow(arr.field(i), f, None)
            for i, f in enumerate(dt.fields)]
    return DeviceColumn(dt, np.zeros(len(arr), np.int8), validity,
                       children=kids)


def column_from_arrow(arr: pa.Array, field: StructField,
                      device: Optional[torch.device],
                      string_pad_min: int = 8) -> DeviceColumn:
    """One pyarrow array -> its host leaves: a DeviceColumn of numpy
    arrays, which `upload_columns` swaps for device views after the one
    upload (`with_leaves`). Dictionary-encoded strings
    stay encoded (but inside a struct, whose child has no device: decoded
    there, as the reference decodes them); any other dictionary decodes
    first."""
    if pa.types.is_dictionary(arr.type):
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        enc = (_enc.encoded_column_from_arrow(arr, field, device)
               if device is not None else None)
        if enc is not None:
            codes, validity, vrange, dd = enc
            return DeviceColumn(field.dataType, codes, validity,
                               vrange=vrange, encoding=dd)
        arr = arr.dictionary_decode()
    if isinstance(field.dataType, (ArrayType, MapType, StructType)):
        return _nested_from_arrow(arr, field)
    if isinstance(field.dataType, StringType):
        mat, lengths = _string_to_matrix(arr, pad_to=string_pad_min)
        return DeviceColumn(field.dataType, mat, np.asarray(arr.is_valid()),
                           lengths)
    if field.dataType.np_dtype is None:
        raise TypeError(f"column {field.name}: type {field.dataType} is not "
                        "ported to the torch package yet")
    if isinstance(field.dataType, DecimalType):
        vals, validity = _decimal_np(arr, field.dataType)
        return DeviceColumn(field.dataType, vals, validity)
    vals, validity = _primitive_np(arr, field.dataType.np_dtype)
    return DeviceColumn(field.dataType, vals, validity)


def _upload(leaves: List[np.ndarray], cap: int,
            device: torch.device) -> List[torch.Tensor]:
    """Stage every leaf, zero-padded to cap rows, in one host buffer
    (pinned when the target is a CUDA device) and copy it over in one
    non_blocking transfer. Returns [cap, ...] views of the device buffer."""
    regions, total = [], 0
    for a in leaves:
        off = -(-total // _LEAF_ALIGN) * _LEAF_ALIGN
        total = off + cap * a.dtype.itemsize * int(np.prod(a.shape[1:]))
        regions.append((off, total))
    pinned = device.type == "cuda"
    staging = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pinned)
    host = staging.numpy()
    for a, (off, end) in zip(leaves, regions):
        live = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        host[off:off + live.size] = live
        host[off + live.size:end] = 0
    dev = staging.to(device, non_blocking=True) if pinned else staging
    return [dev[off:end].view(torch_dtype(a.dtype)).view((cap,) + a.shape[1:])
            for a, (off, end) in zip(leaves, regions)]


def upload_columns(host_cols: List[DeviceColumn], cap: int,
                   device: torch.device) -> List[DeviceColumn]:
    """Every leaf of the host columns (numpy) in one upload; the device
    columns are views into the one buffer."""
    leaves = [leaf for hc in host_cols for leaf in hc.leaves()]
    dev = iter(_upload(leaves, cap, device))
    return [hc.with_leaves([next(dev) for _ in hc.leaves()])
            for hc in host_cols]


def arrow_to_device(table, capacity: Optional[int] = None,
                    device=None, string_pad_min: int = 8) -> ColumnBatch:
    """pyarrow Table/RecordBatch -> ColumnBatch on `device` (default
    `cuda`; raises when no GPU is present and no device is given)."""
    device = resolve_device(device)
    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    table = table.combine_chunks()
    n = table.num_rows
    cap = capacity or next_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} rows")
    schema = schema_from_arrow(table.schema)
    host_cols = []
    for i, field in enumerate(schema.fields):
        col = table.column(i)
        arr = (col.chunk(0) if col.num_chunks else
               pa.array([], type=table.schema.field(i).type))
        host_cols.append(column_from_arrow(arr, field, device,
                                           string_pad_min))
    return ColumnBatch(schema, upload_columns(host_cols, cap, device), n)


def _flat_array(flat: np.ndarray, valid: np.ndarray, dtype) -> pa.Array:
    """Arrow array of flat primitive or decimal(<= 18) values."""
    if isinstance(dtype, DecimalType):
        return _decimal_array(flat, valid, dtype)
    return pa.array(flat.astype(dtype.np_dtype, copy=False),
                    type=to_arrow_type(dtype),
                    mask=None if valid.all() else ~valid)


def _list_offsets(lengths: np.ndarray, width: int):
    """(in_row [n, width], int32 offsets) of rows with these element
    counts (clamped to the matrix width, as the reference does)."""
    lengths = np.minimum(lengths.astype(np.int64), width)
    in_row = np.arange(width)[None, :] < lengths[:, None]
    offsets = np.zeros(len(lengths) + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    return in_row, offsets


def _nested_array(dt, col: DeviceColumn) -> pa.Array:
    """An array, map or struct column's host leaves -> an Arrow array,
    vectorised (the reference's `_matrix_to_list`, `_cube_to_strlist`,
    `_matrices_to_map` and struct branch)."""
    validity = col.validity
    n = len(validity)
    mask = None if validity.all() else pa.array(~validity)
    if isinstance(dt, StructType):
        kids = [_column_array(f.dataType, k)
                for f, k in zip(dt.fields, col.children)]
        return pa.StructArray.from_arrays(
            kids, fields=[pa.field(f.name, to_arrow_type(f.dataType),
                                   f.nullable) for f in dt.fields],
            mask=mask)
    if n == 0:
        return pa.array([], type=to_arrow_type(dt))
    width = col.data.shape[1]
    if isinstance(dt, ArrayType) and isinstance(dt.elementType, StringType):
        # null rows contribute no elements
        in_row, offsets = _list_offsets(
            np.where(validity, col.lengths, 0), width)
        values = _matrix_to_string(col.data[in_row],
                                   col.elem_lengths[in_row],
                                   col.elem_validity[in_row])
        return pa.ListArray.from_arrays(pa.array(offsets), values, mask=mask)
    in_row, offsets = _list_offsets(col.lengths, width)
    if isinstance(dt, MapType):
        keys = _flat_array(col.data[in_row],
                           np.ones(int(in_row.sum()), dtype=bool), dt.keyType)
        items = _flat_array(col.map_values[in_row], col.elem_validity[in_row],
                            dt.valueType)
        out = pa.MapArray.from_arrays(pa.array(offsets, type=pa.int32()),
                                      keys, items)
        if mask is not None:
            out = pa.compute.if_else(pa.array(validity), out,
                                     pa.nulls(n, to_arrow_type(dt)))
        return out
    child = _flat_array(col.data[in_row], col.elem_validity[in_row],
                        dt.elementType)
    return pa.ListArray.from_arrays(pa.array(offsets, type=pa.int32()),
                                    child, mask=mask)


def _column_array(dt, col: DeviceColumn) -> pa.Array:
    """A column whose leaves are fetched numpy live rows -> an Arrow
    array; encoded columns decode on the host from their codes and the
    dictionary."""
    data, validity = col.data, col.validity
    if col.encoding is not None:
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        dd = col.encoding
        hd = _enc._host_dict(dd.dict_id)
        if hd is not None:
            ddata, dlens = hd.matrix, hd.lengths
        else:
            ddata, dlens = dd.data.cpu().numpy(), dd.lengths.cpu().numpy()
        k = max(ddata.shape[0], 1)
        codes = np.clip(data.astype(np.int64), 0, k - 1)
        return _matrix_to_string(ddata[codes],
                                 np.where(validity, dlens[codes], 0),
                                 validity)
    if isinstance(dt, (ArrayType, MapType, StructType)):
        return _nested_array(dt, col)
    if isinstance(dt, StringType):
        return _matrix_to_string(data, col.lengths, validity)
    if isinstance(dt, DecimalType):
        return _decimal_array(data, validity, dt)
    mask = None if validity.all() else ~validity
    return pa.array(data.astype(dt.np_dtype, copy=False),
                    type=to_arrow_type(dt), mask=mask)


def _host_array(field: StructField, col: DeviceColumn,
                leaves: List[np.ndarray]) -> pa.Array:
    """One column's fetched live-row leaves (in `leaves()` order) -> an
    Arrow array."""
    return _column_array(field.dataType, col.with_leaves(leaves))


def device_to_arrow(batch: ColumnBatch) -> pa.Table:
    """ColumnBatch -> pyarrow Table: fetches only the live rows."""
    n = batch.row_count()
    arrays = [_host_array(f, c, [x[:n].cpu().numpy() for x in c.leaves()])
              for f, c in zip(batch.schema.fields, batch.columns)]
    return pa.Table.from_arrays(arrays, names=batch.schema.names)


def device_to_arrow_fused(batch: ColumnBatch, flags: torch.Tensor
                          ) -> Tuple[pa.Table, np.ndarray]:
    """(table, host flags) from ONE device-to-host copy of the row count,
    the flags and every leaf of the batch (whole capacity): the fused
    engine's small-result fetch."""
    dev = flags.device
    nr = batch.num_rows
    nr = (nr.reshape(1).to(torch.int32) if isinstance(nr, torch.Tensor)
          else torch.full((1,), nr, dtype=torch.int32, device=dev))
    leaves = [x for c in batch.columns for x in c.leaves()]
    pieces = [nr.view(torch.uint8), flags.reshape(-1).view(torch.uint8)]
    pieces += [x.contiguous().view(torch.uint8).reshape(-1) for x in leaves]
    host = torch.cat(pieces).cpu().numpy()
    n = int(host[:4].view(np.int32)[0])
    at = 4 + flags.numel()
    host_flags = host[4:at].astype(bool)
    fetched = []
    for x in leaves:
        size = x.numel() * x.element_size()
        np_dt = torch.empty(0, dtype=x.dtype).numpy().dtype
        fetched.append(host[at:at + size].view(np_dt)
                       .reshape(tuple(x.shape))[:n])
        at += size
    arrays, k = [], 0
    for f, c in zip(batch.schema.fields, batch.columns):
        m = len(c.leaves())
        arrays.append(_host_array(f, c, fetched[k:k + m]))
        k += m
    return pa.Table.from_arrays(arrays, names=batch.schema.names), host_flags
