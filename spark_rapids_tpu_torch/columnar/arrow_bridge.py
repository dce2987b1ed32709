"""Host (Arrow) <-> device (ColumnBatch) transitions in the port.

Counterpart of `spark_rapids_tpu/columnar/arrow_bridge.py` for primitive,
string and dictionary-string columns:

- `arrow_to_device` builds each column's leaves in numpy (the string byte
  matrix vectorised, no per-row Python), writes every leaf of the batch
  into ONE pinned host staging buffer and uploads it with ONE
  `non_blocking` copy; the columns are views into that one device buffer.
  Dictionary-encoded string columns upload as codes plus an interned
  dictionary (columnar/encoding.py).
- `device_to_arrow` fetches the live rows and rebuilds Arrow arrays,
  decoding encoded columns on the host from codes plus dictionary;
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
from spark_rapids_tpu_torch.sqltypes import StringType, StructField, StructType
from spark_rapids_tpu_torch.sqltypes.datatypes import (
    from_arrow_type,
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


def _primitive_np(arr: pa.Array, np_dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Arrow primitive array -> (values with nulls zero-filled, validity)."""
    validity = np.asarray(arr.is_valid())
    vals = np.asarray(arr.fill_null(False if pa.types.is_boolean(arr.type)
                                    else 0))
    return vals.astype(np_dtype, copy=False), validity


class _HostColumn:
    """A column's live-row leaves in numpy, before upload."""

    __slots__ = ("dtype", "data", "validity", "lengths", "vrange",
                 "encoding")

    def __init__(self, dtype, data, validity, lengths=None, vrange=None,
                 encoding=None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.lengths = lengths
        self.vrange = vrange
        self.encoding = encoding

    def leaves(self) -> List[np.ndarray]:
        out = [self.data, self.validity]
        if self.lengths is not None:
            out.append(self.lengths)
        return out


def column_from_arrow(arr: pa.Array, field: StructField,
                      device: torch.device,
                      string_pad_min: int = 8) -> _HostColumn:
    """One pyarrow array -> its host leaves. Dictionary-encoded strings
    stay encoded; any other dictionary decodes first."""
    if pa.types.is_dictionary(arr.type):
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        enc = _enc.encoded_column_from_arrow(arr, field, device)
        if enc is not None:
            codes, validity, vrange, dd = enc
            return _HostColumn(field.dataType, codes, validity,
                               vrange=vrange, encoding=dd)
        arr = arr.dictionary_decode()
    if isinstance(field.dataType, StringType):
        mat, lengths = _string_to_matrix(arr, pad_to=string_pad_min)
        return _HostColumn(field.dataType, mat, np.asarray(arr.is_valid()),
                           lengths)
    if field.dataType.np_dtype is None:
        raise TypeError(f"column {field.name}: type {field.dataType} is not "
                        "ported to the torch package yet")
    vals, validity = _primitive_np(arr, field.dataType.np_dtype)
    return _HostColumn(field.dataType, vals, validity)


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
    leaves = [leaf for hc in host_cols for leaf in hc.leaves()]
    dev = iter(_upload(leaves, cap, device))
    cols = []
    for hc in host_cols:
        data, validity = next(dev), next(dev)
        lengths = next(dev) if hc.lengths is not None else None
        cols.append(DeviceColumn(hc.dtype, data, validity, lengths,
                                 vrange=hc.vrange, encoding=hc.encoding))
    return ColumnBatch(schema, cols, n)


def _host_array(field: StructField, col: DeviceColumn,
                leaves: List[np.ndarray]) -> pa.Array:
    """One column's fetched live-row leaves -> an Arrow array; encoded
    columns decode on the host from their codes and the dictionary."""
    data, validity = leaves[0], leaves[1]
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
    if isinstance(field.dataType, StringType):
        return _matrix_to_string(data, leaves[2], validity)
    mask = None if validity.all() else ~validity
    return pa.array(data.astype(field.dataType.np_dtype, copy=False),
                    type=to_arrow_type(field.dataType), mask=mask)


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
