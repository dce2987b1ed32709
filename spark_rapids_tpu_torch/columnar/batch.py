"""Device columnar batch over torch tensors — the reference's contract.

Counterpart of `spark_rapids_tpu/columnar/batch.py`, kept leaf for leaf so
every kernel can be diffed array for array against the JAX package:

- a batch has a row capacity (a power of two from `next_capacity`, at
  least `MIN_CAPACITY`, except for uploads bucketed by the fused engine's
  `bucket_capacity` and the views that `truncate` and `slice_rows`
  take) and a row count `num_rows`, a Python int or a 0-d int32 tensor
  left on the device until `row_count()` needs it on the host (the fused
  engine keeps it there: its shrink and concat never sync);
- columns are validity-masked flat tensors; strings are a zero-padded
  [cap, max_bytes] uint8 matrix plus int32 `lengths`; dictionary-encoded
  strings are int16/int32 codes plus a shared `DeviceDictionary`
  (columnar/encoding.py), with `vrange` = (0, K-1) on the codes; a
  decimal(<= 18) is its scaled int64 and a wider one a [cap, 2] int64 limb
  matrix (hi, lo), which travels through every gather, exchange, slice and
  concatenation as one 16-byte leaf;
- nested columns keep the reference's layout: an array<primitive> is a
  [cap, max_elems] element matrix with `lengths` (element counts) and
  `elem_validity` [cap, max_elems] bool; an array<string> a
  [cap, max_elems, max_bytes] uint8 cube with `elem_lengths`
  [cap, max_elems] int32 byte counts besides; a map<k, v> its keys in
  `data`, its values in `map_values` and their validity in
  `elem_validity`; a struct a [cap] int8 placeholder `data` with one
  child column a field in `children` and the parent's validity. Every
  row-shaped leaf (children's included, depth first) travels through
  gathers, the exchange, slices and concatenation (each piece padded to
  the widest trailing axes) and the download.

Rows at index >= num_rows are garbage; every operator masks with
``row_mask(capacity, num_rows)``.

Row gathers go through kernel K8 (kernels/csrc/gather_leaves.cu):
`gather_columns` moves every leaf of every column it is given in one
launch, each by its own index vector, so a batch gather, or both sides of
a join's output, costs one launch; CPU tensors take the plain
`index_select` version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    DataType,
    MapType,
    StringType,
    StructType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import is_wide, torch_dtype

MIN_CAPACITY = 1024


def next_capacity(rows: int, minimum: int = MIN_CAPACITY) -> int:
    """Smallest power-of-two capacity bucket holding `rows`."""
    cap = max(int(minimum), 1)
    rows = max(int(rows), 1)
    while cap < rows:
        cap <<= 1
    return cap


@lru_cache(maxsize=32)
def _iota(capacity: int, device: torch.device) -> torch.Tensor:
    """0..capacity-1 as int32, made once per capacity bucket and device
    (read-only: every caller only compares against it)."""
    return torch.arange(capacity, dtype=torch.int32, device=device)


def row_mask(capacity: int, num_rows: Union[int, torch.Tensor],
             device: torch.device) -> torch.Tensor:
    """Boolean [capacity] mask of logically-live rows."""
    iota = _iota(int(capacity), torch.device(device))
    if isinstance(num_rows, torch.Tensor):
        return iota < num_rows.to(torch.int32)
    return iota < int(num_rows)


class DeviceColumn:
    """One device column: data (+ lengths for strings) + validity.

    data:     [cap] of the dtype's torch type; [cap, max_bytes] uint8 for
              strings; [cap] int16/int32 codes for encoded strings;
              [cap, max_elems] of the element type for arrays (the keys
              of a map); [cap, max_elems, max_bytes] uint8 for
              array<string>; [cap, 2] int64 (hi, lo) limbs for decimals
              past 18 digits; a [cap] int8 placeholder for structs
    validity: [cap] bool, True = valid (non-null row)
    lengths:  [cap] int32 byte counts (plain strings), element counts
              (arrays, maps)
    vrange:   static (lo, hi) bound on integer values or codes; enables
              the sort-free binned group-by. Gathers keep it.
    encoding: DeviceDictionary for dictionary-encoded strings
    elem_validity: [cap, max_elems] bool, per-element validity (arrays;
              the values' validity for maps)
    map_values: [cap, max_elems] values of a map
    children: a struct's field columns
    elem_lengths: [cap, max_elems] int32 element byte counts
              (array<string>)
    """

    __slots__ = ("dtype", "data", "validity", "lengths", "vrange",
                 "encoding", "elem_validity", "map_values", "children",
                 "elem_lengths")

    def __init__(self, dtype: DataType, data: torch.Tensor,
                 validity: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                 vrange=None, encoding=None,
                 elem_validity: Optional[torch.Tensor] = None,
                 map_values: Optional[torch.Tensor] = None,
                 children: Optional[List["DeviceColumn"]] = None,
                 elem_lengths: Optional[torch.Tensor] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.lengths = lengths
        self.vrange = vrange
        self.encoding = encoding
        self.elem_validity = elem_validity
        self.map_values = map_values
        self.children = children
        self.elem_lengths = elem_lengths

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, StringType)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def max_bytes(self) -> Optional[int]:
        return int(self.data.shape[1]) \
            if self.is_string and self.data.dim() == 2 else None

    @property
    def is_array(self) -> bool:
        return isinstance(self.dtype, ArrayType)

    @property
    def max_elems(self) -> Optional[int]:
        return int(self.data.shape[1]) if self.is_array else None

    def replace(self, **kw) -> "DeviceColumn":
        """Copy with selected leaves replaced."""
        return DeviceColumn(
            kw.get("dtype", self.dtype),
            kw.get("data", self.data),
            kw.get("validity", self.validity),
            kw.get("lengths", self.lengths),
            kw.get("vrange", self.vrange),
            kw.get("encoding", self.encoding),
            kw.get("elem_validity", self.elem_validity),
            kw.get("map_values", self.map_values),
            kw.get("children", self.children),
            kw.get("elem_lengths", self.elem_lengths))

    def with_validity(self, validity: torch.Tensor) -> "DeviceColumn":
        return self.replace(validity=validity)

    def leaves(self) -> List[torch.Tensor]:
        """The row-shaped tensors a gather moves, a struct's children's
        after its own; an encoded column's dictionary is shared, not
        row-shaped, and stays."""
        out = [self.data, self.validity]
        for x in (self.lengths, self.elem_validity, self.map_values,
                  self.elem_lengths):
            if x is not None:
                out.append(x)
        for c in self.children or ():
            out += c.leaves()
        return out

    def with_leaves(self, leaves: Sequence[torch.Tensor]) -> "DeviceColumn":
        rest = iter(leaves[2:])

        def nxt(x):
            return next(rest) if x is not None else None

        lengths, ev = nxt(self.lengths), nxt(self.elem_validity)
        mv, el = nxt(self.map_values), nxt(self.elem_lengths)
        kids = None
        if self.children is not None:
            kids = [c.with_leaves([next(rest) for _ in c.leaves()])
                    for c in self.children]
        return self.replace(data=leaves[0], validity=leaves[1],
                            lengths=lengths, elem_validity=ev,
                            map_values=mv, elem_lengths=el, children=kids)

    def gather(self, indices: torch.Tensor) -> "DeviceColumn":
        """Row gather; indices must lie in [0, capacity) (the kernel traps
        on others, where jnp.take clamps). Gathered values are a subset,
        so vrange survives, and an encoded column moves only its codes."""
        return gather_columns([(self, indices)])[0]

    def truncate(self, cap: int) -> "DeviceColumn":
        """Row-prefix view [:cap] of every row-shaped leaf; callers
        guarantee the live rows fit in cap."""
        return self.slice_rows(0, cap)

    def slice_rows(self, lo: int, hi: int) -> "DeviceColumn":
        """View of rows [lo, hi) of every row-shaped leaf (no copy)."""
        return self.with_leaves([x[lo:hi] for x in self.leaves()])

    def device_size_bytes(self) -> int:
        """Bytes of the row-shaped leaves; an encoded column's dictionary
        is shared across batches and not counted, as in the reference."""
        return sum(x.numel() * x.element_size() for x in self.leaves())


class ColumnBatch:
    """A batch of device columns with shared capacity and row count.
    `row_count()` brings the count to the host (a device sync when it is
    a tensor) and keeps it."""

    __slots__ = ("schema", "columns", "num_rows", "_host_rows")

    def __init__(self, schema: StructType, columns: List[DeviceColumn],
                 num_rows: Union[int, torch.Tensor]):
        if len(schema.fields) != len(columns):
            raise ValueError(f"{len(schema.fields)} fields, "
                             f"{len(columns)} columns")
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows
        self._host_rows = num_rows if isinstance(num_rows, int) else None

    @property
    def capacity(self) -> int:
        if not self.columns:
            return MIN_CAPACITY
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def row_count(self) -> int:
        if self._host_rows is None:
            self._host_rows = int(self.num_rows.item())
        return self._host_rows

    def live_mask(self) -> torch.Tensor:
        return row_mask(self.capacity, self.num_rows, self.device)

    def gather(self, indices: torch.Tensor, new_num_rows) -> "ColumnBatch":
        return ColumnBatch(
            self.schema, gather_columns([(c, indices) for c in self.columns]),
            new_num_rows)

    def slice_rows(self, lo: int, hi: int) -> "ColumnBatch":
        """Rows [lo, hi) as views, every row live: a batch of capacity
        hi - lo, which `concat_batches` brings back to a capacity bucket."""
        return ColumnBatch(self.schema,
                           [c.slice_rows(lo, hi) for c in self.columns],
                           hi - lo)

    def select(self, indices: Sequence[int]) -> "ColumnBatch":
        return ColumnBatch(
            StructType([self.schema.fields[i] for i in indices]),
            [self.columns[i] for i in indices], self.num_rows)

    def device_size_bytes(self) -> int:
        return sum(c.device_size_bytes() for c in self.columns)

    def __repr__(self):
        return (f"ColumnBatch(rows={self._host_rows or '?'}, "
                f"cap={self.capacity}, cols={self.schema.names})")


def gather_leaves_plain(srcs: Sequence[torch.Tensor],
                        idxs: Sequence[torch.Tensor],
                        masks: Optional[Sequence[Optional[torch.Tensor]]]
                        = None, clamp: bool = False,
                        outs: Optional[Sequence[torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """Plain PyTorch version of K8: one index_select per leaf."""
    masks = list(masks) if masks is not None else [None] * len(srcs)
    got = []
    for s, i, m in zip(srcs, idxs, masks):
        i = i.to(torch.int64)
        if clamp:
            i = i.clamp(0, int(s.shape[0]) - 1)
        o = s.index_select(0, i)
        if m is not None:
            keep = m.reshape((-1,) + (1,) * (o.dim() - 1))
            o = torch.where(keep, o, torch.zeros_like(o))
        got.append(o)
    if outs is None:
        return got
    for o, g in zip(outs, got):
        o.copy_(g)
    return list(outs)


def _unit(x: int) -> int:
    """Widest load/store (16, 8, 4, 2 or 1 bytes) dividing x (a row width
    or'ed with the base addresses)."""
    return min(x & -x, 16)


def gather_leaves(srcs: Sequence[torch.Tensor],
                  idxs: Sequence[torch.Tensor],
                  masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                  clamp: bool = False,
                  outs: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Kernel K8: out[k][i] = srcs[k][idxs[k][i]] for row-major leaves
    (a row is every trailing axis of a leaf),
    every index vector of one length, in one launch per 32 leaves. A mask
    zeroes the out rows where it is False; `clamp` clips indices into
    range (decode's dictionary codes) where otherwise an index outside
    [0, rows) traps. Indices are int32, or int16 codes. `outs` are the
    contiguous tensors to write (views into larger buffers, say: the
    mesh engine's receive blocks), one a leaf of its leaf's dtype and
    trailing shape; by default the outputs are allocated."""
    if srcs[0].device.type == "cpu":
        return gather_leaves_plain(srcs, idxs, masks, clamp, outs)
    masks = list(masks) if masks is not None else [None] * len(srcs)
    dev = srcs[0].device
    dev_index = srcs[0].get_device()
    n_out = int(idxs[0].shape[0])
    checked: Dict[int, torch.Tensor] = {}
    for idx in idxs:
        if id(idx) not in checked:
            ok = idx if idx.dtype in (torch.int32, torch.int16) \
                else idx.to(torch.int32)
            kernels.require(ok, "indices", ok.dtype, dev)
            if ok.shape[0] != n_out:
                raise ValueError(f"index vectors of {ok.shape[0]} and "
                                 f"{n_out} rows in one gather")
            checked[id(idx)] = ok
    given = list(outs) if outs is not None else None
    outs, leaves = [], []
    for k, (x, idx, mask) in enumerate(zip(srcs, idxs, masks)):
        if not x.is_contiguous():
            x = x.contiguous()
        if x.get_device() != dev_index or x.shape[0] == 0:
            raise ValueError(f"leaf of {tuple(x.shape)} on {x.device}: "
                             f"expected a non-empty leaf on {dev}")
        # a row is its trailing axes' bytes (an array<string> cube's
        # [max_elems, max_bytes] included)
        row_bytes = x.element_size() * int(np.prod(x.shape[1:], dtype=int))
        if given is None:
            out = torch.empty((n_out,) + x.shape[1:], dtype=x.dtype,
                              device=dev)
        else:
            out = given[k]
            if (out.dtype != x.dtype or out.device != dev
                    or tuple(out.shape) != (n_out,) + tuple(x.shape[1:])
                    or not out.is_contiguous()):
                raise ValueError(
                    f"out {tuple(out.shape)} {out.dtype} on {out.device} "
                    f"for a leaf of {tuple(x.shape)} {x.dtype}")
        outs.append(out)
        if mask is not None:
            kernels.require(mask, "mask", torch.bool, dev)
        ok = checked[id(idx)]
        src_ptr, dst_ptr = x.data_ptr(), out.data_ptr()
        leaves.append(kernels.GatherLeaf(
            src_ptr, dst_ptr, ok.data_ptr(),
            None if mask is None else mask.data_ptr(), x.shape[0],
            row_bytes, _unit(row_bytes | src_ptr | dst_ptr),
            ok.element_size(), int(clamp)))
    if n_out == 0:
        return outs
    for lo in range(0, len(leaves), kernels.MAX_LEAVES):
        chunk = leaves[lo:lo + kernels.MAX_LEAVES]
        ptr, _arr = kernels.struct_array(kernels.GatherLeaf, chunk)
        _build.check(_build.lib().srtpu_gather_leaves(
            ptr, len(chunk), n_out, kernels.sm_count(outs[0]),
            kernels.stream_ptr(outs[0])), "gather_leaves")
        kernels.launches["gather_leaves"] += 1
    return outs


def gather_columns(pairs: Sequence[Tuple[DeviceColumn, torch.Tensor]],
                   clamp: bool = False) -> List[DeviceColumn]:
    """Gather each column by its index vector: every leaf of every column
    in one K8 launch on the card (index vectors of one length); `clamp`
    clips the indices into each column's rows."""
    if not pairs:
        return []
    srcs, idxs, spans = [], [], []
    for col, idx in pairs:
        ls = col.leaves()
        spans.append(len(ls))
        srcs += ls
        idxs += [idx] * len(ls)
    outs = gather_leaves(srcs, idxs, clamp=clamp)
    cols, at = [], 0
    for (col, _), k in zip(pairs, spans):
        cols.append(col.with_leaves(outs[at:at + k]))
        at += k
    return cols


def _empty_column(dtype: DataType, capacity: int, string_bytes: int,
                  device: torch.device) -> DeviceColumn:
    """A column of no valid rows; an array, map or struct gets width-1
    element leaves (the reference's `_empty_column`)."""
    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    valid = zeros(capacity, torch.bool)
    if isinstance(dtype, StringType):
        return DeviceColumn(dtype, zeros((capacity, string_bytes),
                                         torch.uint8),
                            valid, zeros(capacity, torch.int32))
    if isinstance(dtype, ArrayType):
        et = dtype.elementType
        lens, ev = zeros(capacity, torch.int32), zeros((capacity, 1),
                                                       torch.bool)
        if isinstance(et, StringType):  # the array<string> cube
            return DeviceColumn(
                dtype, zeros((capacity, 1, string_bytes), torch.uint8),
                valid, lens, elem_validity=ev,
                elem_lengths=zeros((capacity, 1), torch.int32))
        return DeviceColumn(dtype, zeros((capacity, 1), torch_dtype(et)),
                            valid, lens, elem_validity=ev)
    if isinstance(dtype, MapType):
        return DeviceColumn(
            dtype, zeros((capacity, 1), torch_dtype(dtype.keyType)), valid,
            zeros(capacity, torch.int32),
            elem_validity=zeros((capacity, 1), torch.bool),
            map_values=zeros((capacity, 1), torch_dtype(dtype.valueType)))
    if isinstance(dtype, StructType):
        return DeviceColumn(
            dtype, zeros(capacity, torch.int8), valid,
            children=[_empty_column(f.dataType, capacity, string_bytes,
                                    device) for f in dtype.fields])
    shape = (capacity, 2) if is_wide(dtype) else (capacity,)
    return DeviceColumn(dtype, zeros(shape, torch_dtype(dtype)), valid)


def empty_like_schema(schema: StructType, capacity: int,
                      device: torch.device,
                      string_bytes: int = 8) -> ColumnBatch:
    cols = [_empty_column(f.dataType, capacity, string_bytes, device)
            for f in schema.fields]
    return ColumnBatch(schema, cols, 0)


def _pad_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-pad the row axis of x to cap rows."""
    if x.shape[0] == cap:
        return x
    out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


def _concat_columns(pieces, cap: int, total: int,
                    dtype: DataType) -> DeviceColumn:
    """Concatenate per-batch column prefixes into one [cap] column
    (recursing into a struct's children). Encoded pieces stay encoded only
    when every piece shares one dictionary; any mismatch decodes first.
    Variable-width leaves (string bytes, array elements, both axes of an
    array<string> cube) are zero-padded to the widest piece."""
    if any(c.encoding is not None for c, _ in pieces):
        from spark_rapids_tpu_torch.columnar import encoding as _enc

        aligned = _enc.align_encodings([c for c, _ in pieces])
        pieces = list(zip(aligned, (n for _, n in pieces)))
    first = pieces[0][0]

    def cat(parts):
        if parts[0].dim() >= 2:
            target = [max(int(p.shape[ax]) for p in parts)
                      for ax in range(1, parts[0].dim())]
            parts = [pad_trailing(p, target) for p in parts]
        return _pad_rows(torch.cat(parts, dim=0), cap)

    def leaf(name):
        if getattr(first, name) is None:
            return None
        return cat([getattr(c, name)[:n] for c, n in pieces])

    kids = None
    if first.children is not None:
        kids = [_concat_columns([(c.children[i], n) for c, n in pieces],
                                cap, total, first.children[i].dtype)
                for i in range(len(first.children))]
    # encoded columns keep their [0, K) code bound through concat (the
    # binned group-by depends on it); plain columns drop vrange here,
    # as the reference does
    vr = first.vrange if (
        first.encoding is not None
        and all(c.vrange == first.vrange for c, _ in pieces)) else None
    return DeviceColumn(dtype, leaf("data"), leaf("validity"),
                        leaf("lengths"), vrange=vr, encoding=first.encoding,
                        elem_validity=leaf("elem_validity"),
                        map_values=leaf("map_values"), children=kids,
                        elem_lengths=leaf("elem_lengths"))


def concat_batches(batches: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches into one at the capacity bucket of their total
    rows (one host sync per batch for its row count). A single batch
    already at a capacity bucket comes back as it is."""
    if not batches:
        raise ValueError("concat_batches of no batches")
    if len(batches) == 1 and batches[0].capacity == next_capacity(
            batches[0].capacity):
        return batches[0]
    schema = batches[0].schema
    total = sum(b.row_count() for b in batches)
    cap = next_capacity(total)
    cols = [_concat_columns([(b.columns[ci], b.row_count())
                             for b in batches], cap, total, f.dataType)
            for ci, f in enumerate(schema.fields)]
    return ColumnBatch(schema, cols, total)


def concat_compacted(batches: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches at the sum of their capacities with the live
    rows compacted to the front, without reading any row count on the host
    (the reference's trace-safe `concat_traced`): every leaf is
    concatenated whole, K1 orders the live rows first and one K8 launch
    gathers every leaf. A single batch comes back as it is."""
    if len(batches) == 1:
        return batches[0]
    from spark_rapids_tpu_torch.ops import filterops

    schema = batches[0].schema
    total_cap = sum(b.capacity for b in batches)
    live = torch.cat([b.live_mask() for b in batches])
    cols = [_concat_columns([(b.columns[ci], b.capacity) for b in batches],
                            total_cap, total_cap, f.dataType)
            for ci, f in enumerate(schema.fields)]
    perm, total = filterops.compact_perm(live, total_cap)
    return ColumnBatch(schema, cols, total_cap).gather(perm, total)


def batch_from_host_leaves(schema: StructType, leaves: List[Dict],
                           num_rows: int, device=None) -> ColumnBatch:
    """Build a batch from plain numpy leaves, one dict per column:
    `data`, `validity`, optional `lengths`, optional `vrange`, and for an
    encoded column `dict_values` (the dictionary's canonical values, a
    list of str). The arrays keep their dtypes and capacity exactly, so a
    JAX batch turned into leaves gives the identical port batch."""
    from spark_rapids_tpu_torch import resolve_device
    from spark_rapids_tpu_torch.columnar import encoding as _enc

    device = resolve_device(device)
    cols = []
    for field, leaf in zip(schema.fields, leaves):
        def up(a):
            return torch.from_numpy(np.array(a, order="C")).to(device)

        enc = None
        if leaf.get("dict_values") is not None:
            import pyarrow as pa

            dict_id, remap = _enc.intern_dictionary(
                pa.array(leaf["dict_values"], type=pa.large_string()))
            if remap is not None:
                raise ValueError("dictionary values must be canonical "
                                 "(unique, no nulls)")
            enc = _enc.device_dictionary(dict_id, device)
        vr = leaf.get("vrange")
        cols.append(DeviceColumn(
            field.dataType, up(leaf["data"]), up(leaf["validity"]),
            None if leaf.get("lengths") is None else up(leaf["lengths"]),
            vrange=None if vr is None else (int(vr[0]), int(vr[1])),
            encoding=enc))
    return ColumnBatch(schema, cols, int(num_rows))


def row_select(pred: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Row-wise where: a [cap] predicate broadcast across every trailing
    axis of x and y (string bytes, array elements)."""
    return torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)


def pad_trailing(x: Optional[torch.Tensor],
                 trailing: Sequence[int]) -> Optional[torch.Tensor]:
    """Zero-pad x's trailing axes up to `trailing` (x itself when they
    are equal): the alignment of variable-width leaves (string bytes,
    array elements) before a row-wise select."""
    if x is None or tuple(x.shape[1:]) == tuple(trailing):
        return x
    out = torch.zeros((x.shape[0],) + tuple(trailing), dtype=x.dtype,
                      device=x.device)
    out[(slice(None),) + tuple(slice(0, s) for s in x.shape[1:])] = x
    return out
