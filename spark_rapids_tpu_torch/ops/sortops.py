"""Per-batch sort and the merge of sorted runs (the out-of-core sort) —
counterpart of `spark_rapids_tpu/ops/sortops.py`.

- `sort_batch`: the orderable key words of the sort orders (kernel K9's
  pack), their stable radix sort (K9) and one gather of every leaf by the
  permutation (K8). No kernel of its own.
- `merge_sorted`: merge two sorted runs WITHOUT re-sorting: each live
  row's place is its own index plus its rank in the other run (the lower
  bound for rows of the first run, the upper bound for rows of the
  second, so ties keep the first run's rows first), then a scatter of
  every leaf. Kernel K13 (`merge_runs`, kernels/csrc/merge_runs.cu) does
  both in two launches, with K2's key search.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar import encoding as _enc
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnBatch,
    DeviceColumn,
    _unit,
    next_capacity,
)
from spark_rapids_tpu_torch.expr import EvalContext
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.ops.common import KeySpec, pack_keys, sort_words
from spark_rapids_tpu_torch.ops.joinops import _binary_search

Rows = Union[int, torch.Tensor]


def order_keys(batch: ColumnBatch, orders) -> torch.Tensor:
    """Orderable key words [nwords, capacity] of a batch under the given
    SortOrders (dead rows rank last), in one K9 pack."""
    live = batch.live_mask()
    ctx = EvalContext(batch)
    specs = [KeySpec(o.expr.eval(ctx), o.ascending, o.nulls_first)
             for o in orders]
    words, _ = pack_keys(specs, live)
    return words


def sort_batch(batch: ColumnBatch, orders) -> ColumnBatch:
    perm = sort_words(order_keys(batch, orders))
    return batch.gather(perm, batch.num_rows)


def _align_col(ca: DeviceColumn, cb: DeviceColumn
               ) -> Tuple[DeviceColumn, DeviceColumn]:
    """Bring a column pair to one layout: encoded columns onto one
    dictionary (or both decoded), string byte matrices zero-padded to
    one width, so key words and scatters line up."""
    if ca.encoding is not None or cb.encoding is not None:
        ca, cb = _enc.align_encodings([ca, cb])
    if ca.data.dim() < 2:
        return ca, cb
    width = max(int(ca.data.shape[1]), int(cb.data.shape[1]))

    def pad_to(c: DeviceColumn) -> DeviceColumn:
        if int(c.data.shape[1]) == width:
            return c
        return c.replace(data=torch.nn.functional.pad(
            c.data, (0, width - int(c.data.shape[1]))))

    return pad_to(ca), pad_to(cb)


def align_string_widths(a: ColumnBatch, b: ColumnBatch
                        ) -> Tuple[ColumnBatch, ColumnBatch]:
    """Pad string columns of both batches to a common byte width so key
    structures (packed word counts) and scatters line up."""
    pairs = [_align_col(ca, cb) for ca, cb in zip(a.columns, b.columns)]
    return (ColumnBatch(a.schema, [p[0] for p in pairs], a.num_rows),
            ColumnBatch(b.schema, [p[1] for p in pairs], b.num_rows))


def _rows_tensor(rows: Rows, device: torch.device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(rows), dtype=torch.int32, device=device)


def merge_runs_plain(ka: torch.Tensor, kb: torch.Tensor, na: Rows, nb: Rows,
                     leaves_a: Sequence[torch.Tensor],
                     leaves_b: Sequence[torch.Tensor],
                     out_cap: int) -> List[torch.Tensor]:
    """Plain PyTorch version of K13: the reference's two binary searches
    and its zero-initialised scatters, dead rows (and any place past
    out_cap) sent to a spare row that is cut off."""
    dev = ka.device
    ca, cb = int(ka.shape[1]), int(kb.shape[1])
    na_t, nb_t = _rows_tensor(na, dev), _rows_tensor(nb, dev)
    pos_b = _binary_search(list(kb.unbind(0)), list(ka.unbind(0)), nb_t, cb,
                           upper=False)
    pos_a = _binary_search(list(ka.unbind(0)), list(kb.unbind(0)), na_t, ca,
                           upper=True)
    ia = torch.arange(ca, dtype=torch.int32, device=dev)
    ib = torch.arange(cb, dtype=torch.int32, device=dev)
    dest_a = torch.where(ia < na_t, ia + pos_b, out_cap).clamp(max=out_cap)
    dest_b = torch.where(ib < nb_t, ib + pos_a, out_cap).clamp(max=out_cap)
    outs = []
    for xa, xb in zip(leaves_a, leaves_b):
        out = torch.zeros((out_cap + 1,) + tuple(xa.shape[1:]),
                          dtype=xa.dtype, device=dev)
        out[dest_b.to(torch.int64)] = xb
        out[dest_a.to(torch.int64)] = xa
        outs.append(out[:out_cap])
    return outs


def merge_runs(ka: torch.Tensor, kb: torch.Tensor, na: Rows, nb: Rows,
               leaves_a: Sequence[torch.Tensor],
               leaves_b: Sequence[torch.Tensor],
               out_cap: int) -> List[torch.Tensor]:
    """Kernel K13: merge two runs, each sorted by its key words ([W, ca]
    and [W, cb] int64) over its live rows [0, na) and [0, nb), into leaves
    of out_cap rows: leaf k of the output holds leaf k of both runs at the
    merged places (ties: the first run's rows first), zero past na + nb.
    The leaves of a pair share dtype and trailing shape."""
    if ka.device.type == "cpu":
        return merge_runs_plain(ka, kb, na, nb, leaves_a, leaves_b, out_cap)
    dev = ka.device
    kernels.require(ka, "ka", torch.int64, dev, ndim=2)
    kernels.require(kb, "kb", torch.int64, dev, ndim=2)
    W, ca, cb = int(ka.shape[0]), int(ka.shape[1]), int(kb.shape[1])
    if int(kb.shape[0]) != W or W == 0:
        raise ValueError(f"key words {tuple(ka.shape)} and "
                         f"{tuple(kb.shape)} differ")
    if len(leaves_a) != len(leaves_b) or not leaves_a:
        raise ValueError("the runs' leaves differ in number")
    na_t, nb_t = _rows_tensor(na, dev), _rows_tensor(nb, dev)
    outs, leaves, keep = [], [], []
    for xa, xb in zip(leaves_a, leaves_b):
        xa = xa if xa.is_contiguous() else xa.contiguous()
        xb = xb if xb.is_contiguous() else xb.contiguous()
        if (xa.dtype != xb.dtype or xa.shape[1:] != xb.shape[1:]
                or xa.shape[0] != ca or xb.shape[0] != cb or xa.dim() > 2
                or xa.device != dev or xb.device != dev):
            raise ValueError(f"leaves {tuple(xa.shape)} {xa.dtype} and "
                             f"{tuple(xb.shape)} {xb.dtype} do not pair "
                             f"with runs of {ca} and {cb} rows")
        out = torch.empty((out_cap,) + tuple(xa.shape[1:]), dtype=xa.dtype,
                          device=dev)
        row_bytes = xa.element_size() * (int(xa.shape[1])
                                         if xa.dim() == 2 else 1)
        keep += [xa, xb]
        outs.append(out)
        leaves.append(kernels.MergeLeaf(
            xa.data_ptr(), xb.data_ptr(), out.data_ptr(), row_bytes,
            _unit(row_bytes | xa.data_ptr() | xb.data_ptr()
                  | out.data_ptr())))
    dest = torch.empty(ca + cb, dtype=torch.int32, device=dev)
    lib = _build.lib()
    for lo in range(0, len(leaves), kernels.MAX_MERGE_LEAVES):
        chunk = leaves[lo:lo + kernels.MAX_MERGE_LEAVES]
        ptr, _arr = kernels.struct_array(kernels.MergeLeaf, chunk)
        _build.check(lib.srtpu_merge_runs(
            ka.data_ptr(), ca, kb.data_ptr(), cb, W, na_t.data_ptr(),
            nb_t.data_ptr(), out_cap, ptr, len(chunk), dest.data_ptr(),
            int(lo == 0), kernels.sm_count(ka), kernels.stream_ptr(ka)),
            "merge_runs")
        kernels.launches["merge_runs"] += 1
    return outs


def _sum_rows(na: Rows, nb: Rows) -> Rows:
    if isinstance(na, int) and isinstance(nb, int):
        return na + nb
    dev = na.device if isinstance(na, torch.Tensor) else nb.device
    return _rows_tensor(na, dev) + _rows_tensor(nb, dev)


def merge_sorted(a: ColumnBatch, b: ColumnBatch, orders,
                 out_cap: int = None) -> ColumnBatch:
    """Merge two batches already sorted by `orders` into one sorted batch
    (cuDF `Table.merge` analog). `out_cap` only needs to hold the live
    rows (pass next_capacity(rows_a + rows_b) to avoid capacity bloat
    across merge-tree levels); dead rows are dropped. vrange is dropped,
    as the reference drops it (a's bound does not bound b's values); an
    encoded column keeps the dictionary both runs share."""
    a, b = align_string_widths(a, b)
    ka = order_keys(a, orders)
    kb = order_keys(b, orders)
    if out_cap is None:
        out_cap = next_capacity(a.capacity + b.capacity)
    spans, la, lb = [], [], []
    for fa, fb in zip(a.columns, b.columns):
        xa, xb = fa.leaves(), fb.leaves()
        spans.append(len(xa))
        la += xa
        lb += xb
    outs = merge_runs(ka, kb, a.num_rows, b.num_rows, la, lb, out_cap)
    cols, at = [], 0
    for fa, k in zip(a.columns, spans):
        leaves = outs[at:at + k]
        at += k
        cols.append(DeviceColumn(
            fa.dtype, leaves[0], leaves[1],
            leaves[2] if fa.lengths is not None else None,
            encoding=fa.encoding))
    return ColumnBatch(a.schema, cols, _sum_rows(a.num_rows, b.num_rows))
