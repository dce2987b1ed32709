"""Collection expressions over the padded array and map layouts —
counterpart of `spark_rapids_tpu/expr/collections.py` (Spark's
collectionOperations.scala and higherOrderFunctions.scala).

Arrays are [cap, max_elems] element matrices with `lengths` and
`elem_validity` (array<string>: a [cap, max_elems, max_bytes] cube with
`elem_lengths`); maps keep their keys in `data` and values in
`map_values`. Null semantics follow Spark, as the reference's do:

- size(null) = -1 (the legacy sizeOfNull default);
- array_contains: null if the array is null; true if found; null if not
  found but the array has null elements; else false;
- getItem / element_at out of bounds -> null (non-ANSI);
- array(...) of N children builds a fixed-N array a row.

Elementwise parts are torch, as the reference's are elementwise jnp
(masks, comparisons, the set operations' pairwise membership, the
reductions of array_max and array_min). What is not elementwise runs on
the port's kernels:

- K34 (`array_compact`, csrc/array_rows.cu): the stable left-pack of kept
  elements behind filter, array_remove, array_intersect and array_except
  (the reference's `_row_compact`, a row-wise stable argsort);
- K34's distinct mode (`array_distinct`): the first occurrences of each
  row behind array_distinct and the set operations (the reference's
  `_distinct_of`, a [cap, me, me] pairwise test and a compaction);
- K35 (`array_sort`): sort_array's per-row stable sort (the reference's
  lexsort along axis 1);
- K8 (columnar.batch.gather_leaves) over the flattened element index
  row * max_elems + element: the element picks of getItem, element_at,
  a map's value lookup, slice, reverse and concat.

A CPU tensor takes each kernel's plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceColumn,
    gather_leaves,
    pad_trailing,
)
from spark_rapids_tpu_torch.expr.core import (
    EvalContext,
    Expression,
    binary_validity,
)
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes import (
    ArrayType,
    IntegerType,
    MapType,
    StringType,
)
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean, integer, long


# ----------------------------------------------------------- K34 and K35

def _elem_eq(a: torch.Tensor, b: torch.Tensor,
             a_ok: Optional[torch.Tensor] = None,
             b_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise element equality with NULL == NULL set semantics and NaN
    == NaN (the reference's `_elem_eq`)."""
    eq = a == b
    if a.dtype.is_floating_point:
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    if a_ok is not None:
        eq = (eq & a_ok & b_ok) | (~a_ok & ~b_ok)
    return eq


def _left_pack(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each row's kept entries of x moved to the row's front in order
    (their slot: the kept entries before them), zeros after."""
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    me = int(keep.shape[1])
    dest = torch.where(keep, dest, torch.full_like(dest, me))
    shape = (x.shape[0], me + 1) + tuple(x.shape[2:])
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    idx = dest.reshape(dest.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return out.scatter_(1, idx, x)[:, :me]


def array_compact_plain(data: torch.Tensor, ev: torch.Tensor,
                        keep: torch.Tensor,
                        elem_lengths: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K34's compact: the reference's
    `_row_compact` (a stable argsort of ~keep along each row) as each kept
    element's slot, its kept predecessors, with the slots past the kept
    count zeroed."""
    lengths = keep.sum(dim=1).to(torch.int32)
    el = (None if elem_lengths is None
          else _left_pack(elem_lengths, keep))
    return (_left_pack(data, keep), _left_pack(ev & keep, keep), lengths,
            el)


def _rows_args(data: torch.Tensor, ev: torch.Tensor):
    dev = data.device
    kernels.require(ev.contiguous(), "elem_validity", torch.bool, dev, 2)
    rows, me = int(data.shape[0]), int(data.shape[1])
    if tuple(ev.shape) != (rows, me):
        raise ValueError(f"elem_validity {tuple(ev.shape)} for "
                         f"{tuple(data.shape)} elements")
    return dev, rows, me


def _launch_rows(mode: int, kind: int, elem_bytes: int, data, ev, keep,
                 lengths, elem_len, out, out_ev, out_el, out_len,
                 counter: str) -> None:
    rows, me = int(data.shape[0]), int(data.shape[1])
    _build.check(_build.lib().srtpu_array_rows(
        mode, kind, elem_bytes, data.data_ptr(), ev.data_ptr(),
        None if keep is None else keep.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        None if elem_len is None else elem_len.data_ptr(), rows, me,
        out.data_ptr(), out_ev.data_ptr(),
        None if out_el is None else out_el.data_ptr(),
        None if out_len is None else out_len.data_ptr(),
        kernels.sm_count(data), kernels.stream_ptr(data)), counter)
    kernels.launches[counter] += 1


def array_compact(data: torch.Tensor, ev: torch.Tensor, keep: torch.Tensor,
                  elem_lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """Kernel K34, compact: each row's kept elements left-packed in order
    -> (data, elem_validity = ev & keep, lengths = kept count, and an
    array<string> cube's element byte counts), the slots past the count
    zeroed. data is [cap, me] (or a [cap, me, max_bytes] cube with
    elem_lengths)."""
    if data.device.type == "cpu":
        return array_compact_plain(data, ev, keep, elem_lengths)
    dev, rows, me = _rows_args(data, ev)
    data, ev, keep = data.contiguous(), ev.contiguous(), keep.contiguous()
    kernels.require(keep, "keep", torch.bool, dev, 2)
    out = torch.empty_like(data)
    out_ev = torch.empty_like(ev)
    out_len = torch.empty(rows, dtype=torch.int32, device=dev)
    if data.dim() == 3:
        if elem_lengths is None:
            raise ValueError("a cube's compaction needs its elem_lengths")
        elem_lengths = elem_lengths.contiguous()
        kernels.require(elem_lengths, "elem_lengths", torch.int32, dev, 2)
        eb = int(data.shape[2])
        if eb % 8:
            data = pad_trailing(data, (me, -(-eb // 8) * 8))
            out = torch.empty_like(data)
        out_el = torch.empty_like(elem_lengths)
        _launch_rows(kernels.ARR_COMPACT, kernels.ARR_BYTES,
                     int(data.shape[2]), data, ev, keep, None, elem_lengths,
                     out, out_ev, out_el, out_len, "array_compact")
        return out[:, :, :eb], out_ev, out_len, out_el
    kind = kernels.ELEM_KINDS.get(data.dtype)
    if kind is None or data.dim() != 2:
        raise TypeError(f"K34 compacts [rows, me] primitive elements, not "
                        f"{data.dtype} of {tuple(data.shape)}")
    _launch_rows(kernels.ARR_COMPACT, kind, data.element_size(), data, ev,
                 keep, None, None, out, out_ev, None, out_len,
                 "array_compact")
    return out, out_ev, out_len, None


def array_distinct_plain(data: torch.Tensor, ev: torch.Tensor,
                         lengths: torch.Tensor):
    """Plain PyTorch version of K34's distinct mode: the reference's
    `_distinct_of` (a [cap, me, me] pairwise equality with NULL == NULL
    and NaN == NaN, an earlier-element mask) and the compaction."""
    me = int(data.shape[1])
    j = torch.arange(me, device=data.device)
    in_row = j[None, :] < lengths[:, None]
    eq = _elem_eq(data[:, :, None], data[:, None, :], ev[:, :, None],
                  ev[:, None, :])
    earlier = j[None, :, None] > j[None, None, :]
    both = in_row[:, :, None] & in_row[:, None, :]
    dup = (eq & earlier & both).any(dim=2)
    out, oev, olen, _ = array_compact_plain(data, ev, in_row & ~dup)
    return out, oev, olen


def array_distinct(data: torch.Tensor, ev: torch.Tensor,
                   lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K34, distinct: the first occurrence of each value among a
    row's first lengths elements, in order (NULL equal to NULL, NaN to
    NaN, -0.0 to 0.0) -> (data, elem_validity, lengths), the slots past
    the count zeroed. No [cap, me, me] intermediate."""
    if data.device.type == "cpu":
        return array_distinct_plain(data, ev, lengths)
    dev, rows, me = _rows_args(data, ev)
    data, ev, lengths = data.contiguous(), ev.contiguous(), lengths.contiguous()
    kind = kernels.ELEM_KINDS.get(data.dtype)
    if kind is None or data.dim() != 2:
        raise TypeError(f"K34 compares [rows, me] primitive elements, not "
                        f"{data.dtype} of {tuple(data.shape)}")
    kernels.require(lengths, "lengths", torch.int32, dev)
    out = torch.empty_like(data)
    out_ev = torch.empty_like(ev)
    out_len = torch.empty(rows, dtype=torch.int32, device=dev)
    _launch_rows(kernels.ARR_DISTINCT, kind, data.element_size(), data, ev,
                 None, lengths, None, out, out_ev, None, out_len,
                 "array_distinct")
    return out, out_ev, out_len


def _sort_key_plain(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    """The reference's SortArray key: bool as an integer, NaN as +inf,
    negated for descending; an integer's negation wraps in its own width
    (its minimum stays the minimum), computed in int64."""
    if data.dtype.is_floating_point:
        key = torch.where(torch.isnan(data),
                          torch.full_like(data, float("inf")), data)
        return key if ascending else -key
    key = data.to(torch.int64)
    if ascending:
        return key
    low = (0 if data.dtype == torch.bool
           else int(torch.iinfo(data.dtype).min))
    return torch.where(key == low, key, -key)


def array_sort_plain(data: torch.Tensor, ev: torch.Tensor,
                     lengths: torch.Tensor, ascending: bool):
    """Plain PyTorch version of K35: the reference's SortArray (a lexsort
    of (key, rank) along each row: nulls first ascending, last
    descending, dead slots last) as each element's slot, the in-row
    elements before it in (rank, key) order or tied with it and earlier,
    the dead slots kept in place as the kernel keeps them."""
    me = int(data.shape[1])
    j = torch.arange(me, device=data.device)
    in_row = j[None, :] < lengths[:, None]
    valid_rank = 1 if ascending else 0
    rank = torch.where(ev, valid_rank, 1 - valid_rank)
    key = _sort_key_plain(data, ascending)
    rk, rj = rank[:, :, None], rank[:, None, :]
    kk, kj = key[:, :, None], key[:, None, :]
    less = (rk < rj) | ((rk == rj) & (kk < kj))
    tie = (rk == rj) & ~(kk < kj) & ~(kj < kk)
    before = (less | (tie & (j[:, None] < j[None, :]))) & (
        in_row[:, :, None] & in_row[:, None, :])
    pos = torch.where(in_row, before.sum(dim=1), j[None, :])
    return (torch.empty_like(data).scatter_(1, pos, data),
            torch.empty_like(ev).scatter_(1, pos, ev))


def array_sort(data: torch.Tensor, ev: torch.Tensor, lengths: torch.Tensor,
               ascending: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K35: each row's first lengths elements sorted stably by
    (rank, key) as the reference's SortArray orders them (nulls first
    ascending, last descending; NaN ties +inf; descending negates the
    key, so INT_MIN stays first) -> (data, elem_validity); slots past
    lengths keep their place."""
    if data.device.type == "cpu":
        return array_sort_plain(data, ev, lengths, ascending)
    dev, rows, me = _rows_args(data, ev)
    data, ev, lengths = data.contiguous(), ev.contiguous(), lengths.contiguous()
    kind = kernels.ELEM_KINDS.get(data.dtype)
    if kind is None or data.dim() != 2:
        raise TypeError(f"K35 sorts [rows, me] primitive elements, not "
                        f"{data.dtype} of {tuple(data.shape)}")
    kernels.require(lengths, "lengths", torch.int32, dev)
    out = torch.empty_like(data)
    out_ev = torch.empty_like(ev)
    _launch_rows(kernels.ARR_SORT_ASC if ascending else kernels.ARR_SORT_DESC,
                 kind, data.element_size(), data, ev, None, lengths, None,
                 out, out_ev, None, None, "array_sort")
    return out, out_ev


# ------------------------------------------------------ element picks (K8)

def _in_row(c: DeviceColumn) -> torch.Tensor:
    me = int(c.data.shape[1])
    return (torch.arange(me, dtype=torch.int32, device=c.device)[None, :]
            < c.lengths[:, None])


def _flat_index(c: DeviceColumn, src: torch.Tensor) -> torch.Tensor:
    """Flat element index row * max_elems + src (src [cap] or [cap, k],
    clipped into the row) as int32."""
    cap, me = int(c.data.shape[0]), int(c.data.shape[1])
    rows = torch.arange(cap, dtype=torch.int64, device=c.device)
    src = src.to(torch.int64).clamp(0, me - 1)
    if src.dim() == 2:
        rows = rows[:, None]
    return (rows * me + src).reshape(-1).to(torch.int32)


def _elem_leaves(c: DeviceColumn, with_values: bool = False):
    """The element leaves of an array or map column, flattened to one
    element a row: data, elem_validity, and elem_lengths (a cube) or
    map_values (with_values)."""
    cap, me = int(c.data.shape[0]), int(c.data.shape[1])
    out = [c.data.reshape((cap * me,) + tuple(c.data.shape[2:])),
           c.elem_validity.reshape(cap * me)]
    if c.elem_lengths is not None:
        out.append(c.elem_lengths.reshape(cap * me))
    if with_values and c.map_values is not None:
        out.append(c.map_values.reshape(cap * me))
    return out


def _pick(c: DeviceColumn, src: torch.Tensor, with_values: bool = False):
    """Each row's element at src (clipped into the row), through one K8
    launch over the flattened elements: [data, elem_validity, then
    elem_lengths or map_values] with a [cap] src, or [cap, k] matrices
    with a [cap, k] src."""
    leaves = _elem_leaves(c, with_values)
    flat = _flat_index(c, src)
    got = gather_leaves(leaves, [flat] * len(leaves))
    if src.dim() == 2:
        shape = tuple(src.shape)
        got = [g.reshape(shape + tuple(g.shape[1:])) for g in got]
    return got


class Size(Expression):
    """size(array): element count; -1 for null (Spark legacy default)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return integer

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        n = c.lengths.to(torch.int32)
        data = torch.where(c.validity, n, torch.full_like(n, -1))
        return DeviceColumn(integer, data, torch.ones_like(c.validity))


class ArrayContains(Expression):
    def __init__(self, arr: Expression, value: Expression):
        super().__init__([arr, value])

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = self.children[1].eval(ctx)
        in_row = _in_row(c)
        elem_ok = in_row & c.elem_validity
        if c.elem_lengths is not None:  # array<string> needle compare
            w = max(int(v.data.shape[1]), int(c.data.shape[2]))
            elems = pad_trailing(c.data, (int(c.data.shape[1]), w))
            needle = pad_trailing(v.data, (w,))
            eq = ((elems == needle[:, None, :]).all(dim=2)
                  & (c.elem_lengths == v.lengths[:, None]))
        else:
            eq = c.data == v.data[:, None]
        hit = (elem_ok & eq).any(dim=1)
        has_null_elem = (in_row & ~c.elem_validity).any(dim=1)
        valid = c.validity & v.validity & (hit | ~has_null_elem)
        return DeviceColumn(boolean, hit, valid)


def _item_column(dtype, c: DeviceColumn, idx: torch.Tensor,
                 valid: torch.Tensor) -> DeviceColumn:
    """The element at idx of each row as a flat column (a string column
    from an array<string> cube)."""
    got = _pick(c, idx)
    valid = valid & got[1]
    if c.elem_lengths is not None:
        return DeviceColumn(dtype, got[0], valid, got[2])
    return DeviceColumn(dtype, got[0], valid)


class GetArrayItem(Expression):
    """array[index]; out-of-bounds or null element -> null."""

    def __init__(self, arr: Expression, index: Expression):
        super().__init__([arr, index])

    @property
    def dtype(self):
        return self.children[0].dtype.elementType

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        i = self.children[1].eval(ctx)
        idx = i.data.to(torch.int32)
        in_bounds = (idx >= 0) & (idx < c.lengths)
        return _item_column(self.dtype, c, idx,
                            c.validity & i.validity & in_bounds)


class ElementAt(Expression):
    """element_at(array, i): 1-based, negative counts from the end;
    element_at(map, key): value lookup (GetMapValue semantics)."""

    def __init__(self, arr: Expression, index: Expression):
        super().__init__([arr, index])

    @property
    def _is_map(self):
        return isinstance(self.children[0].dtype, MapType)

    @property
    def dtype(self):
        if self._is_map:
            return self.children[0].dtype.valueType
        return self.children[0].dtype.elementType

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        if self._is_map:
            return GetMapValue(*self.children).eval(ctx)
        c = self.children[0].eval(ctx)
        i = self.children[1].eval(ctx)
        raw = i.data.to(torch.int32)
        idx = torch.where(raw > 0, raw - 1, c.lengths + raw)
        in_bounds = (idx >= 0) & (idx < c.lengths) & (raw != 0)
        return _item_column(self.dtype, c, idx,
                            c.validity & i.validity & in_bounds)


class CreateArray(Expression):
    """array(e1, ..., eN): fixed-width array per row."""

    def __init__(self, *children: Expression):
        super().__init__(list(children))

    @property
    def dtype(self):
        et = (self.children[0].dtype if self.children
              else IntegerType())
        return ArrayType(et)

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        cap, dev = ctx.capacity, ctx.device
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        if not self.children:
            from spark_rapids_tpu_torch.sqltypes.datatypes import torch_dtype

            return DeviceColumn(
                self.dtype,
                torch.zeros((cap, 1), dtype=torch_dtype(
                    self.dtype.elementType), device=dev), ones,
                torch.zeros(cap, dtype=torch.int32, device=dev),
                elem_validity=torch.zeros((cap, 1), dtype=torch.bool,
                                          device=dev))
        cols = [c.eval(ctx) for c in self.children]
        data = torch.stack([c.data for c in cols], dim=1)
        ev = torch.stack([c.validity for c in cols], dim=1)
        lengths = torch.full((cap,), len(cols), dtype=torch.int32,
                             device=dev)
        return DeviceColumn(self.dtype, data, ones, lengths,
                            elem_validity=ev)


# ----------------------- higher-order functions (higherOrderFunctions.scala)

class LambdaVar(Expression):
    """Element placeholder inside an array lambda; eval reads the bound
    flattened element column off the context (set by the enclosing
    higher-order expression)."""

    _SLOT = "_lambda_elem"

    def __init__(self, dtype):
        super().__init__()
        self._dtype = dtype

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        col = getattr(ctx, self._SLOT, None)
        if col is None:
            raise RuntimeError("lambda variable outside a lambda")
        return col

    def key(self):
        return ("lambda_var", repr(self._dtype))


def _eval_lambda(lam: Expression, c: DeviceColumn) -> DeviceColumn:
    """Evaluate the lambda tree over the flattened elements in a context
    sized [cap * me] (literals broadcast to the element count)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnBatch
    from spark_rapids_tpu_torch.sqltypes import StructField, StructType

    flat = DeviceColumn(c.dtype.elementType, c.data.reshape(-1),
                        c.elem_validity.reshape(-1))
    fb = ColumnBatch(StructType([StructField("x", flat.dtype, True)]),
                     [flat], int(c.data.numel()))
    fctx = EvalContext(fb)
    setattr(fctx, LambdaVar._SLOT, flat)
    return lam.eval(fctx)


class _HigherOrder(Expression):
    """Shared deferred-lambda machinery: the user's Python function builds
    the lambda expression tree once the array child resolves to a
    concrete ArrayType (column resolution calls with_children bottom-up)."""

    def __init__(self, arr: Expression, lam: Expression = None, fn=None):
        children = [arr] + ([lam] if lam is not None else [])
        super().__init__(children)
        self.fn = fn
        if lam is None and fn is not None:
            self._try_build()

    def _try_build(self):
        arr = self.children[0]
        try:
            at = arr.dtype
        except Exception:
            return
        if isinstance(at, ArrayType):
            from spark_rapids_tpu_torch.api.column import Column

            var = LambdaVar(at.elementType)
            lam_col = self.fn(Column(var, "x"))
            lam = lam_col.expr if hasattr(lam_col, "expr") else lam_col
            if lam.references():
                raise ValueError(
                    "array lambdas may reference only the element in v1")
            self.children.append(lam)

    def with_children(self, children):
        node = type(self)(children[0],
                          children[1] if len(children) > 1 else None,
                          fn=self.fn)
        if len(node.children) == 1 and node.fn is not None:
            node._try_build()
        return node

    @property
    def _lam(self):
        if len(self.children) < 2:
            raise RuntimeError(
                "higher-order lambda unresolved (array child has no "
                "concrete type yet)")
        return self.children[1]


class ArrayTransform(_HigherOrder):
    """transform(arr, x -> f(x)): the lambda's scalar expression tree runs
    elementwise over the flattened element matrix."""

    @property
    def dtype(self):
        return ArrayType(self._lam.dtype)

    @property
    def nullable(self):
        return self.children[0].nullable

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        cap, me = int(c.data.shape[0]), int(c.data.shape[1])
        out = _eval_lambda(self._lam, c)
        data = out.data.reshape(cap, me)
        ev = out.validity.reshape(cap, me) & _in_row(c)
        return DeviceColumn(self.dtype, data, c.validity, c.lengths,
                            elem_validity=ev)


class ArrayFilter(_HigherOrder):
    """filter(arr, x -> pred(x)): keeps elements where the predicate is
    true, compacted within each row (K34)."""

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return self.children[0].nullable

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        cap, me = int(c.data.shape[0]), int(c.data.shape[1])
        pred = _eval_lambda(self._lam, c)
        keep = (pred.data.reshape(cap, me) & pred.validity.reshape(cap, me)
                & _in_row(c))
        return _row_compact(self.dtype, c, keep, c.validity)


class _ArrayReduce(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype.elementType

    @property
    def nullable(self):
        return True

    @staticmethod
    def _mask(c):
        return _in_row(c) & c.elem_validity


def _extreme(dtype: torch.dtype, low: bool):
    if dtype.is_floating_point:
        return float("-inf") if low else float("inf")
    if dtype == torch.bool:
        return not low
    info = torch.iinfo(dtype)
    return info.min if low else info.max


def _signed_zero(vals: torch.Tensor, c: DeviceColumn, ok: torch.Tensor,
                 positive: bool) -> torch.Tensor:
    """A zero extreme takes the IEEE order of zeros (-0.0 < 0.0), as the
    reference's max and min do; torch's amax and amin return either."""
    if not vals.dtype.is_floating_point:
        return vals
    sign = torch.signbit(c.data)
    want = (ok & (c.data == 0) & (~sign if positive else sign)).any(dim=1)
    zero = torch.full_like(vals, 0.0 if positive else -0.0)
    return torch.where((vals == 0) & want, zero, vals)


class ArrayMax(_ArrayReduce):
    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        ok = self._mask(c)
        ident = torch.full_like(c.data, _extreme(c.data.dtype, True))
        vals = torch.where(ok, c.data, ident).amax(dim=1)
        vals = _signed_zero(vals, c, ok, True)
        return DeviceColumn(self.dtype, vals, c.validity & ok.any(dim=1))


class ArrayMin(_ArrayReduce):
    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        ok = self._mask(c)
        if c.data.dtype.is_floating_point:
            # Spark orders NaN greatest: the min is the smallest non-NaN
            # value, NaN only when every element is NaN
            nan = torch.isnan(c.data)
            inf = torch.full_like(c.data, float("inf"))
            data = torch.where(nan, inf, c.data)
            vals = torch.where(ok, data, inf).amin(dim=1)
            all_nan = ~(ok & ~nan).any(dim=1)
            vals = torch.where(all_nan & ok.any(dim=1),
                               torch.full_like(vals, float("nan")), vals)
        else:
            ident = torch.full_like(c.data, _extreme(c.data.dtype, False))
            vals = torch.where(ok, c.data, ident).amin(dim=1)
        vals = _signed_zero(vals, c, ok, False)
        return DeviceColumn(self.dtype, vals, c.validity & ok.any(dim=1))


class SortArray(Expression):
    """sort_array(arr, asc): per-row element sort (K35); nulls first for
    ascending, last for descending (Spark semantics)."""

    def __init__(self, child: Expression, ascending: bool = True):
        super().__init__([child])
        self.ascending = ascending

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return self.children[0].nullable

    def key(self):
        return ("sort_array", self.ascending, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, ev = array_sort(c.data, c.elem_validity, c.lengths,
                              self.ascending)
        return DeviceColumn(self.dtype, data, c.validity, c.lengths,
                            elem_validity=ev)


# -------------------------------------------------------------- maps

class MapKeys(Expression):
    """map_keys(m) -> array<k>."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return ArrayType(self.children[0].dtype.keyType, False)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, c.data, c.validity, c.lengths,
                            elem_validity=_in_row(c))


class MapValues(Expression):
    """map_values(m) -> array<v>."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        mt = self.children[0].dtype
        return ArrayType(mt.valueType, mt.valueContainsNull)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(self.dtype, c.map_values, c.validity,
                            c.lengths, elem_validity=c.elem_validity)


class MapContainsKey(Expression):
    def __init__(self, m: Expression, key: Expression):
        super().__init__([m, key])

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        k = self.children[1].eval(ctx)
        hit = _in_row(c) & (c.data == k.data[:, None])
        return DeviceColumn(boolean, hit.any(dim=1), binary_validity(c, k))


class GetMapValue(Expression):
    """m[key] / element_at(m, key): first matching key's value, null
    when absent (GetMapValue non-ANSI semantics)."""

    def __init__(self, m: Expression, key: Expression):
        super().__init__([m, key])

    @property
    def dtype(self):
        return self.children[0].dtype.valueType

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        k = self.children[1].eval(ctx)
        me = int(c.data.shape[1])
        hit = _in_row(c) & (c.data == k.data[:, None])
        j = torch.arange(me, dtype=torch.int32, device=c.device)[None, :]
        # the first match's position (me when absent)
        pos = torch.where(hit, j, me).amin(dim=1)
        found = pos < me
        got = _pick(c, pos, with_values=True)
        valid = c.validity & k.validity & found & got[1]
        return DeviceColumn(self.dtype, got[2], valid)


class MapFromArrays(Expression):
    """map_from_arrays(keys_array, values_array)."""

    def __init__(self, keys: Expression, values: Expression):
        super().__init__([keys, values])

    @property
    def dtype(self):
        ka = self.children[0].dtype
        va = self.children[1].dtype
        return MapType(ka.elementType, va.elementType)

    def eval(self, ctx):
        ka = self.children[0].eval(ctx)
        va = self.children[1].eval(ctx)
        me = max(int(ka.data.shape[1]), int(va.data.shape[1]))
        kd = pad_trailing(ka.data, (me,))
        vd = pad_trailing(va.data, (me,))
        vv = pad_trailing(va.elem_validity, (me,))
        # Spark errors on a length mismatch or a null key
        # (NULL_MAP_KEY); the non-ANSI engine nulls the row instead
        same = ka.lengths == va.lengths
        keys_ok = (~_in_row(ka) | ka.elem_validity).all(dim=1)
        return DeviceColumn(self.dtype, kd,
                            binary_validity(ka, va) & same & keys_ok,
                            ka.lengths, elem_validity=vv, map_values=vd)


class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...) from scalar columns."""

    def __init__(self, *kv: Expression):
        assert kv and len(kv) % 2 == 0, "map() needs key/value pairs"
        super().__init__(list(kv))

    @property
    def dtype(self):
        return MapType(self.children[0].dtype, self.children[1].dtype)

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        cols = [c.eval(ctx) for c in self.children]
        keys, vals = cols[0::2], cols[1::2]
        kd = torch.stack([k.data for k in keys], dim=1)
        vd = torch.stack([v.data for v in vals], dim=1)
        vv = torch.stack([v.validity for v in vals], dim=1)
        lengths = torch.full((kd.shape[0],), len(keys), dtype=torch.int32,
                             device=kd.device)
        # a null KEY is illegal in Spark; non-ANSI: null out the row
        kvalid = torch.stack([k.validity for k in keys], dim=1).all(dim=1)
        return DeviceColumn(self.dtype, kd, kvalid, lengths,
                            elem_validity=vv, map_values=vd)


# ------------------------------------------------- array breadth

def _row_compact(c_dtype, c: DeviceColumn, keep: torch.Tensor,
                 validity: torch.Tensor) -> DeviceColumn:
    """Keep flagged elements, left-compacted, preserving order (K34)."""
    data, ev, lengths, el = array_compact(c.data, c.elem_validity, keep,
                                          c.elem_lengths)
    return DeviceColumn(c_dtype, data, validity, lengths, elem_validity=ev,
                        elem_lengths=el)


def _distinct_of(c: DeviceColumn) -> DeviceColumn:
    """array_distinct over an already-evaluated column (K34's distinct
    mode)."""
    data, ev, lengths = array_distinct(c.data, c.elem_validity, c.lengths)
    return DeviceColumn(c.dtype, data, c.validity, lengths,
                        elem_validity=ev)


class Slice(Expression):
    """slice(arr, start, length): 1-based; negative start counts from
    the end; start=0 -> null row (non-ANSI)."""

    def __init__(self, arr: Expression, start: Expression,
                 length: Expression):
        super().__init__([arr, start, length])

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        st = self.children[1].eval(ctx)
        ln = self.children[2].eval(ctx)
        me = int(c.data.shape[1])
        raw = st.data.to(torch.int32)
        begin = torch.where(raw > 0, raw - 1, c.lengths + raw)
        want = ln.data.to(torch.int32).clamp(0, me)
        j = torch.arange(me, dtype=torch.int32, device=c.device)[None, :]
        src = begin[:, None] + j
        # begin < 0 (|start| > length) -> an empty result, not a partial
        # window: a plain src >= 0 test would leave holes mid-row
        inside = ((j < want[:, None]) & (begin >= 0)[:, None]
                  & (src < c.lengths[:, None]))
        got = _pick(c, src)
        lengths = inside.sum(dim=1).to(torch.int32)
        bad = (raw == 0) | (ln.data < 0)
        valid = c.validity & st.validity & ln.validity & ~bad
        return DeviceColumn(self.dtype, got[0], valid, lengths,
                            elem_validity=got[1] & inside)


class ArrayPosition(Expression):
    """array_position(arr, v): 1-based first index, 0 when absent."""

    def __init__(self, arr: Expression, value: Expression):
        super().__init__([arr, value])

    @property
    def dtype(self):
        return long

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = self.children[1].eval(ctx)
        me = int(c.data.shape[1])
        hit = (_in_row(c) & c.elem_validity
               & _elem_eq(c.data, v.data[:, None]))
        j = torch.arange(me, dtype=torch.int64, device=c.device)[None, :]
        pos = torch.where(hit, j, me).amin(dim=1)
        out = torch.where(pos < me, pos + 1, torch.zeros_like(pos))
        return DeviceColumn(long, out, binary_validity(c, v))


class ArrayRemove(Expression):
    """array_remove(arr, v); v null -> null result (Spark)."""

    def __init__(self, arr: Expression, value: Expression):
        super().__init__([arr, value])

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = self.children[1].eval(ctx)
        keep = _in_row(c) & ~(c.elem_validity
                              & _elem_eq(c.data, v.data[:, None]))
        return _row_compact(self.dtype, c, keep, c.validity & v.validity)


class ArrayDistinct(Expression):
    """array_distinct(arr): first occurrences, original order;
    NULL==NULL and NaN==NaN dedupe."""

    def __init__(self, arr: Expression):
        super().__init__([arr])

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx):
        return _distinct_of(self.children[0].eval(ctx))


class Reverse(Expression):
    """reverse(array) / reverse(string)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx):
        if isinstance(self.children[0].dtype, StringType):
            # character-aware (UTF-8) reverse, not a byte reverse
            from spark_rapids_tpu_torch.expr.strings import StringReverse

            return StringReverse(self.children[0]).eval(ctx)
        c = self.children[0].eval(ctx)
        me = int(c.data.shape[1])
        j = torch.arange(me, dtype=torch.int32, device=c.device)[None, :]
        in_row = j < c.lengths[:, None]
        got = _pick(c, c.lengths[:, None] - 1 - j)
        data = torch.where(in_row, got[0], torch.zeros_like(got[0]))
        return DeviceColumn(self.dtype, data, c.validity, c.lengths,
                            elem_validity=got[1] & in_row)


class ArrayExists(_HigherOrder):
    """exists(arr, x -> pred): 3-valued (any true -> true; else any
    null -> null; else false)."""

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return True

    _forall = False

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        cap, me = int(c.data.shape[0]), int(c.data.shape[1])
        pred = _eval_lambda(self._lam, c)
        in_row = _in_row(c)
        # the lambda sees NULL elements (Spark evaluates it over them);
        # only the predicate's own null-ness leaves a slot undecided
        pv = pred.data.reshape(cap, me)
        pvalid = pred.validity.reshape(cap, me)
        pok = pvalid & in_row
        if self._forall:
            decided = (pok & ~pv).any(dim=1)   # a definite false
            result = ~decided
        else:
            decided = (pok & pv).any(dim=1)    # a definite true
            result = decided
        has_null_verdict = (in_row & ~pvalid).any(dim=1)
        valid = c.validity & (decided | ~has_null_verdict)
        return DeviceColumn(boolean, result, valid)


class ArrayForall(ArrayExists):
    _forall = True


def _concat(cols: Sequence[DeviceColumn], dtype) -> DeviceColumn:
    """concat of array columns: each row's elements of every input in
    turn, one K8 launch over the inputs' elements laid side by side."""
    cap = int(cols[0].data.shape[0])
    widths = [int(c.data.shape[1]) for c in cols]
    me_out = sum(widths)
    side = DeviceColumn(
        dtype, torch.cat([c.data for c in cols], dim=1), cols[0].validity,
        torch.full((cap,), me_out, dtype=torch.int32,
                   device=cols[0].device),
        elem_validity=torch.cat([c.elem_validity for c in cols], dim=1))
    k = torch.arange(me_out, dtype=torch.int32,
                     device=cols[0].device)[None, :]
    src = torch.zeros((cap, me_out), dtype=torch.int32,
                      device=cols[0].device)
    inside = torch.zeros((cap, me_out), dtype=torch.bool,
                         device=cols[0].device)
    offset = torch.zeros((cap, 1), dtype=torch.int32, device=cols[0].device)
    base = 0
    for c, w in zip(cols, widths):
        mine = (k >= offset) & (k < offset + c.lengths[:, None])
        src = torch.where(mine, base + k - offset, src)
        inside = inside | mine
        offset = offset + c.lengths[:, None]
        base += w
    got = _pick(side, src)
    data = torch.where(inside, got[0], torch.zeros_like(got[0]))
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    return DeviceColumn(dtype, data, valid, offset[:, 0],
                        elem_validity=got[1] & inside)


class ConcatArrays(Expression):
    """concat(arr1, arr2, ...) for array inputs."""

    def __init__(self, *arrs: Expression):
        super().__init__(list(arrs))

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx):
        return _concat([c.eval(ctx) for c in self.children], self.dtype)


class _ArraySetOp(Expression):
    """Pairwise-membership set ops (array_union/intersect/except,
    arrays_overlap) with NULL==NULL semantics."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self):
        return self.children[0].dtype

    @staticmethod
    def _membership(a: DeviceColumn, b: DeviceColumn) -> torch.Tensor:
        """[cap, me_a] mask: element of a present in b."""
        eq = _elem_eq(a.data[:, :, None], b.data[:, None, :],
                      a.elem_validity[:, :, None],
                      b.elem_validity[:, None, :])
        both = _in_row(a)[:, :, None] & _in_row(b)[:, None, :]
        return (eq & both).any(dim=2)


class ArraysOverlap(_ArraySetOp):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        # Spark: true if any non-null common element; null when there is
        # none but either side has a null element
        eq = _elem_eq(a.data[:, :, None], b.data[:, None, :])
        both_ok = a.elem_validity[:, :, None] & b.elem_validity[:, None, :]
        both = _in_row(a)[:, :, None] & _in_row(b)[:, None, :]
        overlap = (eq & both_ok & both).flatten(1).any(dim=1)
        has_null = ((_in_row(a) & ~a.elem_validity).any(dim=1)
                    | (_in_row(b) & ~b.elem_validity).any(dim=1))
        nonempty = (a.lengths > 0) & (b.lengths > 0)
        valid = binary_validity(a, b) & (overlap | ~(has_null & nonempty))
        return DeviceColumn(self.dtype, overlap, valid)


class ArrayIntersect(_ArraySetOp):
    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        keep = _in_row(a) & self._membership(a, b)
        return _distinct_of(_row_compact(self.dtype, a, keep,
                                         binary_validity(a, b)))


class ArrayExcept(_ArraySetOp):
    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        keep = _in_row(a) & ~self._membership(a, b)
        return _distinct_of(_row_compact(self.dtype, a, keep,
                                         binary_validity(a, b)))


class ArrayUnion(_ArraySetOp):
    def eval(self, ctx):
        # the concatenation already ANDs the input validities
        return _distinct_of(_concat([c.eval(ctx) for c in self.children],
                                    self.dtype))


#: every collection expression the port evaluates on the device
COLLECTION_EXPRESSIONS = (
    Size, ArrayContains, GetArrayItem, ElementAt, CreateArray, LambdaVar,
    ArrayTransform, ArrayFilter, ArrayMax, ArrayMin, SortArray, MapKeys,
    MapValues, MapContainsKey, GetMapValue, MapFromArrays, CreateMap, Slice,
    ArrayPosition, ArrayRemove, ArrayDistinct, Reverse, ArrayExists,
    ArrayForall, ConcatArrays, ArraysOverlap, ArrayIntersect, ArrayExcept,
    ArrayUnion)
