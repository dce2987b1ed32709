"""Dictionary-encoded device columns — compressed execution in the port.

Counterpart of `spark_rapids_tpu/columnar/encoding.py`. A `DeviceColumn`
whose `encoding` slot holds a `DeviceDictionary` is ENCODED: `data` is a
[cap] vector of int16/int32 codes and the dictionary (a padded string
byte matrix plus lengths) is one shared device allocation.

- Dictionaries are interned by CONTENT: the same values map to one
  `dict_id` (a content digest, the reference's exact digest) and one
  device upload per device. The registry is the port's own; it never
  touches the JAX package's.
- Interning canonicalises: duplicate values collapse to one code and a
  null value folds into row validity, so code equality == value equality.
- Decode is deferred: `decode_column` gathers on the device, and
  `device_to_arrow` decodes on the host from the fetched codes.
- `encoded_equality` lowers `<encoded column> = <string literal>` to one
  host probe of the dictionary plus a code compare.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.sqltypes import StringType

#: codes narrower than this dictionary size ship as int16
_INT16_MAX_K = 1 << 15
#: host-side dictionaries retained for predicate probes
_HOST_KEEP = 512
#: larger dictionaries upload decoded (the reference's default of
#: spark.rapids.tpu.encoded.maxDictionaryRows)
MAX_DICTIONARY_ROWS = 1 << 16


class DeviceDictionary:
    """Device-resident dictionary shared by every column encoded with it:
    `data` [K, max_bytes] uint8 padded values, `lengths` [K] int32."""

    __slots__ = ("data", "lengths", "dict_id")

    def __init__(self, data: torch.Tensor, lengths: torch.Tensor,
                 dict_id: str):
        self.data = data
        self.lengths = lengths
        self.dict_id = dict_id

    @property
    def num_values(self) -> int:
        return int(self.data.shape[0])

    def size_bytes(self) -> int:
        return self.data.numel() + self.lengths.numel() * 4


class _HostDict:
    """Host view of one interned dictionary: the padded matrix and the
    value -> code index for predicate probes."""

    __slots__ = ("matrix", "lengths", "index")

    def __init__(self, matrix: np.ndarray, lengths: np.ndarray,
                 values: pa.Array):
        self.matrix = matrix
        self.lengths = lengths
        self.index: Dict[str, int] = {
            v: i for i, v in enumerate(values.to_pylist())}


_lock = threading.Lock()
_host_dicts: "OrderedDict[str, _HostDict]" = OrderedDict()
_device_dicts: Dict[Tuple[str, torch.device], DeviceDictionary] = {}


def _digest(values: pa.Array) -> str:
    h = hashlib.sha1()
    for v in values.to_pylist():
        if v is None:
            h.update(b"\x01N")
        else:
            b = v.encode("utf-8")
            h.update(len(b).to_bytes(4, "little"))
            h.update(b)
    return h.hexdigest()[:20]


def intern_dictionary(values: pa.Array
                      ) -> Tuple[str, Optional[np.ndarray]]:
    """Intern one arrow dictionary VALUES array; returns (dict_id, remap)
    where remap maps raw code -> canonical code (-1 for null values), or
    None when the dictionary was already canonical."""
    pv = values.to_pylist()
    seen: Dict[str, int] = {}
    canon: List[str] = []
    remap = np.empty(max(len(pv), 1), dtype=np.int32)
    dirty = False
    for i, v in enumerate(pv):
        if v is None:
            remap[i] = -1
            dirty = True
            continue
        j = seen.get(v)
        if j is None:
            j = seen[v] = len(canon)
            canon.append(v)
        else:
            dirty = True
        remap[i] = j
    cvals = pa.array(canon, type=pa.large_string())
    dict_id = _digest(cvals)
    with _lock:
        hd = _host_dicts.get(dict_id)
    if hd is None:
        from spark_rapids_tpu_torch.columnar.arrow_bridge import (
            _string_to_matrix,
        )

        if len(cvals):
            matrix, lengths = _string_to_matrix(cvals)
        else:
            # empty dictionary: one zero row keeps decode gathers valid
            matrix = np.zeros((1, 8), np.uint8)
            lengths = np.zeros(1, np.int32)
        hd = _HostDict(matrix, lengths, cvals)
        with _lock:
            _host_dicts[dict_id] = hd
            _host_dicts.move_to_end(dict_id)
            while len(_host_dicts) > _HOST_KEEP:
                gone, _ = _host_dicts.popitem(last=False)
                for key in [k for k in _device_dicts if k[0] == gone]:
                    del _device_dicts[key]
    return dict_id, (remap[:len(pv)] if dirty else None)


def _host_dict(dict_id: str) -> Optional[_HostDict]:
    with _lock:
        hd = _host_dicts.get(dict_id)
        if hd is not None:
            _host_dicts.move_to_end(dict_id)
        return hd


def device_dictionary(dict_id: str,
                      device: torch.device) -> DeviceDictionary:
    """Device copy of an interned dictionary, uploaded once per distinct
    content and device."""
    key = (dict_id, torch.device(device))
    with _lock:
        dd = _device_dicts.get(key)
    if dd is not None:
        return dd
    hd = _host_dict(dict_id)
    if hd is None:
        raise KeyError(f"dictionary {dict_id} is not interned")
    dd = DeviceDictionary(torch.from_numpy(hd.matrix).to(device),
                          torch.from_numpy(hd.lengths).to(device), dict_id)
    with _lock:
        return _device_dicts.setdefault(key, dd)


def probe_code(dict_id: str, value: Optional[str]) -> Optional[int]:
    """Host-side dictionary probe: the canonical code of `value`, or None
    when the value is absent or null."""
    if value is None:
        return None
    hd = _host_dict(dict_id)
    if hd is None:
        return None
    return hd.index.get(value)


def encoded_column_from_arrow(arr: pa.Array, field, device: torch.device):
    """pa.DictionaryArray of strings -> (codes [n] int16/int32, validity
    [n] bool, vrange, DeviceDictionary), or None when encoding does not
    apply (non-string values, an oversized dictionary) and the caller
    uploads the column decoded."""
    if not isinstance(field.dataType, StringType):
        return None
    values = arr.dictionary
    if len(values) > MAX_DICTIONARY_ROWS:
        return None
    dict_id, remap = intern_dictionary(values)
    dd = device_dictionary(dict_id, device)
    n = len(arr)
    validity = np.asarray(arr.is_valid()) if n else np.zeros(0, bool)
    codes = (np.asarray(arr.indices.fill_null(0)).astype(np.int64) if n
             else np.zeros(0, np.int64))
    if remap is not None and n:
        codes = remap[np.clip(codes, 0, len(remap) - 1)].astype(np.int64)
        validity = validity & (codes >= 0)
        codes = np.where(codes >= 0, codes, 0)
    k = dd.num_values
    code_dt = np.int16 if k < _INT16_MAX_K else np.int32
    return codes.astype(code_dt), validity, (0, max(k - 1, 0)), dd


def decode_column(col):
    """Encoded column -> the padded-matrix string column via a device
    dictionary gather (kernel K8 on the card: the dictionary's rows and
    lengths by code, codes clipped to the dictionary, null rows zeroed);
    identity for plain columns."""
    dd = col.encoding
    if dd is None:
        return col
    if col.device.type == "cpu":
        return decode_column_plain(col)
    from spark_rapids_tpu_torch.columnar.batch import gather_leaves

    data, lengths = gather_leaves(
        [dd.data, dd.lengths], [col.data, col.data],
        masks=[col.validity, col.validity], clamp=True)
    return col.replace(data=data, lengths=lengths, vrange=None,
                       encoding=None)


def decode_column_plain(col):
    """Plain PyTorch version of decode_column's K8 launch."""
    dd = col.encoding
    k = dd.num_values
    codes = col.data.to(torch.int64).clamp(0, max(k - 1, 0))
    data = dd.data.index_select(0, codes)
    lengths = dd.lengths.index_select(0, codes)
    # keep the zero-padding / zero-dead-rows invariants
    data = torch.where(col.validity[:, None], data, torch.zeros_like(data))
    lengths = torch.where(col.validity, lengths, torch.zeros_like(lengths))
    return col.replace(data=data, lengths=lengths, vrange=None,
                       encoding=None)


def align_encodings(cols):
    """Pre-concat normalisation: keep codes only when every piece shares
    one dictionary; otherwise decode every piece."""
    encs = [c.encoding for c in cols]
    if all(e is None for e in encs):
        return list(cols)
    if all(e is not None for e in encs) and \
            len({e.dict_id for e in encs}) == 1:
        return list(cols)
    return [decode_column(c) for c in cols]


def raw_column(expr, ctx):
    """The undecoded batch column behind a (possibly aliased)
    BoundReference, or None for any other expression."""
    from spark_rapids_tpu_torch.expr.core import Alias, BoundReference

    if isinstance(expr, Alias):
        expr = expr.children[0]
    if isinstance(expr, BoundReference):
        return ctx.batch.columns[expr.ordinal]
    return None


def eval_preserving(expr, ctx):
    """Evaluate an expression, passing an encoded column through
    undecoded when the expression is a bare (aliased) column reference."""
    col = raw_column(expr, ctx)
    if col is not None and col.encoding is not None:
        return col
    return expr.eval(ctx)


def encoded_equality(left, right, ctx):
    """EqualTo fast path: `<encoded column> = <string literal>` (either
    side) compares codes against one host-probed code. Returns the
    boolean result column, or None when the shape does not apply."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
    from spark_rapids_tpu_torch.expr.core import Literal
    from spark_rapids_tpu_torch.sqltypes.datatypes import boolean

    ref, lit = left, right
    if isinstance(ref, Literal):
        ref, lit = right, left
    if not isinstance(lit, Literal) or not isinstance(lit.dtype,
                                                      StringType):
        return None
    col = raw_column(ref, ctx)
    if col is None or col.encoding is None:
        return None
    cap = col.capacity
    if lit.value is None:
        # `x = NULL` is null for every row
        z = torch.zeros(cap, dtype=torch.bool, device=col.device)
        return DeviceColumn(boolean, z, z)
    code = probe_code(col.encoding.dict_id, lit.value)
    if code is None:
        eq = torch.zeros(cap, dtype=torch.bool, device=col.device)
    else:
        eq = col.data.to(torch.int32) == code
    return DeviceColumn(boolean, eq, col.validity)

