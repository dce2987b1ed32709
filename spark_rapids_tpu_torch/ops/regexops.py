"""Device regex execution: a DFA walk over string byte matrices —
counterpart of `spark_rapids_tpu/ops/regexops.py`.

The compiled DFA (regex/transpiler.py) is walked by kernel K18
(kernels/csrc/dfa_match.cu): one thread a row, the table in shared
memory where it fits. `dfa_match_plain` is the reference's scan over the
byte positions in PyTorch, which CPU tensors take. The DFA's tables go to
a device once per compiled pattern and stay cached on it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.regex.transpiler import CompiledRegex


def dfa_match_plain(data: torch.Tensor, lengths: torch.Tensor,
                    rx: CompiledRegex) -> torch.Tensor:
    """Plain PyTorch version of K18: the reference's scan, one table take
    a byte position for all rows."""
    n, mb = data.shape
    dev = data.device
    flat = torch.from_numpy(rx.table.reshape(-1).astype(np.int64)).to(dev)
    classes = torch.from_numpy(rx.classes.astype(np.int64)).to(dev)
    accept = torch.from_numpy(rx.accept).to(dev)
    n_classes = rx.table.shape[1]
    cls = classes[data.to(torch.int64)]
    pos_live = (torch.arange(mb, dtype=torch.int32, device=dev)[None, :]
                < lengths[:, None])
    state = torch.full((n,), rx.start, dtype=torch.int64, device=dev)
    for i in range(mb):
        nxt = flat[state * n_classes + cls[:, i]]
        state = torch.where(pos_live[:, i], nxt, state)
    return accept[state]


def device_tables(rx: CompiledRegex, dev: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(classes int16 [256], table int16 [S, C], accept uint8 [S]) on dev,
    made once per pattern and device. accept is 2 at an absorbing accept
    state (every class loops back), where K18 stops a row."""
    cache = rx.__dict__.setdefault("_device_tables", {})
    key = str(dev)
    if key not in cache:
        table = rx.table
        s_idx = np.arange(table.shape[0])[:, None]
        absorbing = rx.accept & (table == s_idx).all(axis=1)
        accept = rx.accept.astype(np.uint8) + absorbing.astype(np.uint8)
        cache[key] = (
            torch.from_numpy(rx.classes.astype(np.int16)).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                table.astype(np.int16))).to(dev),
            torch.from_numpy(accept).to(dev))
    return cache[key]


def dfa_match(data: torch.Tensor, lengths: torch.Tensor,
              rx: CompiledRegex) -> torch.Tensor:
    """Kernel K18: data [n, mb] uint8, lengths [n] int32 -> bool[n], the
    pattern found anywhere in each row (Spark RLIKE)."""
    if data.device.type == "cpu":
        return dfa_match_plain(data, lengths, rx)
    dev = data.device
    data = kernels.byte_rows(data)
    kernels.require(data, "data", torch.uint8, dev, 2)
    kernels.require(lengths, "lengths", torch.int32, dev)
    n, mb = int(data.shape[0]), int(data.shape[1])
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    if rx.n_states >= 1 << 15:
        raise ValueError(f"{rx.n_states} DFA states overflow int16")
    classes, table, accept = device_tables(rx, dev)
    _build.check(_build.lib().srtpu_dfa_match(
        data.data_ptr(), lengths.data_ptr(), n, mb, classes.data_ptr(),
        table.data_ptr(), int(table.shape[0]), int(table.shape[1]),
        accept.data_ptr(), int(rx.start), out.data_ptr(),
        kernels.smem_optin(data), kernels.sm_count(data),
        kernels.stream_ptr(data)), "dfa_match")
    kernels.launches["dfa_match"] += 1
    return out
