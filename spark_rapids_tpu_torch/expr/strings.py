"""String expressions over the padded byte-matrix layout — counterpart of
`spark_rapids_tpu/expr/strings.py`, its 24 classes with the reference's
semantics (Spark's stringFunctions rules).

Every operation is a computation on the [rows, max_bytes] uint8 matrix
plus the int32 length vector. Length, Substring, the pads, Instr and
Locate count *characters* (Spark semantics) by skipping UTF-8
continuation bytes (0b10xxxxxx); the case maps and InitCap are
ASCII-only, and needles, trim sets and Translate's tables work on bytes,
as in the reference.

On the card the reference's scans and row-wise sorts run inside four
hand-written kernels (kernels/csrc):

- K19 str_find: `_contains`, `_first_match_charpos`,
  `_select_nonoverlapping` (Java's repeated indexOf) and
  `_substring_index_bounds`;
- K20 str_rewrite: `_rewrite` (byte maps, kept bytes left-packed in
  place of `_compact_bytes`' sort, reverse, InitCap) and `_char_count`
  (Length);
- K21 str_assemble: `_assemble` (Concat, ConcatWs, the pads, Repeat and
  Replace's emission).

Each wrapper sits beside its plain version, the reference's body in
PyTorch, which tensors on the CPU take. StartsWith, EndsWith, Ascii and
Chr are fixed-offset compares and byte selects, elementwise torch on
either device.

Invariant maintained everywhere: bytes at positions >= length are zero
(sort keys and equality rely on it). Every new width is max(8, the next
power of two), as the reference's, so downstream key word counts
(ops/common.py `_value_words`) agree.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.batch import DeviceColumn
from spark_rapids_tpu_torch.expr.core import Expression
from spark_rapids_tpu_torch.kernels import build as _build
from spark_rapids_tpu_torch.sqltypes.datatypes import boolean, integer
from spark_rapids_tpu_torch.sqltypes.datatypes import string as string_t


def _width(total: int) -> int:
    """A new string column's width for `total` bytes: max(8, the next
    power of two), the reference's rule."""
    return max(8, 1 << max(0, total - 1).bit_length())


def _is_continuation(data: torch.Tensor) -> torch.Tensor:
    return (data & 0xC0) == 0x80


def _position_mask(data: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
    mb = data.shape[1]
    return (torch.arange(mb, dtype=torch.int32, device=data.device)[None, :]
            < lengths[:, None])


def _char_index(data: torch.Tensor, lengths: torch.Tensor):
    """(in_str, is_char, char_idx, nchars): each byte's character index
    (0-based; continuation bytes share their lead byte's)."""
    in_str = _position_mask(data, lengths)
    is_char = in_str & ~_is_continuation(data)
    nchars = is_char.sum(dim=1).to(torch.int32)
    char_idx = torch.cumsum(is_char.to(torch.int32), dim=1,
                            dtype=torch.int32) - 1
    return in_str, is_char, char_idx, nchars


def _compact_bytes(data: torch.Tensor, keep: torch.Tensor,
                   mb_out: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep marked bytes, shifted left per row; returns (data, lengths).
    The plain versions' compaction (a stable row-wise sort of ~keep, as
    the reference's); K20 packs its rules' bytes in one pass instead."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    out = torch.gather(data, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    mb = data.shape[1]
    out = torch.where(_position_mask(out, new_len), out, 0).to(torch.uint8)
    if mb_out is not None and mb_out != mb:
        out = out[:, :mb_out] if mb_out < mb else torch.nn.functional.pad(
            out, (0, mb_out - mb))
    return out.contiguous(), new_len


@lru_cache(maxsize=256)
def _device_bytes(raw: bytes, device: str, dtype=torch.uint8
                  ) -> torch.Tensor:
    """A needle, separator, pad or table on a device, made once."""
    if dtype == torch.uint8:
        return torch.tensor(list(raw) or [0], dtype=dtype, device=device)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy()).to(
        device)


def _rows(data: torch.Tensor, lengths: torch.Tensor):
    dev = data.device
    data = kernels.byte_rows(data)
    kernels.require(data, "data", torch.uint8, dev, 2)
    kernels.require(lengths, "lengths", torch.int32, dev)
    return data, lengths, dev


# ------------------------------------------------------- K19 str_find

def _find_candidates(data: torch.Tensor, lengths: torch.Tensor,
                     needle: bytes) -> torch.Tensor:
    """[n, mb] bool: a match of `needle` begins at this byte position."""
    n, mb = data.shape
    nb = len(needle)
    if nb == 0 or nb > mb:
        return torch.zeros((n, mb), dtype=torch.bool, device=data.device)
    ok_at = torch.ones((n, mb - nb + 1), dtype=torch.bool,
                       device=data.device)
    for i, byte in enumerate(needle):
        ok_at = ok_at & (data[:, i:i + mb - nb + 1] == byte)
    starts = torch.arange(mb - nb + 1, dtype=torch.int32,
                          device=data.device)[None, :]
    ok_at = ok_at & (starts + nb <= lengths[:, None])
    return torch.nn.functional.pad(ok_at, (0, nb - 1)) if nb > 1 else ok_at


def _find(mode: int, data: torch.Tensor, lengths: torch.Tensor,
          needle: bytes, arg: int = 0):
    """One K19 launch; (out0, out1) as the mode gives them."""
    data, lengths, dev = _rows(data, lengths)
    n, mb = int(data.shape[0]), int(data.shape[1])
    out1 = None
    if mode == kernels.FIND_ANY:
        out0 = torch.empty(n, dtype=torch.bool, device=dev)
    elif mode == kernels.FIND_SELECT:
        out0 = torch.empty((n, mb), dtype=torch.uint8, device=dev)
    else:
        out0 = torch.empty(n, dtype=torch.int32, device=dev)
        if mode == kernels.FIND_SPLIT:
            out1 = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        nd = _device_bytes(bytes(needle), str(dev)) if needle else None
        _build.check(_build.lib().srtpu_str_find(
            mode, data.data_ptr(), lengths.data_ptr(), n, mb,
            None if nd is None else nd.data_ptr(), len(needle), int(arg),
            out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            kernels.sm_count(data), kernels.stream_ptr(data)), "str_find")
        kernels.launches["str_find"] += 1
    return out0, out1


def _contains_plain(data: torch.Tensor, lengths: torch.Tensor,
                    needle: bytes) -> torch.Tensor:
    """Plain PyTorch version of K19's any-match mode: the reference's
    sliding compare (Contains.eval), an empty needle everywhere."""
    if not needle:
        return torch.ones(data.shape[0], dtype=torch.bool,
                          device=data.device)
    return _find_candidates(data, lengths, needle).any(dim=1)


def _contains(data: torch.Tensor, lengths: torch.Tensor,
              needle: bytes) -> torch.Tensor:
    """Kernel K19 (any match): bool[n], the needle occurs in the row."""
    if data.device.type == "cpu":
        return _contains_plain(data, lengths, needle)
    return _find(kernels.FIND_ANY, data, lengths, needle)[0]


def _first_match_charpos_plain(data: torch.Tensor, lengths: torch.Tensor,
                               needle: bytes, min_char: int
                               ) -> torch.Tensor:
    """Plain PyTorch version of K19's first-match mode (the reference's
    cumsum and argmax)."""
    _, is_char, char_idx, nchars = _char_index(data, lengths)
    if len(needle) == 0:
        hit = torch.clamp(nchars, max=min_char) + 1
        return torch.where(min_char <= nchars, hit, 0).to(torch.int32)
    cand = _find_candidates(data, lengths, needle)
    cand = cand & (char_idx >= min_char) & is_char
    found = cand.any(dim=1)
    first_byte = torch.argmax(cand.to(torch.uint8), dim=1)
    first_char = torch.gather(char_idx, 1, first_byte[:, None])[:, 0]
    return torch.where(found, first_char + 1, 0).to(torch.int32)


def _first_match_charpos(data: torch.Tensor, lengths: torch.Tensor,
                         needle: bytes, min_char: int) -> torch.Tensor:
    """Kernel K19 (first match): 1-based char position of the first
    occurrence at a char >= min_char, 0 when none."""
    if data.device.type == "cpu":
        return _first_match_charpos_plain(data, lengths, needle, min_char)
    return _find(kernels.FIND_FIRST, data, lengths, needle, min_char)[0]


def _select_nonoverlapping_plain(data: torch.Tensor, lengths: torch.Tensor,
                                 needle: bytes) -> torch.Tensor:
    """Plain PyTorch version of K19's selection: the reference's scan over
    the positions, carrying each row's next free byte."""
    cand = _find_candidates(data, lengths, needle)
    n, mb = cand.shape
    next_free = torch.zeros(n, dtype=torch.int32, device=data.device)
    sels = []
    for i in range(mb):
        sel = cand[:, i] & (i >= next_free)
        next_free = torch.where(sel, i + len(needle), next_free)
        sels.append(sel)
    return torch.stack(sels, dim=1)


def _select_nonoverlapping(data: torch.Tensor, lengths: torch.Tensor,
                           needle: bytes) -> torch.Tensor:
    """Kernel K19 (selection): [n, mb] bool, the greedy left-to-right
    non-overlapping match starts (repeated indexOf in Java's replace and
    substring_index)."""
    if data.device.type == "cpu":
        return _select_nonoverlapping_plain(data, lengths, needle)
    return _find(kernels.FIND_SELECT, data, lengths, needle)[0].view(
        torch.bool)


def _substring_index_bounds_plain(data: torch.Tensor, lengths: torch.Tensor,
                                  delim: bytes, count: int):
    """Plain PyTorch version of K19's split mode: the reference's
    occurrence count (a cumsum over the selected starts) and its cut."""
    mb = data.shape[1]
    ld = len(delim)
    sel = _select_nonoverlapping_plain(data, lengths, delim)
    occ = torch.cumsum(sel.to(torch.int32), dim=1, dtype=torch.int32)
    total = occ[:, -1]
    pos = torch.arange(mb, dtype=torch.int32, device=data.device)[None, :]
    if count > 0:
        is_kth = sel & (occ == count)
        cut = torch.where(total >= count,
                          torch.where(is_kth, pos, mb).min(dim=1).values,
                          lengths).to(torch.int32)
        return torch.zeros_like(cut), cut
    target = total + count + 1
    is_kth = sel & (occ == target[:, None]) & (target[:, None] >= 1)
    start = torch.where(total >= -count,
                        torch.where(is_kth, pos, -1).max(dim=1).values + ld,
                        0).to(torch.int32)
    return start, lengths


def _substring_index_bounds(data: torch.Tensor, lengths: torch.Tensor,
                            delim: bytes, count: int):
    """Kernel K19 (split): SubstringIndex's kept bytes as (lo, hi) int32
    [n], for K20 to compact; count != 0 and delim not empty."""
    if data.device.type == "cpu":
        return _substring_index_bounds_plain(data, lengths, delim, count)
    return _find(kernels.FIND_SPLIT, data, lengths, delim, count)


# ---------------------------------------------------- K20 str_rewrite

class Rewrite(NamedTuple):
    """One K20 rule (RewriteKind in csrc/str_rewrite.cu). `table` is 256
    int16: a byte's new value, negative to drop it (map) or to mark the
    trim set (trim); a, b: Substring's position and length, or trim's
    leading and trailing flags; lo, hi: the kept byte range (range)."""

    kind: int
    table: Optional[np.ndarray] = None
    a: int = 0
    b: int = 0
    lo: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None


def _rewrite_plain(data: torch.Tensor, lengths: torch.Tensor, rw: Rewrite
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K20's byte rewrites: the reference's
    bodies, compaction by `_compact_bytes`."""
    dev = data.device
    mb = data.shape[1]
    k = rw.kind
    if k == kernels.REWRITE_MAP:
        table = torch.from_numpy(rw.table.astype(np.int64)).to(dev)
        idx = data.to(torch.int64)
        mapped = torch.clamp(table, min=0).to(torch.uint8)[idx]
        keep = _position_mask(data, lengths) & (table[idx] >= 0)
        return _compact_bytes(mapped, keep)
    if k == kernels.REWRITE_CHARS:
        in_str, _, char_idx, nchars = _char_index(data, lengths)
        pos, length = rw.a, rw.b
        if pos > 0:
            start_raw = torch.full_like(nchars, pos - 1, dtype=torch.int64)
        elif pos == 0:
            start_raw = torch.zeros_like(nchars, dtype=torch.int64)
        else:
            start_raw = nchars.to(torch.int64) + pos
        # Spark UTF8String.substringSQL: the end uses the unclamped start,
        # so substring('abc', -5, 2) is '' (end=0), not 'ab'
        end_char = start_raw + min(length, 1 << 30)
        start_char = torch.clamp(start_raw, min=0)
        keep = (in_str & (char_idx >= start_char[:, None])
                & (char_idx < end_char[:, None]))
        return _compact_bytes(data, keep)
    if k == kernels.REWRITE_TRIM:
        in_str = _position_mask(data, lengths)
        in_set = torch.from_numpy(rw.table < 0).to(dev)[data.to(torch.int64)]
        keep = in_str
        if rw.a:
            lead = torch.cumprod(in_set.to(torch.int32), dim=1) > 0
            keep = keep & ~lead
        if rw.b:
            t = in_set | ~in_str
            rev = torch.flip(torch.cumprod(torch.flip(t, dims=[1]).to(
                torch.int32), dim=1) > 0, dims=[1])
            keep = keep & ~rev
        return _compact_bytes(data, keep)
    if k == kernels.REWRITE_RANGE:
        pos = torch.arange(mb, dtype=torch.int32, device=dev)[None, :]
        keep = (_position_mask(data, lengths) & (pos >= rw.lo[:, None])
                & (pos < rw.hi[:, None]))
        return _compact_bytes(data, keep)
    if k == kernels.REWRITE_REVERSE:
        in_str, is_char, char_idx, nchars = _char_index(data, lengths)
        pos = torch.arange(mb, dtype=torch.int32, device=dev)[None, :]
        lead_pos = torch.cummax(torch.where(is_char, pos, -1), dim=1).values
        within = pos - lead_pos
        key = (nchars[:, None] - 1 - char_idx) * mb + within
        key = torch.where(in_str, key, 1 << 30)
        order = torch.argsort(key, dim=1, stable=True)
        out = torch.gather(data, 1, order)
        out = torch.where(pos < lengths[:, None], out, 0).to(torch.uint8)
        return out, lengths
    if k == kernels.REWRITE_INITCAP:
        d = data
        prev_space = torch.cat(
            [torch.ones((d.shape[0], 1), dtype=torch.bool, device=dev),
             d[:, :-1] == 0x20], dim=1)
        is_up = (d >= 0x41) & (d <= 0x5A)
        is_lo = (d >= 0x61) & (d <= 0x7A)
        lowered = torch.where(is_up, d + 32, d)
        out = torch.where(prev_space & is_lo, d - 32,
                          torch.where(~prev_space, lowered, d))
        return out.to(torch.uint8), lengths
    raise ValueError(f"rewrite kind {k}")


#: K20's tile route (csrc/str_rewrite.cu): shared memory a block takes at
#: most, the tile sizes it may take (rows, most first; 128 threads a block,
#: fewer below 128 rows), and the bytes a tile of more than 128 rows holds
#: at most
REWRITE_TILE_SMEM = 48 * 1024
REWRITE_TILE_ROWS = (1024, 512, 256, 128, 64, 32)
REWRITE_TILE_BYTES = 8192


class RewritePlan(NamedTuple):
    """K20's launch plan: `tile_rows` rows a block (0: the row route over
    device memory), a thread every 128 rows; each row `pitch` bytes of
    shared memory (an odd number of 4-byte words, so a warp's threads
    reading word k of their rows meet 32 banks); `vec`-byte loads and
    stores; `smem` bytes of shared memory a block."""

    tile_rows: int
    pitch: int
    vec: int
    smem: int


def _rewrite_plan(kind: int, mb: int, *addresses: int) -> RewritePlan:
    """The tile a K20 block takes for rows of width mb whose data and
    output start at `addresses`: the widest word (16 bytes down to 1) that
    divides the width and aligns both starts, so a word holds one row's
    bytes and every tile starts on a word; the most rows, up to 128 or
    REWRITE_TILE_BYTES (a narrow row's thread takes several), whose tile
    (two for Reverse, which cannot rewrite in place) fits
    REWRITE_TILE_SMEM; the row route where not even 32 rows fit."""
    vec = 16
    while vec > 1 and (mb % vec or any(a % vec for a in addresses)):
        vec //= 2
    words = -(-mb // 4)
    pitch = 4 * (words + 1 - words % 2)
    tiles = 2 if kind == kernels.REWRITE_REVERSE else 1
    for rows in REWRITE_TILE_ROWS:
        smem = 768 + 4 * rows + tiles * rows * pitch + 16
        if smem <= REWRITE_TILE_SMEM and (
                rows <= 128 or rows * mb <= REWRITE_TILE_BYTES):
            return RewritePlan(rows, pitch, vec, smem)
    return RewritePlan(0, 0, 0, 0)


def _launch_rewrite(kind: int, data: torch.Tensor, lengths: torch.Tensor,
                    table, a: int, b: int, lo, hi, out, out_len) -> None:
    n, mb = int(data.shape[0]), int(data.shape[1])
    plan = _rewrite_plan(kind, mb, data.data_ptr(),
                         0 if out is None else out.data_ptr())
    _build.check(_build.lib().srtpu_str_rewrite(
        kind, data.data_ptr(), lengths.data_ptr(), n, mb,
        None if table is None else table.data_ptr(), int(a), int(b),
        None if lo is None else lo.data_ptr(),
        None if hi is None else hi.data_ptr(),
        None if out is None else out.data_ptr(),
        None if out_len is None else out_len.data_ptr(), plan.tile_rows,
        plan.pitch, plan.vec, kernels.sm_count(data),
        kernels.stream_ptr(data)), "str_rewrite")
    kernels.launches["str_rewrite"] += 1


def _rewrite(data: torch.Tensor, lengths: torch.Tensor, rw: Rewrite,
             new_lengths: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K20: (data [n, mb] uint8, lengths) rewritten by the rule,
    kept bytes left-packed and the tail zeroed. With new_lengths False the
    input's lengths come back (the case maps, reverse and InitCap keep
    them, as the reference does) and the kernel writes none."""
    if data.device.type == "cpu":
        out, lens = _rewrite_plain(data, lengths, rw)
        return out, lens if new_lengths else lengths
    data, lengths, dev = _rows(data, lengths)
    n, mb = int(data.shape[0]), int(data.shape[1])
    out = torch.empty((n, mb), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev) \
        if new_lengths else lengths
    if rw.kind == kernels.REWRITE_RANGE:
        kernels.require(rw.lo, "lo", torch.int32, dev)
        kernels.require(rw.hi, "hi", torch.int32, dev)
    if n:
        table = None if rw.table is None else _device_bytes(
            rw.table.astype(np.int16).tobytes(), str(dev), torch.int16)
        _launch_rewrite(rw.kind, data, lengths, table, rw.a, rw.b, rw.lo,
                        rw.hi, out, out_len if new_lengths else None)
    return out, out_len


def _char_count_plain(data: torch.Tensor, lengths: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of K20's length kind (Length.eval)."""
    chars = _position_mask(data, lengths) & ~_is_continuation(data)
    return chars.sum(dim=1).to(torch.int32)


def _char_count(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Kernel K20 (length): int32 [n] characters of each row."""
    if data.device.type == "cpu":
        return _char_count_plain(data, lengths)
    data, lengths, dev = _rows(data, lengths)
    n = int(data.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch_rewrite(kernels.REWRITE_LENGTH, data, lengths, None, 0, 0,
                        None, None, None, out)
    return out


# --------------------------------------------------- K21 str_assemble

class Assemble(NamedTuple):
    """One K21 layout (AssembleKind in csrc/str_assemble.cu): `text` is
    the separator, the pad or the replacement; `a` the pads' target
    characters, the repeat count or the replaced needle's bytes; `sel` the
    replaced starts (K19's selection)."""

    kind: int
    text: bytes = b""
    a: int = 0
    sel: Optional[torch.Tensor] = None


def _spans_plain(out, offset, pos, data, lengths, mb, use=None):
    """The reference's gather of one input at each row's offset."""
    width = data.shape[1]
    if mb > width:
        data = torch.nn.functional.pad(data, (0, mb - width))
    idx = torch.clamp(pos - offset[:, None], 0, mb - 1).to(torch.int64)
    gathered = torch.gather(data[:, :mb], 1, idx)
    span = (pos >= offset[:, None]) & (pos < (offset + lengths)[:, None])
    if use is not None:
        span = span & use[:, None]
    return torch.where(span, gathered, out)


def _assemble_plain(cols: Sequence[DeviceColumn], asm: Assemble,
                    mb_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K21: the reference's gathers at running
    offsets (Concat, ConcatWs, the pads, Repeat) and Replace's emission
    matrix packed by `_compact_bytes`."""
    c0 = cols[0]
    n = c0.data.shape[0]
    dev = c0.data.device
    k = asm.kind
    pos = torch.arange(mb_out, dtype=torch.int32, device=dev)[None, :]
    if k in (kernels.ASSEMBLE_CONCAT, kernels.ASSEMBLE_CONCAT_WS):
        out = torch.zeros((n, mb_out), dtype=torch.uint8, device=dev)
        offset = torch.zeros(n, dtype=torch.int32, device=dev)
        emitted_any = torch.zeros(n, dtype=torch.bool, device=dev)
        lsep = len(asm.text)
        sep = torch.tensor(list(asm.text or b"\x00"), dtype=torch.uint8,
                           device=dev)
        for c in cols:
            if k == kernels.ASSEMBLE_CONCAT:
                out = _spans_plain(out, offset, pos, c.data, c.lengths,
                                   mb_out)
                offset = offset + c.lengths
                continue
            use = c.validity
            if lsep:
                sep_here = use & emitted_any
                idx = torch.clamp(pos - offset[:, None], 0, lsep - 1)
                span = ((pos >= offset[:, None])
                        & (pos < (offset + lsep)[:, None])
                        & sep_here[:, None])
                out = torch.where(span, sep[idx.to(torch.int64)], out)
                offset = torch.where(sep_here, offset + lsep, offset)
            out = _spans_plain(out, offset, pos, c.data, c.lengths, mb_out,
                               use)
            offset = torch.where(use, offset + c.lengths, offset)
            emitted_any = emitted_any | use
        return out.to(torch.uint8), offset.to(torch.int32)
    if k in (kernels.ASSEMBLE_LPAD, kernels.ASSEMBLE_RPAD):
        target = asm.a
        in_str, _, char_idx, nchars = _char_index(c0.data, c0.lengths)
        kept_len = (in_str & (char_idx < target)).sum(dim=1).to(torch.int32)
        npad = torch.clamp(target - nchars, min=0).to(torch.int32)
        pad = asm.text
        lp = len(pad)
        width = c0.data.shape[1]
        data_wide = torch.nn.functional.pad(c0.data, (0, mb_out - width)) \
            if mb_out > width else c0.data[:, :mb_out]
        out_len = npad + kept_len
        if k == kernels.ASSEMBLE_LPAD:
            padvec = torch.tensor([pad[i % lp] for i in range(mb_out)],
                                  dtype=torch.uint8, device=dev)
            src_idx = torch.clamp(pos - npad[:, None], 0, mb_out - 1)
            src = torch.gather(data_wide, 1, src_idx.to(torch.int64))
            out = torch.where(pos < npad[:, None], padvec[None, :], src)
        else:
            # pad characters appended after the kept prefix; the pad cycle
            # restarts at the append point (Java StringUtils behaviour)
            pad_idx = torch.clamp(pos - kept_len[:, None], 0, mb_out - 1)
            padmat = torch.tensor(list(pad), dtype=torch.uint8,
                                  device=dev)[(pad_idx % lp).to(torch.int64)]
            out = torch.where(pos < kept_len[:, None], data_wide, padmat)
        out = torch.where(pos < out_len[:, None], out, 0)
        return out.to(torch.uint8), out_len
    if k == kernels.ASSEMBLE_REPEAT:
        times = asm.a
        width = c0.data.shape[1]
        safe_len = torch.clamp(c0.lengths, min=1)[:, None]
        src_idx = torch.clamp(pos % safe_len, 0, width - 1)
        src = torch.gather(c0.data, 1, src_idx.to(torch.int64))
        out_len = (c0.lengths * times).to(torch.int32)
        out = torch.where(pos < out_len[:, None], src, 0).to(torch.uint8)
        return out, out_len
    if k == kernels.ASSEMBLE_REPLACE:
        ls, lr = asm.a, len(asm.text)
        data, sel = c0.data, asm.sel
        mb = data.shape[1]
        bpos = torch.arange(mb, dtype=torch.int32, device=dev)[None, :]
        # covered[i] = i falls strictly inside a selected match
        sel_start = torch.where(sel, bpos, -(1 << 20))
        last_start = torch.cummax(sel_start, dim=1).values
        covered = (bpos < last_start + ls) & (last_start >= 0)
        in_str = _position_mask(data, c0.lengths)
        emit_n = torch.where(sel, lr, torch.where(covered | ~in_str, 0, 1))
        e = max(lr, 1)
        # emission matrix [n, mb, e]: replacement bytes at selected
        # starts, the original byte in slot 0 otherwise
        repl = torch.tensor(list(asm.text or b"\x00"), dtype=torch.uint8,
                            device=dev)
        slot = torch.arange(e, dtype=torch.int32, device=dev)
        emat = torch.where(sel[:, :, None], repl[None, None, :e],
                           data[:, :, None])
        emask = slot[None, None, :] < emit_n[:, :, None]
        return _compact_bytes(emat.reshape(n, mb * e),
                              emask.reshape(n, mb * e), mb_out=mb_out)
    raise ValueError(f"assemble kind {k}")


def _assemble(cols: Sequence[DeviceColumn], asm: Assemble, mb_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K21: (data [n, mb_out] uint8, lengths) of each output row
    written from its inputs' spans (up to 16 columns a launch)."""
    if cols[0].data.device.type == "cpu":
        return _assemble_plain(cols, asm, mb_out)
    if len(cols) > kernels.MAX_STR_COLS:
        raise ValueError(f"{len(cols)} columns: one K21 launch takes "
                         f"{kernels.MAX_STR_COLS}")
    dev = cols[0].data.device
    keep = []
    descs = []
    for c in cols:
        data, lengths, _ = _rows(c.data, c.lengths)
        kernels.require(c.validity, "validity", torch.bool, dev)
        keep.append(data)
        descs.append(kernels.StrCol(data.data_ptr(), lengths.data_ptr(),
                                    c.validity.data_ptr(),
                                    int(data.shape[1]), 0))
    n = int(cols[0].data.shape[0])
    sel = None
    if asm.kind == kernels.ASSEMBLE_REPLACE:
        sel = asm.sel.contiguous().view(torch.uint8)
        if tuple(sel.shape) != tuple(keep[0].shape):
            raise ValueError(f"sel {tuple(sel.shape)} for data "
                             f"{tuple(keep[0].shape)}")
    out = torch.empty((n, mb_out), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        text = _device_bytes(bytes(asm.text), str(dev)) if asm.text \
            else None
        ptr, _arr = kernels.struct_array(kernels.StrCol, descs)
        _build.check(_build.lib().srtpu_str_assemble(
            asm.kind, ptr, len(descs), n,
            None if text is None else text.data_ptr(), len(asm.text),
            int(asm.a), None if sel is None else sel.data_ptr(),
            out.data_ptr(), mb_out, out_len.data_ptr(),
            kernels.sm_count(out), kernels.stream_ptr(out)), "str_assemble")
        kernels.launches["str_assemble"] += 1
    return out, out_len


# ------------------------------------------------------- expressions

class Length(Expression):
    """Character count (UTF-8 aware)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return integer

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(integer, _char_count(c.data, c.lengths),
                            c.validity)


def _case_table(lo: int, hi: int, delta: int) -> np.ndarray:
    table = np.arange(256, dtype=np.int16)
    table[lo:hi + 1] += delta
    return table


_UPPER = _case_table(ord("a"), ord("z"), -32)
_LOWER = _case_table(ord("A"), ord("Z"), 32)


class _CaseMap(Expression):
    _table: np.ndarray

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, lens = _rewrite(c.data, c.lengths,
                              Rewrite(kernels.REWRITE_MAP, self._table),
                              new_lengths=False)
        return DeviceColumn(string_t, data, c.validity, lens)


class Upper(_CaseMap):
    _table = _UPPER


class Lower(_CaseMap):
    _table = _LOWER


class Substring(Expression):
    """substring(str, pos, len) — 1-based pos, negative from end,
    character-indexed (Spark semantics)."""

    def __init__(self, child, pos: int, length: int = 1 << 30):
        super().__init__([child])
        self.pos = pos
        self.length = length

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("substr", self.pos, self.length, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, lens = _rewrite(c.data, c.lengths, Rewrite(
            kernels.REWRITE_CHARS, a=int(self.pos), b=int(self.length)))
        return DeviceColumn(string_t, data, c.validity, lens)


class Concat(Expression):
    """concat(s1, s2, ...) — null if any input is null (Spark concat)."""

    def __init__(self, *exprs):
        super().__init__(list(exprs))

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        cols = [c.eval(ctx) for c in self.children]
        mb = _width(sum(c.max_bytes for c in cols))
        data, lens = _assemble(cols, Assemble(kernels.ASSEMBLE_CONCAT), mb)
        validity = cols[0].validity
        for c in cols[1:]:
            validity = validity & c.validity
        return DeviceColumn(string_t, data, validity, lens)


class StartsWith(Expression):
    def __init__(self, child, prefix: str):
        super().__init__([child])
        self.needle = prefix.encode("utf-8")

    @property
    def dtype(self):
        return boolean

    def key(self):
        return ("startswith", self.needle, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        nb = len(self.needle)
        if nb > c.max_bytes:
            return DeviceColumn(boolean, torch.zeros_like(c.validity),
                                c.validity)
        target = torch.tensor(list(self.needle), dtype=torch.uint8,
                              device=c.device)
        ok = ((c.data[:, :nb] == target[None, :]).all(dim=1)
              & (c.lengths >= nb))
        return DeviceColumn(boolean, ok, c.validity)


class EndsWith(Expression):
    def __init__(self, child, suffix: str):
        super().__init__([child])
        self.needle = suffix.encode("utf-8")

    @property
    def dtype(self):
        return boolean

    def key(self):
        return ("endswith", self.needle, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        nb = len(self.needle)
        if nb > c.max_bytes:
            return DeviceColumn(boolean, torch.zeros_like(c.validity),
                                c.validity)
        target = torch.tensor(list(self.needle), dtype=torch.uint8,
                              device=c.device)
        start = c.lengths - nb
        pos = torch.arange(nb, dtype=torch.int32, device=c.device)[None, :]
        idx = torch.clamp(start[:, None] + pos, 0, c.max_bytes - 1)
        got = torch.gather(c.data, 1, idx.to(torch.int64))
        ok = (got == target[None, :]).all(dim=1) & (c.lengths >= nb)
        return DeviceColumn(boolean, ok, c.validity)


class Contains(Expression):
    def __init__(self, child, needle: str):
        super().__init__([child])
        self.needle = needle.encode("utf-8")

    @property
    def dtype(self):
        return boolean

    def key(self):
        return ("contains", self.needle, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        nb = len(self.needle)
        if nb == 0:
            return DeviceColumn(boolean, torch.ones_like(c.validity),
                                c.validity)
        if nb > c.max_bytes:
            return DeviceColumn(boolean, torch.zeros_like(c.validity),
                                c.validity)
        return DeviceColumn(boolean, _contains(c.data, c.lengths,
                                               self.needle), c.validity)


# ---------------------------------------------------------------------------
# Extended string family (the reference's stringFunctions breadth): trim,
# pad, repeat, reverse, initcap, instr, locate, translate, replace,
# concat_ws, ascii, chr, substring_index.
# ---------------------------------------------------------------------------

class StringTrimBase(Expression):
    _leading = True
    _trailing = True

    def __init__(self, child, trim_str: str = " "):
        super().__init__([child])
        self.trim_bytes = trim_str.encode("utf-8")

    @property
    def dtype(self):
        return string_t

    def key(self):
        return (type(self).__name__.lower(), self.trim_bytes,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        table = np.zeros(256, dtype=np.int16)
        table[list(set(self.trim_bytes))] = -1
        data, lens = _rewrite(c.data, c.lengths, Rewrite(
            kernels.REWRITE_TRIM, table, int(self._leading),
            int(self._trailing)))
        return DeviceColumn(string_t, data, c.validity, lens)


class StringTrim(StringTrimBase):
    pass


class StringTrimLeft(StringTrimBase):
    _trailing = False


class StringTrimRight(StringTrimBase):
    _leading = False


class _PadBase(Expression):
    """lpad/rpad to `length` characters with an ASCII pad string."""

    _kind: int

    def __init__(self, child, length: int, pad: str = " "):
        super().__init__([child])
        self.length = int(length)
        self.pad = pad.encode("utf-8")
        if any(b >= 0x80 for b in self.pad):
            raise ValueError(f"pad {pad!r}: ASCII pad strings only")

    @property
    def dtype(self):
        return string_t

    def key(self):
        return (type(self).__name__.lower(), self.length, self.pad,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        target = max(self.length, 0)
        mb_out = _width(target + c.max_bytes)
        data, lens = _assemble([c], Assemble(self._kind, self.pad or b" ",
                                             target), mb_out)
        return DeviceColumn(string_t, data, c.validity, lens)


class StringLPad(_PadBase):
    _kind = kernels.ASSEMBLE_LPAD


class StringRPad(_PadBase):
    _kind = kernels.ASSEMBLE_RPAD


class StringRepeat(Expression):
    def __init__(self, child, times: int):
        super().__init__([child])
        self.times = int(times)

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("repeat", self.times, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        n = max(self.times, 0)
        if n == 0:
            cap = c.capacity
            return DeviceColumn(
                string_t, torch.zeros((cap, 8), dtype=torch.uint8,
                                      device=c.device), c.validity,
                torch.zeros(cap, dtype=torch.int32, device=c.device))
        data, lens = _assemble([c], Assemble(kernels.ASSEMBLE_REPEAT, a=n),
                               _width(c.max_bytes * n))
        return DeviceColumn(string_t, data, c.validity, lens)


class StringReverse(Expression):
    """Character-aware (UTF-8) reverse."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, lens = _rewrite(c.data, c.lengths,
                              Rewrite(kernels.REWRITE_REVERSE),
                              new_lengths=False)
        return DeviceColumn(string_t, data, c.validity, lens)


class InitCap(Expression):
    """Uppercase first letter of each space-delimited word; lowercase the
    rest (ASCII letters)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        data, lens = _rewrite(c.data, c.lengths,
                              Rewrite(kernels.REWRITE_INITCAP),
                              new_lengths=False)
        return DeviceColumn(string_t, data, c.validity, lens)


class StringInstr(Expression):
    """instr(str, substr): 1-based char position of first match, 0 if
    absent, 1 for empty substr."""

    def __init__(self, child, substr: str):
        super().__init__([child])
        self.needle = substr.encode("utf-8")

    @property
    def dtype(self):
        return integer

    def key(self):
        return ("instr", self.needle, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return DeviceColumn(integer, _first_match_charpos(
            c.data, c.lengths, self.needle, 0), c.validity)


class StringLocate(Expression):
    """locate(substr, str, start): like instr but from a 1-based char
    start; start <= 0 -> 0."""

    def __init__(self, child, substr: str, start: int = 1):
        super().__init__([child])
        self.needle = substr.encode("utf-8")
        self.start = int(start)

    @property
    def dtype(self):
        return integer

    def key(self):
        return ("locate", self.needle, self.start, self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self.start <= 0:
            return DeviceColumn(integer, torch.zeros_like(c.lengths),
                                c.validity)
        return DeviceColumn(integer, _first_match_charpos(
            c.data, c.lengths, self.needle, self.start - 1), c.validity)


class StringTranslate(Expression):
    """translate(str, match, replace): per-byte table; chars in `match`
    beyond len(replace) are deleted (ASCII alphabets)."""

    def __init__(self, child, matching: str, replace: str):
        super().__init__([child])
        self.matching = matching.encode("utf-8")
        self.replace = replace.encode("utf-8")

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("translate", self.matching, self.replace,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        table = np.arange(256, dtype=np.int16)
        seen = set()
        for i, m in enumerate(self.matching):
            if m in seen:  # first mapping wins (Spark)
                continue
            seen.add(m)
            table[m] = self.replace[i] if i < len(self.replace) else -1
        data, lens = _rewrite(c.data, c.lengths,
                              Rewrite(kernels.REWRITE_MAP, table))
        return DeviceColumn(string_t, data, c.validity, lens)


class StringReplace(Expression):
    """replace(str, search, replacement): all non-overlapping occurrences,
    leftmost-greedy (Java String.replace)."""

    def __init__(self, child, search: str, replacement: str = ""):
        super().__init__([child])
        self.search = search.encode("utf-8")
        self.replacement = replacement.encode("utf-8")

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("replace", self.search, self.replacement,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        ls, lr = len(self.search), len(self.replacement)
        if ls == 0:
            return c
        sel = _select_nonoverlapping(c.data, c.lengths, self.search)
        data, lens = _assemble([c], Assemble(
            kernels.ASSEMBLE_REPLACE, self.replacement, ls, sel),
            _width(c.max_bytes * max(1, lr)))
        return DeviceColumn(string_t, data, c.validity, lens)


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): null inputs are skipped; result is
    non-null (Spark semantics with a literal separator)."""

    def __init__(self, sep: str, *exprs):
        super().__init__(list(exprs))
        self.sep = sep.encode("utf-8")

    @property
    def dtype(self):
        return string_t

    @property
    def nullable(self):
        return False

    def key(self):
        return ("concat_ws", self.sep,
                tuple(c.key() for c in self.children))

    def eval(self, ctx):
        cols = [c.eval(ctx) for c in self.children]
        lsep = len(self.sep)
        mb = _width(sum(c.max_bytes for c in cols)
                    + lsep * max(0, len(cols) - 1))
        data, lens = _assemble(cols, Assemble(kernels.ASSEMBLE_CONCAT_WS,
                                              self.sep), mb)
        return DeviceColumn(string_t, data, torch.ones_like(cols[0].validity),
                            lens)


class Ascii(Expression):
    """ascii(str): codepoint of the first character (first byte for
    ASCII); 0 for empty string."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return integer

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        first = c.data[:, 0].to(torch.int32)
        return DeviceColumn(integer, torch.where(c.lengths > 0, first, 0),
                            c.validity)


class Chr(Expression):
    """chr(n): the character for code n & 0xFF. Spark: n < 0 -> "";
    (n & 0xFF) == 0 -> the 1-char NUL string; 128-255 encode as 2-byte
    UTF-8."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return string_t

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.data.to(torch.int64)
        code = (v & 0xFF).to(torch.int32)
        neg = v < 0
        two_byte = code >= 0x80
        b0 = torch.where(two_byte, 0xC0 | (code >> 6), code)
        b1 = torch.where(two_byte, 0x80 | (code & 0x3F), 0)
        data = torch.zeros((v.shape[0], 8), dtype=torch.uint8,
                           device=c.device)
        data[:, 0] = torch.where(neg, 0, b0).to(torch.uint8)
        data[:, 1] = torch.where(neg, 0, b1).to(torch.uint8)
        lens = torch.where(neg, 0, torch.where(two_byte, 2, 1)).to(
            torch.int32)
        return DeviceColumn(string_t, data, c.validity, lens)


class SubstringIndex(Expression):
    """substring_index(str, delim, count).

    Known incompat (the reference's): for negative counts with
    self-overlapping delimiters (e.g. delim 'aa' in 'aaa') occurrences
    are counted left-greedy while Spark scans lastIndexOf from the right;
    results agree whenever the delimiter does not overlap itself."""

    def __init__(self, child, delim: str, count: int):
        super().__init__([child])
        self.delim = delim.encode("utf-8")
        self.count = int(count)

    @property
    def dtype(self):
        return string_t

    def key(self):
        return ("substring_index", self.delim, self.count,
                self.children[0].key())

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self.count == 0 or len(self.delim) == 0:
            cap = c.capacity
            return DeviceColumn(
                string_t, torch.zeros((cap, 8), dtype=torch.uint8,
                                      device=c.device), c.validity,
                torch.zeros(cap, dtype=torch.int32, device=c.device))
        lo, hi = _substring_index_bounds(c.data, c.lengths, self.delim,
                                         self.count)
        data, lens = _rewrite(c.data, c.lengths, Rewrite(
            kernels.REWRITE_RANGE, lo=lo, hi=hi))
        return DeviceColumn(string_t, data, c.validity, lens)


#: every string expression class, in the reference's order
STRING_EXPRESSIONS: List[type] = [
    Length, Upper, Lower, Substring, Concat, StartsWith, EndsWith, Contains,
    StringTrim, StringTrimLeft, StringTrimRight, StringLPad, StringRPad,
    StringRepeat, StringReverse, InitCap, StringInstr, StringLocate,
    StringTranslate, StringReplace, ConcatWs, Ascii, Chr, SubstringIndex]
