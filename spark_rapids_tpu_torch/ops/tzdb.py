"""Time-zone database — counterpart of `spark_rapids_tpu/ops/tzdb.py`
(the GpuTimeZoneDB role).

A zone's rules are parsed from the system TZif files (/usr/share/zoneinfo)
on the host into three int64 tables, cached per zone id:

- UTC -> local: transitions[i] = the UTC instant (us) where the offset
  changes, offsets[i] = the offset (us) in effect from that instant
  (offsets has one more entry: offsets[0] applies before the first
  transition);
- local -> UTC: wall[i] = the local wall-clock instant of the same
  transition under the PRE-transition offset, so that an ambiguous local
  time resolves to the earlier offset (java.time.ZoneRules.getOffset).

Past the last explicit transition the TZif footer's POSIX rule is
unrolled through 2100, as the reference does.

On the card the tables go to the device once per (zone, device) and stay
there (`device_tables`); the reference bakes them into each XLA program.
`utc_to_local` and `local_to_utc` are wrappers over kernel K23
(csrc/tz_rebase.cu: the tables in shared memory, an upper-bound binary
search per row); their plain versions (`torch.searchsorted` plus a
gather, the reference's body) take tensors on the CPU. UTC aliases and
zones without transitions never reach the kernel: their offset is one
constant.
"""

from __future__ import annotations

import os
import struct
import threading
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.kernels import build as _build

_US = 1_000_000
_ZONEINFO_DIRS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo")

_lock = threading.Lock()
_cache: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


class TimeZoneError(ValueError):
    pass


def _parse_tzif(data: bytes):
    """TZif v2/v3 parser -> (transition_secs[int64], offset_secs[int64]).

    offset_secs has len(transitions)+1 entries: offset_secs[0] applies
    before the first transition."""
    if data[:4] != b"TZif":
        raise TimeZoneError("not a TZif file")

    def read_block(off, long_times):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6I", data[off + 20:off + 44])
        p = off + 44
        tfmt = ">%dq" % timecnt if long_times else ">%dl" % timecnt
        tsize = 8 if long_times else 4
        trans = np.array(struct.unpack(tfmt, data[p:p + timecnt * tsize]),
                         dtype=np.int64)
        p += timecnt * tsize
        idx = np.frombuffer(data[p:p + timecnt], dtype=np.uint8)
        p += timecnt
        ttinfo = []
        for i in range(typecnt):
            gmtoff, isdst, abbrind = struct.unpack(
                ">lBB", data[p + i * 6:p + i * 6 + 6])
            ttinfo.append(gmtoff)
        p += typecnt * 6 + charcnt + leapcnt * (tsize + 4) \
            + isstdcnt + isutcnt
        offs = np.array(ttinfo, dtype=np.int64)
        # offset before the first transition: first non-dst type, else 0
        first = offs[0] if typecnt else 0
        offsets = np.concatenate([[first],
                                  offs[idx] if timecnt else offs[:0]])
        return trans, offsets, p

    version = data[4:5]
    trans, offsets, end = read_block(0, long_times=False)
    footer = b""
    if version in (b"2", b"3", b"4"):
        # v2+: a second block with 64-bit transition times follows, then
        # a newline-wrapped POSIX TZ footer with the recurring rule for
        # instants past the last explicit transition
        trans, offsets, p = read_block(end, long_times=True)
        footer = data[p:].strip(b"\n \t")
    ext = _extend_with_posix_rule(trans, offsets,
                                  footer.decode("ascii", "ignore"))
    if ext is not None:
        trans, offsets = ext
    return trans, offsets


_POSIX_OFF = r"[+-]?\d{1,2}(?::\d{2}(?::\d{2})?)?"
_POSIX_NAME = r"(?:[A-Za-z]{3,}|<[^>]+>)"


def _posix_seconds(s: str) -> int:
    sign = -1 if s.startswith("-") else 1
    s = s.lstrip("+-")
    parts = [int(x) for x in s.split(":")]
    while len(parts) < 3:
        parts.append(0)
    return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2])


def _rule_instant(year: int, rule: str, default_time: int,
                  offset: int) -> Optional[int]:
    """Mm.w.d[/time] -> UTC epoch seconds of the transition in `year`
    under the prevailing `offset`; None for unsupported J/n forms."""
    import calendar
    import datetime as dtm

    if "/" in rule:
        rule, timestr = rule.split("/", 1)
        t = _posix_seconds(timestr)
    else:
        t = default_time
    if not rule.startswith("M"):
        return None
    m, w, d = (int(x) for x in rule[1:].split("."))
    # day-of-week d (0=Sunday); week w (5 = last)
    first_dow = dtm.date(year, m, 1).weekday()  # Mon=0
    first_sun0 = (first_dow + 1) % 7  # dow (Sun=0) of day 1
    day1 = 1 + (d - first_sun0) % 7
    day = day1 + (w - 1) * 7
    ndays = calendar.monthrange(year, m)[1]
    while day > ndays:
        day -= 7
    wall = int(dtm.datetime(year, m, day, tzinfo=dtm.timezone.utc)
               .timestamp()) + t
    return wall - offset


def _extend_with_posix_rule(trans, offsets, footer: str):
    """Append yearly DST transitions (through 2100) from the TZ footer so
    post-2037 instants keep the recurring rule, as java.time does. Returns
    None when the footer has no DST rule (fixed offset) or uses an
    unsupported form."""
    import datetime as dtm
    import re

    if not footer or "," not in footer:
        return None
    m = re.match(
        rf"^({_POSIX_NAME})({_POSIX_OFF})({_POSIX_NAME})({_POSIX_OFF})?"
        rf",([^,]+),(.+)$", footer)
    if not m:
        return None
    std_off = -_posix_seconds(m.group(2))  # POSIX: west positive
    dst_off = (-_posix_seconds(m.group(4)) if m.group(4)
               else std_off + 3600)
    start_rule, end_rule = m.group(5), m.group(6)
    last = int(trans[-1]) if trans.size else 0
    y0 = max(dtm.datetime.fromtimestamp(
        max(last, 0), dtm.timezone.utc).year, 1970)
    new_t, new_o = [], []
    for year in range(y0, 2101):
        a = _rule_instant(year, start_rule, 7200, std_off)
        b = _rule_instant(year, end_rule, 7200, dst_off)
        if a is None or b is None:
            return None
        for instant, off in sorted([(a, dst_off), (b, std_off)]):
            if instant > last:
                new_t.append(instant)
                new_o.append(off)
    if not new_t:
        return None
    trans2 = np.concatenate([trans, np.array(new_t, np.int64)])
    offsets2 = np.concatenate([offsets, np.array(new_o, np.int64)])
    return trans2, offsets2


def _load_zone(zone: str):
    if zone in ("UTC", "GMT", "Z", "Etc/UTC", "Etc/GMT"):
        return (np.zeros(0, np.int64), np.zeros(1, np.int64),
                np.zeros(0, np.int64))
    path = None
    for base in _ZONEINFO_DIRS:
        cand = os.path.join(base, zone)
        if os.path.isfile(cand):
            path = cand
            break
    if path is None:
        raise TimeZoneError(f"unknown timezone {zone!r}")
    with open(path, "rb") as f:
        trans_s, offs_s = _parse_tzif(f.read())
    trans = trans_s * _US
    offsets = offs_s * _US
    # wall-clock instants of each transition under the PRE-transition
    # offset (earlier-offset rule for ambiguous local times)
    wall = trans + offsets[:-1]
    return trans, offsets, wall


def tables(zone: str):
    """(transitions_us, offsets_us[len+1], wall_us) numpy arrays."""
    with _lock:
        t = _cache.get(zone)
        if t is None:
            t = _load_zone(zone)
            _cache[zone] = t
        return t


def is_utc(zone: str) -> bool:
    """Single UTC-alias predicate (shared by the casts and the datetime
    expressions so the alias list cannot drift)."""
    return zone in ("UTC", "GMT", "Z", "Etc/UTC", "Etc/GMT", "GMT0")


@lru_cache(maxsize=64)
def device_tables(zone: str, device: str):
    """A zone's three tables on a device, made once per (zone, device)."""
    trans, offsets, wall = tables(zone)
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (trans, offsets, wall))


# ------------------------------------------------------- K23 tz_rebase

def _rebase(to_utc: bool, us: torch.Tensor, zone: str) -> torch.Tensor:
    """One K23 launch over int64 instants."""
    dev = us.device
    us = us.contiguous()
    kernels.require(us, "us", torch.int64, dev)
    trans, offsets, wall = device_tables(zone, str(dev))
    out = torch.empty_like(us)
    n = int(us.shape[0])
    if n:
        _build.check(_build.lib().srtpu_tz_rebase(
            int(to_utc), us.data_ptr(), n, trans.data_ptr(),
            offsets.data_ptr(), wall.data_ptr(), int(trans.shape[0]),
            out.data_ptr(), kernels.sm_count(us), kernels.stream_ptr(us)),
            "tz_rebase")
        kernels.launches["tz_rebase"] += 1
    return out


def utc_to_local_plain(ts_us: torch.Tensor, zone: str) -> torch.Tensor:
    """Plain PyTorch version of K23's UTC -> local mode: the reference's
    searchsorted over the transitions and a gather of the offsets."""
    trans, offsets, _ = device_tables(zone, str(ts_us.device))
    i = torch.searchsorted(trans, ts_us, right=True)
    return ts_us + offsets[i]


def local_to_utc_plain(local_us: torch.Tensor, zone: str) -> torch.Tensor:
    """Plain PyTorch version of K23's local -> UTC mode, with the
    reference's gap rule."""
    trans, offsets, wall = device_tables(zone, str(local_us.device))
    i = torch.searchsorted(wall, local_us, right=True)
    cand = local_us - offsets[i]
    # gap detection: the chosen regime starts at trans[i-1]; if the
    # candidate instant lands BEFORE that start, the local time never
    # existed: fall back to the previous (pre-gap) offset
    prev = torch.clamp(i - 1, min=0)
    in_gap = (i > 0) & (cand < trans[prev])
    return torch.where(in_gap, local_us - offsets[prev], cand)


def utc_to_local(ts_us: torch.Tensor, zone: str) -> torch.Tensor:
    """UTC epoch-us -> local wall-clock epoch-us: kernel K23 on the card.
    A zone without transitions adds its one offset."""
    trans, offsets, _ = tables(zone)
    if trans.size == 0:
        return ts_us + int(offsets[0])
    if ts_us.device.type == "cpu":
        return utc_to_local_plain(ts_us, zone)
    return _rebase(False, ts_us, zone)


def local_to_utc(local_us: torch.Tensor, zone: str) -> torch.Tensor:
    """Local wall-clock epoch-us -> UTC epoch-us: kernel K23 on the card.
    Ambiguous local times resolve to the earlier offset, and nonexistent
    (gap) local times keep the PRE-gap offset, i.e. they are pushed later
    by the gap width: the java.time.ZoneRules behaviour Spark inherits."""
    trans, offsets, _ = tables(zone)
    if trans.size == 0:
        return local_us - int(offsets[0])
    if local_us.device.type == "cpu":
        return local_to_utc_plain(local_us, zone)
    return _rebase(True, local_us, zone)


def utc_to_local_np(ts_us: np.ndarray, zone: str) -> np.ndarray:
    trans, offsets, _ = tables(zone)
    if trans.size == 0:
        return ts_us + int(offsets[0])
    i = np.searchsorted(trans, ts_us, side="right")
    return ts_us + offsets[i]


def local_to_utc_np(local_us: np.ndarray, zone: str) -> np.ndarray:
    trans, offsets, wall = tables(zone)
    if trans.size == 0:
        return local_us - int(offsets[0])
    i = np.searchsorted(wall, local_us, side="right")
    cand = local_us - offsets[i]
    prev_start = trans[np.maximum(i - 1, 0)]
    in_gap = (i > 0) & (cand < prev_start)
    prev_off = offsets[np.maximum(i - 1, 0)]
    return np.where(in_gap, local_us - prev_off, cand)
