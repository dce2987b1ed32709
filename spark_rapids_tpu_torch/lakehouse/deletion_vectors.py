"""Delta deletion vectors: the merge-on-read row-removal sidecar — a copy
of `spark_rapids_tpu/lakehouse/deletion_vectors.py` (host-only numpy,
byte for byte the same format).

Implements the Delta protocol's Deletion Vector binary format
(PROTOCOL.md "Deletion Vector Format"; reference read path
`delta-lake/.../GpuDeltaParquetFileFormat` + delta-storage
`RoaringBitmapArray`): a DV is a 64-bit roaring bitmap array of deleted
row indexes, serialized as

    blob := <magic: i32 LE = 1681511377> <n_bitmaps: i64 LE>
            <bitmap_0> ... <bitmap_{n-1}>

where bitmap_i covers row indexes [i * 2^32, (i+1) * 2^32) and each
bitmap uses the 32-bit RoaringBitmap "portable" spec (cookie 12346/7,
array/bitmap/run containers). In a DV FILE (descriptor storageType
"u"/"p"; the file starts with a 1-byte format version = 1) each blob is
framed as <size: i32 BE> <blob> <crc32(blob): i32 BE> at the
descriptor's offset; inline DVs (storageType "i") carry the blob
z85-encoded in the descriptor itself.

Only the container kinds the spec defines exist here — no private
extensions — so DVs written by other Delta implementations parse, and
DVs written here follow the NO_RUNCONTAINER layout every reader must
accept.
"""

from __future__ import annotations

import os
import struct
import uuid as _uuid
import zlib
from typing import Dict, List, Optional

import numpy as np

MAGIC = 1681511377
_COOKIE_RUN = 12347
_COOKIE_NORUN = 12346
_NO_OFFSET_THRESHOLD = 4

# ---------------------------------------------------------------- z85

_Z85 = ("0123456789abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ.-:+=^!/*?&<>()[]{}@%$#")
_Z85_INV = {c: i for i, c in enumerate(_Z85)}


def z85_encode(data: bytes) -> str:
    assert len(data) % 4 == 0, "z85 encodes 4-byte groups"
    out = []
    for i in range(0, len(data), 4):
        v = int.from_bytes(data[i:i + 4], "big")
        chunk = []
        for _ in range(5):
            chunk.append(_Z85[v % 85])
            v //= 85
        out.extend(reversed(chunk))
    return "".join(out)


def z85_decode(s: str) -> bytes:
    assert len(s) % 5 == 0, "z85 decodes 5-char groups"
    out = bytearray()
    for i in range(0, len(s), 5):
        v = 0
        for c in s[i:i + 5]:
            v = v * 85 + _Z85_INV[c]
        out += v.to_bytes(4, "big")
    return bytes(out)


# ------------------------------------------- 32-bit roaring (portable)

def _parse_roaring32(buf: memoryview, pos: int):
    """-> (sorted np.uint32 values, new pos)."""
    (cookie,) = struct.unpack_from("<I", buf, pos)
    run_flags = None
    if (cookie & 0xFFFF) == _COOKIE_RUN:
        size = (cookie >> 16) + 1
        pos += 4
        nb = (size + 7) // 8
        flag_bytes = bytes(buf[pos:pos + nb])
        run_flags = [(flag_bytes[i // 8] >> (i % 8)) & 1
                     for i in range(size)]
        pos += nb
    elif cookie == _COOKIE_NORUN:
        pos += 4
        (size,) = struct.unpack_from("<I", buf, pos)
        pos += 4
    else:
        raise ValueError(f"bad roaring cookie {cookie}")
    keys = []
    cards = []
    for i in range(size):
        k, cm1 = struct.unpack_from("<HH", buf, pos)
        pos += 4
        keys.append(k)
        cards.append(cm1 + 1)
    if run_flags is None or size >= _NO_OFFSET_THRESHOLD:
        pos += 4 * size  # container offsets (we read sequentially)
    parts: List[np.ndarray] = []
    for i in range(size):
        base = np.uint32(keys[i]) << np.uint32(16)
        if run_flags is not None and run_flags[i]:
            (n_runs,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            vals = []
            for _ in range(n_runs):
                start, length = struct.unpack_from("<HH", buf, pos)
                pos += 4
                vals.append(np.arange(start, start + length + 1,
                                      dtype=np.uint32))
            lo = (np.concatenate(vals) if vals
                  else np.empty(0, np.uint32))
        elif cards[i] > 4096:  # bitmap container: 1024 x u64
            words = np.frombuffer(buf, np.uint64, 1024, pos)
            pos += 8192
            bits = np.unpackbits(
                words.view(np.uint8), bitorder="little")
            lo = np.nonzero(bits)[0].astype(np.uint32)
        else:  # array container
            lo = np.frombuffer(buf, np.uint16, cards[i],
                               pos).astype(np.uint32)
            pos += 2 * cards[i]
        parts.append((base.astype(np.uint32) | lo))
    vals = (np.concatenate(parts) if parts
            else np.empty(0, np.uint32))
    return vals, pos


def _serialize_roaring32(values: np.ndarray) -> bytes:
    """NO_RUNCONTAINER portable layout (array/bitmap containers)."""
    values = np.unique(values.astype(np.uint32))
    if len(values) == 0:
        # valid empty bitmap (size 0, no offsets) — empty 2^32 buckets
        # between occupied ones serialize through here
        return struct.pack("<II", _COOKIE_NORUN, 0)
    hi = (values >> np.uint32(16)).astype(np.uint16)
    keys, starts = np.unique(hi, return_index=True)
    groups = np.split(values, starts[1:])
    out = bytearray()
    out += struct.pack("<II", _COOKIE_NORUN, len(keys))
    for k, g in zip(keys, groups):
        out += struct.pack("<HH", int(k), len(g) - 1)
    # container offsets (relative to stream start)
    header = len(out) + 4 * len(keys)
    offs = []
    pos = header
    bodies = []
    for g in groups:
        lo = (g & np.uint32(0xFFFF)).astype(np.uint16)
        if len(g) > 4096:
            bits = np.zeros(1 << 16, np.uint8)
            bits[lo] = 1
            body = np.packbits(bits, bitorder="little").tobytes()
        else:
            body = lo.tobytes()
        offs.append(pos)
        bodies.append(body)
        pos += len(body)
    for o in offs:
        out += struct.pack("<I", o)
    for b in bodies:
        out += b
    return bytes(out)


# ----------------------------------------------- 64-bit array + blobs

def parse_blob(blob: bytes) -> np.ndarray:
    """DV blob -> sorted int64 deleted-row indexes."""
    buf = memoryview(blob)
    (magic,) = struct.unpack_from("<i", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad deletion-vector magic {magic}")
    (n,) = struct.unpack_from("<q", buf, 4)
    pos = 12
    parts = []
    for i in range(n):
        vals32, pos = _parse_roaring32(buf, pos)
        parts.append(vals32.astype(np.int64) + (i << 32))
    return (np.concatenate(parts) if parts
            else np.empty(0, np.int64))


def serialize_blob(indexes: np.ndarray) -> bytes:
    """Sorted int64 deleted-row indexes -> DV blob."""
    indexes = np.unique(np.asarray(indexes, np.int64))
    n = int(indexes[-1] >> 32) + 1 if len(indexes) else 0
    out = bytearray(struct.pack("<iq", MAGIC, n))
    for i in range(n):
        sel = indexes[(indexes >> 32) == i] & 0xFFFFFFFF
        out += _serialize_roaring32(sel.astype(np.uint32))
    return bytes(out)


# --------------------------------------------------- descriptor plane

def _uuid_file_name(table_path: str, encoded: str) -> str:
    """storageType 'u': optional random prefix + z85 UUID (20 chars)."""
    prefix, enc = encoded[:-20], encoded[-20:]
    u = _uuid.UUID(bytes=z85_decode(enc))
    name = f"deletion_vector_{u}.bin"
    return (os.path.join(table_path, prefix, name) if prefix
            else os.path.join(table_path, name))


def load_descriptor(table_path: str, dv: dict) -> np.ndarray:
    """add.deletionVector descriptor -> deleted-row index array."""
    st = dv["storageType"]
    if st == "i":
        blob = z85_decode(dv["pathOrInlineDv"])
        size = int(dv.get("sizeInBytes", len(blob)))
        return parse_blob(blob[:size])
    if st == "u":
        path = _uuid_file_name(table_path, dv["pathOrInlineDv"])
    elif st == "p":
        path = dv["pathOrInlineDv"]
        if not os.path.isabs(path):
            path = os.path.join(table_path, path)
    else:
        raise ValueError(f"deletion vector storageType {st!r}")
    size = int(dv["sizeInBytes"])
    with open(path, "rb") as f:
        f.seek(int(dv.get("offset", 1)))
        (framed,) = struct.unpack(">i", f.read(4))
        blob = f.read(framed)
        (crc,) = struct.unpack(">I", f.read(4))
    if framed != size:
        raise ValueError(
            f"deletion vector size mismatch: framed {framed} != "
            f"descriptor {size}")
    if crc != zlib.crc32(blob):
        raise ValueError("deletion vector checksum mismatch")
    return parse_blob(blob)


def write_dv_file(table_path: str, indexes_by_key: Dict[str, np.ndarray]
                  ) -> Dict[str, dict]:
    """Write one DV file holding a blob per key; returns descriptors
    (storageType 'u') keyed like the input. The file layout is
    <version: 1 byte = 1> then framed blobs."""
    u = _uuid.uuid4()
    path = os.path.join(table_path, f"deletion_vector_{u}.bin")
    descriptors: Dict[str, dict] = {}
    with open(path, "wb") as f:
        f.write(b"\x01")
        for key, idx in indexes_by_key.items():
            blob = serialize_blob(idx)
            offset = f.tell()
            f.write(struct.pack(">i", len(blob)))
            f.write(blob)
            f.write(struct.pack(">I", zlib.crc32(blob)))
            descriptors[key] = {
                "storageType": "u",
                "pathOrInlineDv": z85_encode(u.bytes),
                "offset": offset,
                "sizeInBytes": len(blob),
                "cardinality": int(len(np.unique(idx))),
            }
    return descriptors


def inline_descriptor(indexes: np.ndarray,
                      max_bytes: int = 512) -> Optional[dict]:
    """Inline ('i') descriptor when the blob is small enough (the
    protocol caps inline DVs well under a commit line's practical
    size); None -> caller should use a DV file."""
    blob = serialize_blob(indexes)
    pad = (-len(blob)) % 4
    if len(blob) + pad > max_bytes:
        return None
    return {
        "storageType": "i",
        "pathOrInlineDv": z85_encode(blob + b"\x00" * pad),
        # sizeInBytes is the RAW serialized DV size; readers use it to
        # strip the z85 padding, so it must exclude the pad bytes.
        "sizeInBytes": len(blob),
        "cardinality": int(len(np.unique(indexes))),
    }
