"""Parquet inputs — the part of `spark_rapids_tpu/io/readers.py` the
port's PERFILE scan needs: path expansion with Spark's hidden-file rule,
schema inference, and the row-capped batch reader.

Local paths only: the reference's remote-file cache, Alluxio rewriting,
manifest validation and hive-partitioned layouts are not ported yet
(ROADMAP A10); a partitioned layout raises rather than read without its
partition columns.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq


def _hidden(base: str, f: str) -> bool:
    """Spark's hidden-file convention: a path segment below the scanned
    root starting with `_` or `.` is invisible to scans."""
    rel = os.path.relpath(f, base)
    return any(seg.startswith(("_", "."))
               for seg in rel.split(os.sep))


def _check_unpartitioned(base: str, files: List[str]) -> None:
    for f in files:
        rel = os.path.relpath(f, base)
        if any("=" in seg and not seg.startswith("=")
               for seg in rel.split(os.sep)[:-1]):
            raise NotImplementedError(
                f"{base}: hive-partitioned parquet layouts are not ported "
                "yet (ROADMAP A10)")


def expand_paths(paths: List[str], suffix: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files = sorted(
                f for f in globlib.glob(os.path.join(p, "**", "*"),
                                        recursive=True)
                if f.endswith(suffix) and not _hidden(p, f))
            _check_unpartitioned(p, files)
            out.extend(files)
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    return out


def infer_parquet_schema(paths: List[str]) -> pa.Schema:
    files = expand_paths(paths, ".parquet")
    if not files:
        raise FileNotFoundError(f"no parquet files in {paths}")
    return pq.read_schema(files[0])


def read_parquet_task(files: List[str], columns: Optional[List[str]],
                      batch_rows: int,
                      read_dictionary: Optional[List[str]] = None
                      ) -> Iterator[pa.Table]:
    """Decode one task's files in row-capped tables (PERFILE); columns in
    `read_dictionary` surface as DictionaryArrays, so they upload as
    codes plus one dictionary."""
    for f in files:
        pf = pq.ParquetFile(f, read_dictionary=read_dictionary)
        for rb in pf.iter_batches(batch_size=batch_rows, columns=columns):
            yield pa.Table.from_batches([rb])
