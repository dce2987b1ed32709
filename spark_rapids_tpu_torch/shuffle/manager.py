"""In-process shuffle bookkeeping — the part of
`spark_rapids_tpu/shuffle/manager.py` that the device-resident exchange
and adaptive execution use: shuffle ids, map outputs staged per attempt
and committed once (the first commit of a map task wins, a later
attempt's output is discarded), per-reduce-partition sizes, and removal.

A map output is a device batch sorted by reduce partition plus the row
offsets of each partition in it, as the reference's DEVICE shuffle mode
keeps them. Nothing is serialized: host blocks, files, compression and
the fetch-retry machinery are not ported yet (ROADMAP A13), and the
outputs are not spill-backed (the spill catalog is ROADMAP A10).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import ColumnBatch

#: one map output: the partition-sorted batch and its [P + 1] offsets
Block = Tuple[ColumnBatch, np.ndarray]


class _Shuffle:
    def __init__(self):
        self.staged: Dict[Tuple[int, int], List[Block]] = {}
        self.committed: Dict[int, List[Block]] = {}


class ShuffleManager:
    def __init__(self):
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._shuffles: Dict[int, _Shuffle] = {}

    def new_shuffle_id(self) -> int:
        with self._lock:
            sid = next(self._ids)
            self._shuffles[sid] = _Shuffle()
            return sid

    def _get(self, shuffle_id: int) -> _Shuffle:
        sh = self._shuffles.get(shuffle_id)
        if sh is None:
            raise KeyError(f"shuffle {shuffle_id} is not registered")
        return sh

    def put(self, shuffle_id: int, map_id: int, attempt: int,
            batch: ColumnBatch, offsets: np.ndarray) -> None:
        """Stage one block of a map attempt, invisible to readers until
        the attempt commits."""
        with self._lock:
            self._get(shuffle_id).staged.setdefault(
                (map_id, attempt), []).append((batch, offsets))

    def commit_map_output(self, shuffle_id: int, map_id: int,
                          attempt: int) -> bool:
        """Publish a map attempt's blocks; the first commit of a map task
        wins and a later attempt's blocks are dropped. True when this
        attempt's output is the one readers see."""
        with self._lock:
            sh = self._get(shuffle_id)
            blocks = sh.staged.pop((map_id, attempt), [])
            if map_id in sh.committed:
                return False
            sh.committed[map_id] = blocks
            return True

    def discard_attempt(self, shuffle_id: int, map_id: int,
                        attempt: int) -> None:
        with self._lock:
            sh = self._shuffles.get(shuffle_id)
            if sh is not None:
                sh.staged.pop((map_id, attempt), None)

    def blocks(self, shuffle_id: int) -> List[Block]:
        """Committed blocks in map-task order."""
        with self._lock:
            sh = self._get(shuffle_id)
            return [b for m in sorted(sh.committed)
                    for b in sh.committed[m]]

    def partition_sizes(self, shuffle_id: int,
                        num_partitions: int) -> List[int]:
        """Bytes per reduce partition: each block's device bytes per row
        times the rows it holds for that partition (the reference's
        DEVICE-mode statistic)."""
        out = [0] * num_partitions
        for batch, offs in self.blocks(shuffle_id):
            rows = max(int(offs[-1]), 1)
            bpr = batch.device_size_bytes() / rows
            for rp in range(num_partitions):
                out[rp] += int((int(offs[rp + 1]) - int(offs[rp])) * bpr)
        return out

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)


_manager: Optional[ShuffleManager] = None
_manager_lock = threading.Lock()


def get_shuffle_manager() -> ShuffleManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = ShuffleManager()
        return _manager
