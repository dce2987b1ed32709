"""Process write totals — the conflict counter of
`spark_rapids_tpu/io/commit.py` (`note_conflict`, `write_totals`), which
the Delta commit loop feeds. The committed-output protocol around it
(`_SUCCESS` manifests, task attempts, the file-format writers) is not
ported yet (ROADMAP A14)."""

from __future__ import annotations

import threading
from typing import Dict

_totals_lock = threading.Lock()
_TOTALS: Dict[str, float] = {"conflicts": 0}


def note_conflict(n: int = 1) -> None:
    """Count a lakehouse optimistic-commit conflict retry."""
    with _totals_lock:
        _TOTALS["conflicts"] = _TOTALS.get("conflicts", 0) + n


def write_totals() -> Dict[str, float]:
    with _totals_lock:
        return dict(_TOTALS)
