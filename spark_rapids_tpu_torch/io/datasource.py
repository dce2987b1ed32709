"""External data-source SPI — counterpart of
`spark_rapids_tpu/io/datasource.py` (the ExternalSource role: pluggable
providers that extend the reader's formats without touching the core).

Third-party formats register a reader factory; `spark.read.format(name)
.load(path)` resolves through this registry before the built-ins.

    from spark_rapids_tpu_torch.io.datasource import register_format

    def my_reader(session, path, schema, options) -> DataFrame: ...
    register_format("myformat", my_reader)
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

_SOURCES: Dict[str, Callable] = {}
_lock = threading.Lock()


def register_format(name: str, reader: Callable) -> None:
    """reader(session, path, schema, options) -> DataFrame."""
    with _lock:
        _SOURCES[name] = reader


def lookup_format(name: str) -> Optional[Callable]:
    with _lock:
        return _SOURCES.get(name)
