"""The engine's I/O error classes — the part of
`spark_rapids_tpu/runtime/errors.py` the port's retry loop raises. The
shuffle, spill and manifest errors beside them in the reference are not
ported yet (ROADMAP A10, A17)."""


class EngineIOError(RuntimeError):
    """Base for clean engine-surfaced I/O failures: a failure domain that
    exhausted its recovery budget reports WHAT failed in engine terms
    instead of leaking a raw OSError."""


class RetryExhausted(EngineIOError):
    """A backoff loop (runtime/backoff.py) ran out of attempts; chained to
    the last underlying error."""
