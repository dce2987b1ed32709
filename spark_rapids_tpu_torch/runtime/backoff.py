"""Bounded exponential backoff with jitter — counterpart of
`spark_rapids_tpu/runtime/backoff.py`: every retryable site funnels
through ONE policy, so the attempt budget and the delay curve are set
once (`spark.rapids.tpu.io.retry.*`) and counted once.

Not ported (ROADMAP A17): the chaos harness (the reference's
`runtime/faults.py` injects a fault at a named site before each
attempt), query cancellation (an interruptible sleep and a check before
each attempt) and the per-query cumulative delay budget
(`spark.rapids.tpu.io.retry.maxTotalMs`, which rides the cancellation
token). A `site` here only names the counter.
"""

from __future__ import annotations

import random
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple, TypeVar

from spark_rapids_tpu_torch.runtime.errors import RetryExhausted

T = TypeVar("T")

_counters: Dict[str, int] = defaultdict(int)
_counters_lock = threading.Lock()
# jitter decorrelates concurrent retriers; seeded so runs are
# reproducible
_jitter_rng = random.Random(0x5EED)


class BackoffPolicy:
    """attempts total tries; delay_i = min(max, base * 2^i) * jitter,
    jitter uniform in [0.5, 1.0]."""

    __slots__ = ("attempts", "base_ms", "max_ms")

    def __init__(self, attempts: int = 4, base_ms: float = 50.0,
                 max_ms: float = 2000.0):
        self.attempts = max(1, int(attempts))
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)

    def delay_s(self, attempt: int) -> float:
        raw = min(self.max_ms, self.base_ms * (2 ** attempt))
        return raw / 1000.0 * (0.5 + 0.5 * _jitter_rng.random())


def policy_from_conf(conf=None) -> BackoffPolicy:
    """The session's retry policy (the entries' defaults when no session
    is active)."""
    from spark_rapids_tpu_torch.config import rapids_conf as rc

    if conf is None:
        from spark_rapids_tpu_torch.api.session import TpuSparkSession

        s = TpuSparkSession.active()
        conf = s.rapids_conf if s is not None else None
    if conf is None:
        return BackoffPolicy(rc.IO_RETRY_ATTEMPTS.default,
                             rc.IO_RETRY_BACKOFF_MS.default,
                             rc.IO_RETRY_MAX_BACKOFF_MS.default)
    return BackoffPolicy(conf.get(rc.IO_RETRY_ATTEMPTS),
                         conf.get(rc.IO_RETRY_BACKOFF_MS),
                         conf.get(rc.IO_RETRY_MAX_BACKOFF_MS))


def retry_io(fn: Callable[[], T], what: str,
             site: Optional[str] = None,
             retry_on: Tuple[type, ...] = (OSError,),
             no_retry: Tuple[type, ...] = (),
             policy: Optional[BackoffPolicy] = None,
             counter: Optional[str] = None,
             on_retry: Optional[Callable[[BaseException], None]] = None
             ) -> T:
    """Run `fn` under the backoff policy. Exceptions in `retry_on`
    consume an attempt; `no_retry` classes fail at once. The final
    failure raises RetryExhausted chained to the last error."""
    policy = policy or policy_from_conf()
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        # the reference checks for cancellation here and, at a named
        # site, lets the chaos registry inject a fault (ROADMAP A17)
        try:
            return fn()
        except no_retry:
            raise
        except retry_on as e:
            last = e
        key = counter or site or "io"
        with _counters_lock:
            _counters[key] += 1
        if on_retry is not None:
            on_retry(last)
        if attempt < policy.attempts - 1:
            # the reference bills the delay to the query's retry budget
            # and sleeps interruptibly (ROADMAP A17)
            time.sleep(policy.delay_s(attempt))
    raise RetryExhausted(
        f"{what}: {policy.attempts} attempts exhausted "
        f"(last: {type(last).__name__}: {last})") from last


def record_retry(key: str, n: int = 1) -> None:
    """Count a retry attempt made outside retry_io."""
    with _counters_lock:
        _counters[key] += int(n)


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()
