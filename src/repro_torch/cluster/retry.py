"""Shared retry policy: exponential backoff + deterministic jitter (a
copy of ``repro.cluster.retry``: the same seed backs off bitwise the
same).

Transport-level operations against edge devices fail transiently all
the time -- a worker dials before the coordinator binds its port, a
shard ship races a slow event loop, a submit hits a half-open socket.
The cluster's answer everywhere is the same ``RetryPolicy``: bounded
attempts (``REPRO_RETRY_MAX_ATTEMPTS``), exponential backoff capped at
``max_backoff_s``, and *deterministic* jitter (hashed from
``(seed, attempt)``, not sampled from global randomness) so two
replayed runs back off identically -- the chaos harness depends on
that determinism.

Users: the remote worker's dial loop (``--max-dial-s`` maps onto
``total_timeout_s``), the tcp transport's shard shipping, and the
fleet's join catch-up.  ``attempt_timeout_s`` is the per-attempt
budget a caller should apply to the operation itself (e.g. the
event-loop round-trip timeout); ``call`` enforces the overall wall
budget between attempts.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from .._env import env_int

ENV_RETRY_MAX_ATTEMPTS = "REPRO_RETRY_MAX_ATTEMPTS"


def default_max_attempts() -> int:
    """Attempt cap for transport retries: ``REPRO_RETRY_MAX_ATTEMPTS``,
    else 5 (first try + 4 retries)."""
    return env_int(ENV_RETRY_MAX_ATTEMPTS, 5)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + deterministic jitter + wall budget.

    ``max_attempts=None`` resolves from the env var; ``max_attempts=0``
    means unlimited attempts (the dial loop: only ``total_timeout_s``
    bounds it).  ``backoff_s(attempt)`` is pure -- same (seed, attempt)
    always sleeps the same -- so retry schedules replay exactly.
    """

    max_attempts: int | None = None
    base_s: float = 0.05
    factor: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25            # +/- fraction of the raw backoff
    seed: int = 0
    total_timeout_s: float | None = None
    attempt_timeout_s: float | None = None

    def _cap(self) -> int:
        if self.max_attempts is None:
            return default_max_attempts()
        if self.max_attempts == 0:
            return 1 << 30
        return max(1, self.max_attempts)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based), jittered
        deterministically from ``(seed, attempt)``."""
        raw = min(self.base_s * self.factor ** (attempt - 1),
                  self.max_backoff_s)
        if self.jitter <= 0:
            return raw
        u = random.Random((self.seed << 20) ^ attempt).random()  # noqa: S311
        return raw * (1.0 + self.jitter * (2.0 * u - 1.0))

    def call(self, fn, *, retry_on=(ConnectionError, OSError, TimeoutError),
             on_retry=None, clock=time.monotonic, sleep=time.sleep):
        """Run ``fn()`` under this policy.

        Retries on ``retry_on`` until the attempt cap or the wall
        budget is exhausted, then re-raises the last error.
        ``on_retry(attempt, delay_s, exc)`` observes each retry (used
        by the dial loop's progress logging and by tests).
        """
        start = clock()
        cap = self._cap()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on as exc:
                if attempt >= cap:
                    raise
                delay = self.backoff_s(attempt)
                if self.total_timeout_s is not None and \
                        clock() - start + delay > self.total_timeout_s:
                    raise
                if on_retry is not None:
                    on_retry(attempt, delay, exc)
                sleep(delay)
