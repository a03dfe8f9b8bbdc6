"""Retry policy: exponential backoff with jitter, deadlines, and a budget.

A copy of `incubator_mxnet_tpu/resilience/retry.py`, which imports no JAX.

`RetryPolicy` is the retry currency of the dist transport: per-attempt
delay grows geometrically from ``base_delay`` to ``max_delay`` with
multiplicative jitter, bounded by ``max_attempts``
and/or an overall ``deadline`` (seconds from the first attempt), and
optionally charged against a shared `RetryBudget` so a cluster-wide
brownout cannot turn every caller into a retry storm (the classic retry
amplification failure).

Jitter is drawn from a policy-local seeded stream: under a seeded fault
schedule the whole retry timeline is reproducible bit for bit.
"""
from __future__ import annotations

import random
import time

__all__ = ["RetryPolicy", "RetryBudget"]


class RetryBudget:
    """Token bucket shared across callers: each retry spends one token,
    tokens refill at ``refill_per_s``.  When the bucket is dry, callers
    stop retrying and surface the error — retries are a scarce resource
    during a real outage, not a right."""

    def __init__(self, capacity=16, refill_per_s=1.0,
                 clock=time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = self.capacity
        self._last = clock()

    def acquire(self):
        now = self._clock()
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) *
                           self.refill_per_s)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class RetryPolicy:
    """Backoff schedule: attempt k (0-based retry index) sleeps
    ``min(base_delay * multiplier**k, max_delay) * (1 + U[0,jitter))``."""

    def __init__(self, max_attempts=4, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, deadline=None, budget=None,
                 seed=None, sleep=time.sleep, clock=time.monotonic):
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline if deadline is None else float(deadline)
        self.budget = budget
        self.seed = seed
        self._sleep = sleep
        self._clock = clock

    def delay(self, retry_index, rng=None):
        """The backoff delay before retry `retry_index` (0-based)."""
        d = min(self.base_delay * self.multiplier ** retry_index,
                self.max_delay)
        if self.jitter and rng is not None:
            d *= 1.0 + rng.random() * self.jitter
        return d

    def delays(self):
        """Generator of sleep durations — one per permitted retry.
        Exhausts after ``max_attempts - 1`` retries, when the overall
        deadline would be passed, or when the shared budget runs dry."""
        rng = random.Random(self.seed) if self.jitter else None
        t_end = None if self.deadline is None \
            else self._clock() + self.deadline
        for k in range(max(self.max_attempts - 1, 0)):
            if t_end is not None and self._clock() >= t_end:
                return
            if self.budget is not None and not self.budget.acquire():
                return
            yield self.delay(k, rng)

    def call(self, fn, retry_on=(ConnectionError, EOFError, OSError),
             on_retry=None):
        """Run ``fn()`` under this policy.  ``on_retry(attempt, exc)``
        observes each failure that will be retried; the final failure
        (attempts/deadline/budget exhausted) propagates."""
        delays = self.delays()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as exc:
                delay = next(delays, None)
                if delay is None:
                    raise
                attempt += 1
                if on_retry is not None:
                    on_retry(attempt, exc)
                self._sleep(delay)
