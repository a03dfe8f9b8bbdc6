"""Circuit breaker: fail fast on a peer that keeps failing.

A copy of `incubator_mxnet_tpu/resilience/breaker.py` (which imports no
JAX) with a plain lock in place of the JAX package's lock hooks.

Classic three-state machine (closed -> open -> half-open -> closed):

* **closed** — requests flow; ``failure_threshold`` CONSECUTIVE failures
  trip the breaker (one success resets the count);
* **open** — `allow()` returns False (callers fail fast, no wire time
  wasted on a dead peer) until ``reset_timeout`` elapses;
* **half-open** — exactly one probe request is admitted; its success
  closes the breaker, its failure re-opens it for another full
  ``reset_timeout``.

Used per parameter server by `dist.kvstore_dist` and per shard by
`embedding.sharded` (a tripped breaker becomes a structured
`ServerLostError`).  The clock is injectable so scripted open/
half-open/close sequences are testable without sleeping.
"""
from __future__ import annotations

import threading
import time

__all__ = ["CircuitBreaker"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, failure_threshold=3, reset_timeout=5.0,
                 clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at = None
        self._probe_out = False     # the half-open probe is in flight

    @property
    def state(self):
        with self._lock:
            return self._observe()

    @property
    def consecutive_failures(self):
        with self._lock:
            return self._failures

    def _observe(self):
        """State with the open -> half-open timer applied (lock held)."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout:
            self._state = HALF_OPEN
            self._probe_out = False
        return self._state

    def allow(self):
        """Whether a request may proceed now.  In half-open exactly one
        caller gets True (the probe); everyone else fails fast until the
        probe reports back."""
        with self._lock:
            state = self._observe()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def release_probe(self):
        """Return an admitted half-open probe WITHOUT recording an
        outcome — for callers that admitted a request via `allow()` but
        then rejected it before it ever executed (shed, oversized,
        queue-full).  Without this the probe token leaks and the breaker
        wedges in half_open forever."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_out = False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probe_out = False
            self._state = CLOSED

    def record_failure(self):
        """One failure.  Returns True when this failure tripped (or
        re-tripped) the breaker open."""
        with self._lock:
            state = self._observe()
            if state == HALF_OPEN:
                # the probe failed: back to a full open window
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_out = False
                return True
            self._failures += 1
            if state == CLOSED and self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                return True
            return False
