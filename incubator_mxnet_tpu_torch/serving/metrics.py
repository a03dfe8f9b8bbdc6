"""Serving metrics: QPS, latency percentiles, batch occupancy, queue depth.

PyTorch port of `incubator_mxnet_tpu/serving/metrics.py`.  One
`ServingMetrics` per served model, updated by the micro-batching worker
under a plain lock.  Latency lands in a `LatencyReservoir`, a fixed-size
uniform sample (algorithm R) over every response since start.  The JAX
package's hooks into the telemetry plane, the profiler trace and the
concurrency sanitizer are not ported (ROADMAP.md).
"""
from __future__ import annotations

import random
import threading
import time

import numpy as _np

__all__ = ["ServingMetrics", "LatencyReservoir"]


class LatencyReservoir:
    """Bounded uniform sample of a value stream (algorithm R).  NOT
    thread-safe on its own: callers hold their own lock."""

    __slots__ = ("_vals", "count", "_rng", "capacity")

    def __init__(self, capacity=4096, seed=0):
        self.capacity = int(capacity)
        self._vals = _np.empty(self.capacity, dtype=_np.float64)
        self.count = 0
        self._rng = random.Random(seed)

    def add(self, value):
        n = self.count
        if n < self.capacity:
            self._vals[n] = value
        else:
            j = self._rng.randrange(n + 1)
            if j < self.capacity:
                self._vals[j] = value
        self.count = n + 1

    def __len__(self):
        return min(self.count, self.capacity)

    def percentile(self, q):
        """q-th percentile of the sample, or None before any record."""
        n = len(self)
        if not n:
            return None
        return float(_np.percentile(self._vals[:n], q))


class ServingMetrics:
    """Counters and a bounded latency reservoir for one served model."""

    def __init__(self, model_name, window=4096):
        self.model_name = model_name
        self._lock = threading.Lock()
        self._lat_ms = LatencyReservoir(window)
        self._t0 = time.monotonic()
        self.requests = 0        # accepted into the queue
        self.responses = 0       # completed with a result
        self.timeouts = 0        # deadline-exceeded in the queue
        self.rejected = 0        # backpressure rejections
        self.shed = 0            # deadline-unmeetable, refused pre-queue
        self.batches = 0         # executed device batches
        self.rows = 0            # live request rows executed
        self.capacity = 0        # bucket rows executed (rows + padding)
        self.queue_depth = 0     # gauge, set by the batcher
        self._ewma_batch_s = None    # recent batch execution time

    def record_request(self, queue_depth):
        with self._lock:
            self.requests += 1
            self.queue_depth = queue_depth

    def record_batch(self, rows, bucket, dur_s):
        with self._lock:
            self.batches += 1
            self.rows += rows
            self.capacity += bucket
            self._ewma_batch_s = dur_s if self._ewma_batch_s is None \
                else 0.8 * self._ewma_batch_s + 0.2 * dur_s

    def avg_batch_s(self):
        """Recent batch execution time (EWMA), or None before the first
        executed batch (no shedding until there is an estimate)."""
        with self._lock:
            return self._ewma_batch_s

    def record_response(self, latency_s):
        with self._lock:
            self.responses += 1
            self._lat_ms.add(latency_s * 1e3)

    def record_timeout(self):
        with self._lock:
            self.timeouts += 1

    def record_reject(self):
        with self._lock:
            self.rejected += 1

    def record_shed(self):
        with self._lock:
            self.shed += 1

    def set_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth

    def snapshot(self):
        """One coherent metrics dict: counts, QPS since start, p50/p99
        latency (ms, reservoir-sampled over the whole run), mean batch
        occupancy."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            return {
                "model": self.model_name,
                "requests": self.requests,
                "responses": self.responses,
                "timeouts": self.timeouts,
                "rejected": self.rejected,
                "shed": self.shed,
                "batches": self.batches,
                "rows": self.rows,
                "queue_depth": self.queue_depth,
                "qps": self.responses / elapsed,
                "batch_occupancy": (self.rows / self.capacity
                                    if self.capacity else 0.0),
                "avg_batch_rows": (self.rows / self.batches
                                   if self.batches else 0.0),
                "avg_batch_ms": (self._ewma_batch_s * 1e3
                                 if self._ewma_batch_s is not None else None),
                "p50_ms": self._lat_ms.percentile(50),
                "p99_ms": self._lat_ms.percentile(99),
            }
