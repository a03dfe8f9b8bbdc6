"""Serving metrics: QPS, latency percentiles, batch occupancy, queue depth.

PyTorch port of `incubator_mxnet_tpu/serving/metrics.py`.  One
`ServingMetrics` per served model, updated by the micro-batching worker
under a plain lock.  Latency lands in a `LatencyReservoir`, a fixed-size
uniform sample (algorithm R) over every response since start.  Traffic
that carries a priority class (``interactive``, ``batch``,
``best_effort``: the decode engine's and the router's) also lands in
per-class counters (responses, shed, rejected) and reservoirs, reported
under ``classes`` in `snapshot()`.  `avg_latency_s` is the EWMA of the
end-to-end response latency, the floor a replica's wait estimate takes.
The degraded-mode counters of the resilience layer ride along:
``breaker_rejects`` (requests failed fast while the model's circuit
breaker was open), ``breaker_state`` (a gauge the batcher sets) and
``retry_histogram`` (attempt number -> count).  Each instance is the
``serving.<model>`` telemetry producer (its `snapshot`), and every
executed batch is a `profiler.record_serving` event while a profile
runs, as in the JAX package; the concurrency sanitizer's hooks are not
ported (ROADMAP.md).
"""
from __future__ import annotations

import random
import collections
import threading
import time
import zlib

import numpy as _np

from .. import profiler as _profiler
from ..obs import metrics as _obs_metrics

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
        # telemetry plane: a producer under 'serving.<model>' (weakly
        # held: a retired replica's metrics drop out of scrapes with it)
        _obs_metrics.register_producer(f"serving.{model_name}",
                                       self.snapshot)
        self._lat_ms = LatencyReservoir(window)
        self._window = int(window)
        # class -> {"responses", "lat"}; created on a class's first
        # record, so classless serving pays nothing
        self._classes = {}
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
        self.breaker_rejects = 0  # failed fast while the breaker was open
        self.breaker_state = "closed"   # gauge, set by the batcher
        self.retries = collections.Counter()   # attempt number -> count
        self._ewma_batch_s = None    # recent batch execution time
        self._ewma_lat_s = None      # recent end-to-end response latency

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
        _profiler.record_serving(f"serving:{self.model_name}",
                                 dur_s * 1e6, rows=rows, bucket=bucket)

    def avg_batch_s(self):
        """Recent batch execution time (EWMA), or None before the first
        executed batch (no shedding until there is an estimate)."""
        with self._lock:
            return self._ewma_batch_s

    def _class_locked(self, cls):
        rec = self._classes.get(cls)
        if rec is None:
            # stable per-class seed (str hash is randomized per process)
            rec = self._classes[cls] = {
                "responses": 0, "shed": 0, "rejected": 0,
                "lat": LatencyReservoir(max(self._window // 4, 256),
                                        seed=zlib.crc32(cls.encode()))}
        return rec

    def record_response(self, latency_s, cls=None):
        with self._lock:
            self.responses += 1
            self._lat_ms.add(latency_s * 1e3)
            self._ewma_lat_s = latency_s if self._ewma_lat_s is None \
                else 0.8 * self._ewma_lat_s + 0.2 * latency_s
            if cls is not None:
                rec = self._class_locked(cls)
                rec["responses"] += 1
                rec["lat"].add(latency_s * 1e3)

    def avg_latency_s(self):
        """Recent end-to-end response latency (EWMA), or None before the
        first response; unlike `avg_batch_s` it includes the queueing."""
        with self._lock:
            return self._ewma_lat_s

    def record_timeout(self):
        with self._lock:
            self.timeouts += 1

    def record_reject(self):
        with self._lock:
            self.rejected += 1

    def record_shed(self, cls=None):
        with self._lock:
            self.shed += 1
            if cls is not None:
                self._class_locked(cls)["shed"] += 1

    def record_class_reject(self, cls):
        with self._lock:
            self._class_locked(cls)["rejected"] += 1

    def record_breaker_reject(self):
        with self._lock:
            self.breaker_rejects += 1

    def record_retry(self, attempt):
        with self._lock:
            self.retries[int(attempt)] += 1

    def set_breaker_state(self, state):
        with self._lock:
            self.breaker_state = state

    def set_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth

    def snapshot(self):
        """One coherent metrics dict: counts, QPS since start, p50/p99
        latency (ms, reservoir-sampled over the whole run), mean batch
        occupancy, and a ``classes`` block (per class: responses, p50/p99
        ms) once traffic carried classes."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            snap = {
                "model": self.model_name,
                "requests": self.requests,
                "responses": self.responses,
                "timeouts": self.timeouts,
                "rejected": self.rejected,
                "shed": self.shed,
                "breaker_rejects": self.breaker_rejects,
                "breaker_state": self.breaker_state,
                "retry_histogram": dict(self.retries),
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
            if self._classes:
                snap["classes"] = {
                    cls: {"responses": rec["responses"],
                          "shed": rec["shed"],
                          "rejected": rec["rejected"],
                          "p50_ms": rec["lat"].percentile(50),
                          "p99_ms": rec["lat"].percentile(99)}
                    for cls, rec in self._classes.items()}
        return snap
