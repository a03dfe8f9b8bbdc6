"""Dynamic micro-batching: coalesce concurrent requests into bucket-sized
device batches.

PyTorch port of `incubator_mxnet_tpu/serving/batcher.py`.  One bounded
priority queue and one worker thread per model.  The worker takes the
oldest request, then keeps admitting more until the batch would exceed
``max_batch_size`` or ``max_queue_latency_ms`` has passed since the first
request of the batch arrived.  The coalesced rows are padded to the
nearest bucket, run as ONE device batch, and scattered back to
per-request futures by row range.

Unhappy paths kept from the JAX package: per-request deadlines (a request
still queued past its deadline fails and never reaches the device),
deadline-aware shedding before queueing, backpressure on a full queue
(with the top fifth reserved for rank < 2), and graceful drain.  The
circuit breaker, execution retries, fault injection, trace spans, monitor
hook and sanitizer instrumentation are not ported (ROADMAP.md).
"""
from __future__ import annotations

import queue as _queue
import threading
import time

from concurrent.futures import Future, InvalidStateError

import numpy as _np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["MicroBatcher"]


class _Request:
    __slots__ = ("arrs", "rows", "deadline", "timeout_ms", "future",
                 "t_enqueue", "rid", "prio")

    def __init__(self, arrs, rows, timeout_ms, rid, prio=1):
        self.arrs = arrs
        self.rows = rows
        self.timeout_ms = timeout_ms
        self.rid = rid
        self.prio = int(prio)
        self.t_enqueue = time.monotonic()
        self.deadline = (self.t_enqueue + timeout_ms / 1e3
                         if timeout_ms is not None else None)
        self.future = Future()


class MicroBatcher:
    """The per-model request queue + coalescing worker."""

    def __init__(self, model, metrics, max_batch_size=None,
                 max_queue_latency_ms=2.0, max_queue=256):
        self._model = model
        self._metrics = metrics
        self.max_batch_size = min(int(max_batch_size or model.max_batch_size),
                                  model.max_batch_size)
        self.max_queue_latency_ms = float(max_queue_latency_ms)
        self.max_queue = int(max_queue)
        # keyed (priority rank, arrival seq): rank 0 dispatches first,
        # equal ranks stay FIFO
        self._q = _queue.PriorityQueue(maxsize=self.max_queue)
        self._carry = None         # admitted but deferred to the next batch
        self._outstanding = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._rid_counter = 0
        self._pending = {}             # rid -> _Request (admitted, unresolved)
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"mx-serving-{model.name}")
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def estimated_wait_s(self):
        """Queue wait a new request faces, from the queue depth and the
        EWMA of recent batch times; None before the first batch."""
        batch_s = self._metrics.avg_batch_s()
        if batch_s is None:
            return None
        batches_ahead = -(-(self._q.qsize() + 1) // self.max_batch_size)
        return batch_s * batches_ahead

    def submit(self, inputs, timeout_ms=None, priority=1):
        """Enqueue one request; returns a Future resolving to the list of
        per-output NDArrays for exactly this request's rows.
        ``priority`` is the dispatch rank (0 first, 1 default, 2 last)."""
        if self._draining.is_set() or self._stop.is_set():
            raise MXNetError(f"serving: model '{self._model.name}' is "
                             "draining; not accepting requests")
        if timeout_ms is not None:
            est = self.estimated_wait_s()
            if est is not None and est > timeout_ms / 1e3:
                self._metrics.record_shed()
                raise MXNetError(
                    f"serving: model '{self._model.name}' is overloaded — "
                    f"estimated queue wait {est * 1e3:.0f} ms exceeds this "
                    f"request's {timeout_ms:g} ms deadline (shed before "
                    "queueing)")
        rows, arrs = self._model.prepare_rows(inputs)
        if rows > self.max_batch_size:
            raise MXNetError(
                f"serving: model '{self._model.name}' request batch "
                f"{rows} exceeds max_batch_size {self.max_batch_size}")
        if priority >= 2 and self._q.qsize() >= (self.max_queue * 4) // 5:
            self._metrics.record_reject()
            raise MXNetError(
                f"serving: model '{self._model.name}' queue is past its "
                f"best-effort high-water mark ({(self.max_queue * 4) // 5} "
                f"of {self.max_queue}) — backpressure, retry later")
        with self._lock:
            self._rid_counter += 1
            seq = self._rid_counter
            rid = f"{self._model.name}-{seq}"
            req = _Request(arrs, rows, timeout_ms, rid, prio=priority)
            req.future.request_id = rid
            self._outstanding += 1
            self._pending[rid] = req
        try:
            self._q.put_nowait((req.prio, seq, req))
        except _queue.Full:
            with self._lock:
                self._outstanding -= 1
                self._pending.pop(rid, None)
            self._metrics.record_reject()
            raise MXNetError(
                f"serving: model '{self._model.name}' queue is full "
                f"({self.max_queue} pending) — backpressure, retry later")
        if self._stop.is_set():
            # raced with close(): sweep so no future is left unresolved
            self._sweep_failed()
        self._metrics.record_request(self._q.qsize())
        return req.future

    def pending_request_ids(self):
        """Ids of admitted-but-unresolved requests (drain diagnostics)."""
        with self._lock:
            return sorted(self._pending)

    def close(self, drain=True, timeout=None):
        """Stop the batcher.  With ``drain`` every queued request completes
        first; without, queued requests fail with a shutdown error.  A
        drain that outlives ``timeout`` seconds stops anyway and raises,
        listing the request ids still pending."""
        self._draining.set()
        drained = True
        if drain:
            with self._idle:
                drained = self._idle.wait_for(
                    lambda: self._outstanding == 0, timeout=timeout)
        stuck = self.pending_request_ids() if not drained else []
        self._stop.set()
        self._thread.join(10)
        self._sweep_failed()
        if stuck:
            raise MXNetError(
                f"serving: model '{self._model.name}' drain timed out "
                f"after {timeout:g}s with {len(stuck)} request(s) still "
                f"pending: {', '.join(stuck[:16])}"
                + (" ..." if len(stuck) > 16 else ""))

    def _sweep_failed(self):
        while True:
            try:
                req = self._q.get_nowait()[2]
            except _queue.Empty:
                return
            self._fail(req, MXNetError(
                f"serving: model '{self._model.name}' shut down before "
                "this request ran"))

    # -- worker side ---------------------------------------------------------
    def _done(self, req):
        with self._idle:
            self._outstanding -= 1
            self._pending.pop(req.rid, None)
            if self._outstanding == 0:
                self._idle.notify_all()

    def _fail(self, req, exc):
        try:
            req.future.set_exception(exc)
        except InvalidStateError:   # the caller cancelled it meanwhile
            pass
        self._done(req)

    def _take(self, timeout):
        if self._carry is not None:
            req, self._carry = self._carry, None
            return req
        return self._q.get(timeout=timeout)[2]

    def _worker(self):
        while True:
            try:
                first = self._take(timeout=0.05)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            rows = first.rows
            t_close = first.t_enqueue + self.max_queue_latency_ms / 1e3
            while rows < self.max_batch_size:
                if self._carry is None and self._q.empty():
                    with self._lock:
                        quiescent = self._outstanding == len(batch)
                    if quiescent:
                        # every live request is in hand: waiting out the
                        # latency window would buy rows from nobody
                        break
                try:
                    # a non-positive remainder still sweeps the queue once
                    nxt = self._take(timeout=max(t_close - time.monotonic(),
                                                 0))
                except _queue.Empty:
                    break
                if rows + nxt.rows > self.max_batch_size:
                    self._carry = nxt   # heads the next batch
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._metrics.set_queue_depth(self._q.qsize())
            self._execute(batch)

    def _execute(self, batch):
        model = self._model
        now = time.monotonic()
        live = []
        rows = 0
        for req in batch:
            # a cancelled future is dropped; marking the others running
            # keeps a later set_result from raising InvalidStateError
            if not req.future.set_running_or_notify_cancel():
                self._done(req)
            elif req.deadline is not None and now > req.deadline:
                self._metrics.record_timeout()
                self._fail(req, MXNetError(
                    f"serving: request to model '{model.name}' exceeded "
                    f"its {req.timeout_ms:g} ms deadline in the queue"))
            else:
                live.append(req)
                rows += req.rows
        if not live:
            return
        bucket = model.bucket_for(rows)
        arrs = [_np.concatenate(parts) if len(parts) > 1 else parts[0]
                for parts in zip(*(r.arrs for r in live))]
        t0 = time.monotonic()
        try:
            outs = model.run_bucket(model.pad_rows(arrs, rows, bucket),
                                    bucket)
            model.synchronize()
        except Exception as exc:   # the worker serves every client: report
            err = exc if isinstance(exc, MXNetError) else MXNetError(
                f"serving: model '{model.name}' batch execution failed: "
                f"{exc!r}")
            for req in live:
                self._fail(req, err)
            return
        done = time.monotonic()
        self._metrics.record_batch(rows, bucket, done - t0)
        off = 0
        for req in live:
            lo, hi = off, off + req.rows
            off = hi
            req.future.set_result(
                [NDArray(o[lo:hi], ctx=model.ctx) for o in outs])
            self._metrics.record_response(done - req.t_enqueue)
            self._done(req)
