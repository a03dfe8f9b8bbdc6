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
(with the top fifth reserved for rank < 2), graceful drain, abrupt death
(`kill`, a replica's failure), and overload control:

* a per-model circuit breaker (`resilience.CircuitBreaker`) — consecutive
  failed batches (``MXNET_SERVING_BREAKER_THRESHOLD``, unless the
  ``breaker_threshold`` knob is given) open it, and while it is open
  `submit` fails fast; after the reset window
  (``MXNET_SERVING_BREAKER_RESET_S``) one half-open probe batch tests
  recovery.  A probe token taken by a request that is rejected before it
  queues, or whose whole batch dies before it executes, is handed back;
* bounded execution retries under a `resilience.RetryPolicy`, recorded
  in the metrics' retry histogram.  The card's synchronisation sits
  inside the retried block, so an asynchronous CUDA error is retried like
  a raised one;
* the ``serving.execute`` fault site (`resilience.faults`) before every
  attempt, and a `monitor.Monitor` driven tic/toc once around each
  batch, its retries included (`install_monitor`; the JAX batcher tics
  every attempt, so its sampling interval shifts with each retry).

Each executed batch records one ``batcher.execute`` span, parented into
the first coalesced request's trace context (captured on the submitting
thread), as in the JAX package.  The sanitizer instrumentation is not
ported (ROADMAP.md).
"""
from __future__ import annotations

import queue as _queue
import threading
import time

from concurrent.futures import Future, InvalidStateError

import numpy as _np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..obs import trace as _obs_trace
from ..resilience import CircuitBreaker, faults as _faults

__all__ = ["MicroBatcher"]


class _Request:
    __slots__ = ("arrs", "rows", "deadline", "timeout_ms", "future",
                 "t_enqueue", "rid", "prio", "tr")

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
        # trace context captured on the SUBMITTING thread: the batch
        # executes on the worker thread, where contextvars are blind
        self.tr = _obs_trace.current_frame()


class MicroBatcher:
    """The per-model request queue + coalescing worker."""

    def __init__(self, model, metrics, max_batch_size=None,
                 max_queue_latency_ms=2.0, max_queue=256,
                 breaker_threshold=None, breaker_reset_s=None,
                 retry_policy=None):
        from .. import config as _config
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
        self._killed = False       # abrupt death: sweep, don't execute
        self._draining = threading.Event()
        self._paused = threading.Event()
        self._monitor = None       # a monitor.Monitor driven per batch
        # an explicit knob wins over MXNET_SERVING_BREAKER_*
        self._breaker = CircuitBreaker(
            failure_threshold=int(
                breaker_threshold if breaker_threshold is not None
                else _config.get("MXNET_SERVING_BREAKER_THRESHOLD")),
            reset_timeout=float(
                breaker_reset_s if breaker_reset_s is not None
                else _config.get("MXNET_SERVING_BREAKER_RESET_S")))
        self._retry = retry_policy     # None: a failed batch is not retried
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
        if not self._breaker.allow():
            self._metrics.record_breaker_reject()
            self._metrics.set_breaker_state(self._breaker.state)
            raise MXNetError(
                f"serving: model '{self._model.name}' circuit breaker is "
                f"{self._breaker.state} after "
                f"{self._breaker.failure_threshold} consecutive batch "
                "failures — failing fast; recovery probes run every "
                f"{self._breaker.reset_timeout:g}s")
        # a rejection below hands back the half-open probe token allow()
        # may just have taken, or the breaker wedges half-open
        queued = False
        try:
            req = self._admit(inputs, timeout_ms, priority)
            queued = True
        finally:
            if not queued:
                self._breaker.release_probe()
        if self._stop.is_set():
            # raced with close(): sweep so no future is left unresolved
            self._sweep_failed()
        self._metrics.record_request(self._q.qsize())
        return req.future

    def _admit(self, inputs, timeout_ms, priority):
        """Shed, validate and queue one request; raises when it is
        refused."""
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
        return req

    def pause(self):
        """Stop dispatching (queued requests wait), as while swapping
        weights, or in a test that needs a full queue."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def install_monitor(self, mon):
        """Drive a `monitor.Monitor` tic/toc around every executed batch;
        its statistics see each batch's outputs (`ServedModel`)."""
        self._model.install_monitor(mon)
        self._monitor = mon

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
        self._paused.clear()   # a paused worker could never drain
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

    def kill(self):
        """Abrupt death, as a killed replica's: the worker stops without
        executing queued requests, which fail with the shutdown error; a
        batch already on the device completes."""
        self._killed = True
        self._draining.set()
        self._stop.set()
        self._paused.clear()
        self._thread.join(10)
        self._sweep_failed()

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
            while self._paused.is_set() and not self._stop.is_set():
                time.sleep(0.001)
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
            if self._killed:
                # killed mid-coalesce: nothing more executes here
                for req in batch:
                    self._fail(req, MXNetError(
                        f"serving: model '{self._model.name}' shut down "
                        "before this request ran"))
                continue
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
            # the whole batch died before executing: a half-open probe
            # among it never had its trial, so its token goes back
            self._breaker.release_probe()
            return
        bucket = model.bucket_for(rows)
        arrs = [_np.concatenate(parts) if len(parts) > 1 else parts[0]
                for parts in zip(*(r.arrs for r in live))]
        mon = self._monitor
        if mon is not None:
            mon.tic()   # once a batch, whatever its attempts
        delays = self._retry.delays() if self._retry is not None \
            else iter(())
        attempt = 0
        while True:
            t0 = time.monotonic()   # per attempt: the EWMA sheds by it
            try:
                _faults.fire("serving.execute", model=model.name,
                             attempt=attempt)
                outs = model.run_bucket(model.pad_rows(arrs, rows, bucket),
                                        bucket)
                # inside the try: an asynchronous device error surfaces
                # here and is retried like a raised one
                model.synchronize()
                break
            except Exception as exc:   # the worker serves every client
                delay = next(delays, None)
                if delay is None:
                    # retries spent: every future fails, the breaker
                    # counts one failed batch
                    self._breaker.record_failure()
                    self._metrics.set_breaker_state(self._breaker.state)
                    err = exc if isinstance(exc, MXNetError) else \
                        MXNetError(f"serving: model '{model.name}' batch "
                                   f"execution failed: {exc!r}")
                    for req in live:
                        self._fail(req, err)
                    if mon is not None:
                        mon.toc()   # closes the batch; nothing to log
                    return
                attempt += 1
                self._metrics.record_retry(attempt)
                _faults.note("retry", site="serving.execute",
                             model=model.name, attempt=attempt)
                time.sleep(delay)
        if mon is not None:
            mon.toc_print()
        self._breaker.record_success()
        self._metrics.set_breaker_state(self._breaker.state)
        done = time.monotonic()
        self._metrics.record_batch(rows, bucket, done - t0)
        if _obs_trace.enabled():
            # ONE span per executed batch, parented into the first
            # coalesced request's trace; the other requests' rids ride in
            # args and their trees stay rooted at their own requests
            dur_us = int((done - t0) * 1e6)
            _obs_trace.record_span(
                "batcher.execute", time.time_ns() // 1000 - dur_us,
                dur_us, parent=next((r.tr for r in live
                                     if r.tr is not None), None),
                cat="serving", model=model.name, bucket=bucket,
                batch_rows=rows, requests=len(live),
                rids=",".join(str(r.rid) for r in live[:8]))
        off = 0
        for req in live:
            lo, hi = off, off + req.rows
            off = hi
            req.future.set_result(
                [NDArray(o[lo:hi], ctx=model.ctx) for o in outs])
            self._metrics.record_response(done - req.t_enqueue)
            self._done(req)
