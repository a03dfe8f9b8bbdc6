"""ReplicaRouter: health-checked request routing over N model replicas.

PyTorch port of `incubator_mxnet_tpu/serving/router.py`, the
availability layer of the serving plane: one replica dying, or one bad
weight reload, costs capacity, not the model.

* **least-loaded, health- and breaker-aware dispatch** — each request
  goes to the live replica with the least outstanding work; a replica
  whose requests keep failing trips its `CircuitBreaker`
  (``MXNET_SERVING_BREAKER_*``) and is skipped while it cools off.
* **liveness** — a health thread heartbeats every replica each
  ``health_interval_s``, every k-th beat a *deepcheck* (a real bucket-1
  inference).  A failed probe makes a replica *suspect* (dispreferred,
  never evicted: a correlated probe-drop burst only reorders
  preference); only probe silence older than ``health_deadline_s`` makes
  it *dead*, and a served request counts as proof of life.
* **failover, idempotent by request id** — a request is re-dispatched
  to a survivor ONLY on `ReplicaLostError` (replica death), never on a
  caller error; the first result wins the future, late duplicates are
  counted and dropped, and worker processes deduplicate by rid.
* **hot weight swap, replica by replica** — `swap_weights()` takes each
  replica out of rotation, drains it, swaps in place (same shapes, same
  programs), deepchecks it and puts it back, while the rest serve: no
  request is dropped, and each is served wholly at one version.  A
  failed swap aborts the roll with the fleet serving.
* **priority classes** — ``interactive``, ``batch``, ``best_effort``.
  Under overload (the fleet's estimated wait past a class's shed
  threshold, ``MXNET_ROUTER_SHED_*_MS``) the low classes shed first.

Fault sites (`resilience.faults`): ``router.dispatch`` (per dispatch),
``replica.health`` (per probe), ``replica.swap`` (per replica swap).
Telemetry, as in the JAX package: each request is a ``router.request``
span (the trace root its dispatches and the replica's execution parent
into, in this process or a worker's; it also records the replica that
answered and the dispatch count, which the JAX span leaves out), and
`stats()` is the ``router`` producer (``router.<name>`` for another
name).  Declared divergence:
plain `threading` locks stand in for `analysis.locks` and
`analysis.tsan`.
"""
from __future__ import annotations

import threading
import time
import uuid

from concurrent.futures import Future

from ..base import MXNetError
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..resilience import CircuitBreaker, faults as _faults
from .metrics import ServingMetrics
from .replica import ReplicaLostError

__all__ = ["ReplicaRouter", "SwapInProgressError", "PRIORITIES",
           "PRIORITY_RANK"]

PRIORITIES = ("interactive", "batch", "best_effort")
# dispatch rank inside replica queues: interactive is served first even
# when lower classes were admitted ahead of it
PRIORITY_RANK = {"interactive": 0, "batch": 1, "best_effort": 2}

HEALTHY, SUSPECT, SWAPPING, DEAD = "healthy", "suspect", "swapping", "dead"


def serving_breaker():
    """A replica's (or a fleet host's) breaker at the serving knobs."""
    from .. import config as _config
    return CircuitBreaker(
        failure_threshold=int(_config.get("MXNET_SERVING_BREAKER_THRESHOLD")),
        reset_timeout=float(_config.get("MXNET_SERVING_BREAKER_RESET_S")))


class SwapInProgressError(MXNetError):
    """A weight swap is already rolling through this fleet; ``version``
    is the label the in-flight swap was issued under."""

    def __init__(self, router, version):
        self.router = router
        self.version = version
        super().__init__(
            f"router '{router}': a weight swap is already in progress "
            f"(in-flight: {version!r})")


class _Slot:
    """Router-side bookkeeping for one replica."""

    def __init__(self, replica, breaker, now):
        self.replica = replica
        self.state = HEALTHY
        self.breaker = breaker
        self.last_ok = now
        self.probe_failures = 0    # consecutive
        self.probes = 0
        self.deepchecks = 0
        self.dispatching = 0       # submits claimed, not yet handed over
                                   # (the swap fence)


class _RouterRequest:
    __slots__ = ("rid", "inputs", "timeout_ms", "priority", "future",
                 "dispatches", "replica_id", "t0", "lock", "done", "span")

    def __init__(self, rid, inputs, timeout_ms, priority, now):
        self.rid = rid
        self.inputs = inputs
        self.timeout_ms = timeout_ms
        self.priority = priority
        self.future = Future()
        self.future.request_id = rid
        self.dispatches = 0
        self.replica_id = None
        self.t0 = now
        self.lock = threading.Lock()
        self.done = False
        # the request's trace root: dispatch attempts and the replica's
        # execution parent into it (ends at _resolve)
        self.span = _obs_trace.start_span("router.request", cat="serving",
                                          rid=rid, priority=priority)


class ReplicaRouter:
    """Front-end router over `Replica` handles (see module docstring)."""

    def __init__(self, replicas=(), name="router", health_interval_s=None,
                 health_deadline_s=None, deepcheck_every=None,
                 max_dispatches=None, shed_ms=None, clock=time.monotonic):
        from .. import config as _config

        def knob(value, key):
            return value if value is not None else _config.get(key)

        self.name = str(name)
        self._clock = clock
        self.health_interval_s = float(
            knob(health_interval_s, "MXNET_ROUTER_HEALTH_INTERVAL_S"))
        self.health_deadline_s = float(
            knob(health_deadline_s, "MXNET_ROUTER_HEALTH_DEADLINE_S"))
        self.deepcheck_every = int(
            knob(deepcheck_every, "MXNET_ROUTER_DEEPCHECK_EVERY"))
        self.max_dispatches = int(
            knob(max_dispatches, "MXNET_ROUTER_MAX_DISPATCHES"))
        self.shed_ms = dict(shed_ms) if shed_ms is not None else {
            "best_effort": float(
                _config.get("MXNET_ROUTER_SHED_BEST_EFFORT_MS")),
            "batch": float(_config.get("MXNET_ROUTER_SHED_BATCH_MS")),
            "interactive": float(
                _config.get("MXNET_ROUTER_SHED_INTERACTIVE_MS"))}
        self.metrics = ServingMetrics(self.name)
        _obs_metrics.register_producer(
            "router" if self.name == "router" else f"router.{self.name}",
            self.stats)
        self._lock = threading.Lock()
        self._slots = {}               # replica_id -> _Slot
        self._inflight = {}            # rid -> _RouterRequest
        # resolved rids, insertion-ordered so the bounded trim drops the
        # oldest first (the idempotency window keeps recent ids)
        self._completed = {}
        self._completed_cap = 65536
        self._rid_counter = 0
        # generated ids in their own namespace: never a caller's id
        self._rid_ns = uuid.uuid4().hex[:8]
        self._swap_lock = threading.Lock()
        self._swap_inflight = None     # label of the swap holding the lock
        self._closed = threading.Event()
        self.failovers = 0
        self.duplicates_suppressed = 0
        self.replicas_lost = 0
        self.swaps_committed = 0
        for r in replicas:
            self.add_replica(r)
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name=f"mx-router-{self.name}-health")
        self._health_thread.start()

    # -- fleet membership -----------------------------------------------------
    def add_replica(self, replica):
        slot = _Slot(replica, serving_breaker(), self._clock())
        with self._lock:
            if replica.replica_id in self._slots:
                raise MXNetError(
                    f"router '{self.name}': duplicate replica id "
                    f"{replica.replica_id!r}")
            self._slots[replica.replica_id] = slot
        return replica

    def remove_replica(self, replica_id, drain=True):
        with self._lock:
            slot = self._slots.pop(replica_id, None)
        if slot is None:
            raise MXNetError(f"router '{self.name}': no replica "
                             f"{replica_id!r}")
        slot.replica.close(drain=drain)

    def replicas(self):
        with self._lock:
            return sorted(self._slots)

    def replica(self, replica_id):
        """The live `Replica` handle for `replica_id`."""
        with self._lock:
            slot = self._slots.get(replica_id)
            if slot is None or slot.state == DEAD:
                raise MXNetError(f"router '{self.name}': no live replica "
                                 f"{replica_id!r}")
            return slot.replica

    # -- dispatch -------------------------------------------------------------
    def _eligible_locked(self):
        # the breaker's state, not allow(): load estimation must not take
        # a half-open probe token.  Suspect replicas still serve.
        return [s for s in self._slots.values()
                if s.state in (HEALTHY, SUSPECT)
                and s.breaker.state != "open"]

    def _pick(self, exclude=()):
        """Least-loaded live replica (breaker-aware), or None; healthy
        first, suspect as the fallback tier.  Only the chosen slot's
        `allow()` is asked, and the dispatch outcome settles the probe
        token it may take."""
        with self._lock:
            cands = [s for s in self._eligible_locked()
                     if s.replica.replica_id not in exclude]
        cands.sort(key=lambda s: (s.state != HEALTHY,
                                  s.replica.outstanding()))
        for s in cands:
            if s.breaker.allow():
                return s
        return None

    def _fleet_wait_s(self):
        """The wait a new request faces: the best estimate among live
        replicas (the queue it would join); a replica with no estimate
        yet is taken as free; None with no live replica."""
        with self._lock:
            slots = self._eligible_locked()
        waits = [w for s in slots
                 if (w := s.replica.estimated_wait_s()) is not None]
        if not waits or len(waits) < len(slots):
            return 0.0 if slots else None
        return min(waits)

    def estimated_wait_s(self):
        """The queue-model wait a new request faces on this fleet: the
        signal admission sheds on and the fleet autoscaler reads."""
        return self._fleet_wait_s()

    def submit(self, inputs, timeout_ms=None, priority="interactive",
               request_id=None):
        """Route one request; returns a Future of the per-output array
        list.  ``priority`` picks the shed class; ``request_id`` is the
        idempotency key (an id already accepted is refused)."""
        if self._closed.is_set():
            raise MXNetError(f"router '{self.name}' is shut down")
        if priority not in PRIORITIES:
            raise MXNetError(
                f"router '{self.name}': unknown priority {priority!r} "
                f"(one of {', '.join(PRIORITIES)})")
        wait = self._fleet_wait_s()
        if wait is not None and wait * 1e3 > self.shed_ms[priority]:
            self.metrics.record_shed(priority)
            raise MXNetError(
                f"router '{self.name}': overloaded — estimated fleet "
                f"wait {wait * 1e3:.0f} ms exceeds the {priority} "
                f"class's {self.shed_ms[priority]:g} ms shed threshold")
        with self._lock:
            self._rid_counter += 1
            rid = request_id if request_id is not None \
                else f"{self.name}/{self._rid_ns}-{self._rid_counter}"
            if rid in self._completed or rid in self._inflight:
                raise MXNetError(
                    f"router '{self.name}': request id {rid!r} was "
                    "already accepted (idempotency: it will not execute "
                    "twice)")
            req = _RouterRequest(rid, inputs, timeout_ms, priority,
                                 self._clock())
            self._inflight[rid] = req
            inflight = len(self._inflight)
        self.metrics.record_request(inflight)
        try:
            self._dispatch(req)
        except BaseException:
            # any failure releases the rid, or a retry of the same
            # request_id is refused forever
            with self._lock:
                self._inflight.pop(rid, None)
            req.span.end(outcome="rejected")
            raise
        return req.future

    def predict(self, inputs, timeout_ms=None, priority="interactive",
                request_id=None):
        wait = None if timeout_ms is None else timeout_ms / 1e3 + 60
        return self.submit(inputs, timeout_ms=timeout_ms, priority=priority,
                           request_id=request_id).result(wait)

    def _dispatch(self, req, exclude=()):
        while True:
            slot = self._pick(exclude=exclude)
            if slot is None:
                with self._lock:
                    states = {s.replica.replica_id: s.state
                              for s in self._slots.values()}
                raise MXNetError(
                    f"router '{self.name}': no live replica to dispatch "
                    f"to (fleet: {states or 'empty'})")
            with self._lock:
                if slot.state not in (HEALTHY, SUSPECT):
                    # flipped (swap, eviction) between pick and claim
                    slot.breaker.release_probe()
                    continue
                # the swap fence: a swap waits for dispatching == 0 after
                # going SWAPPING, so nothing claimed here runs mid-swap
                slot.dispatching += 1
            break
        req.dispatches += 1
        req.replica_id = slot.replica.replica_id
        try:
            _faults.fire("router.dispatch", replica=req.replica_id,
                         rid=req.rid, attempt=req.dispatches)
            try:
                # the replica's submit path (batcher enqueue, transport
                # frame) parents into this request's span
                with _obs_trace.activate(req.span):
                    inner = slot.replica.submit(
                        req.inputs, timeout_ms=req.timeout_ms, rid=req.rid,
                        priority=PRIORITY_RANK[req.priority])
            except ReplicaLostError:
                self._on_replica_lost(slot)
                return self._failover(req, exclude + (req.replica_id,))
            except MXNetError:
                # a caller or backpressure error from a live replica would
                # fail anywhere: surface it, and hand back the probe token
                slot.breaker.release_probe()
                self.metrics.record_class_reject(req.priority)
                raise
        finally:
            with self._lock:
                slot.dispatching -= 1
        inner.add_done_callback(
            lambda fut, req=req, slot=slot: self._on_done(req, slot, fut))

    def _failover(self, req, exclude):
        if req.dispatches >= self.max_dispatches:
            self._resolve(req, error=MXNetError(
                f"router '{self.name}': request {req.rid} failed on "
                f"{req.dispatches} replica(s) "
                f"({', '.join(exclude)}) — dispatch budget exhausted"))
            return
        with self._lock:
            self.failovers += 1
        _faults.note("failover", site="router.dispatch", rid=req.rid,
                     attempt=req.dispatches + 1)
        try:
            self._dispatch(req, exclude=exclude)
        except MXNetError as exc:
            self._resolve(req, error=exc)

    def _on_done(self, req, slot, inner):
        """Completion callback of one dispatch attempt."""
        try:
            result = inner.result()
            err = None
        except Exception as exc:   # classified below
            result, err = None, exc
        if err is None:
            slot.breaker.record_success()
            with self._lock:
                slot.last_ok = self._clock()   # proof of life
            self._resolve(req, result=result)
            return
        if isinstance(err, ReplicaLostError):
            # the dead replica cannot be executing it any more, and the
            # completed-rid check keeps an answered request from rerunning
            self._on_replica_lost(slot)
            with req.lock:
                already = req.done
            if not already:
                self._failover(req, (req.replica_id or "",))
            return
        slot.breaker.record_failure()
        self._resolve(req, error=err)

    def _resolve(self, req, result=None, error=None):
        """Complete the router future exactly once; late duplicates are
        counted and dropped."""
        with req.lock:
            if req.done:
                with self._lock:
                    self.duplicates_suppressed += 1
                return
            req.done = True
        with self._lock:
            self._inflight.pop(req.rid, None)
            self._completed[req.rid] = True
            while len(self._completed) > self._completed_cap:
                self._completed.pop(next(iter(self._completed)))
        req.span.end(outcome="error" if error is not None else "ok",
                     replica=req.replica_id, dispatches=req.dispatches)
        try:
            if error is not None:
                req.future.set_exception(error)
            else:
                req.future.set_result(result)
                self.metrics.record_response(
                    self._clock() - req.t0, cls=req.priority)
        except Exception:
            pass   # the caller cancelled it meanwhile

    # -- health ---------------------------------------------------------------
    def declare_lost(self, replica_id):
        """Declare one replica dead from outside (the fleet's host-loss
        path): its in-flight requests fail over at once; an unknown id
        is ignored."""
        with self._lock:
            slot = self._slots.get(replica_id)
        if slot is not None:
            self._on_replica_lost(slot)

    def _on_replica_lost(self, slot):
        with self._lock:
            if slot.state == DEAD:
                return
            slot.state = DEAD
            self.replicas_lost += 1
        _faults.note("replica_lost", site="replica.health",
                     replica=slot.replica.replica_id)
        # fail what it still holds so the failover callbacks fire now,
        # not at the transport's timeout
        mark = getattr(slot.replica, "_mark_lost", None)
        if mark is not None:
            mark("router declared the replica dead")

    def _health_loop(self):
        # bookkeeping under the router lock; the probe itself outside it,
        # so a slow replica never blocks dispatch
        while not self._closed.wait(self.health_interval_s):
            with self._lock:
                slots = list(self._slots.values())
            for slot in slots:
                with self._lock:
                    if slot.state in (DEAD, SWAPPING):
                        continue
                    slot.probes += 1
                    deep = self.deepcheck_every > 0 and \
                        slot.probes % self.deepcheck_every == 0
                    if deep:
                        slot.deepchecks += 1
                try:
                    _faults.fire("replica.health",
                                 replica=slot.replica.replica_id,
                                 deep=deep)
                    if deep:
                        slot.replica.probe()
                    else:
                        slot.replica.heartbeat()
                    with self._lock:
                        slot.last_ok = self._clock()
                        slot.probe_failures = 0
                        if slot.state == SUSPECT:
                            slot.state = HEALTHY
                except ReplicaLostError:
                    self._on_replica_lost(slot)
                except Exception:
                    # a failed probe alone never evicts: suspect until a
                    # probe lands or silence passes the deadline
                    with self._lock:
                        slot.probe_failures += 1
                        if slot.state == HEALTHY:
                            slot.state = SUSPECT
                with self._lock:
                    overdue = slot.state != DEAD and \
                        self._clock() - slot.last_ok > \
                        self.health_deadline_s
                if overdue:
                    self._on_replica_lost(slot)

    # -- hot weight swap ------------------------------------------------------
    def _acquire_swap(self, version):
        if not self._swap_lock.acquire(blocking=False):
            with self._lock:
                inflight = self._swap_inflight
            raise SwapInProgressError(self.name, inflight)
        with self._lock:
            self._swap_inflight = version

    def _release_swap(self):
        with self._lock:
            self._swap_inflight = None
        self._swap_lock.release()

    def _swap_slot(self, slot, arg_params, aux_params, checkpoint_dir,
                   drain_timeout_s):
        """Drain, swap and deepcheck ONE slot (the caller holds the swap
        lock).  Returns None, or the failure with the slot's state
        restored (or the slot declared lost)."""
        replica = slot.replica
        with self._lock:
            if slot.state == DEAD:
                return ReplicaLostError(replica.replica_id, None,
                                        "replica died before its swap")
            slot.state = SWAPPING
        try:
            deadline = self._clock() + float(drain_timeout_s)
            # drain the replica's queue AND the dispatches claimed before
            # the state flipped: nothing runs while parameters change
            while (replica.outstanding() or slot.dispatching) \
                    and self._clock() < deadline:
                time.sleep(0.002)
            if replica.outstanding() or slot.dispatching:
                raise MXNetError(
                    f"replica '{replica.replica_id}' did not "
                    f"drain within {drain_timeout_s:g}s")
            _faults.fire("replica.swap", replica=replica.replica_id,
                         version=replica.version + 1)
            replica.swap(arg_params=arg_params, aux_params=aux_params,
                         checkpoint_dir=checkpoint_dir)
            # deepcheck before rejoining, on the swap's budget: a worker
            # that shares its card with the rest of the fleet is slow
            # there, not dead
            replica.probe(timeout_s=float(drain_timeout_s))
        except ReplicaLostError as exc:
            self._on_replica_lost(slot)
            return exc
        except Exception as exc:
            with self._lock:
                if slot.state == SWAPPING:
                    slot.state = HEALTHY
            return exc
        with self._lock:
            if slot.state == SWAPPING:
                slot.state = HEALTHY
            slot.last_ok = self._clock()
        return None

    def swap_weights(self, checkpoint_dir=None, arg_params=None,
                     aux_params=None, drain_timeout_s=60.0, version=None):
        """Roll new weights through the fleet, one replica at a time:
        out of rotation, drain, swap, deepcheck, back in rotation.  The
        rest serve throughout, so nothing is dropped and each request is
        served at one version.  On a failure the roll ABORTS with an
        error naming the swapped and untouched replicas; the fleet keeps
        serving.  ``version`` labels the roll (a concurrent swap fails
        with `SwapInProgressError` naming it).  ``drain_timeout_s``
        bounds each replica's drain, and the deepcheck after its swap."""
        self._acquire_swap(version if version is not None
                           else (checkpoint_dir or "<params>"))
        try:
            with self._lock:
                order = [s for s in self._slots.values() if s.state != DEAD]
            swapped, failed = [], None
            for slot in order:
                exc = self._swap_slot(slot, arg_params, aux_params,
                                      checkpoint_dir, drain_timeout_s)
                if exc is not None:
                    failed = (slot.replica.replica_id, exc)
                    break
                swapped.append(slot.replica.replica_id)
            if failed is not None:
                rid, exc = failed
                remaining = [s.replica.replica_id for s in order
                             if s.replica.replica_id not in swapped
                             and s.replica.replica_id != rid]
                done_s = ", ".join(swapped) or "none"
                left_s = ", ".join(remaining) or "none"
                raise MXNetError(
                    f"router '{self.name}': weight swap ABORTED at "
                    f"replica '{rid}': {exc} — swapped [{done_s}], "
                    f"untouched [{left_s}]; the fleet keeps serving "
                    "(each request single-version); fix the source and "
                    "re-issue swap_weights") from exc
            with self._lock:
                self.swaps_committed += 1
            return {"swapped": swapped,
                    "versions": {s.replica.replica_id: s.replica.version
                                 for s in order}}
        finally:
            self._release_swap()

    def swap_one(self, replica_id=None, checkpoint_dir=None,
                 arg_params=None, aux_params=None, drain_timeout_s=60.0,
                 version=None):
        """Swap exactly one replica (`replica_id`, or the first healthy
        one) with `swap_weights`' discipline and lock: a canary."""
        self._acquire_swap(version if version is not None
                           else (checkpoint_dir or "<params>"))
        try:
            with self._lock:
                if replica_id is not None:
                    slot = self._slots.get(replica_id)
                    if slot is None or slot.state == DEAD:
                        raise MXNetError(
                            f"router '{self.name}': no live replica "
                            f"{replica_id!r} to swap")
                else:
                    slot = next((s for s in self._slots.values()
                                 if s.state == HEALTHY), None)
                    if slot is None:
                        raise MXNetError(
                            f"router '{self.name}': no healthy replica "
                            "to swap")
            exc = self._swap_slot(slot, arg_params, aux_params,
                                  checkpoint_dir, drain_timeout_s)
            if exc is not None:
                raise MXNetError(
                    f"router '{self.name}': swap of replica "
                    f"'{slot.replica.replica_id}' failed: {exc} — the "
                    "rest of the fleet keeps serving the incumbent") \
                    from exc
            return {"swapped": [slot.replica.replica_id],
                    "version": slot.replica.version}
        finally:
            self._release_swap()

    # -- observability / lifecycle -------------------------------------------
    def stats(self):
        """Fleet counters, per-class latency and sheds, and each
        replica's state."""
        with self._lock:
            slots = dict(self._slots)
            snap = {
                "router": self.name,
                "failovers": self.failovers,
                "duplicates_suppressed": self.duplicates_suppressed,
                "replicas_lost": self.replicas_lost,
                "swaps_committed": self.swaps_committed,
                "inflight": len(self._inflight),
            }
        snap.update(self.metrics.snapshot())
        snap["replicas"] = {
            rid: {"state": s.state,
                  "outstanding": (0 if s.state == DEAD
                                  else s.replica.outstanding()),
                  "version": s.replica.version,
                  "breaker": s.breaker.state,
                  "probes": s.probes,
                  "deepchecks": s.deepchecks,
                  "probe_failures": s.probe_failures,
                  "age_s": round(self._clock() - s.last_ok, 3)}
            for rid, s in slots.items()}
        return snap

    def shutdown(self, drain=True):
        self._closed.set()
        self._health_thread.join(10)
        with self._lock:
            slots, self._slots = dict(self._slots), {}
        for slot in slots.values():
            try:
                slot.replica.close(drain=drain)
            except MXNetError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
