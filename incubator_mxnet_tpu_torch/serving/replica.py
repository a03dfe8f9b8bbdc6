"""Replica handles: the units a `ReplicaRouter` spreads requests over.

PyTorch port of `incubator_mxnet_tpu/serving/replica.py`.  A replica is
one independently failing copy of a served model.  Two concrete kinds
share the `Replica` contract:

* `LocalReplica` — an in-process `ServedModel` + `MicroBatcher` pair
  (its own parameter copy, its own failure domain).  Replicas of one
  symbol on the card each run their own batcher thread, so several
  threads launch the model's kernels at once (`fused_ops.fc_relu`
  counts its launches under a lock).
* `RemoteReplica` — a worker process (`serving.worker`) driven over the
  sequence-numbered `dist.transport` frames.  The process boundary
  makes SIGKILL-grade death real.  Requests carry the router's request
  id and the worker deduplicates on it, so a resend after a torn
  connection never executes twice on that worker.

The contract a router relies on:

* ``submit(inputs, timeout_ms, rid, priority)`` returns a Future; the
  future fails with `ReplicaLostError` when the replica dies before
  resolving it (the failover trigger; anything else is a caller error
  that would fail identically on every replica).
* ``heartbeat()`` is a cheap liveness check; ``probe(timeout_s=None)``
  is the deepcheck, a real bucket-1 inference through the prepared
  ladder.  The router passes ``timeout_s`` for the deepcheck that ends
  a weight swap: a remote replica waits that long for it instead of
  its short control timeout.
* ``swap(...)`` replaces the parameter set in place (same shapes, same
  programs: `ServedModel.program_count` is unchanged); ``version``
  counts committed swaps.
* ``outstanding()`` / ``estimated_wait_s()`` drive least-loaded
  dispatch and priority shedding.

Workers start through `subprocess.Popen` (fork + exec, never a bare
fork of a process that has touched CUDA) with the repository root
appended to ``PYTHONPATH``.  They run on the card unless they are
spawned with ``ctx="cpu"`` (``--ctx cpu``).  Their READY line reads
``REPLICA_READY programs=N builds=B load_ms=L warmup_ms=W``: ``builds``
counts the ``nvcc`` runs the worker made (`kernels/_build.build_log`),
the port's counterpart of the JAX worker's XLA compiles.  A worker's results come
back as CPU `NDArray`s.  An ``infer`` frame carries the submitting
thread's trace context (``tr``), and `RemoteReplica.scrape` reads the
worker's ``metrics`` frame, as in the JAX package.  Declared divergence:
plain `threading` locks stand in for `analysis.locks`.
"""
from __future__ import annotations

import collections
import os
import queue as _queue
import subprocess
import sys
import threading
import time

from concurrent.futures import Future

import numpy as _np

from ..base import MXNetError
from ..obs import trace as _obs_trace

__all__ = ["Replica", "LocalReplica", "RemoteReplica", "ReplicaLostError",
           "worker_argv", "launch_worker"]

# the directory holding the package: appended to a child's PYTHONPATH so
# `python -m incubator_mxnet_tpu_torch...` imports from any working dir
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaLostError(MXNetError):
    """The replica died (process killed, batcher torn down, transport
    gone) before this request resolved.  Structured so a router can tell
    "this replica is gone — fail over" from "this request is bad — fail
    it everywhere": `replica_id` names the dead replica, `rid` the
    in-flight request."""

    def __init__(self, replica_id, rid=None, reason=""):
        self.replica_id = str(replica_id)
        self.rid = rid
        super().__init__(
            f"replica '{replica_id}' lost"
            + (f" with request {rid} in flight" if rid else "")
            + (f": {reason}" if reason else "")
            + " — the router fails over to a surviving replica")


class Replica:
    """Shared contract; see the module docstring."""

    replica_id = "?"
    version = 0          # committed weight-swap count

    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        raise NotImplementedError

    def heartbeat(self):
        raise NotImplementedError

    def probe(self, timeout_s=None):
        raise NotImplementedError

    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        raise NotImplementedError

    def outstanding(self):
        raise NotImplementedError

    def estimated_wait_s(self):
        return None

    def stats(self):
        return {}

    def close(self, drain=True):
        pass


def _load_checkpoint_params(checkpoint_dir):
    """(arg_params, aux_params) of the newest VALID elastic checkpoint
    under `checkpoint_dir`, or of that checkpoint directory itself (torn
    checkpoints are never selected): the swap source of both replica
    kinds and of `ServedModel.from_checkpoint_dir`."""
    from ..checkpoint import load as _load, latest as _latest
    from ..checkpoint.state import split_params
    path = checkpoint_dir
    if not os.path.exists(os.path.join(path, "manifest.json")):
        found = _latest(path)
        if found is None:
            raise MXNetError(
                f"serving: no valid checkpoint under {checkpoint_dir!r} "
                "(torn checkpoints are never selected)")
        path = found
    return split_params(_load(path).arrays)


def _zero_request(model):
    """A bucket-1 request of zeros: the deepcheck's input."""
    return [_np.zeros((1,) + model._sample_shapes[n], model._host_dtype)
            for n in model.data_names]


class LocalReplica(Replica):
    """In-process replica: one `ServedModel` (its own parameter copy)
    behind its own `MicroBatcher`."""

    def __init__(self, model, replica_id=None, max_batch_size=None,
                 max_queue_latency_ms=2.0, max_queue=256, **batcher_knobs):
        from .batcher import MicroBatcher
        from .metrics import ServingMetrics
        self._model = model
        self.replica_id = str(replica_id if replica_id is not None
                              else f"local/{model.name}")
        self.metrics = ServingMetrics(self.replica_id)
        if not model.warmed:
            model.warmup()
        self._batcher = MicroBatcher(
            model, self.metrics, max_batch_size=max_batch_size,
            max_queue_latency_ms=max_queue_latency_ms, max_queue=max_queue,
            **batcher_knobs)
        self._dead = False
        self._last_reply_t = None   # when a response last resolved
        self.probes = 0             # deepchecks run (each one forward)
        # router request ids this replica answered (bounded), as a
        # worker's ``executed_rids``
        self.executed_rids = collections.deque(maxlen=16384)

    # -- request path --------------------------------------------------------
    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        if self._dead:
            raise ReplicaLostError(self.replica_id, rid,
                                   "replica was killed")
        try:
            inner = self._batcher.submit(inputs, timeout_ms=timeout_ms,
                                         priority=priority)
        except MXNetError as exc:
            if self._dead or "draining" in str(exc):
                raise ReplicaLostError(self.replica_id, rid,
                                       str(exc)) from exc
            raise
        # a killed replica fails its queued requests with the batcher's
        # shutdown error: the router must read that as replica loss
        # (fail the request over), not as a bad request
        out = Future()
        out.request_id = rid

        def _chain(f, out=out, rid=rid):
            self._last_reply_t = time.monotonic()
            try:
                res = f.result()
            except MXNetError as exc:
                s = str(exc)
                lost = self._dead and ("shut down" in s or "draining" in s)
                _settle(out, exc=ReplicaLostError(self.replica_id, rid, s)
                        if lost else exc)
                return
            except Exception as exc:
                _settle(out, exc=exc)
                return
            if rid is not None:
                self.executed_rids.append(rid)
            _settle(out, result=res)

        inner.add_done_callback(_chain)
        return out

    # -- health --------------------------------------------------------------
    def heartbeat(self):
        if self._dead or not self._batcher._thread.is_alive():
            raise ReplicaLostError(self.replica_id,
                                   reason="batcher worker is gone")
        return {"outstanding": self.outstanding(), "version": self.version}

    def probe(self, timeout_s=None):
        """Deepcheck: a real inference through the smallest bucket (in
        this process: ``timeout_s`` has nothing to bound)."""
        self.heartbeat()
        model = self._model
        model.infer(_zero_request(model))
        self.probes += 1
        return {"programs": model.program_count(), "version": self.version}

    # -- swap ----------------------------------------------------------------
    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        if checkpoint_dir is not None:
            arg_params, aux_params = _load_checkpoint_params(checkpoint_dir)
        self._model.set_params(arg_params, aux_params)
        self.version += 1
        return self.version

    # -- load ----------------------------------------------------------------
    def outstanding(self):
        return self._batcher._outstanding

    def estimated_wait_s(self):
        """What a new request would wait here: the batcher's queue-model
        estimate, floored by the response-latency EWMA (the queue model
        is blind to host scheduling, which dominates under overload).  On
        an empty replica the floor decays with the age of the last
        response (1 s half-life), or the EWMA, which only moves on
        responses, would hold an old overload forever."""
        est = self._batcher.estimated_wait_s()
        lat = self.metrics.avg_latency_s()
        if lat is not None and self.outstanding() == 0:
            last = self._last_reply_t
            age = 0.0 if last is None else time.monotonic() - last
            lat = lat * 0.5 ** age
        if est is None:
            return lat
        return est if lat is None else max(est, lat)

    def stats(self):
        snap = self.metrics.snapshot()
        snap["version"] = self.version
        snap["probes"] = self.probes
        return snap

    def close(self, drain=True):
        self._dead = True
        self._batcher.close(drain=drain)

    def kill(self):
        """Abrupt death (tests, chaos): queued requests fail with the
        shutdown error, which the router reads as replica loss and fails
        over.  A batch already executing completes."""
        self._dead = True
        try:
            self._batcher.kill()
        except MXNetError:
            pass


def _settle(fut, result=None, exc=None):
    """Resolve `fut` unless its caller cancelled it meanwhile."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass


def worker_argv(*, prefix=None, epoch=0, symbol_file=None,
                checkpoint_dir=None, data_shapes, buckets=(1, 2, 4, 8),
                name="model", host="127.0.0.1", port=0, ctx="gpu"):
    """The `serving.worker` command line for one replica: the one place
    the worker's CLI is spelled, shared by `RemoteReplica.spawn` and the
    fleet's host daemon (`serving.hostd`).  ``ctx`` is ``"gpu"`` (the
    card, the default) or ``"cpu"``."""
    shapes = ";".join("%s=%s" % (n, ",".join(str(d) for d in s))
                      for n, s in data_shapes)
    cmd = [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving.worker",
           "--name", str(name), "--data-shapes", shapes,
           "--buckets", ",".join(str(b) for b in buckets),
           "--host", str(host), "--port", str(int(port)),
           "--ctx", str(ctx)]
    if prefix is not None:
        cmd += ["--prefix", prefix, "--epoch", str(epoch)]
    if symbol_file is not None:
        cmd += ["--symbol-file", symbol_file]
    if checkpoint_dir is not None:
        cmd += ["--checkpoint-dir", checkpoint_dir]
    return cmd


def child_env(env=None):
    """This process's environment plus `env`, with the repository root
    appended to ``PYTHONPATH`` (never replacing what is there)."""
    full = dict(os.environ, **(env or {}))
    paths = [p for p in full.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _ROOT not in paths:
        full["PYTHONPATH"] = os.pathsep.join(paths + [_ROOT])
    return full


def launch_worker(cmd, *, env=None, name="model", ready_timeout=240.0,
                  launch=None, tag=None, port_prefix="REPLICA_PORT",
                  ready_prefix="REPLICA_READY", start_new_session=False,
                  thread_prefix="mx-replica"):
    """Run one worker argv and wait for its readiness handshake.
    Returns ``(proc, port, ready_info)``, ``ready_info`` being the parsed
    ``REPLICA_READY`` line (``programs``, ``builds``, ``load_ms``,
    ``warmup_ms``).  ``launch(cmd,
    env) -> Popen`` replaces the local `subprocess.Popen` (remote exec).
    The line prefixes are parameters so the host daemon's handshake
    (``HOSTD_PORT`` / ``HOSTD_READY``) shares this implementation;
    ``start_new_session`` puts the child in its own process group (the
    daemon and its workers die together under a group SIGKILL).

    ``ready_timeout`` holds even for a child that stays alive but silent
    (wedged on a hung checkpoint read): a deadline timer kills it, which
    unblocks the pipe read."""
    full_env = child_env(env)
    if launch is not None:
        proc = launch(cmd, full_env)
    else:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=full_env,
                                start_new_session=start_new_session)
    port = None
    ready_info = {}
    timed_out = threading.Event()
    tail = []                     # the child's last lines, for the error

    def _deadline_kill():
        timed_out.set()
        proc.kill()

    timer = threading.Timer(float(ready_timeout), _deadline_kill)
    timer.daemon = True
    timer.start()
    try:
        while True:
            line = proc.stdout.readline()
            if not line:
                if timed_out.is_set():
                    break
                raise MXNetError(
                    f"worker '{name}' exited during startup "
                    f"(rc={proc.wait()}): " + "".join(tail[-20:]))
            tail.append(line)
            if line.startswith(port_prefix + " "):
                port = int(line.split()[1])
            elif line.startswith(ready_prefix):
                for tok in line.split()[1:]:
                    k, _, v = tok.partition("=")
                    if v.isdigit():
                        ready_info[k] = int(v)
                break
    finally:
        timer.cancel()
    if port is None or timed_out.is_set():
        proc.kill()
        raise MXNetError(
            f"worker '{name}' did not complete its readiness handshake "
            f"within {ready_timeout:g}s")
    # drain the pipe in the background, or the worker blocks on a full
    # stdout once it logs
    threading.Thread(target=lambda: proc.stdout.read(),
                     daemon=True,
                     name=f"{thread_prefix}-{tag or name}-stdout").start()
    return proc, port, ready_info


class RemoteReplica(Replica):
    """Worker-process replica over the sequence-numbered transport.

    ``concurrency`` dispatch threads each own one `Channel` (channels are
    serial), so up to that many requests are on the wire at once; the
    rest wait in a bounded local priority queue.  The worker coalesces
    nothing (each request is one forward), so the local queue length
    drives the load estimate.  ``timeout`` bounds a dispatch round trip
    (None: ``MXNET_PS_REQUEST_TIMEOUT``); the control channel's is
    short, so one wedged worker cannot pin the router's health loop.
    ``swap_timeout`` bounds a ``swap`` (the worker reads a checkpoint
    and uploads it), as the router's ``timeout_s`` bounds the deepcheck
    after it: a worker busy with a large model is slow there, not
    dead.  The JAX replica holds both to the control timeout."""

    def __init__(self, host, port, replica_id=None, process=None,
                 concurrency=2, max_queue=256, timeout=None,
                 control_timeout=5.0, swap_timeout=120.0):
        self.replica_id = str(replica_id if replica_id is not None
                              else f"remote/{host}:{port}")
        self.host, self.port = host, int(port)
        self.process = process       # Popen when spawn()ed
        self.ready_info = {}
        self.swap_timeout = float(swap_timeout)
        self._q = _queue.PriorityQueue(maxsize=int(max_queue))
        self._seq_counter = 0
        self._lost = threading.Event()
        self._inflight = {}          # rid -> _Pending (on the wire)
        self._lock = threading.Lock()
        self._control_lock = threading.Lock()
        self._ewma_s = None          # recent per-request round trip
        self._last_reply_t = None    # when the EWMA last saw a response
        self._chans = []
        self._threads = []
        self._control = self._make_channel(control_timeout)
        for i in range(int(concurrency)):
            chan = self._make_channel(timeout)
            self._chans.append(chan)
            t = threading.Thread(target=self._dispatch_loop, args=(chan,),
                                 daemon=True,
                                 name=f"mx-replica-{self.replica_id}-{i}")
            t.start()
            self._threads.append(t)

    def _make_channel(self, timeout):
        from ..dist.transport import Channel
        from ..resilience import RetryPolicy
        # a short reconnect budget: a dead worker is diagnosed in about a
        # second so failover starts; the router's re-dispatch is the real
        # retry (the worker's rid dedup keeps a resend from running twice)
        return Channel(self.host, self.port, timeout=timeout,
                       connect_wait=10.0,
                       retry=RetryPolicy(max_attempts=2, base_delay=0.05,
                                         max_delay=0.2))

    @classmethod
    def spawn(cls, *, prefix=None, epoch=0, symbol_file=None,
              checkpoint_dir=None, data_shapes, buckets=(1, 2, 4, 8),
              name="model", replica_id=None, env=None, concurrency=2,
              ready_timeout=240.0, host="127.0.0.1", launch=None,
              ctx="gpu"):
        """Launch a `serving.worker` process and connect to it.  ``host``
        is the address the worker binds and this handle connects to;
        ``launch(cmd, env) -> Popen`` runs the argv elsewhere (an ssh
        wrapper).  Cross-host fleets use `serving.fleet.AgentHost`, which
        has a host daemon spawn the worker there.  ``ctx`` is the
        worker's device, the card by default."""
        cmd = worker_argv(prefix=prefix, epoch=epoch,
                          symbol_file=symbol_file,
                          checkpoint_dir=checkpoint_dir,
                          data_shapes=data_shapes, buckets=buckets,
                          name=name, host=host, ctx=ctx)
        proc, port, ready_info = launch_worker(
            cmd, env=env, name=name, ready_timeout=ready_timeout,
            launch=launch, tag=replica_id or name)
        try:
            self = cls(host, port, replica_id=replica_id, process=proc,
                       concurrency=concurrency)
        except BaseException:
            proc.kill()
            raise
        self.ready_info = ready_info
        return self

    # -- request path --------------------------------------------------------
    class _Pending:
        __slots__ = ("msg", "future", "rid", "t_enqueue")

        def __init__(self, msg, rid):
            self.msg = msg
            self.rid = rid
            self.future = Future()
            self.t_enqueue = time.monotonic()

    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        if self._lost.is_set():
            raise ReplicaLostError(self.replica_id, rid)

        def to_np(v):   # only numpy crosses the transport
            return v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v)

        arrs = {k: to_np(v) for k, v in inputs.items()} \
            if isinstance(inputs, dict) else [to_np(v) for v in inputs]
        msg = {"cmd": "infer", "rid": rid, "inputs": arrs,
               "timeout_ms": timeout_ms}
        tr = _obs_trace.current_frame()
        if tr is not None:
            # captured on the SUBMITTING thread: the dispatch loop that
            # puts this frame on the wire runs where contextvars are
            # blind; the channel's rpc span parents to it instead
            msg["tr"] = tr
        pend = self._Pending(msg, rid)
        with self._lock:
            self._seq_counter += 1
            seq = self._seq_counter
        try:
            # the batcher's dispatch rank: interactive work never waits
            # behind an admitted best-effort burst
            self._q.put_nowait((int(priority), seq, pend))
        except _queue.Full:
            raise MXNetError(
                f"replica '{self.replica_id}' queue is full — "
                "backpressure, retry later") from None
        return pend.future

    def _dispatch_loop(self, chan):
        import torch
        from ..context import cpu
        from ..ndarray.ndarray import NDArray
        while not self._lost.is_set():
            try:
                pend = self._q.get(timeout=0.05)[2]
            except _queue.Empty:
                continue
            if not pend.future.set_running_or_notify_cancel():
                continue
            with self._lock:
                self._inflight[pend.rid] = pend
            try:
                reply = chan.request(pend.msg)
            except Exception as exc:
                # fail THIS request first: a concurrent dispatch thread's
                # _mark_lost may have swept before it was in _inflight,
                # and _mark_lost returns early once the replica is lost
                reason = f"{type(exc).__name__}: {exc}"
                with self._lock:
                    self._inflight.pop(pend.rid, None)
                _settle(pend.future, exc=ReplicaLostError(
                    self.replica_id, pend.rid, reason))
                self._mark_lost(reason)
                return
            with self._lock:
                self._inflight.pop(pend.rid, None)
                rt = time.monotonic() - pend.t_enqueue
                self._ewma_s = rt if self._ewma_s is None \
                    else 0.8 * self._ewma_s + 0.2 * rt
                self._last_reply_t = time.monotonic()
            if "error" in reply:
                _settle(pend.future, exc=MXNetError(reply["error"]))
            else:
                _settle(pend.future, result=[
                    NDArray(torch.from_numpy(_np.array(o)), ctx=cpu())
                    for o in reply["outs"]])

    def _mark_lost(self, reason):
        """Transport-level death: fail everything this replica holds so
        the router's failover callbacks fire at once."""
        with self._lock:
            if self._lost.is_set():
                return
            self._lost.set()
            inflight, self._inflight = dict(self._inflight), {}
        for rid, pend in inflight.items():
            _settle(pend.future,
                    exc=ReplicaLostError(self.replica_id, rid, reason))
        while True:
            try:
                pend = self._q.get_nowait()[2]
            except _queue.Empty:
                break
            _settle(pend.future,
                    exc=ReplicaLostError(self.replica_id, pend.rid, reason))

    # -- health --------------------------------------------------------------
    def _control_request(self, msg, timeout=None):
        if self._lost.is_set():
            raise ReplicaLostError(self.replica_id)
        longer = {} if timeout is None else {"timeout": timeout}
        try:
            # one request at a time: the health thread and stats or swap
            # callers share this serial channel
            with self._control_lock:
                reply = self._control.request(msg, **longer)
        except TimeoutError:
            # slow but connected is suspicion, not death: the router
            # dispreferrs the replica; only continued silence evicts it
            raise
        except Exception as exc:
            raise ReplicaLostError(
                self.replica_id,
                reason=f"{type(exc).__name__}: {exc}") from exc
        if "error" in reply:
            raise MXNetError(reply["error"])
        return reply

    def heartbeat(self):
        return self._control_request({"cmd": "hb"})

    def probe(self, timeout_s=None):
        return self._control_request({"cmd": "probe"}, timeout_s)

    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        if checkpoint_dir is None:
            raise MXNetError(
                f"replica '{self.replica_id}': remote swap needs a "
                "checkpoint_dir the worker can read (raw parameter "
                "tensors are not shipped over the control channel)")
        reply = self._control_request({"cmd": "swap",
                                       "checkpoint_dir": checkpoint_dir},
                                      self.swap_timeout)
        self.version = int(reply["version"])
        return self.version

    # -- load ----------------------------------------------------------------
    def outstanding(self):
        with self._lock:
            return self._q.qsize() + len(self._inflight)

    def estimated_wait_s(self):
        """The round-trip EWMA (measured from enqueue, so it includes the
        queue wait) scaled by the queue ahead; on an empty replica it
        decays with the age of the last response (1 s half-life), as
        `LocalReplica`'s floor does."""
        with self._lock:
            ewma, last = self._ewma_s, self._last_reply_t
        if ewma is None:
            return None
        outstanding = self.outstanding()
        if outstanding == 0:
            age = 0.0 if last is None else time.monotonic() - last
            return ewma * 0.5 ** age
        return ewma * (outstanding + 1) / max(len(self._chans), 1)

    def scrape(self):
        """The worker process's telemetry snapshot ({"values", "prom"})
        over the control channel: the fleet's per-replica scrape leg."""
        reply = self._control_request({"cmd": "metrics"})
        return {"values": dict(reply.get("values") or {}),
                "prom": reply.get("prom", "")}

    def stats(self):
        """The worker's ``stats`` reply (executed rids, ``cache``), or
        ``{"lost": True}``."""
        try:
            return self._control_request({"cmd": "stats"})
        except MXNetError:
            return {"lost": True}

    def close(self, drain=True):
        if not self._lost.is_set() and drain:
            deadline = time.monotonic() + 30
            while self.outstanding() and time.monotonic() < deadline:
                time.sleep(0.01)
        try:
            if not self._lost.is_set():
                with self._control_lock:
                    self._control.bare_request({"cmd": "stop"})
        except Exception:
            pass
        self._mark_lost("replica closed")
        for chan in self._chans + [self._control]:
            try:
                chan.close()
            except Exception:
                pass
        if self.process is not None:
            try:
                self.process.wait(timeout=10)
            except Exception:
                self.process.kill()
                self.process.wait()

    def kill(self):
        """SIGKILL the worker process (chaos): no flush, no unwinding."""
        if self.process is not None:
            self.process.kill()
