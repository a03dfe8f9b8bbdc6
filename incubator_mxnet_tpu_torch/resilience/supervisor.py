"""JobSupervisor: the per-host control plane of an elastic multi-process
run.

PyTorch port of `incubator_mxnet_tpu/resilience/supervisor.py`.  One
lost worker stalls every survivor inside a synchronous exchange (a
parameter-server round, or an all-reduce of the collective plane)
forever; the supervisor turns that hang into a detected event with a
deterministic recovery:

* **heartbeat/membership**: a background thread heartbeats the
  coordinator (the root parameter server, `dist/membership.py`) over its
  own sequence-numbered channel every ``heartbeat_s``; each reply carries
  the pod view (alive and dead hosts, per-host step counters and
  step-time EWMAs, the membership epoch).  A host that missed a shrink
  gets a stale-epoch rejection and is fenced: it must exit, not rejoin.
* **hung-collective watchdog**: `collective(name, fn)` runs a blocking
  cross-host exchange (kvstore push, pull, barrier, an all-reduce) on a
  worker thread under a deadline; on expiry it raises a structured
  `CollectiveTimeoutError` naming the collective, the axis and the hosts
  that failed to arrive (dead or lagging, from the membership view).
* **straggler detection**: `record_step` keeps this host's step-time
  EWMA (shipped with the heartbeats); each view is scanned for hosts
  whose EWMA diverges more than ``straggler_k`` sigma from the pod
  median.
* **shrink-and-resume**: `shrink()` drives the coordinator's
  epoch-fenced barrier with a deadline; the survivors agree on the new
  world size and get dense new ranks, and `Module.fit(checkpoint_dir=)`
  restarts from the last committed checkpoint at that size.

Findings (stragglers, host losses) stay in `findings()`: the JAX
package's `analysis.runtime_report()` is not ported yet.  Plain
`threading` locks stand in for the JAX package's instrumented ones.

Fault sites (`MXNET_FAULTS`): ``heartbeat.send`` (a ``drop`` skips the
beat), ``collective.dispatch`` (a ``hang`` sleeps inside the dispatched
collective: the lost-host stall, deterministically) and ``host.step``
in `Module.fit` (a ``kill`` is a whole-host SIGKILL).
"""
from __future__ import annotations

import os
import queue
import threading
import time

from ..base import MXNetError
from . import faults as _faults

__all__ = ["JobSupervisor", "CollectiveTimeoutError", "HostLostError",
           "StaleEpochError", "ShrinkResult", "Finding", "current",
           "activate", "deactivate", "supervised", "findings",
           "reset_findings"]


class CollectiveTimeoutError(MXNetError):
    """A cross-host collective did not complete within the watchdog
    deadline: `collective` (name), `axis`, `timeout_s`, `absent` (ranks
    that failed to arrive, from membership data), `epoch`.
    `Module.fit` with a ``checkpoint_dir`` turns it into
    shrink-and-resume."""

    def __init__(self, collective, axis=None, timeout_s=0.0, absent=(),
                 detail="", epoch=0):
        self.collective = str(collective)
        self.axis = axis
        self.timeout_s = float(timeout_s)
        self.absent = sorted(int(r) for r in absent)
        self.epoch = int(epoch)
        where = f" over axis {axis!r}" if axis else ""
        if self.absent:
            who = (f"; host(s) {self.absent} failed to arrive"
                   + (f" ({detail})" if detail else ""))
        else:
            who = (f"; {detail}" if detail else
                   "; every member still heartbeats — the collective "
                   "itself is wedged or the deadline is too tight")
        super().__init__(
            f"collective {self.collective!r}{where} timed out after "
            f"{self.timeout_s:g}s at membership epoch {self.epoch}{who} — "
            "shrink the pod and resume from the last checkpoint "
            "(Module.fit(checkpoint_dir=...) does this automatically)")


class HostLostError(MXNetError):
    """Membership confirmed one or more hosts dead: `ranks`, `epoch`."""

    def __init__(self, ranks, epoch=0, detail=""):
        self.ranks = sorted(int(r) for r in ranks)
        self.epoch = int(epoch)
        super().__init__(
            f"host(s) {self.ranks} lost at membership epoch {self.epoch}"
            + (f": {detail}" if detail else "")
            + " — survivors must shrink and resume from the last "
              "checkpoint")


class StaleEpochError(MXNetError):
    """This host carries a stale membership epoch (it missed a shrink and
    is fenced out).  It must exit, not retry."""


class ShrinkResult:
    """One committed shrink, from this host's point of view.  ``seconds``
    is the time this host waited at the barrier and ``ended`` the wall
    clock when the commit came back (the port records both)."""

    __slots__ = ("epoch", "world_size", "rank", "survivors", "rank_map",
                 "seconds", "ended")

    def __init__(self, epoch, world_size, rank, survivors, rank_map,
                 seconds=0.0, ended=None):
        self.epoch = int(epoch)
        self.world_size = int(world_size)
        self.rank = int(rank)              # this host's new rank
        self.survivors = list(survivors)   # old ranks, sorted
        self.rank_map = dict(rank_map)     # old rank -> new rank
        self.seconds = float(seconds)
        self.ended = ended

    def __repr__(self):
        return (f"ShrinkResult(epoch={self.epoch}, "
                f"world_size={self.world_size}, rank={self.rank}, "
                f"survivors={self.survivors})")


class Finding:
    """One supervisor diagnostic, with the JAX `analysis.findings.Finding`
    fields (``pass_name``, ``code``, ``severity``, ``message``, ``node``,
    ``count``) and ``time``, the wall clock when it was first seen."""

    __slots__ = ("pass_name", "code", "severity", "message", "node",
                 "location", "count", "time")

    def __init__(self, pass_name, code, severity, message, node=None):
        self.pass_name = pass_name
        self.code = code
        self.severity = severity
        self.message = message
        self.node = node
        self.location = None
        self.count = 1
        self.time = time.time()

    def as_dict(self):
        return {"pass": self.pass_name, "code": self.code,
                "severity": self.severity, "message": self.message,
                "node": self.node, "location": self.location,
                "count": self.count, "time": self.time}

    def __repr__(self):
        return f"<Finding {self.severity} [{self.code}] {self.message}>"


# -- the active supervisor (one per process) ----------------------------------
_current = [None]
_lock = threading.Lock()
_findings = []          # straggler and host-loss findings


def current():
    """The process's active JobSupervisor, or None."""
    return _current[0]


def activate(sup):
    """Install `sup` as the process's active supervisor: the collective
    call sites (`dist.kvstore_dist`) route through its watchdog."""
    _current[0] = sup


def deactivate(sup=None):
    """Remove the active supervisor (only `sup` when given, so a stale
    deactivate cannot evict a newer one)."""
    if sup is None or _current[0] is sup:
        _current[0] = None


def supervised(name, fn, axis=None, timeout=None):
    """Run a blocking cross-host collective under the active supervisor's
    watchdog; a plain call when none is active."""
    sup = current()
    if sup is None:
        return fn()
    return sup.collective(name, fn, axis=axis, timeout=timeout)


def findings():
    """The supervisor's findings (stragglers, host losses)."""
    with _lock:
        return list(_findings)


def reset_findings():
    with _lock:
        _findings.clear()


def _add_finding(code, message, key):
    """Deduplicate by (code, key): a repeat bumps the count."""
    with _lock:
        for f in _findings:
            if f.code == code and f.node == key:
                f.count += 1
                return
        _findings.append(Finding("supervisor." + code.split("-")[0], code,
                                 "warn", message, node=key))


def _profile(event, **args):
    try:
        from .. import profiler as _profiler
        _profiler.record_supervisor(event, **args)
    except Exception:
        pass


class _Dispatcher:
    """One long-lived worker thread running watchdogged collectives in
    submission order (a step dispatches several; a thread a call would
    put thread creation on the hot path).  When a call times out the
    thread is wedged inside it: the supervisor abandons this dispatcher,
    thread and all, and builds a fresh one for the next collective."""

    def __init__(self, name):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["value"] = fn()
            except BaseException as exc:   # noqa: BLE001 - relayed
                box["error"] = exc
            finally:
                done.set()

    def submit(self, fn):
        box = {"value": None, "error": None}
        done = threading.Event()
        self._q.put((fn, box, done))
        return box, done

    def close(self):
        self._q.put(None)


class JobSupervisor:
    """Per-host supervisor: heartbeats, watchdog, stragglers, shrink."""

    def __init__(self, rank, num_workers, host=None, port=None, epoch=None,
                 heartbeat_s=None, deadline_s=None, collective_timeout_s=None,
                 straggler_k=None, shrink_barrier_s=None,
                 clock=time.monotonic):
        from .. import config as _config

        def knob(value, name):
            return float(value if value is not None else _config.get(name))
        self.rank = int(rank)
        self.num_workers = int(num_workers)
        self.host = host or os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        self.port = int(port if port is not None
                        else os.environ.get("DMLC_PS_ROOT_PORT", 9091))
        self.epoch = int(epoch if epoch is not None
                         else _config.get("MXNET_SUPERVISOR_EPOCH"))
        self.heartbeat_s = knob(heartbeat_s, "MXNET_SUPERVISOR_HEARTBEAT_S")
        self.deadline_s = knob(deadline_s, "MXNET_SUPERVISOR_DEADLINE_S")
        self.collective_timeout_s = knob(
            collective_timeout_s, "MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S")
        self.straggler_k = knob(straggler_k, "MXNET_SUPERVISOR_STRAGGLER_K")
        self.shrink_barrier_s = knob(shrink_barrier_s,
                                     "MXNET_SUPERVISOR_SHRINK_BARRIER_S")
        self._clock = clock
        self._chan = None
        self._thread = None
        self._dispatcher = None
        self._stop = threading.Event()
        self._view_lock = threading.Lock()
        self._view = None
        self._fenced = False
        self._kvstore = None
        self._step = 0
        self._ewma = None
        self._dead_seen = {}      # rank -> clock time first seen dead
        self._stragglers = set()  # ranks already flagged
        # counters shared by the heartbeat thread and the fit thread:
        # every update holds _view_lock
        self._stats = {"heartbeats": 0, "heartbeats_dropped": 0,
                       "heartbeats_failed": 0, "collectives": 0,
                       "collective_timeouts": 0, "stragglers_flagged": 0,
                       "hosts_lost": 0}
        # the telemetry plane: these counters under 'supervisor'
        from ..obs import metrics as _obs_metrics
        _obs_metrics.register_producer("supervisor", self.stats)

    def _count(self, name):
        with self._view_lock:
            self._stats[name] += 1

    @classmethod
    def for_kvstore(cls, kv, **kw):
        """A supervisor with a dist kvstore's identity (rank, world size,
        root server) whose `stats()` carries the store's counters."""
        chan = getattr(kv, "_chan", None)
        sup = cls(rank=kv.rank, num_workers=kv.num_workers,
                  host=getattr(chan, "host", None),
                  port=getattr(chan, "port", None), **kw)
        sup.attach_kvstore(kv)
        return sup

    def attach_kvstore(self, kv):
        self._kvstore = kv

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Open the heartbeat channel (its own: a request blocked in a
        hung collective must not silence the heartbeats too), beat once so
        membership knows this host before the first interval, and start
        the beat loop."""
        from ..dist.transport import Channel
        self._chan = Channel(self.host, self.port,
                             timeout=max(self.deadline_s, 1.0))
        self._beat()
        self._thread = threading.Thread(target=self._beat_loop, daemon=True,
                                        name=f"mx-supervisor-hb-{self.rank}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._dispatcher is not None:
            self._dispatcher.close()
            self._dispatcher = None
        if self._thread is not None:
            self._thread.join(max(self.deadline_s, 1.0) + 1.0)
            self._thread = None
        if self._chan is not None:
            try:
                self._chan.close()
            except Exception:
                pass
            self._chan = None

    def _beat_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            if self._fenced:
                return
            self._beat()

    def _beat(self):
        try:
            _faults.fire("heartbeat.send", rank=self.rank)
        except Exception:
            # an injected (or really lossy) dropped heartbeat: skip it;
            # the deadline tolerates deadline_s / heartbeat_s losses
            self._count("heartbeats_dropped")
            return
        msg = {"cmd": "hb", "rank": self.rank, "epoch": self.epoch,
               "step": self._step, "step_time": self._ewma}
        try:
            reply = self._chan.request(msg)
        except Exception:
            self._count("heartbeats_failed")
            return
        self._count("heartbeats")
        err = reply.get("error") if isinstance(reply, dict) else None
        if err is not None:
            if "stale epoch" in err:
                with self._view_lock:
                    self._fenced = True
                _faults.note("fenced", site="supervisor", rank=self.rank,
                             epoch=self.epoch)
            return
        view = reply.get("view")
        if view is not None:
            self._on_view(view)

    # -- membership view ------------------------------------------------------
    def _on_view(self, view):
        now = self._clock()
        with self._view_lock:
            self._view = view
        for r in view.get("dead", ()):
            if r == self.rank or r in self._dead_seen:
                continue
            self._dead_seen[r] = now
            self._count("hosts_lost")
            age = view.get("age", {}).get(r)
            _add_finding(
                "host-lost",
                f"host rank {r} stopped heartbeating "
                f"({age if age is not None else '?'}s silent, deadline "
                f"{self.deadline_s:g}s) at membership epoch "
                f"{view.get('epoch', self.epoch)}", f"rank{r}")
            _faults.note("host-dead", site="supervisor", rank=r,
                         observer=self.rank)
            _profile("host-lost", rank=r, observer=self.rank)
        self._check_stragglers(view)

    def _check_stragglers(self, view):
        """Flag hosts whose step-time EWMA diverges > k sigma from the
        pod median, both statistics taken over the OTHER hosts (with the
        candidate included a lone straggler's deviation is bounded at
        n / sqrt(n - 1) sigma, out of reach of k = 3 below ~10 hosts); a
        floor of 5 % of the peers' median keeps a near-uniform pod's
        vanishing sigma from flagging noise."""
        ewma = {int(r): float(v) for r, v in (view.get("ewma") or {}).items()
                if v is not None}
        alive = set(view.get("alive", ()))
        pod = {r: v for r, v in ewma.items() if r in alive}
        if len(pod) < 2:
            return
        for r, v in sorted(pod.items()):
            if r in self._stragglers:
                continue
            peers = sorted(pv for pr, pv in pod.items() if pr != r)
            mid = peers[len(peers) // 2] if len(peers) % 2 else \
                0.5 * (peers[len(peers) // 2 - 1] + peers[len(peers) // 2])
            mean = sum(peers) / len(peers)
            sigma = (sum((p - mean) ** 2 for p in peers)
                     / len(peers)) ** 0.5
            if v - mid > self.straggler_k * max(sigma, 0.05 * mid) and \
                    v > 1.2 * mid:
                self._stragglers.add(r)
                self._count("stragglers_flagged")
                _add_finding(
                    "straggler-host",
                    f"host rank {r} step time {v * 1e3:.1f}ms diverges "
                    f">{self.straggler_k:g} sigma from the pod median "
                    f"{mid * 1e3:.1f}ms — a straggler throttles every "
                    "synchronous step to its pace (check its input "
                    "pipeline, thermal state, or neighbors)", f"rank{r}")
                _profile("straggler", rank=r, ewma_ms=v * 1e3,
                         median_ms=mid * 1e3)

    def view(self):
        """The latest membership view (None before the first reply)."""
        with self._view_lock:
            return dict(self._view) if self._view is not None else None

    def dead_hosts(self):
        v = self.view() or {}
        return [r for r in v.get("dead", ()) if r != self.rank]

    def _absent_hosts(self):
        """Who a timed-out collective waits on: confirmed-dead hosts plus
        alive hosts whose step counter lags this host's."""
        v = self.view() or {}
        absent = {int(r) for r in v.get("dead", ()) if int(r) != self.rank}
        steps = v.get("steps") or {}
        for r, s in steps.items():
            r = int(r)
            if r != self.rank and r not in absent and int(s) < self._step:
                absent.add(r)
        detail = ", ".join(
            f"rank {r}: " + (f"silent {v.get('age', {}).get(r)}s"
                             if r in set(v.get("dead", ()))
                             else f"at step {steps.get(r)} vs {self._step}")
            for r in sorted(absent))
        return sorted(absent), detail

    # -- step accounting ------------------------------------------------------
    def record_step(self, seconds):
        """One training step's wall time: the EWMA the heartbeats ship,
        and the step counter lag detection keys on."""
        self._step += 1
        s = float(seconds)
        self._ewma = s if self._ewma is None else \
            0.8 * self._ewma + 0.2 * s

    # -- hung-collective watchdog --------------------------------------------
    def collective(self, name, fn, axis=None, timeout=None):
        """Run the blocking collective `fn` under the watchdog deadline;
        on expiry raise `CollectiveTimeoutError` naming the collective,
        the axis and the absent hosts.  The abandoned worker thread is a
        daemon left to die with its doomed socket or device wait."""
        if self._fenced:
            raise StaleEpochError(
                f"host rank {self.rank} is fenced out at membership epoch "
                f"{self.epoch} (it missed a shrink); refusing to dispatch "
                f"collective {name!r} — exit and rejoin at the current "
                "epoch")
        deadline = float(timeout if timeout is not None
                         else self.collective_timeout_s)
        self._count("collectives")

        def _run():
            _faults.fire("collective.dispatch", collective=name,
                         rank=self.rank)
            return fn()

        if self._dispatcher is None:
            self._dispatcher = _Dispatcher(
                f"mx-collective-worker-{self.rank}")
        box, done = self._dispatcher.submit(_run)
        if not done.wait(deadline):
            # the worker is wedged inside the hung collective: abandon it
            self._dispatcher = None
            self._count("collective_timeouts")
            absent, detail = self._absent_hosts()
            _faults.note("collective-timeout", site="supervisor",
                         collective=name, rank=self.rank,
                         timeout_s=deadline)
            _profile("collective-timeout", collective=name,
                     timeout_s=deadline)
            raise CollectiveTimeoutError(
                name, axis=axis, timeout_s=deadline, absent=absent,
                detail=detail, epoch=self.epoch)
        if box["error"] is not None:
            raise box["error"]
        return box["value"]

    # -- shrink-and-resume ----------------------------------------------------
    def shrink(self, reason=""):
        """Drive the epoch-fenced shrink barrier on the coordinator: block
        until every still-alive host proposed (or the barrier's deadline),
        then return this host's `ShrinkResult`.  A fresh channel: the
        control channel may be wedged in the very hang being recovered
        from."""
        from ..dist.transport import Channel
        # the coordinator waits up to max(barrier_s, watchdog + 2 heartbeat
        # deadlines) for peers whose watchdogs fire later than ours
        chan = Channel(self.host, self.port,
                       timeout=max(self.shrink_barrier_s,
                                   self.collective_timeout_s
                                   + 2 * self.deadline_s) + 30.0)
        t0 = time.perf_counter()
        try:
            reply = chan.request({"cmd": "shrink", "rank": self.rank,
                                  "epoch": self.epoch,
                                  "reason": str(reason)[:500]})
        finally:
            try:
                chan.close()
            except Exception:
                pass
        seconds = time.perf_counter() - t0
        if "error" in reply:
            if "stale epoch" in reply["error"]:
                with self._view_lock:
                    self._fenced = True
                raise StaleEpochError(reply["error"])
            raise MXNetError(f"shrink failed: {reply['error']}")
        rank_map = {int(k): int(v) for k, v in reply["rank_map"].items()}
        if self.rank not in rank_map:
            raise StaleEpochError(
                f"host rank {self.rank} missed the shrink barrier for "
                f"epoch {reply['epoch']} (survivors: {reply['survivors']})"
                " — fenced out")
        result = ShrinkResult(reply["epoch"], reply["world_size"],
                              rank_map[self.rank], reply["survivors"],
                              rank_map, seconds=seconds, ended=time.time())
        _faults.note("shrink", site="supervisor", old_rank=self.rank,
                     new_rank=result.rank, world_size=result.world_size,
                     epoch=result.epoch)
        return result

    # -- observability --------------------------------------------------------
    def stats(self):
        """Everything the supervisor counted, with the attached dist
        kvstore's retry and breaker counters under ``kvstore``."""
        v = self.view() or {}
        out = {
            "rank": self.rank,
            "epoch": self.epoch,
            "world_size": self.num_workers,
            "fenced": self._fenced,
            "step": self._step,
            "step_time_ewma_s": self._ewma,
            "alive": list(v.get("alive", ())),
            "dead": list(v.get("dead", ())),
        }
        with self._view_lock:
            out.update(self._stats)
        kv = self._kvstore
        if kv is not None and hasattr(kv, "stats"):
            try:
                out["kvstore"] = kv.stats()
            except Exception:
                pass
        return out
