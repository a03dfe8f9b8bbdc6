"""Cross-host serving fleet: placement, SLO autoscaling, host-loss survival.

PyTorch port of `incubator_mxnet_tpu/serving/fleet.py`.  The router made
the REPLICA the unit of redundancy; this module makes the HOST one.

* **host-aware placement** — replicas spawn across a registry of
  `FleetHost` handles with anti-affinity: each new replica lands on the
  live host carrying the fewest of this model's replicas.  A host whose
  spawns keep failing trips its `CircuitBreaker` and placement skips it
  while it cools off.
* **host liveness through `dist.membership`** — one prober thread a
  host feeds the `MembershipTable`; a host silent past the deadline is
  dead in the next view, and ALL its replicas are declared lost at once
  (`router.declare_lost`): in-flight requests fail over immediately,
  and the fleet re-places the lost capacity on survivors (backfill; its
  latency is a stat).
* **SLO-driven autoscaling** — the `Autoscaler` watches the signal the
  router's admission sheds on (`router.estimated_wait_s()`): a
  sustained breach spawns a replica, sustained idleness retires one
  through the router's drain.  Hysteresis, a cooldown and a min/max
  budget keep it from flapping.  A spawned worker whose READY line shows
  ``builds > 0`` (it ran ``nvcc``: the kernels were not built before) is
  a ``cold-spinup`` WARN finding.

Fault sites (`resilience.faults`): ``fleet.spawn`` (per spawn) and
``host.down`` (per host probe).  Telemetry, as in the JAX package: every
fleet event is also a `profiler.record_serving` event, `stats()` is the
``fleet`` producer (``fleet.<name>`` for another name), and `scrape()`
aggregates this process's registry, every host daemon's and every remote
replica's ``metrics`` frame, a dead leg recorded under ``unreachable``;
a replica the fleet lost since the previous scrape is listed there too,
though the router no longer holds it (the JAX scrape lists only the
replicas still in the router).
Declared divergences: `findings()` returns this module's small `Finding`
copy; plain `threading` locks stand in for `analysis.locks`; an
`AgentHost` serializes its control channel's requests under a lock (the
JAX host lets a scrape race the prober's heartbeat on that one serial
channel).
"""
from __future__ import annotations

import collections
import itertools
import os
import signal
import sys
import threading
import time

from .. import profiler as _profiler
from ..base import MXNetError
from ..dist.membership import MembershipTable
from ..obs import metrics as _obs_metrics
from ..resilience import faults as _faults

__all__ = ["FleetManager", "Autoscaler", "ReplicaSpec", "FleetHost",
           "InProcessHost", "AgentHost", "Finding", "findings",
           "reset_findings"]

WARN, HINT = "warn", "hint"

# every scale and host event of every live FleetManager, bounded
_EVENTS = collections.deque(maxlen=512)
# replicas a fleet lost and no scrape has reported yet, at most
_LOST_LEGS_CAP = 512
_EVENTS_LOCK = threading.Lock()


class Finding:
    """One diagnostic, as `incubator_mxnet_tpu.analysis.findings.Finding`
    (not ported) gives it."""

    __slots__ = ("pass_name", "code", "severity", "message", "location")

    def __init__(self, pass_name, code, severity, message, location=None):
        self.pass_name = pass_name
        self.code = code
        self.severity = severity
        self.message = message
        self.location = location

    def format(self):
        head = f"{self.location}: " if self.location else ""
        return f"{head}{self.severity} [{self.code}] {self.message}"

    def __repr__(self):
        return f"<Finding {self.format()}>"


def _note_event(fleet, action, **ctx):
    entry = {"fleet": fleet, "action": action, **ctx}
    with _EVENTS_LOCK:
        _EVENTS.append(entry)
    _profiler.record_serving(f"fleet:{fleet}", 0.0, event=action,
                             **{k: v for k, v in ctx.items()
                                if isinstance(v, (str, int, float, bool))})
    return entry


def findings():
    """Fleet findings: host losses and backfills as WARNs, a WARN for any
    spin-up whose worker built kernels (``cold-spinup``: build them
    before spawning), and one HINT summarising each fleet's scaling."""
    with _EVENTS_LOCK:
        events = list(_EVENTS)
    out = []
    per_fleet = collections.Counter()
    for e in events:
        per_fleet[e["fleet"]] += 1
        if e["action"] == "host_down":
            out.append(Finding(
                "serving.fleet", "host-lost", WARN,
                "fleet '%s': host '%s' declared dead (%s) — %d replica(s) "
                "failed over and re-placed on survivors"
                % (e["fleet"], e.get("host"), e.get("reason", "?"),
                   e.get("replicas", 0)),
                location="serving.fleet"))
        elif e["action"] == "backfill_complete":
            out.append(Finding(
                "serving.fleet", "backfill", WARN,
                "fleet '%s': backfilled to target %d in %.2fs after "
                "capacity loss"
                % (e["fleet"], e.get("target", 0),
                   e.get("latency_s", 0.0)),
                location="serving.fleet"))
        elif e["action"] == "scale_up" and e.get("spinup_builds"):
            out.append(Finding(
                "serving.fleet", "cold-spinup", WARN,
                "fleet '%s': scale-up of '%s' on host '%s' built %d "
                "kernel library(ies) — a warm spin-up builds none; build "
                "the kernels into build/ before spawning"
                % (e["fleet"], e.get("replica"), e.get("host"),
                   e.get("spinup_builds")),
                location="serving.fleet"))
    for fleet, n in sorted(per_fleet.items()):
        ups = sum(1 for e in events
                  if e["fleet"] == fleet and e["action"] == "scale_up")
        downs = sum(1 for e in events
                    if e["fleet"] == fleet and e["action"] == "scale_down")
        out.append(Finding(
            "serving.fleet", "summary", HINT,
            "fleet '%s': %d event(s) — %d scale-up, %d scale-down"
            % (fleet, n, ups, downs), location="serving.fleet"))
    return out


def reset_findings():
    with _EVENTS_LOCK:
        _EVENTS.clear()


class ReplicaSpec:
    """What to spawn: one served model's worker recipe, JSON-able for a
    host agent (`to_msg`/`from_msg` give the JAX package's dict)."""

    __slots__ = ("name", "prefix", "epoch", "symbol_file",
                 "checkpoint_dir", "data_shapes", "buckets", "env",
                 "concurrency")

    def __init__(self, *, data_shapes, name="model", prefix=None, epoch=0,
                 symbol_file=None, checkpoint_dir=None,
                 buckets=(1, 2, 4, 8), env=None, concurrency=2):
        self.name = str(name)
        self.prefix = prefix
        self.epoch = int(epoch)
        self.symbol_file = symbol_file
        self.checkpoint_dir = checkpoint_dir
        self.data_shapes = [(str(n), tuple(int(d) for d in s))
                            for n, s in data_shapes]
        self.buckets = tuple(int(b) for b in buckets)
        self.env = dict(env or {})
        self.concurrency = int(concurrency)

    def to_msg(self):
        return {"name": self.name, "prefix": self.prefix,
                "epoch": self.epoch, "symbol_file": self.symbol_file,
                "checkpoint_dir": self.checkpoint_dir,
                "data_shapes": [[n, list(s)] for n, s in self.data_shapes],
                "buckets": list(self.buckets), "env": dict(self.env),
                "concurrency": self.concurrency}

    @classmethod
    def from_msg(cls, msg):
        return cls(data_shapes=[(n, tuple(s))
                                for n, s in msg["data_shapes"]],
                   name=msg.get("name", "model"),
                   prefix=msg.get("prefix"),
                   epoch=msg.get("epoch", 0),
                   symbol_file=msg.get("symbol_file"),
                   checkpoint_dir=msg.get("checkpoint_dir"),
                   buckets=msg.get("buckets", (1, 2, 4, 8)),
                   env=msg.get("env"),
                   concurrency=msg.get("concurrency", 2))


class FleetHost:
    """One serving host the fleet can place replicas on: ``heartbeat()``
    raises when the host is unreachable; ``spawn_replica(spec,
    replica_id)`` starts one replica there and returns its `Replica`
    handle."""

    host_id = "?"

    def heartbeat(self):
        raise NotImplementedError

    def spawn_replica(self, spec, replica_id):
        raise NotImplementedError

    def scrape(self):
        """The host's telemetry snapshot ({"values", "prom"}), or None
        when this host kind has no scrape leg (in-process hosts share
        the manager's own registry)."""
        return None

    def close(self):
        pass


class InProcessHost(FleetHost):
    """A logical host inside this process: ``spawn`` is a caller's
    factory (a `LocalReplica` builder), liveness a flag tests flip.  The
    placement and autoscaling logic is the cross-host path's."""

    def __init__(self, host_id, spawn=None):
        self.host_id = str(host_id)
        self._spawn = spawn
        self._down = False

    def heartbeat(self):
        if self._down:
            raise MXNetError(f"host '{self.host_id}' is down")
        return {"ok": True, "host_id": self.host_id}

    def spawn_replica(self, spec, replica_id):
        if self._down:
            raise MXNetError(f"host '{self.host_id}' is down")
        if self._spawn is None:
            raise MXNetError(
                f"host '{self.host_id}': no spawn factory configured")
        return self._spawn(spec, replica_id)

    def fail(self):
        """Simulate host death: heartbeats fail from now on."""
        self._down = True

    def recover(self):
        self._down = False


class AgentHost(FleetHost):
    """A host fronted by its `serving.hostd` daemon.  Two serial
    channels: a short-timeout control channel (heartbeats) and a
    long-timeout spawn channel (a worker's start-up must not block the
    next heartbeat)."""

    def __init__(self, host_id, host, port, process=None,
                 control_timeout=5.0, spawn_timeout=300.0):
        self.host_id = str(host_id)
        self.host, self.port = str(host), int(port)
        self.process = process       # Popen when launch_local()ed
        self._control = self._make_channel(control_timeout)
        # one request at a time on the serial control channel: the
        # prober's heartbeats and scrapes share it
        self._control_lock = threading.Lock()
        self._spawn_chan = self._make_channel(spawn_timeout)

    def _make_channel(self, timeout):
        from ..dist.transport import Channel
        from ..resilience import RetryPolicy
        # a short connect window: a dead host is diagnosed in seconds so
        # the membership deadline can act
        return Channel(self.host, self.port, timeout=timeout,
                       connect_wait=2.0,
                       retry=RetryPolicy(max_attempts=2, base_delay=0.05,
                                         max_delay=0.2))

    @classmethod
    def connect(cls, host_id, endpoint, **kw):
        """Attach to a running host daemon by endpoint (``"host:port"``,
        ``":port"`` or ``"port"``, `dist.transport.parse_endpoint`)."""
        from ..dist.transport import parse_endpoint
        host, port = parse_endpoint(endpoint)
        return cls(host_id, host, port, **kw)

    @classmethod
    def launch_local(cls, host_id, bind_host="127.0.0.1", env=None,
                     ready_timeout=60.0, launch=None, ctx="gpu"):
        """Start a host daemon (locally, or through ``launch(cmd, env) ->
        Popen``) in its own session, so a SIGKILL of its process group
        powers off the daemon and every worker it spawned together.
        ``ctx`` is the device its workers serve on (the card by
        default)."""
        from .replica import launch_worker
        cmd = [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving.hostd",
               "--host-id", str(host_id), "--host", bind_host,
               "--ctx", str(ctx)]
        proc, port, _ready = launch_worker(
            cmd, env=env, name=f"hostd '{host_id}'",
            ready_timeout=ready_timeout, launch=launch, tag=host_id,
            port_prefix="HOSTD_PORT", ready_prefix="HOSTD_READY",
            start_new_session=True, thread_prefix="mx-hostd")
        try:
            return cls(host_id, bind_host, port, process=proc)
        except BaseException:
            os.killpg(proc.pid, signal.SIGKILL)
            raise

    def _request(self, chan, msg):
        reply = chan.request(msg)
        if "error" in reply:
            raise MXNetError(reply["error"])
        return reply

    def heartbeat(self):
        with self._control_lock:
            return self._request(self._control, {"cmd": "hb"})

    def scrape(self):
        """The daemon process's registry snapshot over the control
        channel (the fleet-wide scrape's per-host leg)."""
        with self._control_lock:
            reply = self._request(self._control, {"cmd": "metrics"})
        return {"values": dict(reply.get("values") or {}),
                "prom": reply.get("prom", "")}

    def spawn_replica(self, spec, replica_id):
        from .replica import RemoteReplica
        reply = self._request(self._spawn_chan,
                              {"cmd": "spawn", "spec": spec.to_msg(),
                               "replica_id": replica_id})
        rep = RemoteReplica(self.host, int(reply["port"]),
                            replica_id=replica_id,
                            concurrency=spec.concurrency)
        rep.ready_info = dict(reply.get("ready", {}))
        return rep

    def close(self):
        try:
            self._control.bare_request({"cmd": "stop"})
        except Exception:
            pass
        for chan in (self._control, self._spawn_chan):
            try:
                chan.close()
            except Exception:
                pass
        if self.process is not None:
            try:
                self.process.wait(timeout=10)
            except Exception:
                self.kill()
                self.process.wait()

    def kill(self):
        """SIGKILL the whole host process group: the daemon and every
        worker it spawned die with no flush, no unwinding."""
        if self.process is not None:
            try:
                os.killpg(self.process.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                self.process.kill()


class Autoscaler:
    """The scale decision, apart from actuation, so seeded wait traces
    drive it deterministically (injectable clock, no threads).

    ``observe(est_wait_ms, live, busy)`` returns ``(action, reason)``,
    action "up", "down" or None:

    * an estimate above ``slo_ms`` (or None: no live capacity) starts or
      extends the BREACH streak; sustained past ``up_after_s`` and out of
      the cooldown -> "up" (clamped at ``max_replicas``);
    * an estimate below ``idle_fraction * slo_ms`` with nothing in
      flight starts or extends the IDLE streak; sustained past
      ``down_after_s`` and out of the cooldown -> "down" (clamped at
      ``min_replicas``);
    * between the two thresholds (the hysteresis dead band) both streaks
      reset, and every action arms the cooldown, so even a square wave
      makes at most one scale event per ``cooldown_s``.
    """

    def __init__(self, slo_ms, *, up_after_s, down_after_s, cooldown_s,
                 min_replicas, max_replicas, idle_fraction=0.1,
                 clock=time.monotonic):
        if int(min_replicas) < 0 or int(max_replicas) < int(min_replicas):
            raise MXNetError(
                f"autoscaler: invalid replica budget "
                f"[{min_replicas}, {max_replicas}]")
        self.slo_ms = float(slo_ms)
        self.up_after_s = float(up_after_s)
        self.down_after_s = float(down_after_s)
        self.cooldown_s = float(cooldown_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.idle_fraction = float(idle_fraction)
        self._clock = clock
        self._breach_since = None
        self._idle_since = None
        self._cooldown_until = 0.0
        self.clamped_at_max = 0
        self.clamped_at_min = 0

    def cooldown_remaining_s(self):
        return max(self._cooldown_until - self._clock(), 0.0)

    def streaks(self):
        now = self._clock()
        return {
            "breach_s": (now - self._breach_since
                         if self._breach_since is not None else 0.0),
            "idle_s": (now - self._idle_since
                       if self._idle_since is not None else 0.0)}

    def observe(self, est_wait_ms, live, busy):
        now = self._clock()
        breach = est_wait_ms is None or est_wait_ms > self.slo_ms
        idle = (not breach and not busy
                and est_wait_ms <= self.idle_fraction * self.slo_ms)
        if breach:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            sustained = now - self._breach_since
            if sustained >= self.up_after_s and now >= self._cooldown_until:
                if live >= self.max_replicas:
                    # episodes, not ticks: the streak restarts
                    self.clamped_at_max += 1
                    self._breach_since = None
                    return None, None
                self._breach_since = None
                self._cooldown_until = now + self.cooldown_s
                wait = ("no live capacity" if est_wait_ms is None
                        else f"est-wait {est_wait_ms:.0f} ms > SLO "
                             f"{self.slo_ms:g} ms")
                return "up", f"{wait} sustained {sustained:.1f}s"
        elif idle:
            self._breach_since = None
            if self._idle_since is None:
                self._idle_since = now
            sustained = now - self._idle_since
            if sustained >= self.down_after_s \
                    and now >= self._cooldown_until:
                if live <= self.min_replicas:
                    self.clamped_at_min += 1
                    self._idle_since = None
                    return None, None
                self._idle_since = None
                self._cooldown_until = now + self.cooldown_s
                return "down", (
                    f"est-wait {est_wait_ms:.1f} ms < "
                    f"{self.idle_fraction * self.slo_ms:g} ms idle "
                    f"threshold sustained {sustained:.1f}s")
        else:
            self._breach_since = None
            self._idle_since = None
        return None, None


class _HostState:
    """Fleet-side bookkeeping for one host."""

    def __init__(self, rank, handle, breaker):
        self.rank = rank             # membership-table rank
        self.handle = handle
        self.breaker = breaker       # trips on consecutive spawn failures
        self.alive = True
        self.beats = 0
        self.hb_failures = 0         # consecutive


class FleetManager:
    """The fleet control loop over a `ReplicaRouter`.

    ``hosts`` is the host registry (`FleetHost` handles); ``spec`` the
    one model this fleet scales (one manager per model).  The manager
    owns placement, host liveness and the autoscaler; the router keeps
    dispatch, replica health, failover and admission shedding, and both
    act on the same estimated-wait signal.
    """

    def __init__(self, hosts, spec, router=None, name="fleet",
                 target_replicas=None, min_replicas=None,
                 max_replicas=None, slo_ms=None, tick_s=None,
                 up_after_s=None, down_after_s=None, cooldown_s=None,
                 idle_fraction=None, host_heartbeat_s=None,
                 host_deadline_s=None, clock=time.monotonic, start=True):
        from .. import config as _config
        from .router import ReplicaRouter, serving_breaker
        if not hosts:
            raise MXNetError("fleet: at least one host is required")
        ids = [h.host_id for h in hosts]
        if len(set(ids)) != len(ids):
            raise MXNetError(f"fleet: duplicate host ids in {ids}")
        self.name = str(name)
        self.spec = spec
        self._clock = clock
        self.router = router if router is not None \
            else ReplicaRouter(name=f"{self.name}-router")
        self._owns_router = router is None

        def knob(value, key):
            return value if value is not None else _config.get(key)

        self.tick_s = float(knob(tick_s, "MXNET_FLEET_TICK_S"))
        self.host_heartbeat_s = float(
            knob(host_heartbeat_s, "MXNET_FLEET_HOST_HEARTBEAT_S"))
        self.host_deadline_s = float(
            knob(host_deadline_s, "MXNET_FLEET_HOST_DEADLINE_S"))
        min_r = int(knob(min_replicas, "MXNET_FLEET_MIN_REPLICAS"))
        max_r = int(knob(max_replicas, "MXNET_FLEET_MAX_REPLICAS"))
        self.autoscaler = Autoscaler(
            float(knob(slo_ms, "MXNET_FLEET_SLO_MS")),
            up_after_s=float(knob(up_after_s, "MXNET_FLEET_UP_AFTER_S")),
            down_after_s=float(
                knob(down_after_s, "MXNET_FLEET_DOWN_AFTER_S")),
            cooldown_s=float(knob(cooldown_s, "MXNET_FLEET_COOLDOWN_S")),
            min_replicas=min_r, max_replicas=max_r,
            idle_fraction=float(
                knob(idle_fraction, "MXNET_FLEET_IDLE_FRACTION")),
            clock=clock)
        self.target = int(target_replicas if target_replicas is not None
                          else max(min_r, 1))
        if not min_r <= self.target <= max_r:
            raise MXNetError(
                f"fleet '{self.name}': target {self.target} outside the "
                f"replica budget [{min_r}, {max_r}]")
        self._lock = threading.Lock()
        _obs_metrics.register_producer(
            "fleet" if self.name == "fleet" else f"fleet.{self.name}",
            self.stats)
        self._placement = {}          # replica_id -> host_id
        # replicas lost since the last scrape -> their host: a scrape
        # lists them as dead legs even once the router has let them go
        self._lost_legs = {}
        self._rid_seq = itertools.count(1)
        # host liveness in the elastic trainer's MembershipTable: rank =
        # registry index, deadline = host death
        self.membership = MembershipTable(len(hosts),
                                          self.host_deadline_s,
                                          clock=clock)
        self._hosts = {}
        for rank, handle in enumerate(hosts):
            self._hosts[handle.host_id] = _HostState(rank, handle,
                                                     serving_breaker())
            # an optimistic first beat: a host that never answers still
            # ages into the dead list
            self.membership.heartbeat(rank, self.membership.epoch,
                                      label=handle.host_id)
        self.scale_ups = 0
        self.scale_downs = 0
        self.hosts_lost = 0
        self.backfills = 0
        self.spawn_failures = 0
        self.last_backfill_s = None
        self._backfill_started = None   # capacity-loss timestamp
        self._scale_reason = None       # the last autoscale decision's why
        self._events = collections.deque(maxlen=256)
        self._last_signal_ms = None
        self._closed = threading.Event()
        self._thread = None
        self._placer = None
        self._probers = []
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Place the initial fleet and start the loops: one prober thread
        per host (a dead host's blocking connects must not starve another
        host's beats), the WATCH loop (liveness and autoscale decisions,
        never blocked by actuation) and the PLACER loop (spawns and
        retires toward the target)."""
        if self._thread is not None:
            return self
        # probers before placement: the initial spawns take seconds, and
        # the seed beats must not age past the deadline meanwhile
        self._probers = []
        for hs in self._hosts.values():
            t = threading.Thread(
                target=self._probe_loop, args=(hs,), daemon=True,
                name=f"mx-fleet-{self.name}-hb-{hs.handle.host_id}")
            t.start()
            self._probers.append(t)
        self._reconcile("initial placement")
        self._thread = threading.Thread(
            target=self._watch_loop, daemon=True,
            name=f"mx-fleet-{self.name}")
        self._thread.start()
        self._placer = threading.Thread(
            target=self._place_loop, daemon=True,
            name=f"mx-fleet-{self.name}-placer")
        self._placer.start()
        return self

    def shutdown(self, drain=True, close_hosts=False):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(30)
            self._placer.join(30)
            for t in self._probers:
                t.join(15)
        if self._owns_router:
            self.router.shutdown(drain=drain)
        if close_hosts:
            for hs in list(self._hosts.values()):
                try:
                    hs.handle.close()
                except Exception:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    # -- placement ------------------------------------------------------------
    def _live_hosts(self):
        with self._lock:
            return [hs for hs in self._hosts.values() if hs.alive]

    def _pick_host(self):
        """Anti-affinity: the live host (breaker permitting) with the
        fewest of this fleet's replicas, registry order breaking ties;
        None when no host can take one."""
        with self._lock:
            crowd = collections.Counter(self._placement.values())
            cands = [hs for hs in self._hosts.values()
                     if hs.alive and hs.breaker.state != "open"]
        cands.sort(key=lambda hs: (crowd[hs.handle.host_id], hs.rank))
        for hs in cands:
            if hs.breaker.allow():
                return hs
        return None

    def _spawn_one(self, reason):
        hs = self._pick_host()
        if hs is None:
            states = {h.handle.host_id: ("alive" if h.alive else "dead",
                                         h.breaker.state)
                      for h in self._hosts.values()}
            raise MXNetError(
                f"fleet '{self.name}': no live host can take a replica "
                f"(hosts: {states})")
        host_id = hs.handle.host_id
        rid = f"{self.spec.name}@{host_id}/{next(self._rid_seq)}"
        t0 = self._clock()
        try:
            _faults.fire("fleet.spawn", host=host_id, replica=rid)
            replica = hs.handle.spawn_replica(self.spec, rid)
        except Exception as exc:
            hs.breaker.record_failure()
            with self._lock:
                self.spawn_failures += 1
            self._event("spawn_failed", host=host_id, replica=rid,
                        reason=f"{type(exc).__name__}: {exc}")
            raise MXNetError(
                f"fleet '{self.name}': spawning {rid} on host "
                f"'{host_id}' failed: {exc}") from exc
        hs.breaker.record_success()
        self.router.add_replica(replica)
        ready = dict(getattr(replica, "ready_info", None) or {})
        with self._lock:
            self._placement[rid] = host_id
        self._event("scale_up", host=host_id, replica=rid, reason=reason,
                    duration_s=round(self._clock() - t0, 3),
                    spinup_builds=ready.get("builds"),
                    spinup_programs=ready.get("programs"))
        with self._lock:
            self.scale_ups += 1
        return rid

    def _retire_one(self, reason):
        """Scale down through the router's drain: a replica on the most
        crowded host, the one with the least outstanding work."""
        with self._lock:
            placement = dict(self._placement)
        if not placement:
            return None
        crowd = collections.Counter(placement.values())
        slots = self._router_slots()

        def key(rid):
            slot = slots.get(rid)
            out = slot.replica.outstanding() if slot is not None else 0
            return (-crowd[placement[rid]], out)

        rid = sorted(placement, key=key)[0]
        host_id = placement[rid]
        t0 = self._clock()
        # the placement goes first: during the drain the router still
        # holds the slot, and _sync_placement must not read this retire
        # as a loss and re-arm the backfill clock
        with self._lock:
            self._placement.pop(rid, None)
            self.scale_downs += 1
        try:
            self.router.remove_replica(rid, drain=True)
        except MXNetError:
            pass   # already gone (raced a death): the sync tick cleans up
        self._event("scale_down", host=host_id, replica=rid, reason=reason,
                    duration_s=round(self._clock() - t0, 3))
        return rid

    def _router_slots(self):
        with self.router._lock:
            return dict(self.router._slots)

    def _live_replicas(self):
        """Replicas this fleet placed that the router still serves."""
        from .router import DEAD
        slots = self._router_slots()
        with self._lock:
            placement = dict(self._placement)
        return [rid for rid in placement
                if rid in slots and slots[rid].state != DEAD]

    def _spawn_reason(self):
        """Why the next spawn happens: a pending backfill first, else the
        autoscaler's last decision."""
        with self._lock:
            if self._backfill_started is not None:
                return "backfill after capacity loss"
            return self._scale_reason or "reconcile to target"

    def _reconcile(self, reason=None):
        """Spawn until the live count meets the target (initial placement
        and backfill share this path)."""
        guard = 0
        while not self._closed.is_set():
            live = len(self._live_replicas())
            if live >= self.target:
                break
            if reason is None:
                reason = self._spawn_reason()
            guard += 1
            if guard > 2 * self.autoscaler.max_replicas + 4:
                break   # spawns keep failing: breakers and events say why
            try:
                self._spawn_one(reason)
            except MXNetError:
                if not self._live_hosts():
                    break
                self._closed.wait(min(self.tick_s, 0.2))
        live_now = len(self._live_replicas())
        with self._lock:
            # one lock hold: a concurrent scale-down cancels the
            # measurement by nulling _backfill_started with the target
            started = self._backfill_started
            if started is None or live_now < self.target:
                return
            latency = self._clock() - started
            self._backfill_started = None
            self.backfills += 1
            self.last_backfill_s = round(latency, 3)
        self._event("backfill_complete", target=self.target,
                    latency_s=round(latency, 3))

    # -- host liveness --------------------------------------------------------
    def _probe_loop(self, hs):
        """One host's heartbeats into the membership table; only silence
        in the table past the deadline judges death (`_check_hosts`)."""
        host_id = hs.handle.host_id
        while not self._closed.wait(self.host_heartbeat_s):
            try:
                _faults.fire("host.down", host=host_id)
                hs.handle.heartbeat()
            except Exception:
                with self._lock:
                    hs.hb_failures += 1
                continue
            # the table's beat before the alive flag: a rejoining host
            # must be out of the dead view before it counts as alive
            self.membership.heartbeat(hs.rank, self.membership.epoch,
                                      label=host_id)
            with self._lock:
                hs.beats += 1
                hs.hb_failures = 0
                was_dead = not hs.alive
                hs.alive = True
            if was_dead:
                self._event("host_rejoined", host=host_id)

    def _check_hosts(self):
        view = self.membership.view()
        with self._lock:
            hosts = list(self._hosts.values())
        for hs in hosts:
            if hs.rank in view["dead"] and hs.alive:
                self._on_host_down(hs, view["age"].get(hs.rank))

    def _on_host_down(self, hs, age_s):
        """A dead host kills all its replicas at once: they fail over
        now, leave the fleet in one lock hold (the placer must not count
        a dead replica still placed), and the survivors backfill."""
        host_id = hs.handle.host_id
        if hs.rank not in self.membership.view()["dead"]:
            return   # it beat again since the snapshot
        with self._lock:
            if not hs.alive:
                return
            hs.alive = False
            self.hosts_lost += 1
            if self._backfill_started is None:
                self._backfill_started = self._clock()
            lost = [rid for rid, hid in self._placement.items()
                    if hid == host_id]
            for rid in lost:
                self._placement.pop(rid, None)
                self._note_lost_locked(rid, host_id)
        reason = (f"heartbeat silence {age_s:.1f}s > deadline "
                  f"{self.host_deadline_s:g}s"
                  if age_s is not None else "heartbeat silence")
        # the event before the sweep: whoever sees the backfill sees the
        # host_down that caused it
        self._event("host_down", host=host_id, reason=reason,
                    replicas=len(lost))
        _faults.note("host_lost", site="host.down", host=host_id,
                     replicas=len(lost))
        for rid in lost:
            self.router.declare_lost(rid)
            try:
                self.router.remove_replica(rid, drain=False)
            except MXNetError:
                pass

    def _sync_placement(self):
        """Forget replicas the router declared dead on its own, so the
        live count (and the backfill) sees the loss."""
        from .router import DEAD
        slots = self._router_slots()
        with self._lock:
            placement = dict(self._placement)
        for rid, host_id in placement.items():
            slot = slots.get(rid)
            if slot is not None and slot.state != DEAD:
                continue
            if slot is not None:
                try:
                    self.router.remove_replica(rid, drain=False)
                except MXNetError:
                    pass
            with self._lock:
                self._placement.pop(rid, None)
                self._note_lost_locked(rid, host_id)
                if self._backfill_started is None:
                    self._backfill_started = self._clock()
            self._event("replica_lost", host=host_id, replica=rid)

    # -- the control loops ----------------------------------------------------
    def _watch_loop(self):
        """Liveness and autoscale decisions only: never blocked by a
        spawn or a drain."""
        while not self._closed.wait(self.tick_s):
            try:
                self._check_hosts()
                self._sync_placement()
                self._autoscale_tick()
            except Exception as exc:   # the loop outlives any tick
                self._event("tick_error",
                            reason=f"{type(exc).__name__}: {exc}")

    def _place_loop(self):
        """Actuation: spawns and retires toward the target."""
        while not self._closed.wait(self.tick_s):
            try:
                self._retire_surplus()
                self._reconcile()
            except Exception as exc:
                self._event("tick_error",
                            reason=f"{type(exc).__name__}: {exc}")

    def _retire_surplus(self):
        with self._lock:
            reason = self._scale_reason
        while not self._closed.is_set():
            if len(self._live_replicas()) <= self.target:
                break
            if self._retire_one(reason or "scale-down") is None:
                break

    def _autoscale_tick(self):
        wait_s = self.router.estimated_wait_s()
        est_ms = None if wait_s is None else wait_s * 1e3
        with self._lock:
            self._last_signal_ms = est_ms
        live = self._live_replicas()
        slots = self._router_slots()
        busy = any(slots[rid].replica.outstanding() > 0
                   for rid in live if rid in slots)
        action, reason = self.autoscaler.observe(est_ms, len(live), busy)
        if action == "up":
            # at least live+1, never below the current target: mid-backfill
            # a scale-up must not shrink the backfill's goal
            with self._lock:
                self.target = min(max(self.target, len(live) + 1),
                                  self.autoscaler.max_replicas)
                self._scale_reason = reason
        elif action == "down":
            with self._lock:
                self.target = max(len(live) - 1,
                                  self.autoscaler.min_replicas)
                self._scale_reason = reason
                # a scale-down cancels a pending backfill measurement, or
                # the shrunken target would report one that never happened
                self._backfill_started = None

    # -- observability --------------------------------------------------------
    def _event(self, action, **ctx):
        entry = _note_event(self.name, action,
                            t=round(self._clock(), 3), **ctx)
        with self._lock:
            self._events.append(entry)

    def stats(self):
        """Per-host replica counts and liveness, the placement, scale
        events with reasons, the backfill latency and the autoscaler's
        signal and streaks."""
        view = self.membership.view()
        with self._lock:
            placement = dict(self._placement)
            events = list(self._events)
            snap = {
                "fleet": self.name,
                "target": self.target,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "hosts_lost": self.hosts_lost,
                "backfills": self.backfills,
                "spawn_failures": self.spawn_failures,
                "backfill_latency_s": self.last_backfill_s,
                "signal": {
                    "est_wait_ms": self._last_signal_ms,
                    "slo_ms": self.autoscaler.slo_ms,
                    "clamped_at_max": self.autoscaler.clamped_at_max,
                    "clamped_at_min": self.autoscaler.clamped_at_min,
                    "cooldown_remaining_s": round(
                        self.autoscaler.cooldown_remaining_s(), 3),
                    **{k: round(v, 3)
                       for k, v in self.autoscaler.streaks().items()},
                },
            }
            hosts = {}
            for hid, hs in self._hosts.items():
                hosts[hid] = {
                    "alive": hs.alive,
                    "replicas": sum(1 for h in placement.values()
                                    if h == hid),
                    "beats": hs.beats,
                    "hb_failures": hs.hb_failures,
                    "age_s": view["age"].get(hs.rank),
                    "spawn_breaker": hs.breaker.state,
                }
        snap["live_replicas"] = len(self._live_replicas())
        snap["hosts"] = hosts
        snap["placement"] = placement
        snap["events"] = events[-32:]
        return snap

    def _note_lost_locked(self, rid, host_id):
        """Remember a lost replica for the next scrape (bounded: the
        oldest go first when no scrape comes)."""
        self._lost_legs[rid] = host_id
        while len(self._lost_legs) > _LOST_LEGS_CAP:
            self._lost_legs.pop(next(iter(self._lost_legs)))

    def scrape(self):
        """The fleet-wide telemetry aggregate: this process's registry
        (router, fleet, serving.* producers), every host daemon's
        snapshot and every placed remote replica's worker snapshot.  A
        dead or unreachable leg is recorded under ``unreachable``
        instead of failing the scrape (a half-dead fleet is when the
        numbers are needed), as is every replica the fleet lost since the
        previous scrape."""
        from ..obs.scrape import metrics_reply
        # the replicas placed when the scrape begins: a host leg's
        # connect timeout must not let a dead host's replicas be swept
        # out of the router before their legs are tried
        slots = self._router_slots()
        local = metrics_reply()
        out = {"fleet": self.name,
               "local": {"values": local["values"],
                         "prom": local["prom"]},
               "hosts": {}, "replicas": {}, "unreachable": []}
        with self._lock:
            hosts = {hid: hs.handle for hid, hs in self._hosts.items()}
            lost, self._lost_legs = self._lost_legs, {}
        for hid, handle in hosts.items():
            try:
                snap = handle.scrape()
            except Exception:
                out["unreachable"].append(f"host:{hid}")
                continue
            if snap is not None:
                out["hosts"][hid] = snap
        for rid, slot in slots.items():
            scrape_fn = getattr(slot.replica, "scrape", None)
            if scrape_fn is None:
                continue
            try:
                out["replicas"][rid] = scrape_fn()
            except Exception:
                out["unreachable"].append(f"replica:{rid}")
        for rid in lost:
            if f"replica:{rid}" not in out["unreachable"] and \
                    rid not in out["replicas"]:
                out["unreachable"].append(f"replica:{rid}")
        return out
