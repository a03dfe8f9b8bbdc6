"""The port's serving fleet (`serving/fleet.py`, `hostd.py`) against the
JAX package's on the CPU.

* The `Autoscaler`: the signal traces of `tests/test_fleet.py` (the
  seeded one included) fed to both packages give identical decisions.
* `FleetManager` over `InProcessHost`s of `LocalReplica`s: each scenario
  runs both packages' managers without their threads, one loop pass at a
  time under the same injected clock (`_tick`), and holds the event
  sequences, placements and counters equal: anti-affinity, a host's
  death with backfill and its rejoin, a scale-up mid-backfill, the spawn
  breaker, the ``fleet.spawn`` fault site, and the autoscaler driving
  the fleet up and down through the drain.
* `ReplicaSpec`'s wire dict across the packages, `hostd`'s idempotent
  spawn, `launch_worker`'s deadline kill, `AgentHost.connect`, the
  findings, and two real host daemons (``--ctx cpu``) whose one host is
  SIGKILLed as a process group: declared dead, its replica failed over,
  the capacity backfilled, no admitted request lost.
"""
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.resilience import faults as jfaults
from incubator_mxnet_tpu.serving import fleet as jfleet
from incubator_mxnet_tpu.serving import LocalReplica as JLocal
from incubator_mxnet_tpu.serving import ReplicaRouter as JRouter

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
from incubator_mxnet_tpu_torch.resilience import faults as tfaults
from incubator_mxnet_tpu_torch.serving import fleet as tfleet
from incubator_mxnet_tpu_torch.serving import (LocalReplica, ReplicaRouter,
                                               ReplicaSpec)

SHAPES = [("data", (1, 6))]
BUCKETS = (1, 2)
PKGS = {"jax": (jmx, jfleet, JLocal, JRouter, jfaults),
        "port": (tmx, tfleet, LocalReplica, ReplicaRouter, tfaults)}


@pytest.fixture(autouse=True)
def _clean():
    for faults in (jfaults, tfaults):
        faults.clear()
    for fl in (jfleet, tfleet):
        fl.reset_findings()
    yield
    for faults in (jfaults, tfaults):
        faults.clear()
    for fl in (jfleet, tfleet):
        fl.reset_findings()


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


# -- the autoscaler: the JAX tests' traces through both ----------------------

def _trace_up(a, clock):
    out = [a.observe(500.0, 1, False)]
    clock.tick(1.0)
    out.append(a.observe(500.0, 1, False))
    clock.tick(1.5)
    out.append(a.observe(500.0, 1, False))
    return out


def _trace_none(a, clock):
    out = [a.observe(None, 0, False)]
    clock.tick(2.5)
    return out + [a.observe(None, 0, False)]


def _trace_cooldown(a, clock):
    out = [a.observe(500.0, 1, False)]
    clock.tick(2.5)
    out.append(a.observe(500.0, 1, False))
    for _ in range(9):
        clock.tick(1.0)
        out.append(a.observe(500.0, 2, False))
    clock.tick(1.5)
    return out + [a.observe(500.0, 2, False)]


def _trace_down(a, clock):
    out = [a.observe(2.0, 3, False)]
    for dt in (4.0, 2.0):
        clock.tick(dt)
        out.append(a.observe(2.0, 3, False))
    out.append(a.observe(2.0, 3, True))
    clock.tick(50.0)
    return out + [a.observe(2.0, 3, True)]


def _trace_dead_band(a, clock):
    out = [a.observe(500.0, 1, False)]
    for dt, ms in ((1.5, 50.0), (1.5, 500.0), (1.0, 500.0), (1.5, 500.0)):
        clock.tick(dt)
        out.append(a.observe(ms, 1, False))
    return out


def _trace_flapping(a, clock):
    out = []
    for i in range(600):
        clock.tick(1.0)
        out.append(a.observe(500.0 if i % 2 else 50.0, 2, False))
    return out


def _trace_clamps(a, clock):
    out = [a.observe(500.0, 3, False)]
    clock.tick(3.0)
    out.append(a.observe(500.0, 3, False))
    out.append(a.observe(1.0, 2, False))
    clock.tick(6.0)
    out.append(a.observe(1.0, 2, False))
    return out + [(a.clamped_at_max, a.clamped_at_min)]


def _trace_seeded(a, clock):
    rng = np.random.RandomState(7)
    live, out = 1, []
    for _ in range(400):
        clock.tick(1.0)
        act = a.observe(float(rng.choice([2.0, 60.0, 500.0, 800.0])),
                        live, False)
        live += {"up": 1, "down": -1}.get(act[0], 0)
        out.append(act)
    return out


TRACES = {  # name: (trace, scaler knobs), as tests/test_fleet.py:66-169
    "sustained_breach": (_trace_up, {}),
    "none_is_breach": (_trace_none, {}),
    "cooldown": (_trace_cooldown, {"cooldown_s": 10.0}),
    "sustained_idle": (_trace_down, {"cooldown_s": 0.0}),
    "dead_band": (_trace_dead_band, {"cooldown_s": 0.0}),
    "flapping": (_trace_flapping, {"cooldown_s": 1.0}),
    "clamps": (_trace_clamps, {"min_replicas": 2, "max_replicas": 3,
                               "cooldown_s": 0.0}),
    "seeded": (_trace_seeded, {"cooldown_s": 5.0}),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_autoscaler_trace_equals_jax(name):
    trace, knobs = TRACES[name]
    got = {}
    for pkg, fl in (("jax", jfleet), ("port", tfleet)):
        clock = _Clock()
        cfg = dict(up_after_s=2.0, down_after_s=5.0, cooldown_s=10.0,
                   min_replicas=1, max_replicas=4, idle_fraction=0.1,
                   clock=clock)
        cfg.update(knobs)
        a = fl.Autoscaler(100.0, **cfg)
        got[pkg] = trace(a, clock) + [a.streaks(),
                                      a.cooldown_remaining_s()]
    assert got["port"] == got["jax"]
    actions = [x[0] for x in got["port"][:-2] if isinstance(x[0], str)]
    if name in ("sustained_breach", "none_is_breach", "cooldown",
                "dead_band", "seeded"):
        assert "up" in actions
    if name == "flapping":
        assert actions == []


def test_autoscaler_budget_is_checked_like_jax():
    for fl, err in ((jfleet, jmx.base.MXNetError), (tfleet, tmx.MXNetError)):
        with pytest.raises(err, match="budget"):
            fl.Autoscaler(100.0, up_after_s=1, down_after_s=1,
                          cooldown_s=1, min_replicas=3, max_replicas=2)


# -- the manager over in-process hosts, one loop pass at a time --------------

class _OneTick:
    """Stands in for a manager's ``_closed`` event: a control loop runs
    exactly one pass."""

    def __init__(self):
        self.calls = 0

    def wait(self, timeout=None):
        self.calls += 1
        return self.calls > 1

    def is_set(self):
        return False

    def set(self):
        pass


def _tick(fm, clock, dt):
    """Advance the clock, then one pass of every host's prober, the watch
    loop and the placer, in that order."""
    clock.tick(dt)
    for hs in list(fm._hosts.values()):
        fm._closed = _OneTick()
        fm._probe_loop(hs)
    for loop in (fm._watch_loop, fm._place_loop):
        fm._closed = _OneTick()
        loop()
    fm._closed = threading.Event()


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    sym = tmx.subgraph.partition_graph(_mlp(tmx), "TPU_PALLAS")
    rng = np.random.RandomState(0)
    params = {"fc0_weight": rng.normal(0, .5, (16, 6)).astype("f4"),
              "fc0_bias": np.zeros(16, "f4"),
              "head_weight": rng.normal(0, .5, (3, 16)).astype("f4"),
              "head_bias": np.zeros(3, "f4")}
    args, _ = params_from_numpy(params, None, ctx=tmx.cpu())
    path = str(tmp_path_factory.mktemp("fleet") / "mlp")
    tmx.save_checkpoint(path, 0, sym, args, {})
    return path


def _mlp(pkg):
    s = pkg.sym
    x = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=16,
                                      name="fc0"), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=3, name="head"),
                           name="softmax")


def _manager(pkg_name, prefix, n_hosts, fail_spawn_on=(), **kw):
    mx, fl, local, router_cls, _ = PKGS[pkg_name]

    def spawn(spec, replica_id):
        return local(mx.serving.ServedModel.load(
            prefix, 0, data_shapes=SHAPES, buckets=BUCKETS, ctx=mx.cpu(),
            name=spec.name), replica_id=replica_id)

    def failing(spec, replica_id):
        raise mx.base.MXNetError("host cannot spawn") if pkg_name == "jax" \
            else tmx.MXNetError("host cannot spawn")

    hosts = [fl.InProcessHost(f"host-{i}", failing
                              if f"host-{i}" in fail_spawn_on else spawn)
             for i in range(n_hosts)]
    clock = _Clock(100.0)
    cfg = dict(target_replicas=2, min_replicas=1, max_replicas=4,
               slo_ms=50.0, tick_s=0.05, up_after_s=0.2, down_after_s=0.4,
               cooldown_s=0.3, host_heartbeat_s=0.1, host_deadline_s=0.6)
    cfg.update(kw)
    spec = fl.ReplicaSpec(data_shapes=SHAPES, name="m", buckets=BUCKETS)
    router = router_cls(name=f"fleet-{pkg_name}", health_interval_s=1e6)
    fm = fl.FleetManager(hosts, spec, router=router, clock=clock,
                         start=False, **cfg)
    fm._reconcile("initial placement")
    return fm, hosts, clock


EVENT_KEYS = ("action", "host", "replica", "reason", "t", "target",
              "latency_s", "replicas")


def _summary(fm):
    st = fm.stats()
    return {"events": [{k: e[k] for k in EVENT_KEYS if k in e}
                       for e in st["events"]],
            "placement": st["placement"], "target": st["target"],
            "live": st["live_replicas"],
            **{k: st[k] for k in ("scale_ups", "scale_downs", "hosts_lost",
                                  "backfills", "spawn_failures",
                                  "backfill_latency_s")},
            "hosts": {h: {k: v[k] for k in ("alive", "replicas",
                                             "spawn_breaker")}
                      for h, v in st["hosts"].items()}}


def _anti_affinity(pkg, prefix):
    fm, hosts, clock = _manager(pkg, prefix, 3, target_replicas=3,
                                max_replicas=6)
    _tick(fm, clock, 0.1)
    return fm


def _host_down_backfill_rejoin(pkg, prefix):
    fm, hosts, clock = _manager(pkg, prefix, 2, target_replicas=4,
                                min_replicas=4, max_replicas=6,
                                down_after_s=60.0)
    _tick(fm, clock, 0.1)
    hosts[1].fail()
    for _ in range(8):
        _tick(fm, clock, 0.1)
    hosts[1].recover()
    _tick(fm, clock, 0.1)
    return fm


def _scale_up_mid_backfill(pkg, prefix):
    fm, hosts, clock = _manager(pkg, prefix, 2, target_replicas=4,
                                min_replicas=4, max_replicas=6,
                                down_after_s=600.0)
    fm.router.estimated_wait_s = lambda: 10.0
    fm.autoscaler._breach_since = clock() - 100.0
    fm.autoscaler._cooldown_until = 0.0
    live = sorted(fm._live_replicas())
    for rid in live[:2]:
        fm.router.remove_replica(rid, drain=False)
        with fm._lock:
            fm._placement.pop(rid, None)
    fm._autoscale_tick()
    assert fm.target >= 4
    _tick(fm, clock, 0.1)
    return fm


def _spawn_breaker(pkg, prefix):
    fm, hosts, clock = _manager(pkg, prefix, 2, fail_spawn_on=("host-0",),
                                target_replicas=2, min_replicas=2,
                                down_after_s=60.0)
    _tick(fm, clock, 0.1)
    return fm


def _spawn_fault_site(pkg, prefix):
    PKGS[pkg][4].configure("seed=51;fleet.spawn:error(at=1-2)")
    fm, hosts, clock = _manager(pkg, prefix, 2, target_replicas=2,
                                min_replicas=2, down_after_s=60.0)
    _tick(fm, clock, 0.1)
    PKGS[pkg][4].clear()
    return fm


def _autoscale_up_down(pkg, prefix):
    fm, hosts, clock = _manager(pkg, prefix, 2, target_replicas=1,
                                min_replicas=1, max_replicas=3,
                                up_after_s=0.15, down_after_s=0.3,
                                cooldown_s=0.1)
    wait = [1.0]     # 1000 ms against a 50 ms SLO
    fm.router.estimated_wait_s = lambda: wait[0]
    for _ in range(10):
        _tick(fm, clock, 0.1)
    assert len(fm._live_replicas()) == 3
    wait[0] = 0.0
    for _ in range(12):
        _tick(fm, clock, 0.1)
    assert len(fm._live_replicas()) == 1
    return fm


SCENARIOS = {"anti_affinity": _anti_affinity,
             "host_down_backfill_rejoin": _host_down_backfill_rejoin,
             "scale_up_never_lowers_target_mid_backfill":
                 _scale_up_mid_backfill,
             "spawn_breaker_skips_broken_host": _spawn_breaker,
             "spawn_fault_site": _spawn_fault_site,
             "autoscaler_drives_fleet_up_and_down": _autoscale_up_down}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_manager_equals_jax(name, prefix):
    got = {}
    for pkg in ("jax", "port"):
        fm = SCENARIOS[name](pkg, prefix)
        try:
            got[pkg] = _summary(fm)
            x = np.ones((1, 6), "f4")
            got[pkg]["answer"] = fm.router.predict(
                {"data": x}, timeout_ms=10000)[0].asnumpy()
        finally:
            fm.shutdown(drain=False)
            fm.router.shutdown(drain=False)
    port, jax = got["port"], got["jax"]
    np.testing.assert_allclose(port.pop("answer"), jax.pop("answer"),
                               rtol=1e-5, atol=1e-6)
    assert port == jax
    actions = [e["action"] for e in port["events"]]
    if name == "anti_affinity":
        assert sorted(port["placement"].values()) == \
            ["host-0", "host-1", "host-2"]
    elif name == "host_down_backfill_rejoin":
        assert port["hosts_lost"] == 1 and port["backfills"] == 1
        assert set(port["placement"].values()) == {"host-0"}
        assert port["live"] == 4
        assert actions.index("host_down") < actions.index(
            "backfill_complete") < actions.index("host_rejoined")
    elif name == "spawn_breaker_skips_broken_host":
        assert set(port["placement"].values()) == {"host-1"}
        assert port["hosts"]["host-0"]["spawn_breaker"] == "open"
    elif name == "spawn_fault_site":
        assert port["spawn_failures"] == 2 and port["live"] == 2
    elif name == "autoscaler_drives_fleet_up_and_down":
        assert port["scale_ups"] == 3 and port["scale_downs"] == 2


# -- the wire, the daemon, the launcher ---------------------------------------

def test_replica_spec_wire_roundtrip_across_packages():
    kw = dict(data_shapes=[("data", (1, 6)), ("mask", (1, 3))], name="m",
              prefix="/tmp/m", epoch=3, buckets=(1, 4), env={"A": "1"},
              concurrency=3)
    port, jax = ReplicaSpec(**kw), jfleet.ReplicaSpec(**kw)
    assert port.to_msg() == jax.to_msg()
    assert jfleet.ReplicaSpec.from_msg(port.to_msg()).to_msg() == \
        jax.to_msg()
    back = ReplicaSpec.from_msg(jax.to_msg())
    assert back.to_msg() == port.to_msg()
    assert back.data_shapes == port.data_shapes and back.buckets == (1, 4)


def test_hostd_spawn_is_idempotent_by_rid(monkeypatch):
    from incubator_mxnet_tpu_torch.serving import hostd, replica

    class _Proc:
        def __init__(self, pid):
            self.pid = pid

        def poll(self):
            return None

    launches = []

    def fake_launch_worker(cmd, **kw):
        launches.append(cmd)
        return _Proc(1000 + len(launches)), 9000 + len(launches), \
            {"builds": 0}

    monkeypatch.setattr(replica, "launch_worker", fake_launch_worker)
    daemon = hostd.HostDaemon("host-x", ctx="cpu")
    try:
        spec = ReplicaSpec(data_shapes=SHAPES, name="m")
        msg = {"cmd": "spawn", "spec": spec.to_msg(), "replica_id": "r1"}
        first = daemon._handle(dict(msg))
        resend = daemon._handle(dict(msg))
        assert first["port"] == resend["port"] == 9001
        assert first["pid"] == resend["pid"] and len(launches) == 1
        assert launches[0][launches[0].index("--ctx") + 1] == "cpu"
        other = daemon._handle({"cmd": "spawn", "spec": spec.to_msg(),
                                "replica_id": "r2"})
        assert other["port"] == 9002 and len(launches) == 2
        metrics = daemon._handle({"cmd": "metrics", "seq": 5})
        assert metrics["ok"] and metrics["seq"] == 5
        assert metrics["values"]["hostd.spawns"] == 2
    finally:
        daemon._server.server_close()


def test_launch_worker_kills_silent_child_at_deadline():
    from incubator_mxnet_tpu_torch.serving.replica import launch_worker
    t0 = time.monotonic()
    with pytest.raises(tmx.MXNetError, match="readiness handshake"):
        launch_worker([sys.executable, "-c", "import time; time.sleep(600)"],
                      name="wedged", ready_timeout=1.0)
    assert time.monotonic() - t0 < 30.0


def test_agent_host_connect_by_endpoint():
    from incubator_mxnet_tpu_torch.dist.transport import parse_endpoint
    from incubator_mxnet_tpu.dist.transport import parse_endpoint as jparse
    from incubator_mxnet_tpu_torch.serving.hostd import HostDaemon
    for spec in ("10.0.0.1:9000", ":9000", "9000"):
        assert parse_endpoint(spec) == jparse(spec)
    with pytest.raises(ValueError):
        parse_endpoint("nonsense")
    daemon = HostDaemon("host-x").start()
    try:
        for ep in (f"127.0.0.1:{daemon.port}", str(daemon.port)):
            agent = tfleet.AgentHost.connect("host-x", ep)
            hb = agent.heartbeat()
            assert hb["host_id"] == "host-x" and hb["workers"] == 0
            # the channels only: close() would stop the daemon, which
            # exits its process (this one)
            agent._control.close()
            agent._spawn_chan.close()
    finally:
        daemon.shutdown()


def test_fleet_findings_name_cold_spinups():
    tfleet._note_event("f", "scale_up", host="h", replica="r",
                       spinup_builds=2)
    tfleet._note_event("f", "host_down", host="h", reason="silence",
                       replicas=1)
    codes = [(f.code, f.severity) for f in tfleet.findings()]
    assert codes == [("cold-spinup", "warn"), ("host-lost", "warn"),
                     ("summary", "hint")]
    assert "built 2 kernel" in tfleet.findings()[0].message


def test_hostd_processes_host_kill_backfill(prefix, monkeypatch):
    """Two host daemons (``--ctx cpu``), one worker each; SIGKILLing one
    host's process group mid-traffic: the host is declared dead, its
    replica fails over, the survivor backfills with ``builds=0``, and
    no admitted request is lost."""
    monkeypatch.setenv("MXNET_PS_RECONNECT_WAIT", "0.2")
    hosts = [None, None]

    def launch(i):
        hosts[i] = tfleet.AgentHost.launch_local(f"host-{i}", ctx="cpu")

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fm = None
    try:
        assert all(hosts)
        spec = ReplicaSpec(data_shapes=SHAPES, name="m", prefix=prefix,
                           buckets=BUCKETS)
        fm = tfleet.FleetManager(hosts, spec, target_replicas=2,
                                 min_replicas=2, max_replicas=3, slo_ms=1e4,
                                 tick_s=0.1, up_after_s=60.0,
                                 down_after_s=60.0, cooldown_s=0.5,
                                 host_heartbeat_s=0.2, host_deadline_s=1.5)
        assert sorted(fm.stats()["placement"].values()) == \
            ["host-0", "host-1"]
        x = np.ones((2, 6), "f4")
        errors, results = [], []
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                try:
                    results.append(fm.router.predict({"data": x},
                                                     timeout_ms=30000))
                except Exception as exc:
                    errors.append(repr(exc))

        clients = [threading.Thread(target=traffic) for _ in range(2)]
        for t in clients:
            t.start()
        time.sleep(0.3)
        hosts[1].kill()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and fm.stats()["backfills"] < 1:
            time.sleep(0.1)
        stop.set()
        for t in clients:
            t.join()
        st = fm.stats()
        assert not errors, errors[:3]
        assert results and st["hosts_lost"] == 1 and st["backfills"] == 1
        assert set(st["placement"].values()) == {"host-0"}
        ups = [e for e in st["events"] if e["action"] == "scale_up"]
        assert len(ups) == 3 and all(e["spinup_builds"] == 0 for e in ups)
        assert hosts[1].process.wait(10) == -signal.SIGKILL
    finally:
        if fm is not None:
            fm.shutdown(drain=False, close_hosts=True)
        for h in hosts:
            if h is not None:
                try:
                    os.killpg(h.process.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
