"""The elastic supervisor of the PyTorch port (`resilience.supervisor`,
`dist.collective`, `dist.pod_worker`) against the JAX package on the
CPU, case for case with tests/test_supervisor.py (its
``analysis.runtime_report`` reads become `supervisor.findings()`, its
mesh rebuild and mxlint cases wait for 14-parallel and 14-analysis).

Scripted cases feed both packages the same clock, views and calls and
hold their answers equal: membership liveness and the epoch fence, the
shrink barrier (dense re-rank, replay, a second shrink, the deadline
with and without a quorum), straggler findings, the structured
`CollectiveTimeoutError`.  The port alone, in real processes: the
epoch-fenced pull, the watchdog's pass-through, relay and timeout, the
injected ``collective.dispatch`` hang, a fenced supervisor, `stats()`
with the store's counters, the faults log's pid and rank, a killed
worker detected within the heartbeat deadline with its stalled round
raised, a torch process group re-formed at a smaller world on the next
epoch's port, and the pod gate: 3 workers fitting, one SIGKILLed at its
4th step, the survivors shrink to world 2 and resume, their parameters
sha256-equal to a 2-worker run resumed from the same checkpoint.
Every server binds port 0; clocks are scaled down (``fast_pod``).
"""
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from incubator_mxnet_tpu.dist.membership import \
    MembershipTable as JMembershipTable
from incubator_mxnet_tpu.resilience import supervisor as jsupmod

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import resilience
from incubator_mxnet_tpu_torch.dist.membership import MembershipTable
from incubator_mxnet_tpu_torch.resilience import (CollectiveTimeoutError,
                                                  JobSupervisor,
                                                  StaleEpochError)
from incubator_mxnet_tpu_torch.resilience import supervisor as supmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120
_ENV_KEYS = ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_RANK",
             "DMLC_NUM_WORKER", "DMLC_NUM_SERVER", "DMLC_ROLE",
             "MXNET_KVSTORE_COLLECTIVE", "MXNET_FAULTS",
             "MXNET_SUPERVISOR_EPOCH")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MXNET_PS_REQUEST_TIMEOUT", "60")
    monkeypatch.setenv("MXNET_PS_CONNECT_WAIT", "30")
    resilience.clear()
    supmod.reset_findings()
    supmod.deactivate()
    yield
    resilience.clear()
    supmod.reset_findings()
    supmod.deactivate()


@pytest.fixture()
def fast_pod(monkeypatch):
    """Pod clocks scaled for CI: death in ~0.6 s, the watchdog in 2 s."""
    monkeypatch.setenv("MXNET_SUPERVISOR_HEARTBEAT_S", "0.1")
    monkeypatch.setenv("MXNET_SUPERVISOR_DEADLINE_S", "0.6")
    monkeypatch.setenv("MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S", "2.0")
    monkeypatch.setenv("MXNET_SUPERVISOR_SHRINK_BARRIER_S", "8.0")


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _ENV_KEYS}
    env.update(PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), MXNET_PS_REQUEST_TIMEOUT="60",
        MXNET_PS_CONNECT_WAIT="30", **extra)
    return env


def _tick(t, n=100, dt=0.1):
    """A thread advancing the scripted clock `t` while a barrier waits."""
    def run():
        for _ in range(n):
            time.sleep(0.01)
            t[0] += dt
    th = threading.Thread(target=run)
    th.start()
    return th


# -- membership: liveness, deadline, epoch fence ------------------------------

def _membership_script(cls):
    t = [0.0]
    mt = cls(3, deadline_s=1.0, clock=lambda: t[0])
    first = [mt.heartbeat(r, 0, step=1, step_time=0.01) for r in range(3)]
    t[0] += 0.5
    mt.heartbeat(0, 0)
    mt.heartbeat(2, 0)
    t[0] += 0.6          # rank 1 now 1.1 s silent; 0 and 2 only 0.6 s
    view = mt.view()
    stale = mt.heartbeat(1, -1)
    return first, view, stale


def test_membership_liveness_and_epoch_fence():
    first, view, stale = _membership_script(MembershipTable)
    assert all(r["ok"] for r in first)
    assert first[-1]["view"]["alive"] == [0, 1, 2]
    assert view["dead"] == [1] and view["alive"] == [0, 2]
    assert view["age"][1] > 1.0
    assert "stale epoch" in stale["error"]
    assert view["steps"][0] >= 1 and view["ewma"][1] == 0.01
    # the JAX table answers the same script with the same views
    assert (first, view, stale) == _membership_script(JMembershipTable)


def _barrier_script(cls):
    t = [0.0]
    mt = cls(3, deadline_s=1.0, clock=lambda: t[0])
    for r in range(3):
        mt.heartbeat(r, 0)
    t[0] += 2.0
    mt.heartbeat(0, 0)
    mt.heartbeat(2, 0)       # rank 1 is dead
    committed, results = [], {}

    def propose(rank):
        results[rank] = mt.propose_shrink(rank, 0, deadline_s=5.0,
                                          on_commit=committed.append)
    th = threading.Thread(target=propose, args=(2,))
    th.start()
    propose(0)
    th.join(timeout=10)
    assert not th.is_alive()
    replay = mt.propose_shrink(2, 0, deadline_s=1.0)
    late = mt.propose_shrink(1, 0, deadline_s=1.0)
    old_hb = mt.heartbeat(0, 0)
    new_hb = mt.heartbeat(0, 1)
    return results, len(committed), replay, late, old_hb, new_hb


def test_shrink_barrier_commits_reranks_and_fences():
    results, commits, replay, late, old_hb, new_hb = \
        _barrier_script(MembershipTable)
    res = results[0]
    assert res == results[2]
    assert res["epoch"] == 1 and res["world_size"] == 2
    assert res["survivors"] == [0, 2]
    assert res["rank_map"] == {0: 0, 2: 1}
    assert commits == 1
    assert replay["epoch"] == 1
    assert "stale epoch" in late.get("error", "")
    assert "stale epoch" in old_hb["error"] and new_hb["ok"]
    jres = _barrier_script(JMembershipTable)
    assert jres[0][0] == res and jres[1] == commits
    assert jres[2]["epoch"] == replay["epoch"]


def test_second_shrink_commits_a_new_epoch():
    """The pod survives a second host loss: the next barrier commits a
    fresh epoch, not a replay of the first shrink."""
    t = [0.0]
    mt = MembershipTable(3, deadline_s=1.0, clock=lambda: t[0])
    for r in range(3):
        mt.heartbeat(r, 0)
    t[0] += 2.0
    mt.heartbeat(0, 0)
    mt.heartbeat(1, 0)       # rank 2 dead -> shrink 1 to world 2
    results = {}

    def propose(rank, epoch):
        results[rank] = mt.propose_shrink(rank, epoch, deadline_s=5.0)
    th = threading.Thread(target=propose, args=(1, 0))
    th.start()
    propose(0, 0)
    th.join(timeout=10)
    assert results[0]["epoch"] == 1 and results[0]["world_size"] == 2
    mt.heartbeat(0, 1)
    mt.heartbeat(1, 1)
    t[0] += 2.0
    mt.heartbeat(0, 1)       # new rank 1 dead -> shrink 2 to world 1
    tick = _tick(t)
    res2 = mt.propose_shrink(0, 1, deadline_s=0.5)
    tick.join()
    assert "error" not in res2, res2
    assert res2["epoch"] == 2, "second shrink replayed the first commit"
    assert res2["world_size"] == 1 and res2["survivors"] == [0]


@pytest.mark.parametrize("cls", [MembershipTable, JMembershipTable],
                         ids=["port", "jax"])
def test_shrink_barrier_deadline_needs_quorum(cls):
    """At the deadline the barrier commits only on a strict majority of
    the hosts still alive: one misfiring watchdog cannot shrink a
    healthy pod down to itself."""
    t = [0.0]
    mt = cls(2, deadline_s=10.0, clock=lambda: t[0])
    mt.heartbeat(0, 0)
    mt.heartbeat(1, 0)       # alive, healthy, never proposes
    tick = _tick(t)
    res = mt.propose_shrink(0, 0, deadline_s=0.5)
    tick.join()
    assert "quorum" in res["error"]
    assert mt.epoch == 0


def test_shrink_barrier_deadline_commits_with_majority():
    """A proposer majority at the deadline commits without the host that
    heartbeats but never proposes, which is then fenced out."""
    t = [0.0]
    mt = MembershipTable(4, deadline_s=10.0, clock=lambda: t[0])
    for r in range(4):
        mt.heartbeat(r, 0)
    results = {}

    def propose(rank):
        results[rank] = mt.propose_shrink(rank, 0, deadline_s=0.5)
    threads = [threading.Thread(target=propose, args=(r,))
               for r in (0, 1, 2)]
    for th in threads:
        th.start()
    tick = _tick(t)
    for th in threads:
        th.join(timeout=15)
        assert not th.is_alive()
    tick.join()
    assert results[0]["survivors"] == [0, 1, 2]
    assert results[0]["world_size"] == 3
    assert "stale epoch" in mt.propose_shrink(3, 0, 0.5).get("error", "")


def test_epoch_fenced_pull_raises_recoverable_signal(monkeypatch):
    """A pull waiting on the server when a shrink commits is released
    with the epoch-fence error, which surfaces as CollectiveTimeoutError
    (the signal fit shrinks on), not as a generic MXNetError."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    nd, c = tmx.nd, tmx.cpu()
    srv = ParameterServer(num_workers=2).start()
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1",
                 "DMLC_PS_ROOT_PORT": str(srv.port), "DMLC_RANK": "0",
                 "DMLC_NUM_WORKER": "2",
                 "MXNET_KVSTORE_COLLECTIVE": "0"}.items():
        monkeypatch.setenv(k, v)
    kv = KVStoreDist("dist_sync")
    try:
        srv._state.store["w"] = np.zeros(4, "f4")
        srv._state.version["w"] = 0
        kv._store["w"] = nd.zeros((4,), ctx=c)
        kv.push("w", nd.ones((4,), ctx=c))   # the round needs 2 workers

        def commit_soon():
            time.sleep(0.3)
            srv._reset_world({"epoch": 1, "world_size": 1})
        th = threading.Thread(target=commit_soon)
        th.start()
        with pytest.raises(CollectiveTimeoutError, match="epoch fenced"):
            kv.pull("w", out=nd.zeros((4,), ctx=c))
        th.join()
    finally:
        kv.close(send_stop=False)
        srv.shutdown()


# -- dist.collective: shutdown and re-init ------------------------------------

def test_collective_returns_group_tuple_and_reinitializes():
    from incubator_mxnet_tpu.dist import collective as jcollective
    from incubator_mxnet_tpu_torch.dist import collective
    collective.shutdown()
    g = collective.init_process_group(num_processes=1, process_id=0)
    assert g == (g[0], 1, 0) and isinstance(g[0], str)
    assert collective.initialized() and collective.group() == g
    assert collective.init_process_group(num_processes=1) == g
    collective.shutdown()
    assert not collective.initialized() and collective.group() is None
    g2 = collective.init_process_group(
        coordinator="127.0.0.1:7777", num_processes=1, process_id=0)
    assert g2 == ("127.0.0.1:7777", 1, 0)
    collective.shutdown()
    assert collective.finalize is collective.shutdown
    # the JAX package joins the same tuple
    jcollective.shutdown()
    assert jcollective.init_process_group(
        coordinator="127.0.0.1:7777", num_processes=1, process_id=0) == g2
    jcollective.shutdown()


REFORM_WORKER = r"""
import os, sys, time
import torch
from incubator_mxnet_tpu_torch.dist import collective
rank, port = int(sys.argv[1]), int(sys.argv[2])
os.environ["DMLC_PS_ROOT_PORT"] = str(port)
g = collective.init_process_group(num_processes=3, process_id=rank,
                                  timeout=30)
assert g == ("127.0.0.1:%d" % (port + 1), 3, rank), g
assert collective.backend() == "gloo"
x = torch.full((4,), float(rank + 1))
collective.process_group().allreduce([x]).wait()
assert x.tolist() == [6.0] * 4, x
if rank == 2:
    os._exit(137)           # the lost host
time.sleep(0.3)
collective.shutdown()       # must not wait on the dead peer
os.environ["MXNET_SUPERVISOR_EPOCH"] = "1"
g = collective.init_process_group(num_processes=2, process_id=rank,
                                  timeout=30)
assert g == ("127.0.0.1:%d" % (port + 2), 2, rank), g
y = torch.full((3,), float(rank + 1))
collective.process_group().allreduce([y]).wait()
assert y.tolist() == [3.0] * 3, y
print("worker %d OK" % rank, flush=True)
"""


def test_collective_group_reforms_at_a_smaller_world(tmp_path):
    """Three ranks form a gloo group and all-reduce; rank 2 dies; the
    survivors forget the group without waiting on it and re-form at
    world 2 on the next epoch's port (DMLC_PS_ROOT_PORT + 1 + epoch)."""
    import socket
    script = tmp_path / "reform.py"
    script.write_text(REFORM_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(port)], env=_child_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(3)]
    outs = [p.communicate(timeout=CHILD_TIMEOUT)[0].decode() for p in procs]
    assert procs[2].returncode == 137, outs[2]
    for r in (0, 1):
        assert procs[r].returncode == 0, outs[r]
        assert f"worker {r} OK" in outs[r]


# -- the watchdog -------------------------------------------------------------

def test_watchdog_passthrough_error_relay_and_timeout(fast_pod):
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    srv = ParameterServer(num_workers=2).start()
    s0 = JobSupervisor(0, 2, host="127.0.0.1", port=srv.port).start()
    s1 = JobSupervisor(1, 2, host="127.0.0.1", port=srv.port).start()
    try:
        assert s0.collective("noop", lambda: 41 + 1) == 42
        with pytest.raises(ValueError, match="boom"):
            s0.collective("err", lambda: (_ for _ in ()).throw(
                ValueError("boom")))
        s1.stop()            # host 1 stops heartbeating
        t0 = time.monotonic()
        while 1 not in (s0.view() or {}).get("dead", ()):
            assert time.monotonic() - t0 < 3.0, \
                "host death not detected within the deadline"
            time.sleep(0.05)
        s0.record_step(0.01)
        with pytest.raises(CollectiveTimeoutError,
                           match=r"kvstore\.pull.*host\(s\) \[1\] failed "
                                 r"to arrive") as err:
            s0.collective("kvstore.pull", lambda: time.sleep(60),
                          axis="workers", timeout=0.4)
        assert err.value.absent == [1]
        assert err.value.collective == "kvstore.pull"
        assert err.value.axis == "workers"
        stats = s0.stats()
        assert stats["collective_timeouts"] == 1
        assert stats["hosts_lost"] == 1
        lost = [f for f in supmod.findings() if f.code == "host-lost"]
        assert len(lost) == 1 and lost[0].node == "rank1"
        # the JAX error for the same stall reads the same
        jerr = jsupmod.CollectiveTimeoutError(
            "kvstore.pull", axis="workers", timeout_s=0.4, absent=[1],
            detail=str(err.value).split("failed to arrive (")[1]
            .split(")")[0])
        assert str(jerr) == str(err.value)
    finally:
        s0.stop()
        s1.stop()
        srv.shutdown()


def test_injected_hang_fault_trips_the_watchdog(fast_pod):
    """The collective.dispatch:hang site stalls inside the dispatched
    collective, and the watchdog converts it; the next one runs."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    resilience.inject("collective.dispatch", "hang", at=1)
    srv = ParameterServer(num_workers=1).start()
    sup = JobSupervisor(0, 1, host="127.0.0.1", port=srv.port).start()
    try:
        with pytest.raises(CollectiveTimeoutError, match="allreduce"):
            sup.collective("allreduce", lambda: 1, timeout=0.3)
        assert [e["kind"] for e in resilience.trace()
                if e["event"] == "fault"] == ["hang"]
        assert sup.collective("allreduce", lambda: 7, timeout=5.0) == 7
    finally:
        sup.stop()
        srv.shutdown()


def test_fenced_supervisor_refuses_collectives():
    sup = JobSupervisor(0, 2, host="127.0.0.1", port=1)   # never started
    sup._fenced = True
    with pytest.raises(StaleEpochError, match="fenced"):
        sup.collective("x", lambda: 1)


# -- stragglers ----------------------------------------------------------------

def test_straggler_findings_match_jax(monkeypatch):
    views = [{"epoch": 0, "alive": [0, 1, 2, 3], "dead": [], "age": {},
              "steps": {}, "ewma": {0: 0.100, 1: 0.101, 2: 0.099,
                                    3: 0.400}},
             {"epoch": 0, "alive": [0, 1, 2, 3], "dead": [], "age": {},
              "steps": {}, "ewma": {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.5}}]
    sup = JobSupervisor(0, 4, host="127.0.0.1", port=1, straggler_k=2.0)
    sup._on_view(views[0])
    assert sup.stats()["stragglers_flagged"] == 1
    strag = [f for f in supmod.findings() if f.code == "straggler-host"]
    assert len(strag) == 1 and "rank 3" in strag[0].message
    assert "sigma" in strag[0].message
    sup._stragglers.clear()
    sup._on_view(views[1])
    strag = [f for f in supmod.findings() if f.code == "straggler-host"]
    assert len(strag) == 1 and strag[0].count == 2
    sup2 = JobSupervisor(0, 4, host="127.0.0.1", port=1)
    sup2._on_view({"epoch": 0, "alive": [0, 1], "dead": [], "age": {},
                   "steps": {}, "ewma": {0: 0.1, 1: 0.100001}})
    assert sup2.stats()["stragglers_flagged"] == 0
    # the JAX supervisor flags the same host with the same words
    monkeypatch.setattr(jsupmod, "_add_finding",
                        lambda code, message, key: seen.append(
                            (code, message, key)))
    seen = []
    jsup = jsupmod.JobSupervisor(0, 4, host="127.0.0.1", port=1,
                                 straggler_k=2.0)
    jsup._on_view(views[0])
    assert seen == [("straggler-host", strag[0].message, "rank3")]


# -- stats, the faults log ---------------------------------------------------

def test_stats_exports_kvstore_retry_breaker_counters(monkeypatch):
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    srv = ParameterServer(num_workers=1).start()
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1",
                 "DMLC_PS_ROOT_PORT": str(srv.port), "DMLC_RANK": "0",
                 "DMLC_NUM_WORKER": "1",
                 "MXNET_KVSTORE_COLLECTIVE": "0"}.items():
        monkeypatch.setenv(k, v)
    kv = KVStoreDist("dist_sync")
    try:
        kv.init("w", tmx.nd.ones((4,), ctx=tmx.cpu()))
        ks = kv.stats()
        assert ks["resends"] == 0 and ks["discarded_stale"] == 0
        assert ks["breakers"][0]["state"] == "closed"
        assert ks["breakers"][0]["server"] == 0
        sup = JobSupervisor.for_kvstore(kv)
        stats = sup.stats()
        assert stats["kvstore"]["breakers"][0]["state"] == "closed"
        assert stats["rank"] == 0 and stats["world_size"] == 1
        assert sup.port == srv.port
    finally:
        kv.close()
        srv.shutdown()


def test_faults_log_carries_rank_pid_and_is_line_atomic(tmp_path,
                                                        monkeypatch):
    log = tmp_path / "faults.jsonl"
    monkeypatch.setenv("DMLC_RANK", "3")
    monkeypatch.setenv("MXNET_FAULTS_LOG", str(log))
    resilience.configure("demo.site:slow(ms=0,n=64)")
    from incubator_mxnet_tpu_torch.resilience import faults as _faults
    monkeypatch.setattr(_faults, "_log_path", str(log))
    threads = [threading.Thread(
        target=lambda: [resilience.fire("demo.site") for _ in range(8)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = log.read_text().strip().splitlines()
    assert len(lines) == 32
    for line in lines:
        event = json.loads(line)
        assert event["rank"] == 3
        assert event["pid"] == os.getpid()
        assert event["site"] == "demo.site"


# -- in real processes ------------------------------------------------------------

MEMBER_WORKER = r"""
import os, time
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.resilience import (CollectiveTimeoutError,
                                                  JobSupervisor)
from incubator_mxnet_tpu_torch.resilience import supervisor as supmod

c = mx.cpu()
rank = int(os.environ["DMLC_RANK"])
kv = mx.kv.create("dist_sync")
sup = JobSupervisor.for_kvstore(kv).start()
supmod.activate(sup)
kv.init("w", nd.zeros((4,), ctx=c))
kv.push("w", nd.ones((4,), ctx=c))
out = nd.zeros((4,), ctx=c)
kv.pull("w", out=out)
assert out.asnumpy()[0] == kv.num_workers
if rank == 1:
    os._exit(137)           # the SIGKILLed host
t0 = time.monotonic()
deadline = float(os.environ["MXNET_SUPERVISOR_DEADLINE_S"])
while 1 not in (sup.view() or {}).get("dead", ()):
    assert time.monotonic() - t0 < deadline + 2.0, "death not detected"
    time.sleep(0.05)
print("DETECTED %.3f" % (time.monotonic() - t0))
sup.record_step(0.01)
kv.push("w", nd.ones((4,), ctx=c))
try:
    kv.pull("w", out=out)
    print("NO_TIMEOUT")
except CollectiveTimeoutError as e:
    assert e.absent == [1], e.absent
    assert e.collective == "kvstore.pull"
    print("TIMEOUT_OK " + str(e)[:120])
sup.stop()
kv.close(send_stop=False)
print("worker %d OK" % rank)
"""


def test_killed_worker_detected_and_hung_round_raises(tmp_path,
                                                      monkeypatch):
    """Two worker processes; one dies without unwinding: the survivor's
    view marks it dead within the deadline, and its stalled sync round
    raises CollectiveTimeoutError naming the absent host."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    # the coordinator's membership deadline is read in this process
    monkeypatch.setenv("MXNET_SUPERVISOR_DEADLINE_S", "0.8")
    script = tmp_path / "member_worker.py"
    script.write_text(MEMBER_WORKER)
    server = ParameterServer(num_workers=2).start()
    env = _child_env(DMLC_PS_ROOT_URI="127.0.0.1",
                     DMLC_PS_ROOT_PORT=str(server.port),
                     DMLC_NUM_WORKER="2", DMLC_ROLE="worker",
                     MXNET_KVSTORE_COLLECTIVE="0",
                     MXNET_SUPERVISOR_HEARTBEAT_S="0.1",
                     MXNET_SUPERVISOR_DEADLINE_S="0.8",
                     MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S="2.5")
    try:
        procs = [subprocess.Popen([sys.executable, str(script)],
                                  env=dict(env, DMLC_RANK=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, cwd=REPO)
                 for r in range(2)]
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        server.shutdown()
    assert procs[1].returncode == 137
    assert procs[0].returncode == 0, outs[0]
    assert "worker 0 OK" in outs[0]
    m = re.search(r"DETECTED ([\d.]+)", outs[0])
    assert m, outs[0]
    assert float(m.group(1)) <= 0.8 + 2.0
    assert "TIMEOUT_OK" in outs[0] and "NO_TIMEOUT" not in outs[0]
    assert "failed to arrive" in outs[0]


def _run_fit_pod(server_port, n_workers, ckpt_dir, faults_by_rank=None,
                 resume=False):
    """`dist.pod_worker` in `n_workers` processes on the CPU, socket
    plane, the JAX gate's clocks."""
    env = _child_env(DMLC_PS_ROOT_URI="127.0.0.1",
                     DMLC_PS_ROOT_PORT=str(server_port),
                     DMLC_NUM_WORKER=str(n_workers), DMLC_ROLE="worker",
                     MXNET_KVSTORE_COLLECTIVE="0",
                     MXNET_SUPERVISOR_HEARTBEAT_S="0.1",
                     MXNET_SUPERVISOR_DEADLINE_S="0.8",
                     MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S="2.5",
                     MXNET_SUPERVISOR_SHRINK_BARRIER_S="10.0",
                     MXNET_PS_RECONNECT_WAIT="1.0",
                     POD_CKPT_DIR=str(ckpt_dir), POD_DEVICE="cpu",
                     POD_RESUME="1" if resume else "0")
    procs = []
    for r in range(n_workers):
        wenv = dict(env, DMLC_RANK=str(r))
        spec = (faults_by_rank or {}).get(r)
        if spec:
            wenv["MXNET_FAULTS"] = spec
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist."
             "pod_worker"], env=wenv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=REPO))
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def _sha(out):
    m = re.search(r"PARAMS_SHA (\w+)", out)
    return m.group(1) if m else None


def test_pod_kill_shrink_resume_bit_identical(tmp_path, monkeypatch):
    """The pod gate: 3 workers mid-`Module.fit`, rank 2 SIGKILLed at its
    4th step (host.step:kill): the survivors detect it, their stalled
    round raises CollectiveTimeoutError naming [2], they shrink to world
    2 at epoch 1 and resume from the last checkpoint; their parameters
    are sha256-equal to a 2-worker run resumed from that checkpoint."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    # the coordinator's clocks are read in this process
    for k, v in {"MXNET_SUPERVISOR_DEADLINE_S": "0.8",
                 "MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S": "2.5",
                 "MXNET_SUPERVISOR_SHRINK_BARRIER_S": "10.0"}.items():
        monkeypatch.setenv(k, v)
    ckpt = tmp_path / "ckpts"
    server = ParameterServer(num_workers=3).start()
    try:
        procs, outs = _run_fit_pod(
            server.port, 3, ckpt,
            faults_by_rank={2: "seed=22;host.step:kill(at=4)"})
    finally:
        server.shutdown()
    assert procs[2].returncode == 137, outs[2]
    for r in (0, 1):
        assert procs[r].returncode == 0, outs[r]
        assert "worker OK" in outs[r]
        assert "pod shrunk to world_size=2" in outs[r], outs[r]
        assert re.search(r"host\(s\) \[2\] failed to arrive", outs[r])
        assert "COMPILES" not in outs[r]
        lost = json.loads(re.search(r"FINDINGS (.*)", outs[r]).group(1))
        assert [f["node"] for f in lost if f["code"] == "host-lost"] == \
            ["rank2"], outs[r]
    chaos = {_sha(outs[0]), _sha(outs[1])}
    assert len(chaos) == 1 and None not in chaos
    stats = [json.loads(re.search(r"SUPSTATS (.*)", o).group(1))
             for o in outs[:2]]
    assert all(s["epoch"] == 1 and s["world_size"] == 2 for s in stats)
    m = re.search(r"resuming from .*\(step (\d+),", outs[0])
    assert m, outs[0]
    resume_step = int(m.group(1))
    control = tmp_path / "control"
    shutil.copytree(ckpt, control)
    for entry in os.listdir(control):
        cm = re.match(r"ckpt-(\d+)$", entry)
        if cm and int(cm.group(1)) > resume_step:
            shutil.rmtree(control / entry)
    server = ParameterServer(num_workers=2).start()
    try:
        cprocs, couts = _run_fit_pod(server.port, 2, control, resume=True)
    finally:
        server.shutdown()
    for r in (0, 1):
        assert cprocs[r].returncode == 0, couts[r]
    control_shas = {_sha(couts[0]), _sha(couts[1])}
    assert control_shas == chaos, \
        "shrink-and-resume diverged from a clean resume at world 2"
