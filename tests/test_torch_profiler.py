"""The port's `profiler` (over `torch.profiler`) against the JAX
package's on the CPU.

`set_config`/`set_state`/`dump`/`dumps` with the CPU activity: the
chrome trace holds the custom events (Task, Frame, Counter, Marker, the
eager ops' per-op events) and the torch session's own, and `dumps`
gives both tables.  The bounded event buffer drops the same events as
the JAX package's at one cap and one count, and reports them under the
``profiler`` producer.  `record_memory` is ``{}``-safe on the CPU, the
server-side commands travel over the control channel (JAX
`tests/test_dist.py::test_server_profiler_commands`), and the knobs'
defaults are the JAX package's.
"""
import json
import os
import subprocess
import sys

import pytest

from incubator_mxnet_tpu import config as jconfig
from incubator_mxnet_tpu import obs as jobs
from incubator_mxnet_tpu import profiler as jprof

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tconfig
from incubator_mxnet_tpu_torch import profiler as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(prof):
    with prof._lock:
        prof._custom_events.clear()
        prof._dropped[0] = 0
    prof.set_event_cap(None)


@pytest.fixture(autouse=True)
def _clean():
    for prof in (tprof, jprof):
        _reset(prof)
    yield
    if tprof.state() == "run":
        tprof.set_state("stop")
    for prof in (tprof, jprof):
        _reset(prof)
        prof.set_config(filename="profile.json", profile_imperative=False,
                        profile_memory=False, profile_all=False,
                        aggregate_stats=False)
        prof.set_kvstore_handle(None)


def test_session_dump_and_dumps_on_the_cpu(tmp_path):
    """A session with the CPU activity: Task/Frame/Counter/Marker and the
    eager ops land in the dumped chrome trace beside the torch events,
    and `dumps` gives the custom table and the per-op table."""
    out = str(tmp_path / "prof.json")
    tprof.set_config(filename=out, profile_imperative=True)
    assert tprof.state() == "stop"
    tprof.set_state("run")
    assert tprof.state() == "run"
    with tprof.Task("step"):
        a = tmx.nd.ones((8, 8), ctx=tmx.cpu())
        tmx.nd.relu(tmx.nd.dot(a, a)).asnumpy()
    with tprof.Frame("frame"):
        pass
    c = tprof.Counter("queue", value=3)
    c += 2
    c -= 1
    tprof.Marker("mark").mark()
    tprof.set_state("stop")
    tprof.dump()
    trace = json.load(open(out))
    names = [e.get("name") for e in trace["traceEvents"]]
    for want in ("step", "frame", "queue", "mark", "dot", "relu"):
        assert want in names, want
    assert any(e.get("cat") == "operator" and e["name"] == "dot"
               for e in trace["traceEvents"])
    assert any(str(e.get("name", "")).startswith("aten::")
               for e in trace["traceEvents"])       # the torch session's
    assert os.path.exists(str(tmp_path / "prof_trace" / "torch_trace.json"))
    counters = [e["args"]["queue"] for e in trace["traceEvents"]
                if e.get("name") == "queue"]
    assert counters == [3, 5, 4]
    table = tprof.dumps()
    assert table.startswith("Profile Statistics:")
    assert "  step: count=1" in table and "  dot: count=1" in table
    assert "torch.profiler (last session):" in table and "aten::" in table
    tprof.dumps(reset=True)
    assert tprof.buffer_stats()["events"] == 0


def test_pause_resume_and_ops_timed_only_while_running(tmp_path):
    tprof.set_config(filename=str(tmp_path / "p.json"),
                     profile_imperative=True)
    a = tmx.nd.ones((4,), ctx=tmx.cpu())
    (a + 1).asnumpy()
    assert tprof.buffer_stats()["events"] == 0      # not running
    tprof.resume()
    (a + 1).asnumpy()
    tprof.pause()
    (a + 1).asnumpy()
    assert tprof.buffer_stats()["events"] == 1
    assert not tprof.buffer_stats()["running"]


def test_custom_events_match_the_jax_profiler():
    """The same custom objects and hooks give the JAX package's events,
    apart from timestamps and durations (the JAX Task also needs no
    session: neither package's buffer depends on one)."""
    events = {}
    for pkg, prof in (("port", tprof), ("jax", jprof)):
        prof._state["running"] = True        # the hooks' gate alone
        try:
            prof.Counter("c", value=1).increment(2)
            prof.Marker("m").mark(scope="global")
            prof.record_op("opx", 12.5)
            prof.record_serving("serving:m", 100.0, rows=2, bucket=4)
            prof.record_fault("server.dispatch", "error", cmd="push")
            prof.record_kvstore("push", keys=3)
        finally:
            prof._state["running"] = False
        with prof._lock:
            events[pkg] = list(prof._custom_events)

    def strip(e):
        e = dict(e)
        for k in ("ts", "tid"):
            e.pop(k, None)
        return e
    assert [strip(e) for e in events["port"]] == \
        [strip(e) for e in events["jax"]]


def test_event_buffer_bounded_and_dropped_like_jax():
    """At one cap and one event count both packages keep the same newest
    window and count the same drops, surfaced under 'profiler'."""
    kept = {}
    for pkg, prof, reg in (("port", tprof, tmx.obs.registry()),
                           ("jax", jprof, jobs.registry())):
        prof.set_event_cap(100)
        for i in range(250):
            prof._emit({"name": f"ev{i}", "ph": "X", "dur": 1.0,
                        "ts": 0, "pid": 0, "tid": 0})
        st = prof.buffer_stats()
        with prof._lock:
            names = [e["name"] for e in prof._custom_events]
        vals = reg.collect()
        kept[pkg] = (st["events"], st["dropped_events"], st["cap"],
                     names[0], names[-1], vals["profiler.dropped_events"],
                     vals["profiler.events"])
    assert kept["port"] == kept["jax"] == (100, 150, 100, "ev150", "ev249",
                                           150, 100)


def test_record_memory_is_empty_safe_on_the_cpu():
    assert tprof.record_memory() is None
    assert tprof.record_memory(ctx=tmx.cpu()) is None
    assert tmx.storage.memory_stats(tmx.cpu()) == {}
    assert tmx.storage.device_memory_info(tmx.cpu()) == (0, 0)
    tprof.set_config(profile_memory=True)
    tprof.record_op("x", 1.0)               # samples memory: nothing here
    assert tprof.buffer_stats()["events"] == 1


def test_server_profiler_commands_over_the_control_channel(tmp_path):
    """set_config/set_state/dump(profile_process='server') drive the port
    parameter server's profiler over the control channel; an unknown
    action is an error reply, and without a dist kvstore the forwarding
    raises."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.transport import Channel
    with pytest.raises(RuntimeError, match="dist kvstore"):
        tprof.set_state("run", profile_process="server")
    server = ParameterServer(num_workers=1).start()
    chan = Channel("127.0.0.1", server.port)
    try:
        out = str(tmp_path / "server_prof.json")
        r = chan.request({"cmd": "profiler", "action": "set_config",
                          "config": {"filename": out,
                                     "aggregate_stats": True}})
        assert r.get("ok"), r
        r = chan.request({"cmd": "profiler", "action": "set_state",
                          "state": "run"})
        assert r.get("ok") and r["state"] == "run", r
        r = chan.request({"cmd": "profiler", "action": "set_state",
                          "state": "stop"})
        assert r.get("ok") and r["state"] == "stop", r
        r = chan.request({"cmd": "profiler", "action": "dump"})
        assert r.get("ok"), r
        assert "traceEvents" in json.load(open(out))
        r = chan.request({"cmd": "profiler", "action": "bogus"})
        assert "error" in r
    finally:
        chan.request({"cmd": "stop"})
        chan.close()
        server.shutdown()


def test_server_forwarding_through_a_dist_kvstore(tmp_path, monkeypatch):
    """`profile_process='server'` goes through the KVStoreDist that
    registered itself as the profiler's handle."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    server = ParameterServer(num_workers=1).start()
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(server.port))
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    kv = tmx.kv.create("dist_sync")
    try:
        assert tprof._kvstore_handle[0] is kv
        out = str(tmp_path / "fwd.json")
        tprof.set_config(profile_process="server", filename=out)
        tprof.set_state("run", profile_process="server")
        tprof.set_state("stop", profile_process="server")
        tprof.dump(profile_process="server")
        assert os.path.exists(out)
        assert kv.server_metrics()[0]["pulls"] == 0
    finally:
        kv.close()
        assert tprof._kvstore_handle[0] is None
        server.shutdown()


def test_knob_defaults_equal_jax():
    for name in ("MXNET_OBS_TRACE", "MXNET_OBS_TRACE_BUFFER",
                 "MXNET_OBS_METRICS", "MXNET_PROFILER_AUTOSTART",
                 "MXNET_PROFILER_MODE", "MXNET_PROFILER_MAX_EVENTS"):
        assert tconfig.KNOBS[name][1] == jconfig.KNOBS[name][1], name
        assert tconfig.KNOBS[name][0](str(tconfig.KNOBS[name][1])) == \
            jconfig.KNOBS[name][0](str(jconfig.KNOBS[name][1])), name


def test_autostart_knob_starts_a_session_at_import(tmp_path):
    code = ("import incubator_mxnet_tpu_torch as mx; "
            "print(mx.profiler.state())")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(env, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "run"
