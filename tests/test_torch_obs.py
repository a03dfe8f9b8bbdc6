"""The port's telemetry plane (`incubator_mxnet_tpu_torch/obs/`) against
the JAX package's `obs/` on the CPU.

The same seeded sequence of counter, gauge and histogram updates goes
through both registries: samples, snapshots, quantiles and the
Prometheus text are equal byte for byte, and each package's strict
parser reads the other's text.  The shared JSONL sink stamps the same
fields and stays line-atomic under 8 threads; the fault log writes the
JAX package's lines.  Span trees, the null span, drop-oldest, the
rendered span lines and the ``tr`` frame field are the JAX package's,
and a frame crosses between the packages both ways.  The headline: a
port `ReplicaRouter` over one ``--ctx cpu`` worker process serves 3
requests and the span file merges through ``tools/mxtrace.py`` into one
connected tree per request across both pids, with zero orphans and the
JAX run's structure.  Scrapes: the JAX client reads the port's worker,
host daemon and parameter server, the port's client reads the JAX ones,
``tools/mxtop.py --json`` renders the port's endpoints, and
`FleetManager.scrape()` records a killed host daemon under
``unreachable``.
"""
import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.obs import jsonl_sink as jsink
from incubator_mxnet_tpu.obs import metrics as jmetrics
from incubator_mxnet_tpu.obs import trace as jtrace
from incubator_mxnet_tpu.resilience import faults as jfaults

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
from incubator_mxnet_tpu_torch.obs import jsonl_sink as tsink
from incubator_mxnet_tpu_torch.obs import metrics as tmetrics
from incubator_mxnet_tpu_torch.obs import trace as ttrace
from incubator_mxnet_tpu_torch.resilience import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

SHAPES = [("data", (1, 6))]
BUCKETS = (1, 2)


@pytest.fixture(autouse=True)
def _trace_clean():
    """Every test starts and ends with tracing off and empty buffers in
    both packages."""
    for mod in (jtrace, ttrace):
        mod.enabled()
        mod.disable()
        mod._path = None
        mod.reset()
    yield
    for mod in (jtrace, ttrace):
        mod.disable()
        mod._path = None
        mod._cap = None
        mod.reset()


# -- metrics -------------------------------------------------------------------

def _drive(pkg_metrics, ops):
    reg = pkg_metrics.MetricsRegistry()
    c = reg.counter("seq.hits")
    g = reg.gauge("seq.depth")
    h = reg.histogram("seq.lat_ms")
    h2 = reg.histogram("seq.size", buckets=(1, 4, 16, 64))
    for kind, v in ops:
        if kind == 0:
            c.inc(int(v * 10))
        elif kind == 1:
            g.set(float(v))
        elif kind == 2:
            g.inc(float(v))
        elif kind == 3:
            h.observe(float(v) * 800)
        else:
            h2.observe(float(v) * 100)
    return reg, (c, g, h, h2)


def _ops(seed=0, n=400):
    rng = np.random.RandomState(seed)
    return list(zip(rng.randint(0, 5, n), rng.exponential(1.0, n)))


def test_metrics_sequence_matches_jax():
    """One seeded sequence of inc/set/observe: equal samples, histogram
    snapshots, quantiles and collect() in both packages."""
    ops = _ops()
    jreg, jinst = _drive(jmetrics, ops)
    treg, tinst = _drive(tmetrics, ops)
    for j, t in zip(jinst, tinst):
        assert t.sample() == j.sample()
    for j, t in zip(jinst[2:], tinst[2:]):
        assert t.snapshot() == j.snapshot()
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert t.quantile(q) == j.quantile(q)
    assert treg.collect() == jreg.collect()
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    empty_t = tmetrics.Histogram("e")
    empty_j = jmetrics.Histogram("e")
    assert empty_t.quantile(0.5) is None and empty_j.quantile(0.5) is None
    with pytest.raises(TypeError):
        treg.gauge("seq.hits")


def test_render_prometheus_byte_equal_and_cross_parsed():
    """The same values render to the same bytes, and each package's
    strict parser reads the other's text (and rejects a bad line)."""
    ops = _ops(seed=1)
    jreg, _ = _drive(jmetrics, ops)
    treg, _ = _drive(tmetrics, ops)
    producer = {"x": 2, "weird/name": 1, "flag": True, "skip": "s",
                "nested": {"y": 2.5, "nan": float("nan"),
                           "inf": float("inf")}}
    jreg.register_producer("ns", lambda: producer)
    treg.register_producer("ns", lambda: producer)
    jtext, ttext = jreg.render_prometheus(), treg.render_prometheus()
    assert ttext.encode() == jtext.encode()
    jparsed = jmetrics.parse_prometheus(ttext)
    tparsed = tmetrics.parse_prometheus(jtext)
    assert set(jparsed) == set(tparsed)
    for key, v in tparsed.items():
        assert (v != v and jparsed[key] != jparsed[key]) or v == jparsed[key]
    assert tparsed[("mx_ns_weird_name", ())] == 1
    assert tparsed[("mx_seq_size_bucket", (("le", "+Inf"),))] > 0
    for bad in ("not a metric line!!!", "mx_ok {\n", "# TYPE x bogus"):
        with pytest.raises(ValueError):
            tmetrics.parse_prometheus(bad)
        with pytest.raises(ValueError):
            jmetrics.parse_prometheus(bad)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_producer_flatten_weakref_and_broken_producer(pkg):
    """Flatten, weakly held bound methods and a raising producer behave
    the same in both packages (one case each)."""
    m = tmetrics if pkg == "port" else jmetrics
    reg = m.MetricsRegistry()
    reg.register_producer("demo", lambda: {
        "a": 1, "flag": True, "skipped": "str",
        "nested": {"b": 2.5, "deep": {"c": 3}}, "list": [1, 2]})

    class Sub:
        def stats(self):
            return {"n": 7}

    def boom():
        raise RuntimeError("broken stats")
    sub = Sub()
    reg.register_producer("sub", sub.stats)
    reg.register_producer("bad", boom)
    vals = reg.collect()
    assert vals["demo.a"] == 1 and vals["demo.flag"] == 1
    assert vals["demo.nested.b"] == 2.5 and vals["demo.nested.deep.c"] == 3
    assert "demo.skipped" not in vals and "demo.list" not in vals
    assert vals["sub.n"] == 7 and vals["obs.producer_errors.bad"] == 1
    del sub
    gc.collect()
    vals = reg.collect()
    assert "sub.n" not in vals and "sub" not in reg.producers()
    assert reg.counter("obs.producer_errors").value == 2
    assert m.flatten("x", {"a": {"b": 1}, "c": False}) == \
        {"x.a.b": 1, "x.c": 0}


def test_producer_flatten_equals_jax():
    nested = {"a": 1, "b": {"c": 2.0, "d": {"e": True}}, "s": "x",
              "l": [1], "n": None}
    assert tmetrics.flatten("p", nested) == jmetrics.flatten("p", nested)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_hot_path_exact_across_8_threads(pkg):
    m = tmetrics if pkg == "port" else jmetrics
    reg = m.MetricsRegistry()
    c, g, h = reg.counter("t.hits"), reg.gauge("t.g"), reg.histogram("t.h")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for i in range(2000):
                c.inc()
                g.inc()
                h.observe(i % 7)
        threads = [threading.Thread(target=worker, name=f"mx-test-{i}")
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert c.value == 16000 and g.value == 16000
    assert h.snapshot()["count"] == 16000


def test_metrics_knob_gates_producers(monkeypatch):
    """MXNET_OBS_METRICS=0: collect() returns the instruments only."""
    reg = tmetrics.MetricsRegistry()
    reg.counter("k.hits").inc()
    reg.register_producer("p", lambda: {"v": 1})
    monkeypatch.setenv("MXNET_OBS_METRICS", "0")
    assert reg.collect() == {"k.hits": 1}
    monkeypatch.setenv("MXNET_OBS_METRICS", "1")
    assert reg.collect()["p.v"] == 1


# -- the sink ------------------------------------------------------------------

def test_sink_stamps_the_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_RANK", "3")
    got = {}
    for pkg, m in (("port", tsink), ("jax", jsink)):
        path = str(tmp_path / f"{pkg}.jsonl")
        s = m.JsonlSink(path)
        s.write({"event": "a"})
        s.write({"event": "b", "pid": 42, "thread": "custom"})
        s.write_many([{"event": "c"}, {"event": "d", "rank": 9}])
        s.write_rendered(['{"k":"x"}'])
        s.close()
        got[pkg] = m.read_jsonl(path)
    for t, j in zip(got["port"], got["jax"]):
        assert set(t) == set(j)
        for key in set(t) - {"time"}:
            assert t[key] == j[key]
    port = got["port"]
    assert port[0]["pid"] == os.getpid() and port[0]["rank"] == 3
    assert port[1]["pid"] == 42 and port[1]["thread"] == "custom"
    assert port[3]["rank"] == 9 and port[4] == {"k": "x"}
    assert tsink.sink(str(tmp_path / "s")) is tsink.sink(str(tmp_path / "s"))
    tsink.close_all()


def test_sink_8_threads_200_lines_stay_line_atomic(tmp_path):
    path = str(tmp_path / "shared.jsonl")

    def writer(wid):
        s = tsink.JsonlSink(path)   # an fd per writer, one file
        for i in range(200):
            s.write({"w": wid, "i": i, "pad": "x" * 64})
        s.close()
    threads = [threading.Thread(target=writer, args=(w,),
                                name=f"mx-test-sink-{w}") for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    entries = tsink.read_jsonl(path)
    assert len(entries) == 1600
    assert {(e["w"], e["i"]) for e in entries} == {
        (w, i) for w in range(8) for i in range(200)}
    assert {e["thread"] for e in entries} == {
        f"mx-test-sink-{w}" for w in range(8)}


def test_fault_log_lines_equal_jax(tmp_path):
    """The same fault spec writes the JAX package's log lines, apart from
    the pid and the time, and each is a profiler fault instant while a
    profile runs."""
    lines = {}
    for pkg, faults in (("port", tfaults), ("jax", jfaults)):
        log = str(tmp_path / f"{pkg}.jsonl")
        faults.clear()
        faults._log_path = log
        try:
            faults.inject("server.dispatch", "error", n=2)
            for _ in range(3):
                try:
                    faults.fire("server.dispatch", cmd="push")
                except Exception:
                    pass
            faults.note("retry", site="transport.send", attempt=1)
            with open(log) as f:
                lines[pkg] = f.read().splitlines()
        finally:
            faults._log_path = None
            faults.clear()
    assert len(lines["port"]) == len(lines["jax"]) == 3

    def strip(line):
        e = json.loads(line)
        assert e.pop("pid") == os.getpid()
        e.pop("time")
        return e
    assert [strip(x) for x in lines["port"]] == \
        [strip(x) for x in lines["jax"]]
    # the same fields in the same order
    assert [list(json.loads(x)) for x in lines["port"]] == \
        [list(json.loads(x)) for x in lines["jax"]]


# -- traces --------------------------------------------------------------------

def _tree(mod):
    with mod.span("root", cat="test", x=1) as root:
        assert mod.current_frame() == {"t": root.trace, "s": root.span}
        with mod.span("child") as child:
            assert child.trace == root.trace
            with mod.span("grandchild", cat="leaf"):
                pass
        sp = mod.start_span("manual", k=2)
        sp.note(extra=True).end(outcome="ok")
        sp.end(outcome="twice")            # a second end is ignored
    mod.record_span("posthoc", 10, 5, cat="late")
    assert mod.current_frame() is None
    by = {s["name"]: s for s in mod.buffered()}
    return by


def test_span_nesting_and_frames_match_jax():
    jtrace.enable()
    ttrace.enable()
    j, t = _tree(jtrace), _tree(ttrace)
    assert set(j) == set(t)

    def shape(by):
        names = {v["sp"]: v["name"] for v in by.values()}
        return {n: (names.get(s["pa"], s["pa"]), s["cat"], s["args"],
                    sorted(s)) for n, s in by.items()}
    assert shape(t) == shape(j)
    assert t["root"]["pa"] is None and t["root"]["args"] == {"x": 1}
    assert t["manual"]["args"] == {"k": 2, "extra": True, "outcome": "ok"}
    assert t["root"]["dur"] >= t["child"]["dur"]
    assert t["posthoc"]["ts"] == 10 and t["posthoc"]["dur"] == 5
    assert t["root"]["sp"].startswith("s%x-" % os.getpid())
    assert t["root"]["tr"].startswith("t%x-" % os.getpid())


def test_tracing_off_is_the_shared_null_span():
    for mod in (ttrace, jtrace):
        assert not mod.enabled()
        sp = mod.start_span("x", rid="r")
        assert sp is mod.NULL_SPAN and sp.frame() is None
        sp.end()
        with mod.span("y") as sp2:
            assert sp2 is mod.NULL_SPAN
        with mod.server_span({"tr": {"t": "t1", "s": "s1"}}, "z") as sp3:
            assert sp3 is mod.NULL_SPAN
        msg = {"cmd": "infer"}
        assert mod.rpc_span(msg, "h:1") is mod.NULL_SPAN and "tr" not in msg
        mod.record_span("w", 0, 1)
        assert mod.buffered() == []
        assert mod.calibrate_span_cost() is None


def test_drop_oldest_counted_the_same_at_one_cap():
    dropped = {}
    for pkg, mod in (("port", ttrace), ("jax", jtrace)):
        mod.enable()
        mod._cap = 50
        for i in range(120):
            mod.start_span(f"s{i}").end()
        st = mod.stats()
        names = [s["name"] for s in mod.buffered()]
        dropped[pkg] = (st["buffered"], st["dropped"], st["ended"],
                        names[0], names[-1])
    assert dropped["port"] == dropped["jax"] == (50, 70, 120, "s70",
                                                 "s119")


def test_rendered_lines_have_the_jax_keys(tmp_path):
    keys = {}
    for pkg, mod, sink_mod in (("port", ttrace, tsink),
                               ("jax", jtrace, jsink)):
        path = str(tmp_path / f"{pkg}.jsonl")
        mod.enable(path)
        mod.start_span('we"ird', note='va"l\\ue', n=1).end()
        with mod.span("plain", rid="r-1"):
            pass
        mod.flush()       # the background flusher may have written some
        entries = sink_mod.read_jsonl(path)
        assert len(entries) == 2
        keys[pkg] = [sorted(e) for e in entries]
        weird = next(e for e in entries if e["name"] == 'we"ird')
        assert weird["args"]["note"] == 'va"l\\ue' and weird["k"] == "span"
        assert all(e["pid"] == os.getpid() for e in entries)
        mod.disable()
    assert keys["port"] == keys["jax"]
    assert keys["port"][0] == sorted(["k", "tr", "sp", "pa", "name", "cat",
                                      "ts", "dur", "pid", "thread", "args"])


def test_rpc_span_injects_and_server_span_adopts_across_packages():
    """rpc_span injects the ``tr`` frame field, server_span adopts it;
    a JAX server adopts a port frame, and the port one a JAX frame."""
    ttrace.enable()
    jtrace.enable()
    for client, server in ((ttrace, ttrace), (ttrace, jtrace),
                           (jtrace, ttrace)):
        with client.span("client.request") as root:
            msg = {"cmd": "infer", "rid": "r1"}
            rpc = client.rpc_span(msg, "127.0.0.1:9")
            assert msg["tr"] == {"t": root.trace, "s": rpc.span}
            rpc.end()
        with server.server_span(msg, "worker.infer", rid="r1") as srv:
            assert srv.parent == rpc.span and srv.trace == root.trace
        # an explicit frame already on the message becomes the parent
        msg2 = {"cmd": "infer", "tr": {"t": "tX", "s": "sX"}}
        rpc2 = client.rpc_span(msg2, "h:1")
        assert rpc2.parent == "sX" and rpc2.trace == "tX"
        rpc2.end()
    port = {s["name"] for s in ttrace.buffered()}
    assert {"client.request", "rpc.infer", "worker.infer"} <= port


def test_transport_request_carries_the_frame():
    """Channel.request opens an ``rpc.<cmd>`` span and the port's
    parameter server handles it inside a ``server.<cmd>`` span that
    adopts the frame (both in this process)."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.transport import Channel
    ttrace.enable()
    server = ParameterServer(num_workers=1).start()
    chan = Channel("127.0.0.1", server.port)
    try:
        with ttrace.span("fit.step", cat="train"):
            assert chan.request({"cmd": "metrics"})["ok"]
    finally:
        chan.close()
        server.shutdown()
    by = {s["name"]: s for s in ttrace.buffered()}
    assert by["rpc.metrics"]["pa"] == by["fit.step"]["sp"]
    assert by["server.metrics"]["pa"] == by["rpc.metrics"]["sp"]
    assert by["server.metrics"]["cat"] == "kvstore"


def test_lazy_scrape_attribute_unlike_jax():
    """`obs.scrape` reached as an attribute before its import works in
    the port; the JAX package's `__getattr__` recurses (ROADMAP.md,
    Queue 3)."""
    code = ("import {pkg}.obs as o; print(o.scrape.metrics_reply()"
            "['ok'])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    port = subprocess.run(
        [sys.executable, "-c", code.format(pkg="incubator_mxnet_tpu_torch")],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert port.returncode == 0 and port.stdout.strip() == "True", \
        port.stdout + port.stderr
    jax = subprocess.run(
        [sys.executable, "-c", code.format(pkg="incubator_mxnet_tpu")],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert jax.returncode != 0 and "RecursionError" in jax.stderr


# -- the headline: a routed request across two processes -----------------------

def _fc_net(pkg):
    s = pkg.sym
    return s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                            num_hidden=8, name="fc"),
                           name="softmax")


@pytest.fixture
def prefix(tmp_path):
    """An FC + softmax checkpoint pair, written by the port, that both
    packages' workers load."""
    rng = np.random.RandomState(0)
    args, _ = params_from_numpy(
        {"fc_weight": rng.normal(0, 0.5, (8, 6)).astype("f4"),
         "fc_bias": rng.normal(0, 0.1, (8,)).astype("f4")}, None,
        ctx=tmx.cpu())
    path = str(tmp_path / "m")
    tmx.save_checkpoint(path, 0, _fc_net(tmx), args, {})
    return path


def _routed_run(pkg, trace_mod, prefix, span_path, n=3):
    """n requests through pkg's router and one worker process; returns
    the answers, the rids, the worker's scrape and the span file's
    spans.  The worker inherits the span file through the env."""
    trace_mod.enable(span_path)
    env = {"MXNET_OBS_TRACE": span_path, "JAX_PLATFORMS": "cpu"}
    kw = {"ctx": "cpu"} if pkg is tmx else {}
    rep = pkg.serving.RemoteReplica.spawn(
        prefix=prefix, epoch=0, data_shapes=SHAPES, buckets=BUCKETS,
        name="m", replica_id="w0", env=env, **kw)
    router = pkg.serving.ReplicaRouter([rep], health_interval_s=0.5,
                                       health_deadline_s=10.0)
    outs, rids = [], []
    try:
        x = np.random.RandomState(1).randn(1, 6).astype(np.float32)
        for _ in range(n):
            fut = router.submit({"data": x}, timeout_ms=30000)
            rids.append(fut.request_id)
            outs.append(fut.result(60)[0].asnumpy())
        scrape = rep.scrape()
    finally:
        router.shutdown(drain=True)     # stops the worker: it flushes
    assert rep.process.wait(30) == 0
    trace_mod.flush()
    import mxtrace
    spans, events, chrome = mxtrace.load_inputs([span_path])
    return outs, rids, scrape, spans, mxtrace.merge(spans, events, chrome)


def _request_trees(spans):
    """Per router.request root: the sorted (name, parent name, same pid
    as the root) of every span its tree reaches."""
    import mxtrace
    by_id = {s["sp"]: s for s in spans}
    trees = []
    for root in (s for s in spans if s["name"] == "router.request"):
        tree = mxtrace.trace_tree(spans, root["tr"])
        reached, frontier = [], [root["sp"]]
        while frontier:
            cur = frontier.pop()
            reached.append(cur)
            frontier += tree["children"].get(cur, [])
        trees.append(sorted(
            (by_id[sp]["name"],
             by_id[by_id[sp]["pa"]]["name"] if by_id[sp]["pa"] else None,
             by_id[sp]["pid"] == root["pid"]) for sp in reached))
    return trees


def test_cross_process_span_tree_equals_jax(prefix, tmp_path):
    """A port router with one --ctx cpu RemoteReplica worker serves 3
    requests: the merged span file is one connected tree per request
    across both pids with zero orphans, whose span names and parent
    structure equal the JAX run's; the answers agree, and each client
    reads the other package's worker scrape."""
    port = _routed_run(tmx, ttrace, prefix, str(tmp_path / "port.jsonl"))
    ttrace.disable()
    jax = _routed_run(jmx, jtrace, prefix, str(tmp_path / "jax.jsonl"))
    jtrace.disable()
    for outs, rids, scrape, spans, (merged, summary) in (port, jax):
        assert summary["orphan_spans"] == 0, summary["orphans"]
        assert summary["processes"] == 2
        roots = [s for s in spans if s["name"] == "router.request"]
        assert sorted(r["args"]["rid"] for r in roots) == sorted(rids)
        assert all(r["args"]["outcome"] == "ok" for r in roots)
        assert scrape["values"]["worker.executed"] == 3
        assert any(e.get("ph") == "s" for e in merged["traceEvents"])
    tree = _request_trees(port[3])
    assert len(tree) == 3 and tree == _request_trees(jax[3])
    assert ("worker.infer", "rpc.infer", False) in tree[0]
    for a, b in zip(port[0], jax[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    tmetrics.parse_prometheus(port[2]["prom"])
    jmetrics.parse_prometheus(jax[2]["prom"])


# -- scrapes -------------------------------------------------------------------

def test_scrapes_cross_between_the_packages(prefix):
    """The JAX scrape client reads a port worker's, host daemon's and
    parameter server's ``metrics`` frame; the port's client reads the
    JAX worker's (in process), host daemon's and parameter server's."""
    from incubator_mxnet_tpu.dist.server import ParameterServer as JPS
    from incubator_mxnet_tpu.obs.scrape import scrape as jscrape
    from incubator_mxnet_tpu.serving.hostd import HostDaemon as JHostd
    from incubator_mxnet_tpu.serving.worker import ReplicaWorker as JWorker
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.obs.scrape import scrape as tscrape
    from incubator_mxnet_tpu_torch.serving.hostd import HostDaemon
    from incubator_mxnet_tpu_torch.serving.worker import ReplicaWorker
    model = tmx.serving.ServedModel.load(prefix, 0, data_shapes=SHAPES,
                                         buckets=BUCKETS, ctx=tmx.cpu())
    jmodel = jmx.serving.ServedModel.load(prefix, 0, data_shapes=SHAPES,
                                          buckets=BUCKETS)
    servers = [ReplicaWorker(model).start(), HostDaemon("h-port").start(),
               ParameterServer(num_workers=1).start()]
    jservers = [JWorker(jmodel).start(), JHostd("h-jax").start(),
                JPS(num_workers=1).start()]
    try:
        x = np.ones((1, 6), "f4")
        servers[0]._handle({"cmd": "infer", "rid": "a", "inputs": [x]})
        for s in servers:
            snap = jscrape(f"127.0.0.1:{s.port}")
            assert snap["values"]["worker.executed"] == 1
            assert snap["values"]["hostd.spawns"] == 0
            assert snap["values"][f"ps.{servers[2].port}.pushes"] == 0
            jmetrics.parse_prometheus(snap["prom"])
        for s in jservers:
            snap = tscrape(f"127.0.0.1:{s.port}")
            assert "hostd.workers" in snap["values"]
            assert "worker.executed" in snap["values"]
            tmetrics.parse_prometheus(snap["prom"])
    finally:
        for s in servers + jservers:
            s._server.shutdown()
            s._server.server_close()


def test_mxtop_json_renders_port_endpoints():
    """``tools/mxtop.py --json`` over a port MetricsEndpoint returns the
    port's namespaces; an unreachable endpoint is listed, not fatal."""
    import mxtop
    kv = tmx.kv.create("device")
    router = tmx.serving.ReplicaRouter(name="router", health_interval_s=5.0)
    try:
        kv.init("w", tmx.nd.zeros((4,), ctx=tmx.cpu()))
        kv.push("w", tmx.nd.ones((4,), ctx=tmx.cpu()))
        with tmx.obs.scrape.MetricsEndpoint() as ep:
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools", "mxtop.py"),
                 f"127.0.0.1:{ep.port}", "127.0.0.1:1", "--json",
                 "--timeout", "2"],
                capture_output=True, text=True, timeout=120,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert proc.returncode == 0, proc.stdout + proc.stderr
            snap = json.loads(proc.stdout)
        assert {"kvstore", "router", "profiler"} <= \
            {k.split(".")[0] for k in snap["fleet"]}
        assert snap["fleet"]["kvstore.pushes"] >= 1
        assert [u["endpoint"] for u in snap["unreachable"]] == \
            ["127.0.0.1:1"]
        frame = mxtop.render(snap)
        assert "KVSTORE" in frame and "ROUTER" in frame
    finally:
        router.shutdown()
        del kv


def test_fleet_manager_scrape_over_two_hostds_one_killed(prefix,
                                                         monkeypatch):
    """`FleetManager.scrape()` over 2 host daemons (``--ctx cpu``, one
    worker each): both hosts and both workers answer; after one host's
    process group is SIGKILLed the scrape does not raise, lists it and
    its worker under ``unreachable``, and the survivors' executed counts
    equal their stats()."""
    from incubator_mxnet_tpu_torch.serving import fleet as tfleet
    monkeypatch.setenv("MXNET_PS_RECONNECT_WAIT", "0.2")
    hosts = [None, None]

    def launch(i):
        hosts[i] = tfleet.AgentHost.launch_local(f"host-{i}", ctx="cpu")
    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    fm = None
    try:
        assert all(hosts)
        spec = tfleet.ReplicaSpec(data_shapes=SHAPES, name="m",
                                  prefix=prefix, buckets=BUCKETS)
        fm = tfleet.FleetManager(hosts, spec, target_replicas=2,
                                 min_replicas=2, max_replicas=2,
                                 slo_ms=1e4, tick_s=0.1, up_after_s=60.0,
                                 down_after_s=60.0, cooldown_s=60.0,
                                 host_heartbeat_s=0.2, host_deadline_s=60.0)
        x = np.ones((1, 6), "f4")
        for _ in range(6):
            fm.router.predict({"data": x}, timeout_ms=30000)
        snap = fm.scrape()
        assert snap["fleet"] == "fleet" and snap["unreachable"] == []
        assert sorted(snap["hosts"]) == ["host-0", "host-1"]
        assert len(snap["replicas"]) == 2
        assert any(k.startswith("fleet.") for k in snap["local"]["values"])
        for leg in list(snap["hosts"].values()) + \
                list(snap["replicas"].values()):
            tmetrics.parse_prometheus(leg["prom"])
        assert sum(r["values"]["worker.executed"]
                   for r in snap["replicas"].values()) >= 6
        placement = fm.stats()["placement"]
        dead = next(r for r, h in placement.items() if h == "host-1")
        hosts[1].kill()
        assert hosts[1].process.wait(10) == -signal.SIGKILL
        t0 = time.monotonic()
        snap = fm.scrape()
        assert time.monotonic() - t0 < 30
        assert "host:host-1" in snap["unreachable"]
        assert f"replica:{dead}" in snap["unreachable"]
        slots = fm._router_slots()
        live = {r: v for r, v in snap["replicas"].items()}
        assert live and dead not in live
        assert sum(v["values"]["worker.executed"] for v in live.values()) \
            == sum(slots[r].replica.stats()["executed"] for r in live)
    finally:
        if fm is not None:
            fm.shutdown(drain=False, close_hosts=True)
        for h in hosts:
            if h is not None:
                try:
                    os.killpg(h.process.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass


def test_agent_host_serializes_its_control_channel():
    """Heartbeats and scrapes share an AgentHost's serial control channel:
    the port takes them one at a time (the JAX host does not lock it;
    ROADMAP.md, Queue 3)."""
    from incubator_mxnet_tpu_torch.serving import fleet as tfleet

    class Serial:
        """A channel that fails when two requests overlap."""

        def __init__(self):
            self.busy = threading.Lock()
            self.overlaps = 0

        def request(self, msg):
            if not self.busy.acquire(blocking=False):
                self.overlaps += 1
                return {"error": "overlap"}
            try:
                time.sleep(0.002)
                return {"ok": True, "values": {"x": 1}, "prom": ""}
            finally:
                self.busy.release()

    errors = []
    for pkg, cls in (("port", tfleet.AgentHost),
                     ("jax", jmx.serving.fleet.AgentHost)):
        host = cls.__new__(cls)
        host._control = Serial()
        if pkg == "port":
            host._control_lock = threading.Lock()

        def hammer(fn):
            for _ in range(50):
                try:
                    fn()
                except Exception as exc:
                    errors.append((pkg, repr(exc)))
        threads = [threading.Thread(target=hammer, args=(fn,))
                   for fn in (host.heartbeat, host.scrape) * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if pkg == "port":
            assert host._control.overlaps == 0 and not errors
        else:
            assert host._control.overlaps > 0


def test_decode_spans_on_the_wall_clock_unlike_jax():
    """The decode engine's ``decode.prefill`` and ``decode.step`` spans
    carry the JAX names and args; the port stamps them on the wall clock
    as every other span, where the JAX engine stamps `time.monotonic`
    (ROADMAP.md, Queue 3)."""
    from incubator_mxnet_tpu import llm as jllm
    from incubator_mxnet_tpu import serving as jserving
    from incubator_mxnet_tpu_torch import llm as tllm
    base = dict(vocab_size=32, num_layers=1, num_heads=2, hidden=8,
                ffn_mult=2, max_len=24, eos_id=0)
    rng = np.random.default_rng(0)
    c, f = 8, 16
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5  # noqa: E731
    params = {"lm_embed_weight": mk(32, c),
              "lm_final_ln_gamma": np.ones((c,), np.float32),
              "lm_final_ln_beta": np.zeros((c,), np.float32)}
    pre = "lm_block0_"
    for name, shape in (("ln1_gamma", (c,)), ("ln2_gamma", (c,))):
        params[pre + name] = np.ones(shape, np.float32)
    for name in ("ln1_beta", "ln2_beta", "out_proj_bias", "fc2_bias"):
        params[pre + name] = np.zeros((c,), np.float32)
    params.update({pre + "qkv_weight": mk(3 * c, c),
                   pre + "qkv_bias": np.zeros((3 * c,), np.float32),
                   pre + "out_proj_weight": mk(c, c),
                   pre + "fc1_weight": mk(f, c),
                   pre + "fc1_bias": np.zeros((f,), np.float32),
                   pre + "fc2_weight": mk(c, f)})
    spans = {}
    for pkg, llm, serving, mod, kw in (
            ("port", tllm, tmx.serving, ttrace, {"ctx": tmx.cpu()}),
            ("jax", jllm, jserving, jtrace, {})):
        mod.enable()
        eng = serving.DecodeEngine(llm.LMConfig(**base), params, slots=2,
                                   buckets=(4, 8), **kw)
        try:
            futs = [eng.submit([1, 2, 3], max_new_tokens=3, rid=f"r{i}")
                    for i in range(2)]
            for fut in futs:
                fut.result(120)
        finally:
            eng.close()
        spans[pkg] = [s for s in mod.buffered()
                      if s["name"].startswith("decode.")]
        mod.disable()
    now_us = time.time() * 1e6
    for pkg in ("port", "jax"):
        names = {s["name"] for s in spans[pkg]}
        assert names == {"decode.prefill", "decode.step"}, (pkg, names)
    assert sorted(spans["port"][0]["args"]) == \
        sorted(spans["jax"][0]["args"])
    assert all(abs(s["ts"] - now_us) < 600e6 for s in spans["port"])
    assert all(abs(s["ts"] - now_us) > 600e6 for s in spans["jax"])
