"""The port's `ReplicaRouter` over `LocalReplica`s and worker processes
(`serving/router.py`, `replica.py`, `worker.py`) against the JAX
package's on the CPU.

The model is an FC->ReLU mlp (6 -> 16 -> 3, a SoftmaxOutput head)
partitioned under ``TPU_PALLAS``, so its first layer is K1's node: the
port takes `fc_relu_ref` on the CPU and the JAX package its reference.
Both load the same checkpoint pair, written by the port; answers agree
within rtol 1e-5 + atol 1e-6 (fp32 sums in other orders).  The cases
are `tests/test_router.py`'s: parity and load spreading, a replica
killed mid-stream, a probe-drop burst, eviction at the liveness
deadline, the rolling swap and its torn abort, priority shedding,
request-id idempotency, the structured no-live-replica error, and the
worker processes (``--ctx cpu``) with a SIGKILL and a checkpoint swap.
Then the serving knobs against the JAX package's `config.py`.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import config as jconfig
from incubator_mxnet_tpu.resilience import faults as jfaults
from incubator_mxnet_tpu.serving import LocalReplica as JLocal
from incubator_mxnet_tpu.serving import ReplicaRouter as JRouter

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tconfig
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
from incubator_mxnet_tpu_torch.resilience import faults as tfaults
from incubator_mxnet_tpu_torch.serving import (LocalReplica, RemoteReplica,
                                               ReplicaRouter,
                                               SwapInProgressError)

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [("data", (1, 6))]
BUCKETS = (1, 2, 4)


def _net(pkg):
    s = pkg.sym
    x = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=16,
                                      name="fc0"), act_type="relu",
                     name="relu0")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=3, name="head"),
                           name="softmax")


def _params(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"fc0_weight": rng.normal(0, 0.5, (16, 6)).astype("f4") * scale,
            "fc0_bias": rng.normal(0, 0.1, (16,)).astype("f4"),
            "head_weight": rng.normal(0, 0.5, (3, 16)).astype("f4") * scale,
            "head_bias": rng.normal(0, 0.1, (3,)).astype("f4")}


@pytest.fixture
def prefix(tmp_path):
    """The partitioned mlp's checkpoint pair, written by the port."""
    sym = tmx.subgraph.partition_graph(_net(tmx), "TPU_PALLAS")
    assert sym.tojson().count('"_sg_pallas_fc_relu"') == 1
    args, _ = params_from_numpy(_params(0), None, ctx=tmx.cpu())
    path = str(tmp_path / "mlp")
    tmx.save_checkpoint(path, 0, sym, args, {})
    return path


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _replicas(pkg, prefix, n, **knobs):
    local = JLocal if pkg is jmx else LocalReplica
    return [local(pkg.serving.ServedModel.load(
        prefix, 0, data_shapes=SHAPES, buckets=BUCKETS, ctx=pkg.cpu(),
        name="m"), replica_id=f"r{i}", **knobs) for i in range(n)]


def _router(pkg, reps, **kw):
    return (JRouter if pkg is jmx else ReplicaRouter)(reps, **kw)


def _np(out):
    return out[0].asnumpy()


def _reference(prefix, x):
    """The JAX package's single-model answer."""
    m = jmx.serving.ServedModel.load(prefix, 0, data_shapes=SHAPES,
                                     buckets=BUCKETS, ctx=jmx.cpu())
    return m.infer({"data": x})[0].asnumpy()


def test_router_parity_and_load_spreading(prefix):
    rng = np.random.RandomState(1)
    reqs = [rng.randn(1 + i % 3, 6).astype("f4") for i in range(24)]
    answers, spread = {}, {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        reps = _replicas(pkg, prefix, 3)
        with _router(pkg, reps, health_interval_s=0.2) as router:
            futs = [router.submit({"data": x}) for x in reqs]
            answers[name] = [_np(f.result(30)) for f in futs]
            spread[name] = [r.metrics.snapshot()["responses"] for r in reps]
            snap = router.stats()
        assert snap["responses"] == len(reqs)
        assert snap["classes"]["interactive"]["responses"] == len(reqs)
    for got, want, x in zip(answers["port"], answers["jax"], reqs):
        assert got.shape == (len(x), 3)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # least-loaded dispatch spread the work over all three, in both
    for name, counts in spread.items():
        assert all(n > 0 for n in counts), (name, counts)
        assert sum(counts) == len(reqs), (name, counts)


def test_replica_kill_zero_lost_zero_duplicated(prefix):
    x = np.random.RandomState(2).randn(2, 6).astype("f4")
    want = _reference(prefix, x)
    reps = _replicas(tmx, prefix, 3)
    with ReplicaRouter(reps, health_interval_s=0.2,
                       health_deadline_s=3.0) as router:
        # park requests on r0, then kill it: its queued requests fail
        # over, none lost, none served twice
        reps[0]._batcher.pause()
        futs = [router.submit({"data": x}) for _ in range(12)]
        time.sleep(0.05)
        reps[0].kill()
        for f in futs:
            np.testing.assert_allclose(_np(f.result(30)), want, rtol=RTOL,
                                       atol=ATOL)
        snap = router.stats()
        assert snap["replicas_lost"] == 1
        assert snap["failovers"] >= 1
        assert snap["duplicates_suppressed"] == 0
        assert sum(r.metrics.snapshot()["responses"] for r in reps) == 12
        assert snap["replicas"]["r0"]["state"] == "dead"
        np.testing.assert_allclose(
            _np(router.predict({"data": x}, timeout_ms=10000)), want,
            rtol=RTOL, atol=ATOL)


def test_probe_drop_burst_suspends_but_never_evicts(prefix):
    """The same fault spec given to both packages: three dropped probes
    make replicas suspect, never dead, and traffic never stops."""
    x = np.random.RandomState(3).randn(1, 6).astype("f4")
    spec = "seed=31;replica.health:drop(at=1-3)"
    for pkg, faults in ((jmx, jfaults), (tmx, tfaults)):
        faults.configure(spec)
        reps = _replicas(pkg, prefix, 2)
        with _router(pkg, reps, health_interval_s=0.05,
                     health_deadline_s=5.0) as router:
            deadline = time.monotonic() + 20.0
            served = 0
            while time.monotonic() < deadline and served < 20:
                router.predict({"data": x}, timeout_ms=10000)
                served += 1
                time.sleep(0.01)
            time.sleep(0.3)   # past the three dropped probes
            snap = router.stats()
        fired = [e for e in faults.trace()
                 if e.get("site") == "replica.health"]
        assert len(fired) == 3, (pkg.__name__, fired)
        assert snap["replicas_lost"] == 0
        assert all(r["state"] in ("healthy", "suspect")
                   for r in snap["replicas"].values())
        assert sum(r["probe_failures"] for r in
                   snap["replicas"].values()) == 0   # recovered
        assert served == 20
        faults.clear()


def test_dead_replica_evicted_at_liveness_deadline(prefix):
    x = np.random.RandomState(4).randn(1, 6).astype("f4")
    states = {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        reps = _replicas(pkg, prefix, 2)
        with _router(pkg, reps, health_interval_s=0.05,
                     health_deadline_s=0.4) as router:
            reps[1]._batcher.kill()   # heartbeats fail from now on
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and \
                    router.stats()["replicas"]["r1"]["state"] != "dead":
                time.sleep(0.05)
            states[name] = router.stats()["replicas"]["r1"]["state"]
            out = _np(router.predict({"data": x}, timeout_ms=10000))
        np.testing.assert_allclose(out, _reference(prefix, x), rtol=RTOL,
                                   atol=ATOL)
    assert states == {"jax": "dead", "port": "dead"}


def test_rolling_swap_answers_equal_jax(prefix):
    """Traffic runs through the roll: nothing dropped, every answer
    wholly the old weights' or the new's, the ladder unchanged; before
    and after equal the JAX router's."""
    x = np.random.RandomState(5).randn(2, 6).astype("f4")
    new = _params(0, scale=2.0)
    outs = {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        reps = _replicas(pkg, prefix, 2)
        new_args = params_from_numpy(new, None, ctx=tmx.cpu())[0] \
            if pkg is tmx else {k: jmx.nd.array(v) for k, v in new.items()}
        with _router(pkg, reps, health_interval_s=0.2) as router:
            before = _np(router.predict({"data": x}, timeout_ms=10000))
            programs = [r._model.program_count() for r in reps]
            stop = threading.Event()
            errors, seen = [], []

            def traffic():
                while not stop.is_set():
                    try:
                        seen.append(_np(router.predict({"data": x},
                                                       timeout_ms=10000)))
                    except Exception as exc:
                        errors.append(repr(exc))

            threads = [threading.Thread(target=traffic) for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.1)
            result = router.swap_weights(arg_params=new_args)
            time.sleep(0.1)
            stop.set()
            for t in threads:
                t.join()
            after = _np(router.predict({"data": x}, timeout_ms=10000))
            assert not errors, errors[:3]
            assert result["swapped"] == ["r0", "r1"]
            assert all(v == 1 for v in result["versions"].values())
            assert [r._model.program_count() for r in reps] == programs
            assert router.stats()["swaps_committed"] == 1
        outs[name] = (before, after, seen)
    before, after, seen = outs["port"]
    np.testing.assert_allclose(before, outs["jax"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(after, outs["jax"][1], rtol=RTOL, atol=ATOL)
    assert not np.allclose(before, after)
    for got in seen:   # never mixed: one version or the other
        assert np.allclose(got, before, RTOL, ATOL) or \
            np.allclose(got, after, RTOL, ATOL)


def test_torn_swap_aborts_with_fleet_serving(prefix, tmp_path):
    """The ``replica.swap`` fault tears the second replica's swap in both
    packages: the roll aborts naming the swapped replica, the fleet
    serves, and a re-issue finishes.  A checkpoint root holding only a
    torn snapshot aborts the roll at its first replica."""
    x = np.random.RandomState(6).randn(1, 6).astype("f4")
    new = _params(0, scale=2.0)
    for pkg, faults in ((jmx, jfaults), (tmx, tfaults)):
        faults.configure("seed=32;replica.swap:torn(at=2)")
        reps = _replicas(pkg, prefix, 2)
        new_args = params_from_numpy(new, None, ctx=tmx.cpu())[0] \
            if pkg is tmx else {k: jmx.nd.array(v) for k, v in new.items()}
        with _router(pkg, reps, health_interval_s=0.5) as router:
            with pytest.raises((jmx.base.MXNetError, tmx.MXNetError),
                               match=r"ABORTED.*r1.*swapped \[r0\]"):
                router.swap_weights(arg_params=new_args)
            assert [r.version for r in reps] == [1, 0]
            assert len(router.predict({"data": x}, timeout_ms=10000)) == 1
            assert router.stats()["swaps_committed"] == 0
            faults.clear()
            assert router.swap_weights(arg_params=new_args)["swapped"]
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    root = str(tmp_path / "torn")
    mgr = ckpt.CheckpointManager(root, async_snapshots=False)
    mgr.snapshot(arrays={f"arg:{k}": v for k, v in new.items()}, step=1)
    mgr.close()
    shard = os.path.join(root, ckpt.manifest.checkpoint_dirname(1),
                         ckpt.snapshot.ARRAYS_SHARD)
    with open(shard, "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 16)
    reps = _replicas(tmx, prefix, 2)
    with ReplicaRouter(reps, health_interval_s=0.5) as router:
        before = _np(router.predict({"data": x}, timeout_ms=10000))
        with pytest.raises(tmx.MXNetError,
                           match=r"ABORTED at replica 'r0'.*no valid"):
            router.swap_weights(checkpoint_dir=root)
        assert [r.version for r in reps] == [0, 0]
        np.testing.assert_allclose(
            _np(router.predict({"data": x}, timeout_ms=10000)), before,
            rtol=0, atol=0)


class _Stub:
    """A replica that answers at once and reports a scripted wait."""

    def __init__(self, pkg, rid, waits):
        from concurrent.futures import Future
        self._future = Future
        self.replica_id = rid
        self.version = 0
        self.waits = waits
        self.pkg = pkg

    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        f = self._future()
        f.set_result([priority])
        return f

    def heartbeat(self):
        return {}

    def probe(self):
        return {}

    def outstanding(self):
        return 0

    def estimated_wait_s(self):
        return self.waits[0]

    def close(self, drain=True):
        pass


def test_priority_shedding_same_classes_and_counts():
    """Stub replicas with a scripted estimated wait: both routers shed
    the same classes at each step, in the same counts."""
    waits_ms = [0, 10, 30, 60, 150, 500, 2000, 90, 20, 5]
    outcome, counts = {}, {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        wait = [0.0]
        reps = [_Stub(pkg, f"s{i}", wait) for i in range(2)]
        router = _router(pkg, reps, health_interval_s=100.0)
        try:
            steps = []
            for ms in waits_ms:
                wait[0] = ms / 1e3
                row = []
                for cls in ("interactive", "batch", "best_effort"):
                    try:
                        router.predict({"x": 0}, priority=cls)
                        row.append("ok")
                    except Exception as exc:
                        assert "shed threshold" in str(exc), exc
                        row.append("shed")
                steps.append(row)
            outcome[name] = steps
            counts[name] = {c: (v["responses"], v["shed"]) for c, v in
                            router.stats()["classes"].items()}
        finally:
            router.shutdown()
    assert outcome["port"] == outcome["jax"]
    assert counts["port"] == counts["jax"]
    # lowest class first: best_effort past 25 ms, batch past 100 ms,
    # interactive past 1000 ms (the knobs' defaults)
    assert outcome["port"][2] == ["ok", "ok", "shed"]
    assert outcome["port"][4] == ["ok", "shed", "shed"]
    assert outcome["port"][6] == ["shed", "shed", "shed"]


def test_request_id_idempotency_and_swap_lock(prefix):
    x = np.random.RandomState(7).randn(1, 6).astype("f4")
    for pkg in (jmx, tmx):
        reps = _replicas(pkg, prefix, 1)
        with _router(pkg, reps, health_interval_s=0.5) as router:
            assert len(router.predict({"data": x}, timeout_ms=10000,
                                      request_id="req-1")) == 1
            with pytest.raises(Exception, match="already accepted"):
                router.submit({"data": x}, request_id="req-1")
            router._acquire_swap("v7")
            try:
                with pytest.raises(Exception, match="in-flight: 'v7'"):
                    router.swap_one(arg_params={})
            finally:
                router._release_swap()
    with pytest.raises(SwapInProgressError):
        r = ReplicaRouter(health_interval_s=100.0)
        try:
            r._acquire_swap("a")
            r.swap_weights(arg_params={})
        finally:
            r.shutdown()


def test_no_live_replica_is_structured_error(prefix):
    x = np.random.RandomState(8).randn(1, 6).astype("f4")
    for pkg in (jmx, tmx):
        reps = _replicas(pkg, prefix, 1)
        with _router(pkg, reps, health_interval_s=0.5) as router:
            reps[0].kill()
            with pytest.raises((jmx.base.MXNetError, tmx.MXNetError),
                               match="no live replica|failed on"):
                router.predict({"data": x}, timeout_ms=2000)


def test_worker_processes_sigkill_and_checkpoint_swap(prefix, tmp_path,
                                                      monkeypatch):
    """Two port workers (``--ctx cpu``) under a router: one SIGKILLed
    after the 16th accepted request, zero lost and no rid executed twice
    (the survivor's rid log), answers equal the JAX model's; then a
    rolling swap from an elastic checkpoint over the survivor.  Each
    spawn has a 60 s deadline."""
    monkeypatch.setenv("MXNET_PS_RECONNECT_WAIT", "0.2")
    x = np.random.RandomState(9).randn(2, 6).astype("f4")
    want = _reference(prefix, x)
    reps = [None, None]

    def spawn(i):
        reps[i] = RemoteReplica.spawn(
            prefix=prefix, epoch=0, data_shapes=SHAPES, buckets=BUCKETS,
            name="m", replica_id=f"w{i}", ctx="cpu", ready_timeout=60.0)

    threads = [threading.Thread(target=spawn, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert all(r is not None for r in reps)
        for r in reps:
            assert (r.ready_info["programs"], r.ready_info["builds"]) == \
                (len(BUCKETS), 0)
            assert r.ready_info["load_ms"] >= 0 <= r.ready_info["warmup_ms"]
        router = ReplicaRouter(reps, health_interval_s=0.2,
                               health_deadline_s=3.0)
        results, errors = [], []
        accepted = [0]
        lock = threading.Lock()

        def client(n):
            for _ in range(n):
                try:
                    f = router.submit({"data": x}, timeout_ms=30000)
                    with lock:
                        accepted[0] += 1
                        if accepted[0] == 16:
                            reps[1].kill()   # a real SIGKILL mid-flight
                    results.append(_np(f.result(60)))
                except Exception as exc:
                    errors.append(repr(exc))

        clients = [threading.Thread(target=client, args=(12,))
                   for _ in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        assert not errors, errors[:3]
        assert len(results) == 36
        for got in results:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        snap = router.stats()
        assert snap["replicas_lost"] == 1
        assert snap["duplicates_suppressed"] == 0
        rids = reps[0].stats()["executed_rids"]
        assert len(rids) == len(set(rids))
        assert reps[1].process.wait(10) == -signal.SIGKILL
        from incubator_mxnet_tpu_torch import checkpoint as ckpt
        root = str(tmp_path / "ckpts")
        mgr = ckpt.CheckpointManager(root, async_snapshots=False)
        mgr.snapshot(arrays={f"arg:{k}": v for k, v in
                             _params(0, scale=2.0).items()}, step=1)
        mgr.close()
        result = router.swap_weights(checkpoint_dir=root)
        assert result["swapped"] == ["w0"]
        after = _np(router.predict({"data": x}, timeout_ms=10000))
        jm = jmx.serving.ServedModel.from_checkpoint_dir(
            prefix + "-symbol.json", root, data_shapes=SHAPES,
            buckets=BUCKETS, ctx=jmx.cpu())
        np.testing.assert_allclose(after, jm.infer({"data": x})[0].asnumpy(),
                                   rtol=RTOL, atol=ATOL)
        st = reps[0].stats()
        assert st["programs"] == len(BUCKETS) and st["version"] == 1
        assert st["cache"] == {"builds": 0, "k1_launches": 0}   # the CPU
        router.shutdown()
    finally:
        for r in reps:
            if r is not None and r.process.poll() is None:
                r.kill()


def test_worker_main_needs_the_card_and_answers_metrics(prefix,
                                                        monkeypatch):
    """Without ``--ctx cpu`` the worker serves on the card, and with no
    card it raises instead of running on the CPU; the ``metrics`` frame
    answers the telemetry registry in `metrics_reply`'s shape."""
    import torch
    from incubator_mxnet_tpu_torch.serving import worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        worker.main(["--prefix", prefix, "--data-shapes", "data=1,6",
                     "--buckets", "1,2"])
    model = tmx.serving.ServedModel.load(prefix, 0, data_shapes=SHAPES,
                                         buckets=BUCKETS, ctx=tmx.cpu())
    w = worker.ReplicaWorker(model)
    try:
        reply = w._handle({"cmd": "metrics", "seq": 3})
        assert reply["ok"] and reply["seq"] == 3
        assert set(reply) == {"ok", "values", "prom", "seq"}
        x = np.ones((1, 6), "f4")
        first = w._handle({"cmd": "infer", "rid": "a", "inputs": [x]})
        again = w._handle({"cmd": "infer", "rid": "a", "inputs": [x]})
        assert again["deduped"] and w._executed == 1
        np.testing.assert_array_equal(first["outs"][0], again["outs"][0])
        values = w._handle({"cmd": "metrics"})["values"]
        assert values["worker.executed"] == 1
        assert values["worker.dedup_hits"] == 1
        parsed = tmx.obs.parse_prometheus(reply["prom"])
        assert ("mx_worker_executed", ()) in parsed
    finally:
        w._server.server_close()


KNOB_PREFIXES = ("MXNET_ROUTER_", "MXNET_FLEET_", "MXNET_SERVING_BREAKER_")


def test_serving_knob_defaults_equal_jax():
    jknobs = [k for k in jconfig.KNOBS if k.startswith(KNOB_PREFIXES)]
    assert len(jknobs) == 19
    for k in jknobs:
        assert k in tconfig.KNOBS, k
        parse, default, _ = tconfig.KNOBS[k]
        jparse, jdefault = jconfig.KNOBS[k][:2]
        assert (parse, default) == (jparse, jdefault), k
        assert tconfig.get(k) == jconfig.get(k), k
    assert sorted(k for k in tconfig.KNOBS if k.startswith(KNOB_PREFIXES)) \
        == sorted(jknobs)


def test_batcher_reads_the_breaker_knobs(monkeypatch, prefix):
    model = tmx.serving.ServedModel.load(prefix, 0, data_shapes=SHAPES,
                                         buckets=BUCKETS, ctx=tmx.cpu())
    metrics = tmx.serving.ServingMetrics("k")
    monkeypatch.setenv("MXNET_SERVING_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("MXNET_SERVING_BREAKER_RESET_S", "7.5")
    for knobs, want in (({}, (2, 7.5)),
                        ({"breaker_threshold": 9, "breaker_reset_s": 1.0},
                         (9, 1.0))):
        b = tmx.serving.MicroBatcher(model, metrics, **knobs)
        try:
            assert (b._breaker.failure_threshold,
                    b._breaker.reset_timeout) == want
        finally:
            b.close()
    r = ReplicaRouter([LocalReplica(model, replica_id="r0")],
                      health_interval_s=100.0)
    try:
        assert r._slots["r0"].breaker.failure_threshold == 2
    finally:
        r.shutdown()


class _CountingChannel:
    """A control channel that counts how many callers are inside
    `request` at once (a serial channel must never see two); the first
    caller inside waits up to 0.5 s for a second to join it."""

    def __init__(self):
        self.inside = 0
        self.most = 0
        self.lock = threading.Lock()
        self.joined = threading.Event()

    def request(self, msg):
        with self.lock:
            self.inside += 1
            self.most = max(self.most, self.inside)
            first = self.inside == 1
        if first:
            self.joined.wait(0.5)
        else:
            self.joined.set()
        with self.lock:
            self.inside -= 1
        return {"ok": True, "outstanding": 0, "version": 0}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_remote_control_channel_one_request_at_a_time(pkg):
    """The router's health thread and a `stats()` or `swap()` caller share
    a worker replica's serial control channel: the port sends one request
    at a time; the JAX `RemoteReplica` lets two interleave on the socket
    (ROADMAP Queue 3), where one caller can read the other's reply."""
    from incubator_mxnet_tpu.serving import RemoteReplica as JRemote
    rep = object.__new__(JRemote if pkg == "jax" else RemoteReplica)
    rep.replica_id = "w0"
    rep._lost = threading.Event()
    rep._control = chan = _CountingChannel()
    rep._control_lock = threading.Lock()
    callers = [threading.Thread(target=rep.heartbeat) for _ in range(2)]
    for t in callers:
        t.start()
    for t in callers:
        t.join(10)
    assert not any(t.is_alive() for t in callers)
    assert chan.most == (1 if pkg == "port" else 2)


class _SwapStub(_Stub):
    """A stub that records the deepcheck budget the router gives it."""

    def __init__(self, pkg, rid):
        super().__init__(pkg, rid, [0.0])
        self.probe_budgets = []

    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        self.version += 1
        return self.version

    def probe(self, timeout_s=None):
        self.probe_budgets.append(timeout_s)
        return {}


class _BudgetChannel:
    """Records each control request's command and its timeout override."""

    def __init__(self):
        self.sent = []

    def request(self, msg, timeout=None):
        self.sent.append((msg["cmd"], timeout))
        return {"ok": True, "outstanding": 0, "version": 1, "programs": 1}


def test_swap_deepcheck_waits_on_the_swap_budget():
    """A worker busy with a large model can take longer than the short
    control timeout to load a checkpoint and run its first inference:
    the router gives the deepcheck after a swap ``drain_timeout_s``, and
    a `RemoteReplica` sends ``swap`` on ``swap_timeout``.  Heartbeats and
    the health loop's deepchecks keep the control timeout."""
    stub = _SwapStub(tmx, "s0")
    router = ReplicaRouter([stub], health_interval_s=100.0)
    try:
        router.swap_weights(arg_params={}, drain_timeout_s=7.0)
        router.swap_one("s0", arg_params={}, drain_timeout_s=9.0)
    finally:
        router.shutdown()
    assert stub.probe_budgets == [7.0, 9.0]
    assert stub.version == 2
    rep = object.__new__(RemoteReplica)
    rep.replica_id = "w0"
    rep._lost = threading.Event()
    rep._control = chan = _BudgetChannel()
    rep._control_lock = threading.Lock()
    rep.swap_timeout = 120.0
    rep.heartbeat()
    rep.swap(checkpoint_dir="/nowhere")
    rep.probe(timeout_s=7.0)
    rep.probe()
    assert chan.sent == [("hb", None), ("swap", 120.0), ("probe", 7.0),
                         ("probe", None)]
    assert rep.version == 1


def test_channel_timeout_override_holds_for_one_request():
    """`Channel.request(timeout=)` waits longer for that request only: a
    server that answers after 0.3 s times out a 0.1 s channel, answers
    the same channel given 5 s, and times it out again afterwards."""
    import socketserver
    from incubator_mxnet_tpu_torch.dist import transport

    class Slow(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    msg = transport.recv_msg(self.request)
                    time.sleep(0.3)
                    transport.send_msg(self.request,
                                       {"ok": True, "seq": msg["seq"]})
                except (EOFError, ConnectionError, OSError):
                    return

    class Server(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    server = Server(("127.0.0.1", 0), Slow)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        chan = transport.Channel("127.0.0.1", server.server_address[1],
                                 timeout=0.1, connect_wait=5.0)
        with pytest.raises(TimeoutError, match="after 0.1s"):
            chan.request({"cmd": "hb"})
        assert chan.request({"cmd": "hb"}, timeout=5.0)["ok"]
        with pytest.raises(TimeoutError, match="after 0.1s"):
            chan.request({"cmd": "hb"})
        chan.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert not thread.is_alive()
