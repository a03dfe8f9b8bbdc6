"""The train-to-serve loop in the PyTorch port (`loop/`: `ModelRegistry`,
`CheckpointPublisher`, `LoopController`) on the CPU, case for case with
tests/test_loop.py (its ``unguarded-model-swap`` lint waits for the
port's analysis package), and the registry read across packages: the
port reads the versions, fences and rejection stamps the JAX registry
wrote, and the reverse.

The served model is the JAX test's: one 4x4 FullyConnected whose
identity weights classify the one-hot holdout rows perfectly (accuracy
1.0) and whose negated weights misclassify every row (0.0), so every
canary score is exact.  No sleep is longer than 1 s; every thread is
joined with a timeout.
"""
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.loop import ModelRegistry as JModelRegistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import checkpoint as ckpt
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.loop import (CanaryRejectedError,
                                            CheckpointPublisher,
                                            LoopController, ModelRegistry,
                                            RegistryUnavailableError)
from incubator_mxnet_tpu_torch.obs import metrics as obs_metrics
from incubator_mxnet_tpu_torch.resilience import faults
from incubator_mxnet_tpu_torch.resilience.guardian import \
    TrainingDivergedError
from incubator_mxnet_tpu_torch.serving import (LocalReplica, ReplicaRouter,
                                               SwapInProgressError)

IDENT = np.eye(4, dtype=np.float32)
HOLDOUT = ({"data": IDENT}, np.arange(4))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _net():
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=4, no_bias=True, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _served(weight, name="m", buckets=(1, 2, 4)):
    args = {"fc_weight": mx.nd.array(np.asarray(weight, np.float32),
                                     ctx=mx.cpu())}
    return mx.serving.ServedModel(_net(), args, {},
                                  data_shapes=[("data", (1, 4))],
                                  buckets=buckets, ctx=mx.cpu(), name=name)


def _fleet(n=2, weight=IDENT):
    reps = [LocalReplica(_served(weight, name=f"m{i}"), replica_id=f"r{i}")
            for i in range(n)]
    return ReplicaRouter(reps, name="loop-test", health_interval_s=5.0)


def _write_ckpt(root, weight, step, health="healthy"):
    """One elastic checkpoint holding `weight`, guardian-stamped."""
    mgr = ckpt.CheckpointManager(str(root), keep_last=64)
    mgr.snapshot(arrays={"arg:fc_weight": np.asarray(weight, np.float32)},
                 step=step, epoch=0, nbatch=step,
                 meta={"health": {"status": health}}, sync=True)
    mgr.close()
    return os.path.join(str(root), "ckpt-%010d" % step)


def _publish(registry, path, step, score=None):
    return registry.publish(path, step=step,
                            health={"status": "healthy"},
                            watermark={"step": step, "time": time.time()},
                            score=score)


def _argmax_ok(router, rows=4):
    out = router.predict({"data": IDENT[:rows]}, timeout_ms=10000)
    first = out[0] if isinstance(out, (list, tuple)) else out
    first = np.asarray(first.asnumpy() if hasattr(first, "asnumpy")
                       else first)
    return (first.argmax(axis=-1) == np.arange(rows)).all()


# -- the registry -------------------------------------------------------------

def test_registry_publish_and_latest(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    _publish(reg, "/ck/a", 3, score=0.9)
    _publish(reg, "/ck/b", 7)
    assert [r["version"] for r in reg.versions()] == [3, 7]
    top = reg.latest()
    assert top["version"] == 7 and top["checkpoint"] == "/ck/b"
    assert top["health"]["status"] == "healthy"
    assert "time" in top["watermark"]
    assert reg.get(3)["score"] == 0.9
    assert reg.stats()["latest_version"] == 7


def test_registry_pin_survives_trainer_retention(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _write_ckpt(tmp_path / "ck", IDENT * 3.0, 5)
    rec = reg.publish(src, step=5, health={"status": "healthy"}, pin=True)
    pinned = rec["checkpoint"]
    assert pinned == os.path.join(str(tmp_path / "reg"), "blobs",
                                  "v-0000000005")
    assert reg.latest()["checkpoint"] == pinned
    assert reg.publish(src, step=5, pin=True)["checkpoint"] == pinned
    shutil.rmtree(src)                    # the trainer's retention prunes it
    data = ckpt.load(pinned)
    np.testing.assert_array_equal(np.asarray(data.arrays["arg:fc_weight"]),
                                  IDENT * 3.0)


def test_registry_torn_manifest_invisible(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    _publish(reg, "/ck/a", 1)
    with open(os.path.join(reg.root, "v-0000000002.json"), "w") as f:
        f.write('{"format": "incubator_mxnet_tpu.registry/1", "vers')
    with open(os.path.join(reg.root, "v-0000000003.json"), "w") as f:
        f.write('{"version": 3, "checkpoint": "/ck/evil"}')
    assert [r["version"] for r in reg.versions()] == [1]
    assert reg.latest()["version"] == 1
    assert reg.stats()["torn_manifests"] == 2


def test_registry_ordering_under_concurrent_publishes(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    steps = list(range(1, 9))
    threads = [threading.Thread(target=_publish, name=f"mx-test-pub-{s}",
                                args=(reg, f"/ck/{s}", s))
               for s in steps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert [r["version"] for r in reg.versions()] == steps


def test_registry_reject_idempotent(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    _publish(reg, "/ck/a", 1)
    _publish(reg, "/ck/b", 2)
    first = reg.reject(2, reason="canary", canary_score=0.1)
    again = reg.reject(2, reason="something-else", canary_score=0.99)
    assert again["reason"] == "canary" and again["canary_score"] == 0.1
    assert first["rejected_unix"] == again["rejected_unix"]
    assert reg.latest()["version"] == 1
    rec = reg.versions(include_rejected=True)[-1]
    assert rec["version"] == 2 and rec["rejected"]
    assert ModelRegistry(reg.root).rejected(2)["reason"] == "canary"


def test_registry_fence_hides_window(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    for s in (2, 6, 11):
        _publish(reg, f"/ck/{s}", s)
    reg.fence(5, 10, reason="guardian-rollback")
    assert [r["version"] for r in reg.versions()] == [2, 11]
    assert reg.fenced(6) and not reg.fenced(11) and reg.get(6)["fenced"]
    assert ModelRegistry(reg.root).fences() == [(5, 10)]


def test_registry_dir_disappears_structured_error(tmp_path):
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    _publish(reg, "/ck/a", 1)
    shutil.rmtree(root)
    with pytest.raises(RegistryUnavailableError) as ei:
        reg.versions()
    assert ei.value.root == root
    with pytest.raises(RegistryUnavailableError):
        _publish(reg, "/ck/b", 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_reads_across_packages(tmp_path, writer):
    """Versions (a pinned one among them), a torn manifest, a fence and
    a rejection stamp written by one package's registry read the same
    through the other's."""
    Writer, Reader = (JModelRegistry, ModelRegistry) if writer == "jax" \
        else (ModelRegistry, JModelRegistry)
    root = str(tmp_path / "reg")
    w = Writer(root)
    src = _write_ckpt(tmp_path / "ck", IDENT, 4)
    w.publish(src, step=4, health={"status": "healthy"},
              watermark={"step": 4, "time": 1.0}, pin=True)
    for s in (6, 9, 12):
        w.publish(f"/ck/{s}", step=s, health={"status": "healthy"},
                  score=0.5)
    with open(os.path.join(root, "v-0000000013.json"), "w") as f:
        f.write('{"format": "incubator_mxnet_tpu.registry/1", "ver')
    w.fence(5, 7, reason="guardian-rollback")
    w.reject(12, reason="canary", canary_score=0.0, incumbent_score=1.0)
    r = Reader(root, create=False)
    assert [v["version"] for v in r.versions()] == [4, 9]
    assert r.latest()["version"] == 9
    assert r.fences() == [(5, 7)] and r.fenced(6)
    stamp = r.rejected(12)
    assert stamp["reason"] == "canary" and stamp["canary_score"] == 0.0
    assert r.get(4)["checkpoint"] == os.path.join(root, "blobs",
                                                  "v-0000000004")
    assert r.get(4)["source_checkpoint"] == src
    keys = ("visible", "rejected", "fenced", "torn_manifests",
            "latest_version")
    rs, ws = r.stats(), w.stats()
    assert {k: rs[k] for k in keys} == {k: ws[k] for k in keys}
    # and the reader stamps back: the writer sees it
    r.reject(9, reason="canary")
    assert w.latest()["version"] == 4


# -- the fault sites ----------------------------------------------------------

def test_publish_commit_torn_fault_and_retry(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    faults.configure("seed=3;publish.commit:torn(at=2)")
    committed = []
    for step in (1, 2, 3):
        try:
            _publish(reg, f"/ck/{step}", step)
            committed.append(step)
        except faults.TornWrite:
            pass
    assert committed == [1, 3]
    assert os.path.exists(os.path.join(reg.root, "v-0000000002.json"))
    assert [r["version"] for r in reg.versions()] == [1, 3]
    assert reg.stats()["torn_manifests"] == 1
    faults.clear()
    _publish(reg, "/ck/2", 2)
    assert [r["version"] for r in reg.versions()] == [1, 2, 3]


def test_publish_commit_schedule_equals_jax(tmp_path):
    """The same seeded ``p=`` schedule fails the same publishes in both
    packages (and twice in a row in each)."""
    from incubator_mxnet_tpu.resilience import faults as jfaults
    patterns = []
    for reg_cls, fl, err in ((ModelRegistry, faults, MXNetError),
                             (JModelRegistry, jfaults, jmx.MXNetError)):
        for run in range(2):
            reg = reg_cls(str(tmp_path / f"reg-{len(patterns)}"))
            fl.configure("seed=11;publish.commit:error(p=0.4)")
            pattern = []
            for step in range(1, 21):
                try:
                    _publish(reg, f"/ck/{step}", step)
                    pattern.append(True)
                except err:
                    pattern.append(False)
            fl.clear()
            patterns.append(pattern)
    assert all(p == patterns[0] for p in patterns)
    assert False in patterns[0] and True in patterns[0]


def test_canary_eval_seeded_schedule_is_deterministic():
    def run():
        faults.configure("seed=17;canary.eval:error(p=0.5)")
        pattern = []
        for i in range(20):
            try:
                faults.fire("canary.eval", version=i, phase="canary")
                pattern.append(True)
            except MXNetError:
                pattern.append(False)
        faults.clear()
        return pattern
    first, second = run(), run()
    assert first == second and False in first and True in first


# -- checkpoints: rejection stamps and exclude= -------------------------------

def test_latest_healthy_exclude_filters(tmp_path):
    paths = {s: _write_ckpt(tmp_path, IDENT * s, s) for s in (1, 2, 3)}
    man = ckpt.manifest
    assert man.latest_healthy(str(tmp_path)) == paths[3]
    assert man.latest_healthy(str(tmp_path), exclude={3}) == paths[2]
    assert man.latest_healthy(str(tmp_path), exclude={paths[3]}) == paths[2]
    assert man.latest_healthy(str(tmp_path),
                              exclude=lambda s: s >= 2) == paths[1]


def test_rejected_stamp_never_selected_and_survives_restart(tmp_path):
    good = _write_ckpt(tmp_path, IDENT, 1)
    bad = _write_ckpt(tmp_path, -IDENT, 2)
    assert ckpt.stamp_rejected(bad, reason="canary",
                               canary_score=0.0)["reason"] == "canary"
    assert ckpt.stamp_rejected(bad, reason="other")["reason"] == "canary"
    assert ckpt.is_rejected(bad) and not ckpt.is_rejected(good)
    assert ckpt.latest(str(tmp_path)) == good
    assert ckpt.manifest.latest_healthy(str(tmp_path)) == good
    assert ckpt.latest(str(tmp_path), include_rejected=True) == bad
    code = ("import incubator_mxnet_tpu_torch as mx\n"
            "print(mx.checkpoint.latest(%r))\n"
            "print(mx.checkpoint.latest_healthy(%r))\n"
            % (str(tmp_path), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == [good, good]


# -- the router's swap lock and swap_one --------------------------------------

def test_swap_busy_raises_structured_error():
    router = _fleet(1)
    try:
        router._acquire_swap(42)
        with pytest.raises(SwapInProgressError) as ei:
            router.swap_weights(checkpoint_dir="/nowhere")
        assert ei.value.version == 42 and "42" in str(ei.value)
        with pytest.raises(SwapInProgressError):
            router.swap_one(checkpoint_dir="/nowhere")
        router._release_swap()
        assert isinstance(ei.value, MXNetError)
    finally:
        router.shutdown()


def test_swap_one_touches_exactly_one_replica(tmp_path):
    router = _fleet(2)
    try:
        ck = _write_ckpt(tmp_path, IDENT * 2.0, 1)
        out = router.swap_one("r1", checkpoint_dir=ck, version=1)
        assert out["swapped"] == ["r1"]
        versions = {rid: s["version"]
                    for rid, s in router.stats()["replicas"].items()}
        assert versions["r0"] == 0 and versions["r1"] == 1
        assert router._swap_inflight is None
    finally:
        router.shutdown()


# -- the publisher ------------------------------------------------------------

def test_publisher_cadence_and_watermark(tmp_path):
    ck_root = tmp_path / "ck"
    reg = ModelRegistry(str(tmp_path / "reg"))
    _write_ckpt(ck_root, IDENT, 2)
    pub = CheckpointPublisher(reg, str(ck_root), publish_steps=4,
                              publish_secs=0)
    for step in range(3):
        pub.poll(step)
    assert reg.latest() is None
    pub.poll(3)
    rec = reg.latest()
    assert rec["version"] == 2
    wm = rec["watermark"]
    assert wm["step"] == 2 and wm["nbatch"] == 2 and wm["time"] > 0
    for step in range(4, 7):
        pub.poll(step)
    assert pub.stats()["published"] == 1
    _write_ckpt(ck_root, IDENT, 6)
    pub.poll(7)
    assert reg.latest()["version"] == 6
    assert pub.stats()["published"] == 2


def test_publisher_never_publishes_suspect_checkpoints(tmp_path):
    ck_root = tmp_path / "ck"
    reg = ModelRegistry(str(tmp_path / "reg"))
    _write_ckpt(ck_root, IDENT, 2, health="healthy")
    _write_ckpt(ck_root, -IDENT, 4, health="suspect")
    pub = CheckpointPublisher(reg, str(ck_root), publish_steps=1,
                              publish_secs=0)
    pub.poll(5)
    assert reg.latest()["version"] == 2


def test_publisher_fences_rollback_window(tmp_path):
    ck_root = tmp_path / "ck"
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = CheckpointPublisher(reg, str(ck_root), publish_steps=100,
                              publish_secs=0)
    pub.poll(10)
    pub.poll(4)                           # a regression: fence (5..10)
    assert reg.fences() == [(5, 10)] and pub.stats()["fences"] == 1
    _write_ckpt(ck_root, -IDENT, 7)
    pub2 = CheckpointPublisher(reg, str(ck_root), publish_steps=1,
                               publish_secs=0)
    pub2.poll(20)
    assert reg.latest() is None
    _write_ckpt(ck_root, IDENT, 20)
    pub2.poll(21)
    assert reg.latest()["version"] == 20


def test_publisher_retries_after_torn_publish(tmp_path):
    ck_root = tmp_path / "ck"
    reg = ModelRegistry(str(tmp_path / "reg"))
    _write_ckpt(ck_root, IDENT, 2)
    pub = CheckpointPublisher(reg, str(ck_root), publish_steps=2,
                              publish_secs=0)
    faults.configure("seed=5;publish.commit:torn(at=1)")
    pub.poll(1)
    assert pub.stats()["torn_publishes"] == 1 and reg.latest() is None
    pub.poll(2)
    assert reg.latest()["version"] == 2


def _fit_mlp(pub, ckpt_dir, spec=None, **kw):
    """A small guarded Module.fit through the publisher's `fit`."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((128, 10)).astype("f4")
    y = rng.randint(0, 4, 128).astype("f4")
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(net, num_hidden=4, name="fc2"),
        name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    if spec:
        faults.configure(spec)
    try:
        pub.fit(mod, mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                optimizer_params={"learning_rate": 0.05},
                initializer=mx.initializer.Xavier(), checkpoint_dir=ckpt_dir,
                checkpoint_period=4, **kw)
    finally:
        faults.clear()
    return mod


def test_publisher_fences_the_guardians_rollback_window(tmp_path,
                                                        monkeypatch):
    """Through a real fit: a loss spike's rollback makes the publisher
    fence exactly the window the guardian disowned."""
    monkeypatch.setenv("MXNET_GUARDIAN_INTERVAL", "4")
    monkeypatch.setenv("MXNET_GUARDIAN_SPIKE_WINDOW", "4")
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = CheckpointPublisher(reg, str(tmp_path / "ck"), publish_steps=2,
                              publish_secs=0)
    mod = _fit_mlp(pub, str(tmp_path / "ck"),
                   "seed=7;loss.spike:error(at=10)")
    assert mod._guardian.stats()["rollbacks"] == 1
    lo, hi = mod._guardian.last_rollback_window
    assert (lo, hi) in reg.fences()
    assert not any(lo <= r["version"] <= hi for r in reg.versions())
    assert pub.stats()["published"] >= 1


def test_publisher_fences_after_divergence(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_GUARDIAN_INTERVAL", "4")
    monkeypatch.setenv("MXNET_GUARDIAN_MAX_FAILURES", "2")
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = CheckpointPublisher(reg, str(tmp_path / "ck"), publish_steps=2,
                              publish_secs=0)
    with pytest.raises(TrainingDivergedError):
        _fit_mlp(pub, str(tmp_path / "ck"),
                 "seed=7;grad.nonfinite:error(at=6-30)")
    assert [f for f in reg.fences() if f[0] >= 1]
    assert reg.latest() is None or reg.latest()["version"] <= 4


# -- the controller: the canary gate ------------------------------------------

def _loop_rig(tmp_path, n=2):
    ck_root = tmp_path / "ck"
    reg = ModelRegistry(str(tmp_path / "reg"))
    boot = _write_ckpt(ck_root, IDENT, 1)
    router = _fleet(n)
    ctrl = LoopController(router, reg, HOLDOUT, canary_tol=0.25,
                          poll_interval_s=0.05, freshness_slo_s=120.0,
                          incumbent_checkpoint=boot)
    return ck_root, reg, router, ctrl, boot


def test_canary_promotes_matching_version_and_measures_freshness(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        assert ctrl.poll_once()["status"] == "idle"
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        res = ctrl.poll_once()
        assert res["status"] == "promoted" and res["version"] == 2
        assert res["canary_score"] == pytest.approx(1.0)
        assert res["incumbent_score"] == pytest.approx(1.0)
        assert 0.0 <= res["freshness_lag_s"] < 60.0
        versions = {rid: s["version"]
                    for rid, s in router.stats()["replicas"].items()}
        assert all(v >= 1 for v in versions.values())
        snap = obs_metrics.registry().collect()
        assert snap.get("loop.freshness_lag_s") == \
            pytest.approx(res["freshness_lag_s"])
        assert snap.get("loop.promotions") == 1
        assert snap.get("loop.freshness_slo_met") == 1
        assert ctrl.poll_once()["status"] == "idle"
    finally:
        router.shutdown()


def test_canary_rejects_poisoned_version(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        assert ctrl.poll_once()["status"] == "promoted"
        poisoned = _write_ckpt(ck_root, -IDENT, 3)
        _publish(reg, poisoned, 3)
        with pytest.raises(CanaryRejectedError) as ei:
            ctrl.poll_once()
        err = ei.value
        assert err.version == 3
        assert err.canary_score == pytest.approx(0.0)
        assert err.incumbent_score == pytest.approx(1.0)
        assert reg.rejected(3)["canary_score"] == pytest.approx(0.0)
        assert reg.latest()["version"] == 2
        assert ckpt.is_rejected(poisoned)
        assert _argmax_ok(router)
        assert ctrl.poll_once()["status"] == "idle"
        assert ctrl.stats()["canary_rejections"] == 1
    finally:
        router.shutdown()


def test_canary_eval_failure_fails_closed(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        faults.configure("seed=7;canary.eval:error(at=2)")
        with pytest.raises(CanaryRejectedError) as ei:
            ctrl.poll_once()
        assert ei.value.canary_score == float("-inf")
        assert reg.rejected(2) is not None
        assert ctrl.stats()["eval_failures"] == 1
    finally:
        router.shutdown()


def test_controller_survives_replica_lost_mid_swap(tmp_path):
    from incubator_mxnet_tpu_torch.serving import ReplicaLostError
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        canary_rid = ctrl._pick_canary()[0]
        rep = router.replica(canary_rid)
        real_swap, hits = rep.swap, []

        def dying_swap(*a, **kw):
            if not hits:
                hits.append(1)
                raise ReplicaLostError(canary_rid, reason="killed mid-swap")
            return real_swap(*a, **kw)

        rep.swap = dying_swap
        res = ctrl.poll_once()
        assert res["status"] == "swap-failed" and res["candidate"] == 2
        assert "lost" in res["error"]
        assert ctrl.stats()["swap_failures"] == 1
        assert ctrl.stats()["live_version"] == -1
        assert _argmax_ok(router)
        assert ctrl.poll_once()["status"] == "promoted"
        assert router._swap_inflight is None
    finally:
        router.shutdown()


def test_controller_backs_off_while_swap_in_progress(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        router._acquire_swap("operator-roll")
        res = ctrl.poll_once()
        assert res["status"] == "swap-busy"
        assert res["in_flight"] == "operator-roll"
        assert reg.rejected(2) is None
        router._release_swap()
        assert ctrl.poll_once()["status"] == "promoted"
        assert ctrl.stats()["swap_busy"] == 1
    finally:
        router.shutdown()


def test_controller_keeps_serving_when_registry_vanishes(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        assert ctrl.poll_once()["status"] == "promoted"
        shutil.rmtree(reg.root)
        res = ctrl.poll_once()
        assert res["status"] == "registry-unavailable"
        assert ctrl.stats()["registry_errors"] == 1
        assert ctrl.stats()["live_version"] == 2
        assert _argmax_ok(router, rows=2)
    finally:
        router.shutdown()


def test_controller_background_thread_promotes(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        ctrl.start()
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        deadline = time.monotonic() + 30.0
        while ctrl.stats()["live_version"] != 2 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert ctrl.stats()["live_version"] == 2
    finally:
        ctrl.stop()
        router.shutdown()
    assert not any(t.name == "mx-loop-controller"
                   for t in threading.enumerate())


def test_hung_canary_eval_fails_closed(tmp_path):
    import concurrent.futures
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        rid = ctrl._pick_canary()[0]
        rep = router.replica(rid)
        real_submit, calls = rep.submit, []

        class _Hung:
            def result(self, timeout=None):
                raise concurrent.futures.TimeoutError()

        def submit(*a, **kw):
            calls.append(1)
            if len(calls) == 2:        # the candidate's eval
                return _Hung()
            return real_submit(*a, **kw)

        rep.submit = submit
        with pytest.raises(CanaryRejectedError) as ei:
            ctrl.poll_once()
        assert ei.value.canary_score == float("-inf")
        assert ctrl.stats()["eval_failures"] == 1
        assert reg.rejected(2) is not None
        assert router.stats()["replicas_lost"] == 0
        rep.submit = real_submit
        assert _argmax_ok(router)
    finally:
        router.shutdown()


def test_incumbent_eval_failure_is_eval_failed_not_swap_failed(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        faults.configure("seed=7;canary.eval:error(at=1)")
        res = ctrl.poll_once()
        assert res["status"] == "eval-failed"
        assert res["phase"] == "incumbent" and res["candidate"] == 2
        st = ctrl.stats()
        assert (st["eval_failures"], st["swap_failures"],
                st["canary_rejections"]) == (1, 0, 0)
        assert reg.rejected(2) is None
        assert ctrl.poll_once()["status"] == "promoted"
    finally:
        router.shutdown()


def test_restore_backs_off_when_swap_lock_held(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        assert ctrl.poll_once()["status"] == "promoted"
        _publish(reg, _write_ckpt(ck_root, -IDENT, 3), 3)
        real_swap_one, state = router.swap_one, {"n": 0}

        def swap_one(*a, **kw):
            state["n"] += 1
            if state["n"] == 2:        # the restore's swap back
                raise SwapInProgressError(router.name, "operator-roll")
            return real_swap_one(*a, **kw)

        router.swap_one = swap_one
        with pytest.raises(CanaryRejectedError):
            ctrl.poll_once()
        assert router.stats()["replicas_lost"] == 0
        assert ctrl._pending_restore is not None
        assert ctrl.stats()["swap_busy"] == 1
        assert ctrl.poll_once()["status"] == "idle"
        assert ctrl._pending_restore is None and state["n"] == 3
        assert _argmax_ok(router)
    finally:
        router.shutdown()


def test_aborted_promote_resumes_without_recanary(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        _publish(reg, _write_ckpt(ck_root, IDENT, 2), 2)
        scored = []
        real_score = ctrl._score_replica

        def counting_score(*a, **kw):
            scored.append(1)
            return real_score(*a, **kw)

        ctrl._score_replica = counting_score
        rep1 = router.replica("r1")
        real_swap, hits = rep1.swap, []

        def failing_swap(*a, **kw):
            if not hits:
                hits.append(1)
                raise MXNetError("transient swap fault")
            return real_swap(*a, **kw)

        rep1.swap = failing_swap
        res = ctrl.poll_once()
        assert res["status"] == "swap-failed" and res["candidate"] == 2
        assert len(scored) == 2
        assert ctrl.stats()["live_version"] == -1
        res = ctrl.poll_once()
        assert res["status"] == "promoted" and res["version"] == 2
        assert res["canary_score"] == pytest.approx(1.0)
        assert len(scored) == 2
    finally:
        router.shutdown()


def test_rejection_stamps_source_checkpoint_through_pin(tmp_path):
    ck_root, reg, router, ctrl, boot = _loop_rig(tmp_path)
    try:
        poisoned = _write_ckpt(ck_root, -IDENT, 2)
        rec = reg.publish(poisoned, step=2, health={"status": "healthy"},
                          pin=True)
        assert rec["checkpoint"] != str(poisoned)
        assert rec["source_checkpoint"] == str(poisoned)
        with pytest.raises(CanaryRejectedError):
            ctrl.poll_once()
        assert ckpt.is_rejected(rec["checkpoint"])
        assert ckpt.is_rejected(str(poisoned))
        assert ckpt.latest_healthy(str(ck_root)) == boot
    finally:
        router.shutdown()


def test_loop_knobs_registered():
    from incubator_mxnet_tpu.config import KNOBS as JKNOBS
    from incubator_mxnet_tpu_torch.config import KNOBS
    for name in ("MXNET_LOOP_PUBLISH_STEPS", "MXNET_LOOP_PUBLISH_SECS",
                 "MXNET_LOOP_CANARY_TOL", "MXNET_LOOP_POLL_S",
                 "MXNET_LOOP_FRESHNESS_SLO_S"):
        assert KNOBS[name][1] == JKNOBS[name][1]
        assert mx.config.get(name) == KNOBS[name][1]
