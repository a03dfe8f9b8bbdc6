"""Elastic checkpointing in the PyTorch port (`checkpoint/`, `storage.py`,
`Module.fit(checkpoint_dir=..., resume=...)`, the Estimator's
`ElasticCheckpointHandler`) on the CPU, and checkpoint directories
crossing between the port and the JAX package.

The first cases are `tests/test_checkpoint.py`'s, run against the port:
a torn checkpoint is never selected, retention, the rank-shard layout,
iterator seek and state, crash-and-resume equal to an uninterrupted fit
bit for bit (in process, and across processes after a hard kill),
SIGTERM's final snapshot and exit 143, the async snapshot's overhead,
the Estimator handler, the Trainer/optimizer/scheduler state round
trips, the fused step rebuilt after a resume, and a fresh run refusing
an old run's directory.  Then `tests/test_llm.py`'s LM resume, and the
cross-package cases: the array shard byte for byte, a JAX package
checkpoint loading into the port's Module and one the port wrote
loading into the JAX package's.  The optimizer blobs are each package's
own pickle (a declared divergence); momenta cross through
`compat.weights`.  Tolerance for float32 steps the two packages take
from one state: rtol 1e-4 + 1e-5 * max|ref| (sums in another order,
and a bias near zero after momentum steps loses digits to
cancellation).
"""
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import checkpoint as ckpt
from incubator_mxnet_tpu_torch import nd, sym
from incubator_mxnet_tpu_torch.compat import weights as cw
from incubator_mxnet_tpu_torch.io import NDArrayIter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
STEP_TOL = (1e-4, 1e-5)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _mlp(hidden=16, classes=4):
    d = sym.Variable("data")
    f1 = sym.FullyConnected(d, num_hidden=hidden, name="fc1")
    a1 = sym.Activation(f1, act_type="relu")
    f2 = sym.FullyConnected(a1, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(f2, name="softmax")


# -- manifest / torn-checkpoint crash consistency ----------------------------

def test_latest_skips_torn_checkpoints(tmp_path):
    """A checkpoint with a truncated shard, a corrupted shard, a missing
    manifest, or a garbage manifest is never selected by latest()."""
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=10)
    for step in range(1, 5):
        mgr.snapshot(arrays={"w": np.full((8,), step, "f4")},
                     blobs={"opt": b"state-%d" % step}, step=step,
                     epoch=0, nbatch=step, sync=True)
    mgr.close()
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-0000000004")

    with open(os.path.join(tmp_path, "ckpt-0000000004", "arrays.npk"),
              "r+b") as f:
        f.truncate(max(0, os.path.getsize(f.name) - 7))
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-0000000003")

    shard = os.path.join(tmp_path, "ckpt-0000000003", "opt.bin")
    blob = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(b"X" * len(blob))
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-0000000002")

    os.remove(os.path.join(tmp_path, "ckpt-0000000002", "manifest.json"))
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-0000000001")

    with open(os.path.join(tmp_path, "ckpt-0000000001", "manifest.json"),
              "w") as f:
        f.write("{not json")
    assert ckpt.latest(str(tmp_path)) is None
    with pytest.raises(mx.MXNetError):
        ckpt.load(os.path.join(str(tmp_path), "ckpt-0000000001"))


def test_retention_gc_and_roundtrip(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=2)
    rng = np.random.RandomState(3)
    payloads = {}
    for step in (1, 2, 3, 4, 5):
        payloads[step] = rng.randn(5, 3).astype("f4")
        mgr.snapshot(arrays={"w": payloads[step]}, blobs={"b": b"x" * step},
                     step=step, epoch=step, nbatch=1, sync=True)
    mgr.close()
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt-"))
    assert names == ["ckpt-0000000004", "ckpt-0000000005"]
    data = ckpt.load(ckpt.latest(str(tmp_path)))
    assert data.step == 5 and data.epoch == 5 and data.nbatch == 1
    np.testing.assert_array_equal(data.arrays["w"], payloads[5])
    assert data.blobs["b"] == b"x" * 5
    assert data.rng is not None  # random streams travel in the manifest


def test_rank_shard_layout(tmp_path):
    """dist layout: non-zero ranks publish side shards; rank 0's atomic
    commit adopts them, and a reader gets them back per rank."""
    w1 = ckpt.CheckpointManager(str(tmp_path), rank=1, num_ranks=2)
    w1.snapshot(arrays={"slice": torch.arange(4, dtype=torch.float32)},
                blobs={"opt": b"rank1-opt"}, step=7, sync=True)
    w1.close()
    assert ckpt.latest(str(tmp_path)) is None  # no commit without rank 0

    w0 = ckpt.CheckpointManager(str(tmp_path), rank=0, num_ranks=2)
    w0.snapshot(arrays={"w": np.ones((3,), "f4")}, step=7, sync=True)
    w0.close()
    data = ckpt.load(ckpt.latest(str(tmp_path)))
    shard = data.rank_shard(1)
    np.testing.assert_array_equal(shard["arrays"]["slice"],
                                  np.arange(4, dtype="f4"))
    assert shard["blobs"]["opt"] == b"rank1-opt"
    assert shard["rng"] is not None
    assert data.rank_shard(3) is None


def test_ndarray_iter_seek_and_state():
    X = np.arange(40, dtype="f4").reshape(20, 2)
    it = NDArrayIter(X, np.arange(20, dtype="f4"), batch_size=4,
                     shuffle=True)
    batches = [b.data[0].asnumpy().copy() for b in it]
    state = it.checkpoint_state()
    it.set_checkpoint_state(pickle.loads(pickle.dumps(state)), nbatch=3)
    np.testing.assert_array_equal(next(it).data[0].asnumpy(), batches[3])
    it.seek(2)
    np.testing.assert_array_equal(next(it).data[0].asnumpy(), batches[2])


# -- save -> resume property (in-process) ------------------------------------

def _fit_toy(ckpt_dir=None, resume=False, crash_at=None, num_epoch=2,
             optimizer="sgd", opt_params=None):
    mx.random.seed(7)
    np.random.seed(7)
    X = np.random.RandomState(1).randn(64, 10).astype("f4")
    y = (np.arange(64) % 4).astype("f4")
    it = NDArrayIter(X, y, batch_size=8, shuffle=True)
    mod = mx.mod.Module(_mlp(), context=CPU)

    class _Crash(Exception):
        pass

    cb = None
    if crash_at is not None:
        hits = {"n": 0}

        def cb(param):
            hits["n"] += 1
            if hits["n"] == crash_at:
                raise _Crash()
    try:
        mod.fit(it, optimizer=optimizer,
                optimizer_params=opt_params or {"learning_rate": 0.1,
                                                "momentum": 0.9},
                num_epoch=num_epoch, checkpoint_dir=ckpt_dir,
                checkpoint_period=1, resume=resume, batch_end_callback=cb)
    except _Crash:
        pass
    return mod


def _states_np(mod):
    out = {}
    for k, s in mod._updater.states.items():
        if s is None:
            out[k] = None
        elif isinstance(s, (tuple, list)):
            out[k] = [x.asnumpy() if x is not None else None for x in s]
        else:
            out[k] = s.asnumpy()
    return out


@pytest.mark.parametrize("optimizer,opt_params,crash_at", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 11),
    ("adam", {"learning_rate": 0.01}, 5),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 8),  # epoch boundary
])
def test_save_resume_reproduces_next_steps(monkeypatch, tmp_path,
                                           optimizer, opt_params, crash_at):
    """Crash anywhere, resume, and every later step — params AND
    optimizer slots — matches the uninterrupted run exactly (shuffled
    iterator, momentum/Adam state, update counts all restored)."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    full = _fit_toy(num_epoch=2, optimizer=optimizer, opt_params=opt_params)
    _fit_toy(ckpt_dir=str(tmp_path), crash_at=crash_at, num_epoch=2,
             optimizer=optimizer, opt_params=opt_params)
    assert ckpt.latest(str(tmp_path)) is not None
    resumed = _fit_toy(ckpt_dir=str(tmp_path), resume=True, num_epoch=2,
                       optimizer=optimizer, opt_params=opt_params)
    fa, _ = full.get_params()
    ra, _ = resumed.get_params()
    for k in fa:
        np.testing.assert_array_equal(fa[k].asnumpy(), ra[k].asnumpy(),
                                      err_msg=k)
    sf, sr = _states_np(full), _states_np(resumed)
    assert sf.keys() == sr.keys()
    for k in sf:
        np.testing.assert_array_equal(np.asarray(sf[k]), np.asarray(sr[k]),
                                      err_msg=f"optimizer state {k}")
    assert full._optimizer.num_update == resumed._optimizer.num_update


# -- end-to-end: hard process kill + relaunch --------------------------------

HARNESS = r"""
import os, pickle, sys
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import sym
from incubator_mxnet_tpu_torch.io import NDArrayIter

mode, ckpt_dir, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
KILL_AT = int(os.environ.get("KILL_AT", "11"))

def build():
    d = sym.Variable("data")
    f1 = sym.FullyConnected(d, num_hidden=16, name="fc1")
    a1 = sym.Activation(f1, act_type="relu")
    f2 = sym.FullyConnected(a1, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(f2, name="softmax")

mx.random.seed(7); np.random.seed(7)
X = np.random.RandomState(1).randn(64, 10).astype("f4")
y = (np.arange(64) % 4).astype("f4")
it = NDArrayIter(X, y, batch_size=8, shuffle=True)
mod = mx.mod.Module(build(), context=mx.cpu())

cb = None
if mode == "crash":
    hits = {"n": 0}
    def cb(param):
        hits["n"] += 1
        if hits["n"] == KILL_AT:
            os._exit(9)   # hard kill: no flush, no atexit, writer may tear
mod.fit(it, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        num_epoch=2,
        checkpoint_dir=(ckpt_dir if mode != "full" else None),
        checkpoint_period=1, resume=(mode == "resume"),
        batch_end_callback=cb)

states = {}
for k, s in mod._updater.states.items():
    states[k] = None if s is None else s.asnumpy()
arg, aux = mod.get_params()
with open(out_path, "wb") as f:
    pickle.dump({"params": {k: v.asnumpy() for k, v in arg.items()},
                 "states": states,
                 "num_update": mod._optimizer.num_update}, f)
print("DONE")
"""


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _run_harness(script, mode, ckpt_dir, out_path):
    return subprocess.run([sys.executable, str(script), mode,
                           str(ckpt_dir), str(out_path)],
                          env=_env(), capture_output=True, text=True,
                          timeout=240)


def test_e2e_hard_kill_resume_bit_for_bit(tmp_path):
    """Train with async checkpointing, hard-kill the process (os._exit
    mid-epoch), relaunch with resume=True: final params and optimizer
    state match the uninterrupted run bit for bit at the same step."""
    script = tmp_path / "harness.py"
    script.write_text(HARNESS)
    ckpt_dir = tmp_path / "ckpts"

    full = _run_harness(script, "full", ckpt_dir, tmp_path / "full.pkl")
    assert full.returncode == 0 and "DONE" in full.stdout, full.stdout + \
        full.stderr

    crash = _run_harness(script, "crash", ckpt_dir, tmp_path / "crash.pkl")
    assert crash.returncode == 9, (crash.returncode, crash.stdout,
                                   crash.stderr)
    assert ckpt.latest(str(ckpt_dir)) is not None, \
        "hard kill must leave at least one committed checkpoint"

    resume = _run_harness(script, "resume", ckpt_dir,
                          tmp_path / "resume.pkl")
    assert resume.returncode == 0 and "DONE" in resume.stdout, \
        resume.stdout + resume.stderr

    a = pickle.load(open(tmp_path / "full.pkl", "rb"))
    b = pickle.load(open(tmp_path / "resume.pkl", "rb"))
    assert a["num_update"] == b["num_update"] == 16
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg=k)
    for k in a["states"]:
        np.testing.assert_array_equal(a["states"][k], b["states"][k],
                                      err_msg=f"optimizer state {k}")


# -- preemption hook ---------------------------------------------------------

PREEMPT_HARNESS = r"""
import os, sys, time
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import sym
from incubator_mxnet_tpu_torch.io import NDArrayIter

ckpt_dir = sys.argv[1]
d = sym.Variable("data")
net = sym.SoftmaxOutput(sym.FullyConnected(d, num_hidden=4, name="fc"),
                        name="softmax")
mx.random.seed(0); np.random.seed(0)
X = np.random.randn(64, 6).astype("f4")
y = (np.arange(64) % 4).astype("f4")
it = NDArrayIter(X, y, batch_size=8)
mod = mx.mod.Module(net, context=mx.cpu())
def slow(param):
    time.sleep(0.05)
print("TRAINING", flush=True)
mod.fit(it, optimizer="sgd", num_epoch=1000, checkpoint_dir=ckpt_dir,
        checkpoint_period=100000, batch_end_callback=slow)
print("FINISHED-UNEXPECTEDLY")
"""


def test_preemption_sigterm_takes_final_snapshot(tmp_path):
    """SIGTERM mid-training -> one final synchronous snapshot, exit 143,
    and the committed checkpoint carries the preemption marker."""
    script = tmp_path / "preempt.py"
    script.write_text(PREEMPT_HARNESS)
    ckpt_dir = tmp_path / "ckpts"
    proc = subprocess.Popen([sys.executable, str(script), str(ckpt_dir)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        # training is underway once the first epoch-end snapshot landed
        while time.time() < deadline:
            if ckpt.latest(str(ckpt_dir), deep=False) is not None:
                break
            time.sleep(0.2)
        else:
            proc.kill()
            pytest.fail("no checkpoint appeared: " + proc.stdout.read())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, (proc.returncode, out)
    assert "FINISHED-UNEXPECTEDLY" not in out
    data = ckpt.load(ckpt.latest(str(ckpt_dir)))
    assert data.meta.get("preempted") is True
    assert data.arrays  # params made it out


# -- async overhead ----------------------------------------------------------

def test_async_snapshot_overhead_within_10pct(monkeypatch, tmp_path):
    """period=1 async checkpointing costs < 10% wall time over the
    no-checkpoint baseline (or 0.2 s): the background serialization
    overlaps the train step.  The toy model is compute-heavy and
    parameter-light (conv), the regime real training runs in."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")

    def convnet():
        d = sym.Variable("data")
        c1 = sym.Convolution(d, kernel=(3, 3), num_filter=16, name="c1")
        a1 = sym.Activation(c1, act_type="relu")
        c2 = sym.Convolution(a1, kernel=(3, 3), num_filter=16, name="c2")
        a2 = sym.Activation(c2, act_type="relu")
        p = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
        f = sym.FullyConnected(sym.Flatten(p), num_hidden=10, name="fc")
        return sym.SoftmaxOutput(f, name="softmax")

    def build_and_fit(ckpt_dir, epochs):
        mx.random.seed(0)
        np.random.seed(0)
        X = np.random.RandomState(0).randn(256, 1, 28, 28).astype("f4")
        y = (np.arange(256) % 10).astype("f4")
        it = NDArrayIter(X, y, batch_size=64)
        mod = mx.mod.Module(convnet(), context=CPU)
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                num_epoch=epochs, checkpoint_dir=ckpt_dir,
                checkpoint_period=1)
        return mod

    def timed(ckpt_dir):
        t0 = time.perf_counter()
        build_and_fit(ckpt_dir, 5)
        return time.perf_counter() - t0

    # one intra-op thread: the step's own time, not the host's load (and
    # no load of ours on tests running beside this one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        build_and_fit(None, 1)                  # warm-up
        # the min of three runs per variant, interleaved: robust to
        # stalls of a shared host that one seconds-long sample is not
        runs = [(timed(None), timed(str(tmp_path / str(i))))
                for i in range(3)]
    finally:
        torch.set_num_threads(threads)
    base = min(b for b, _ in runs)
    with_ckpt = min(c for _, c in runs)
    budget = max(0.10 * base, 0.2)
    assert with_ckpt - base < budget, \
        f"checkpoint overhead {with_ckpt - base:.3f}s over base " \
        f"{base:.3f}s exceeds {budget:.3f}s"
    assert ckpt.latest(str(tmp_path / "0")) is not None


# -- gluon estimator handler -------------------------------------------------

def _make_estimator():
    from incubator_mxnet_tpu_torch import gluon
    mx.random.seed(11)
    np.random.seed(11)
    rng = np.random.RandomState(0)
    X = nd.array(rng.randn(64, 10).astype("f4"), ctx=CPU)
    Y = nd.array((np.arange(64) % 3).astype("f4"), ctx=CPU)
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=16)
    net = gluon.nn.Sequential(prefix="net_")
    net.add(gluon.nn.Dense(16, activation="relu", prefix="h_"),
            gluon.nn.Dense(3, prefix="out_"))
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    return Estimator(net, SoftmaxCrossEntropyLoss(), trainer=trainer), \
        loader


def test_estimator_elastic_handler_resume(monkeypatch, tmp_path):
    """ElasticCheckpointHandler restores net + trainer + position and
    continues mid-epoch after a crashed estimator run."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")

    est_full, loader = _make_estimator()
    est_full.fit(loader, epochs=3, event_handlers=[])

    class Boom(Exception):
        pass

    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import \
        EventHandler

    class CrashAt(EventHandler):
        def __init__(self, at):
            self.at, self.n = at, 0

        def batch_end(self, est):
            self.n += 1
            if self.n == self.at:
                raise Boom()

    est_crash, loader_c = _make_estimator()
    handler = ckpt.ElasticCheckpointHandler(str(tmp_path), period=1,
                                            resume=True,
                                            preemption_hook=False)
    with pytest.raises(Boom):
        est_crash.fit(loader_c, epochs=3,
                      event_handlers=[handler, CrashAt(6)])  # mid epoch 1
    handler.manager.flush()
    data = ckpt.load(ckpt.latest(str(tmp_path)))
    assert (data.epoch, data.nbatch) == (1, 2)

    est_res, loader_r = _make_estimator()
    handler2 = ckpt.ElasticCheckpointHandler(str(tmp_path), period=1,
                                             resume=True,
                                             preemption_hook=False)
    est_res.fit(loader_r, epochs=3, event_handlers=[handler2])
    assert est_res.epoch == 2

    pf = {k: p.list_data()[0].asnumpy()
          for k, p in est_full.net.collect_params().items()}
    pr = {k: p.list_data()[0].asnumpy()
          for k, p in est_res.net.collect_params().items()}
    for k in pf:
        np.testing.assert_allclose(pf[k], pr[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_trainer_checkpoint_state_roundtrip():
    from incubator_mxnet_tpu_torch import gluon, autograd
    mx.random.seed(2)
    net = gluon.nn.Dense(4, in_units=6)
    net.initialize(ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    x = nd.array(np.random.RandomState(0).uniform(size=(8, 6)), ctx=CPU)
    for _ in range(3):
        with autograd.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        trainer.step(8)
    blob = trainer.get_checkpoint_state()
    before = trainer._optimizer.num_update
    moms = cw.trainer_states_to_numpy(trainer)
    for _ in range(2):
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(8)
    trainer.set_checkpoint_state(blob)
    assert trainer._optimizer.num_update == before
    s0 = trainer._updaters[0].states
    assert s0, "momentum slots restored"
    for i, m in cw.trainer_states_to_numpy(trainer).items():
        np.testing.assert_array_equal(m, moms[i])


def test_lr_scheduler_state_roundtrip():
    sched = mx.lr_scheduler.FactorScheduler(step=4, factor=0.5)
    sched.base_lr = 0.8
    for i in range(10):
        sched(i)
    state = sched.state_dict()
    fresh = mx.lr_scheduler.FactorScheduler(step=4, factor=0.5)
    fresh.load_state_dict(state)
    assert fresh.base_lr == sched.base_lr and fresh.count == sched.count
    assert fresh(11) == sched(11)


def test_optimizer_state_dict_counters():
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    w = nd.ones((3,), ctx=CPU)
    g = nd.ones((3,), ctx=CPU)
    st = opt.create_state(0, w)
    for _ in range(5):
        opt.update(0, w, g, st)
    d = opt.state_dict()
    assert d["num_update"] == 5
    fresh = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    fresh.load_state_dict(d)
    assert fresh.num_update == 5
    assert fresh._index_update_count == {0: 5}


def test_resume_rebuilds_fused_step_with_restored_optimizer(tmp_path):
    """With the fused train step on (the default), the resumed module's
    fused step, updater and Module drive ONE optimizer, the restored
    one, whose num_update continues from the checkpoint."""
    full = _fit_toy(num_epoch=2, optimizer="adam",
                    opt_params={"learning_rate": 0.01})
    _fit_toy(ckpt_dir=str(tmp_path), crash_at=11, num_epoch=2,
             optimizer="adam", opt_params={"learning_rate": 0.01})
    resumed = _fit_toy(ckpt_dir=str(tmp_path), resume=True, num_epoch=2,
                       optimizer="adam", opt_params={"learning_rate": 0.01})
    assert resumed._optimizer.num_update == full._optimizer.num_update == 16
    assert resumed._updater.optimizer is resumed._optimizer
    fs = resumed._fused_step
    assert fs is not None and fs.steps == 16 - 10
    assert fs._updater.optimizer is resumed._optimizer
    fa, _ = full.get_params()
    ra, _ = resumed.get_params()
    for k in fa:
        np.testing.assert_array_equal(fa[k].asnumpy(), ra[k].asnumpy(),
                                      err_msg=k)


def test_ndarray_iter_roll_over_seek():
    """roll_over epochs start mid-stride (carried samples); seek must
    anchor at the epoch-start cursor, not assume n*batch_size."""
    X = np.arange(20, dtype="f4").reshape(10, 2)
    it = NDArrayIter(X, np.arange(10, dtype="f4"), batch_size=4,
                     shuffle=False, last_batch_handle="roll_over")
    for _ in it:
        pass
    it.reset()
    wanted = [b.data[0].asnumpy().copy() for b in it]
    it.reset()
    state = it.checkpoint_state()
    it2 = NDArrayIter(X, np.arange(10, dtype="f4"), batch_size=4,
                      shuffle=False, last_batch_handle="roll_over")
    for _ in it2:
        pass
    it2.reset()
    it2.set_checkpoint_state(state, nbatch=1)
    np.testing.assert_array_equal(next(it2).data[0].asnumpy(), wanted[1])


def test_fresh_run_refuses_dir_with_old_checkpoints(tmp_path):
    """resume=False into a directory holding another run's checkpoints
    fails loudly; resume=True is the way to keep going."""
    _fit_toy(ckpt_dir=str(tmp_path), num_epoch=1)
    assert ckpt.latest(str(tmp_path)) is not None
    with pytest.raises(mx.MXNetError, match="previous run"):
        _fit_toy(ckpt_dir=str(tmp_path), num_epoch=1)
    _fit_toy(ckpt_dir=str(tmp_path), resume=True, num_epoch=2)


# -- the LM ------------------------------------------------------------------

def _lm_data(vocab, n=64, bs=8, t=12, seed=3):
    """Synthetic periodic token stream (`tests/test_llm.py`'s)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, vocab, t + 1)
    x = np.empty((n, t), np.float32)
    y = np.empty((n, t), np.float32)
    for i in range(n):
        roll = np.roll(base, i % (t + 1))
        x[i] = roll[:t]
        y[i] = roll[1:]
    return NDArrayIter(x, y, batch_size=bs, shuffle=False,
                       label_name="softmax_label")


class _Crash(Exception):
    pass


def _fit_lm(ckpt_dir=None, crash_at=None, resume=False, num_epoch=2):
    from incubator_mxnet_tpu_torch.llm import LMConfig, lm_symbol
    cfg = LMConfig(vocab_size=40, num_layers=2, num_heads=2, hidden=16,
                   max_len=48, eos_id=0)
    mx.random.seed(11)
    np.random.seed(11)
    mod = mx.mod.Module(lm_symbol(cfg), context=CPU)
    cb = None
    if crash_at is not None:
        hits = {"n": 0}

        def cb(param):
            hits["n"] += 1
            if hits["n"] == crash_at:
                raise _Crash()
    try:
        mod.fit(_lm_data(cfg.vocab_size), num_epoch=num_epoch,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                eval_metric="acc", initializer=mx.initializer.Xavier(),
                checkpoint_dir=ckpt_dir, checkpoint_period=1,
                resume=resume, batch_end_callback=cb)
    except _Crash:
        pass
    return mod


def test_lm_checkpoint_resume_bit_identical(tmp_path):
    """Crash the LM fit mid-epoch under the elastic checkpointer, resume,
    and land bit-identical to the uninterrupted run."""
    full = _fit_lm()
    _fit_lm(ckpt_dir=str(tmp_path), crash_at=9)
    resumed = _fit_lm(ckpt_dir=str(tmp_path), resume=True)
    fa, _ = full.get_params()
    ra, _ = resumed.get_params()
    assert fa.keys() == ra.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k].asnumpy(), ra[k].asnumpy(),
                                      err_msg=k)
    sf, sr = _states_np(full), _states_np(resumed)
    for k in sf:
        np.testing.assert_array_equal(sf[k], sr[k], err_msg=f"momentum {k}")


# -- the pinned staging pool and the pickled states --------------------------

def test_staging_pool_reuses_size_classes():
    from incubator_mxnet_tpu_torch.storage import HostStagingPool
    pool = HostStagingPool(max_bytes=1 << 20, pin=False)
    t, raw = pool.acquire((3, 5), torch.bfloat16)
    assert t.shape == (3, 5) and t.dtype == torch.bfloat16
    assert raw.numel() == 4096           # the smallest size class
    assert pool.release(raw) and not pool.release(raw)
    t2, raw2 = pool.acquire((100,), "float32")
    assert raw2 is raw and pool.stats()["hits"] == 1
    big, raw3 = pool.acquire((1 << 19,), "float32")   # 2 MiB: over max
    assert raw3.numel() == 1 << 21 and not pool.release(raw3)


def test_staged_optimizer_blob_equals_get_states():
    """The background-built optimizer blob (its arrays out of band,
    written from the staged buffer) reads back as the states and
    optimizer `Updater.get_states` holds at staging time, although the
    states are updated in place right after staging."""
    from incubator_mxnet_tpu_torch.checkpoint import state as cstate
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    upd = mx.optimizer.get_updater(opt)
    w = nd.array(np.arange(6, dtype="f4"), ctx=CPU)
    g = nd.array(np.ones(6, "f4"), ctx=CPU)
    upd(0, g, w)
    want = pickle.loads(upd.get_states(dump_optimizer=True))
    build, staged = cstate.stage_updater_states(upd)
    upd(0, g, w)                             # in place, after staging
    parts = build()
    assert parts[-1] is staged.payload       # written from the staging
    blob = b"".join(bytes(memoryview(p).cast("B")) for p in parts)
    states, opt2 = mx.optimizer.loads_states(blob)
    staged.release()
    np.testing.assert_array_equal(states[0].asnumpy(),
                                  want[0][0].asnumpy())
    assert opt2.num_update == want[1].num_update == 1
    assert upd.optimizer.num_update == 2


def test_card_pickle_loads_without_a_card():
    """An NDArray pickled under a card's context loads on the CPU where
    this machine has no such card; a CPU one stays on the CPU."""
    a = mx.nd.NDArray(torch.arange(4, dtype=torch.float32), ctx=mx.gpu(0))
    b = pickle.loads(pickle.dumps(a))
    if not torch.cuda.is_available():
        assert b.context == CPU
    np.testing.assert_array_equal(b.asnumpy(), np.arange(4, dtype="f4"))
    c = pickle.loads(pickle.dumps(nd.array(np.ones(3), ctx=CPU)))
    assert c.context == CPU


# -- crossing between the packages -------------------------------------------

def test_array_shard_bytes_equal_the_jax_packages(tmp_path):
    """One table of arrays (float32 from numpy and from a tensor, int32,
    a scalar) written by each package: the shard files are equal byte
    for byte, and each package reads the other's.  bfloat16:
    the port writes it under the JAX package's dtype string, and the JAX
    package reads it back bit for bit (its own writer cannot take an
    `ml_dtypes` array through `memoryview`, so it has no file to
    compare)."""
    from incubator_mxnet_tpu.checkpoint import snapshot as jsnap
    from incubator_mxnet_tpu_torch.checkpoint import snapshot as tsnap
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 4).astype("f4")
    i32 = np.arange(5, dtype=np.int32)
    jarrays = {"arg:w": f32, "aux:i": i32, "s": np.float32(2.5).reshape(())}
    tarrays = {"arg:w": torch.from_numpy(f32), "aux:i": i32,
               "s": torch.tensor(2.5)}
    jn, tn = tmp_path / "j.npk", tmp_path / "t.npk"
    assert jsnap.write_array_shard(str(jn), jarrays) == \
        tsnap.write_array_shard(str(tn), tarrays)
    assert jn.read_bytes() == tn.read_bytes()
    back = tsnap.read_array_shard(str(jn))
    for k in jarrays:
        np.testing.assert_array_equal(back[k], jarrays[k])
        assert back[k].dtype == jarrays[k].dtype
    bits = rng.randint(0, 1 << 16, (2, 3)).astype(np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0      # no NaN/inf bit patterns
    bf = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    bn = tmp_path / "b.npk"
    tsnap.write_array_shard(str(bn), {"arg:b": bf})
    jback = jsnap.read_array_shard(str(bn))["arg:b"]
    assert str(jback.dtype) == "bfloat16"
    np.testing.assert_array_equal(jback.view(np.uint16), bits)
    tback = tsnap.read_array_shard(str(bn))["arg:b"]
    assert tback.dtype == torch.bfloat16
    assert torch.equal(tback.view(torch.int16), bf.view(torch.int16))


def _jax_sym():
    return jmx.sym.load_json(_mlp().tojson())


def _toy_iter(pkg):
    X = np.random.RandomState(1).randn(64, 10).astype("f4")
    y = (np.arange(64) % 4).astype("f4")
    return pkg.io.NDArrayIter(X, y, batch_size=8, shuffle=False)


def _one_step(mod, pkg, ctx):
    X = np.random.RandomState(5).randn(8, 10).astype("f4")
    y = (np.arange(8) % 4).astype("f4")
    b = pkg.io.DataBatch(data=[pkg.nd.array(X, ctx=ctx)],
                         label=[pkg.nd.array(y, ctx=ctx)])
    mod.forward_backward(b)
    mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _in_thread(fn):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", fn()))
    t.start()
    t.join(240)
    assert "v" in out
    return out["v"]


def test_jax_checkpoint_loads_into_port_module(tmp_path, monkeypatch):
    """A directory the JAX package's `Module.fit` wrote validates in the
    port; its arg:/aux: shards load into the port's Module bit for bit,
    and with the momenta crossed through `compat.weights` one more SGD
    step agrees between the packages."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    d = str(tmp_path)
    opt = {"learning_rate": 0.1, "momentum": 0.9}

    def jax_fit():
        jmx.random.seed(7)
        m = jmx.mod.Module(_jax_sym(), context=jmx.cpu())
        m.fit(_toy_iter(jmx), optimizer="sgd", optimizer_params=opt,
              num_epoch=1, checkpoint_dir=d, checkpoint_period=3)
        return m
    jmod = _in_thread(jax_fit)
    path = ckpt.latest(d)
    assert path is not None and ckpt.manifest.validate(path)
    data = ckpt.load(path)
    assert (data.epoch, data.nbatch, data.step) == (1, 0, 8)
    arg, aux = ckpt.state.split_params(data.arrays)
    jarg, _ = jmod.get_params()
    assert arg.keys() == jarg.keys()
    for k in arg:
        np.testing.assert_array_equal(arg[k].asnumpy(), jarg[k].asnumpy())
    tmod = mx.mod.Module(_mlp(), context=CPU)
    tmod.bind(data_shapes=[("data", (8, 10))],
              label_shapes=[("softmax_label", (8,))])
    tmod.init_params(arg_params=arg, aux_params=aux)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    cw.module_states_from_numpy(tmod, cw.module_states_to_numpy(jmod))
    want = _one_step(jmod, jmx, jmx.cpu())
    got = _one_step(tmod, mx, CPU)
    for k in want:
        _close(got[k], want[k], STEP_TOL, k)


def test_port_checkpoint_loads_into_jax_module(tmp_path, monkeypatch):
    """A directory the port's `Module.fit` wrote validates in the JAX
    package, its manifest's step/epoch/batch and random streams read
    there, its arrays load into the JAX Module bit for bit, and with the
    momenta crossed one more SGD step agrees."""
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    from incubator_mxnet_tpu import checkpoint as jckpt
    d = str(tmp_path)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    mx.random.seed(7)
    tmod = mx.mod.Module(_mlp(), context=CPU)
    tmod.fit(_toy_iter(mx), optimizer="sgd", optimizer_params=opt,
             num_epoch=1, checkpoint_dir=d, checkpoint_period=3)
    path = jckpt.latest(d)
    assert path is not None and jckpt.manifest.validate(path)
    data = jckpt.load(path)
    assert (data.epoch, data.nbatch, data.step) == (1, 0, 8)
    assert data.rng["host_seq"] == [7, mx.random._state.host_seq[1]]
    assert data.meta["optimizer"]["num_update"] == 8
    targ, _ = tmod.get_params()
    arg, aux = jckpt.state.split_params(data.arrays)
    for k in targ:
        np.testing.assert_array_equal(arg[k].asnumpy(), targ[k].asnumpy())
    # the port's optimizer blob, read by the port, crosses as numpy
    states, _ = mx.optimizer.loads_states(
        data.blobs[ckpt.state.OPTIMIZER_BLOB])
    moms = {i: s.asnumpy() for i, s in states.items()}
    for i, m in cw.module_states_to_numpy(tmod).items():
        np.testing.assert_array_equal(moms[i], m)

    def jax_side():
        m = jmx.mod.Module(_jax_sym(), context=jmx.cpu())
        m.bind(data_shapes=[("data", (8, 10))],
               label_shapes=[("softmax_label", (8,))])
        m.init_params(arg_params=arg, aux_params=aux)
        m.init_optimizer(optimizer="sgd", optimizer_params=opt)
        for i, v in moms.items():
            m._updater.states[i] = jmx.nd.array(v)
        return _one_step(m, jmx, jmx.cpu())
    want = _in_thread(jax_side)
    got = _one_step(tmod, mx, CPU)
    for k in want:
        _close(got[k], want[k], STEP_TOL, k)


def test_adam_matches_jax_package():
    """`optimizer.Adam` (bias-corrected lr, weight decay, clipping) takes
    the JAX package's steps from the same weights and gradients."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 5).astype("f4")
    grads = [rng.randn(4, 5).astype("f4") for _ in range(4)]
    kw = dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5,
              rescale_grad=0.5)
    results = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        opt = pkg.optimizer.Adam(**kw)
        opt.set_wd_mult({})
        w = pkg.nd.array(w0, ctx=ctx)
        st = opt.create_state(0, w)
        for g in grads:
            opt.update(0, w, pkg.nd.array(g, ctx=ctx), st)
        results.append((w.asnumpy(), st[0].asnumpy(), st[1].asnumpy()))
    for want, got in zip(*results):
        _close(got, want, STEP_TOL)
