"""The training guardian in the PyTorch port (`resilience.guardian`, the
fused step's health word, `Module.fit`'s skip / rollback / quarantine /
divergence plane) against the JAX package on the CPU, case for case
with tests/test_guardian.py (its ``nan-swallow`` lint waits for the
port's analysis package).

Both packages train the same seeded mlp (tanh, and a ReLU variant whose
FullyConnected+ReLU pairs become kernel K1 under ``TPU_PALLAS``) from
the same numpy parameters and batches; the JAX package runs one step a
dispatch (``MXNET_FUSED_STEP_BLOCK=1``), as the port does, so both poll
after the same steps.  Held: the skipped steps, the rollback step, the
quarantine lines and `TrainingDivergedError`'s step and shard equal;
the displacement signals rtol 1e-3 (float32 sums in other orders), and
the detector's float64 arithmetic on the same signals rtol 1e-5; final
parameters phase 6's tolerance, rtol 1e-3 + 1e-4 * max|ref|.  Within the
port: a skip and a rollback are sha256-equal to their reference runs,
and a healthy guarded step is bit-identical to an unguarded one.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.resilience import faults as jfaults
from incubator_mxnet_tpu.resilience import guardian as jguardian

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import recordio as trecordio
from incubator_mxnet_tpu_torch.resilience import faults
from incubator_mxnet_tpu_torch.resilience import guardian
from incubator_mxnet_tpu_torch.resilience.guardian import (
    QuarantineLog, RollbackRequested, TrainingDivergedError,
    TrainingGuardian)

FIT_TOL = (1e-3, 1e-4)       # phase 6's gate on parameters after a fit
SIGNAL_TOL = 1e-3            # displacement signals, float32
DETECTOR_TOL = 1e-5          # the detector's float64 EWMA on equal inputs
LR = 0.05


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP_BLOCK", "1")
    faults.clear()
    jfaults.clear()
    guardian.reset_findings()
    yield
    faults.clear()
    jfaults.clear()
    guardian.reset_findings()


@pytest.fixture()
def fast_guardian(monkeypatch):
    monkeypatch.setenv("MXNET_GUARDIAN_INTERVAL", "4")
    monkeypatch.setenv("MXNET_GUARDIAN_SPIKE_WINDOW", "4")


def _sym(pkg, act="tanh"):
    s = pkg.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
    net = s.Activation(net, act_type=act, name="act1")
    net = s.FullyConnected(net, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.normal(0, 0.3, (16, 10)).astype("f4"),
            "fc1_bias": rng.normal(0, 0.1, 16).astype("f4"),
            "fc2_weight": rng.normal(0, 0.3, (4, 16)).astype("f4"),
            "fc2_bias": rng.normal(0, 0.1, 4).astype("f4")}


def _data(pkg, n=128, bs=8):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((n, 10)).astype("float32")
    y = rng.randint(0, 4, n).astype("float32")
    return pkg.io.NDArrayIter(x, y, batch_size=bs, shuffle=False)


def _module(pkg, act="tanh"):
    return pkg.mod.Module(_sym(pkg, act), context=pkg.cpu())


def _fit(pkg, mod=None, ckpt=None, n=128, num_epoch=2, resume=False,
         act="tanh"):
    mod = mod or _module(pkg, act)
    mod.fit(_data(pkg, n=n), num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": LR}, eval_metric="acc",
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in _params().items()},
            checkpoint_dir=ckpt, checkpoint_period=4, resume=resume)
    return mod


def _sha(mod):
    args, auxs = mod.get_params()
    h = hashlib.sha256()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


def _close_params(tmod, jmod):
    got, want = tmod.get_params()[0], jmod.get_params()[0]
    assert sorted(got) == sorted(want)
    rtol, atol = FIT_TOL
    for k in want:
        w = want[k].asnumpy()
        np.testing.assert_allclose(got[k].asnumpy(), w, rtol=rtol,
                                   atol=atol * np.abs(w).max(), err_msg=k)


_DECISION_KEYS = ("reason", "step", "epoch", "nbatch", "shard")


def _held_quarantine(tpath, jpath):
    """The two quarantine files hold the same decisions in order; the
    signals within SIGNAL_TOL."""
    tq = QuarantineLog(tpath).load()
    jq = jguardian.QuarantineLog(jpath).load()
    assert [{k: e.get(k) for k in _DECISION_KEYS} for e in tq] == \
        [{k: e.get(k) for k in _DECISION_KEYS} for e in jq]
    for te, je in zip(tq, jq):
        if je.get("signal") is None:
            assert te.get("signal") is None
        else:
            assert te["signal"] == pytest.approx(je["signal"],
                                                 rel=SIGNAL_TOL)
    return tq


_STAT_KEYS = ("steps_observed", "polls", "skips", "spikes", "rollbacks",
              "quarantined", "injected_nonfinite", "injected_spike",
              "consecutive_failures", "pending_rollback_step")


def _held_stats(tmod, jmod):
    ts, js = tmod._guardian.stats(), jmod._guardian.stats()
    assert {k: ts[k] for k in _STAT_KEYS} == {k: js[k] for k in _STAT_KEYS}
    return ts


# -- the health word ----------------------------------------------------------

@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_guardian_observes_every_step_like_jax(monkeypatch, act):
    if act == "relu":
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    tmod, jmod = _fit(tmx, act=act), _fit(jmx, act=act)
    st = _held_stats(tmod, jmod)
    assert st["steps_observed"] == 32          # 128 / 8 batches x 2 epochs
    assert st["skips"] == st["spikes"] == st["rollbacks"] == 0
    assert tmod._fused_step._guardian is tmod._guardian
    assert tmod._guardian.stats()["signal_ewma"] == pytest.approx(
        jmod._guardian.stats()["signal_ewma"], rel=SIGNAL_TOL)
    _close_params(tmod, jmod)
    if act == "relu":
        graph = tmod._exec_group.execs[0]._symbol.tojson()
        assert graph.count('"_sg_pallas_fc_relu"') == 1


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_skip_batch_matches_jax_and_is_deterministic(monkeypatch, tmp_path,
                                                      fast_guardian, act):
    if act == "relu":
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    spec = "seed=7;grad.nonfinite:error(at=5)"
    shas = []
    for run in range(2):
        faults.configure(spec)
        tmod = _fit(tmx, ckpt=str(tmp_path / f"t{run}"), act=act)
        faults.clear()
        shas.append(_sha(tmod))
    assert shas[0] == shas[1]
    jfaults.configure(spec)
    jmod = _fit(jmx, ckpt=str(tmp_path / "j"), act=act)
    jfaults.clear()
    st = _held_stats(tmod, jmod)
    assert st["skips"] == 1 and st["injected_nonfinite"] == 1
    q = _held_quarantine(str(tmp_path / "t1" / "quarantine.jsonl"),
                         str(tmp_path / "j" / "quarantine.jsonl"))
    assert [(e["reason"], e["step"]) for e in q] == [("nonfinite", 5)]
    for name, arr in tmod.get_params()[0].items():
        assert np.isfinite(arr.asnumpy()).all(), name
    _close_params(tmod, jmod)


class _NanIter:
    """Batch 2 of each epoch is NaN data (either package's iterator)."""

    def __init__(self, pkg, n=32):
        self._pkg = pkg
        self._inner = _data(pkg, n=n)
        self.batch_size = self._inner.batch_size
        self._i = 0

    provide_data = property(lambda self: self._inner.provide_data)
    provide_label = property(lambda self: self._inner.provide_label)

    def __iter__(self):
        return self

    def reset(self):
        self._inner.reset()
        self._i = 0

    def __next__(self):
        self._i += 1
        batch = self._inner.next()
        if self._i != 2:
            return batch
        nan = self._pkg.nd.array(np.full((8, 10), np.nan, np.float32),
                                ctx=self._pkg.cpu())
        return self._pkg.io.DataBatch(
            data=[nan], label=batch.label, pad=0,
            provide_data=batch.provide_data,
            provide_label=batch.provide_label)

    next = __next__


def test_nan_batch_guardian_on_vs_off(monkeypatch):
    """Without the guardian a NaN batch poisons the parameters; with it
    (the default) the update is refused and they stay finite."""
    def run():
        mod = _module(tmx)
        mod.fit(_NanIter(tmx), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": LR}, eval_metric="acc",
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in _params().items()})
        return [a.asnumpy() for a in mod.get_params()[0].values()], mod

    vals_on, mod = run()
    assert all(np.isfinite(v).all() for v in vals_on)
    assert mod._guardian.stats()["skips"] == 1
    monkeypatch.setenv("MXNET_GUARDIAN", "0")
    vals_off, mod = run()
    assert mod._guardian is None
    assert not all(np.isfinite(v).all() for v in vals_off)


def test_refused_step_leaves_state_bit_identical():
    """A step whose gradients are NaN leaves the weights, the momenta and
    the metric's totals bit for bit as they were; the update counts
    advance (the unit the select covers, one step at a time)."""
    mod = _module(tmx)
    it = _data(tmx, n=16)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in _params().items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LR, "momentum": 0.9})
    g = TrainingGuardian(interval=1000)
    g.attach(mod)
    metric = tmx.metric.create("acc")
    batches = list(it)
    mod.fit_step(batches[0], metric)          # momenta now non-zero

    def state():
        ws = [mod._exec_group.execs[0].arg_dict[n].data.clone()
              for n in sorted(_params())]
        moms = [s.data.clone() for _, s in
                sorted(mod._updater.states.items())]
        return ws, moms, [t.clone() for t in metric._device_totals]

    before = state()
    count = dict(mod._optimizer._index_update_count)
    faults.configure("grad.nonfinite:error(at=1)")   # the next hit
    mod.fit_step(batches[1], metric)
    after = state()
    for a, b in zip(sum(before, []), sum(after, [])):
        assert a.dtype == b.dtype and a.numpy().tobytes() == \
            b.numpy().tobytes()
    assert all(mod._optimizer._index_update_count[i] == c + 1
               for i, c in count.items())
    g.maybe_poll(2, force=True)
    assert g.stats()["skips"] == 1


def test_guarded_matches_unguarded_bitwise(monkeypatch):
    """The health word and the select do not change a healthy step."""
    sha_on = _sha(_fit(tmx))
    monkeypatch.setenv("MXNET_GUARDIAN", "0")
    sha_off = _sha(_fit(tmx))
    assert sha_on == sha_off


def test_detector_float64_matches_jax():
    """The spike detector's log-space EWMA, sigma band and displacement
    gate on one sequence of float64 signals: the same classifications,
    the same EWMA and the same last good step."""
    rng = np.random.RandomState(5)
    sigs = np.exp(rng.normal(-4.0, 0.3, 40))
    sigs[29] = 40.0                          # a spike past the gate
    out = []
    for mod in (guardian, jguardian):
        g = mod.TrainingGuardian(interval=8, window=4, max_failures=100)
        g._gstep = len(sigs)
        raw = [((0, i), i + 1, 1.0, float(s)) for i, s in enumerate(sigs)]
        tokens = g._classify(raw)
        out.append(([t[4] for t in tokens], g._ewma_linear(),
                    g._last_good_step))
    (tspikes, tew, tlast), (jspikes, jew, jlast) = out
    assert tspikes == jspikes and tspikes.count(True) == 1
    assert tlast == jlast == 29
    assert tew == pytest.approx(jew, rel=DETECTOR_TOL)


# -- rollback -----------------------------------------------------------------

def test_spike_rollback_matches_jax_and_a_clean_run(tmp_path, fast_guardian):
    spec = "seed=7;loss.spike:error(at=10)"
    faults.configure(spec)
    tmod = _fit(tmx, ckpt=str(tmp_path / "t"))
    faults.clear()
    jfaults.configure(spec)
    jmod = _fit(jmx, ckpt=str(tmp_path / "j"))
    jfaults.clear()
    st = _held_stats(tmod, jmod)
    assert st["rollbacks"] == 1 and st["spikes"] == 1
    assert tmod._guardian.last_rollback_window == \
        jmod._guardian.last_rollback_window == (10, 10)
    q = _held_quarantine(str(tmp_path / "t" / "quarantine.jsonl"),
                         str(tmp_path / "j" / "quarantine.jsonl"))
    assert [e["step"] for e in q] == [10, 11, 12]
    assert q[0]["signal"] > 1e3              # the 1e6-scaled step
    _close_params(tmod, jmod)
    # a clean run over the same quarantine ends sha256-equal
    os.makedirs(tmp_path / "ref")
    (tmp_path / "ref" / "quarantine.jsonl").write_text(
        (tmp_path / "t" / "quarantine.jsonl").read_text())
    ref = _fit(tmx, ckpt=str(tmp_path / "ref"))
    assert ref._guardian.stats()["rollbacks"] == 0
    assert _sha(tmod) == _sha(ref)


def test_rollback_restores_the_newest_healthy_checkpoint(tmp_path,
                                                         fast_guardian):
    """Rollback resumes from `latest_healthy(max_step=last good)`, not
    from `latest()`: a suspect checkpoint past the last good step (here
    the spike's own, stamped before the poll could see it) is passed
    over."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    root = str(tmp_path / "t")
    faults.configure("seed=7;loss.spike:error(at=10)")
    picked = []
    real = ckpt.latest_healthy

    def spy(root_, max_step=None, **kw):
        path = real(root_, max_step=max_step, **kw)
        picked.append((max_step, path))
        return path

    ckpt.latest_healthy = spy
    try:
        _fit(tmx, ckpt=root)
    finally:
        ckpt.latest_healthy = real
    assert picked and picked[0][0] == 9
    assert picked[0][1].endswith("ckpt-%010d" % 8)


def test_health_stamp_in_manifest(tmp_path):
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    _fit(tmx, ckpt=str(tmp_path / "ck"))
    manifest = ckpt.manifest.read_manifest(ckpt.latest(str(tmp_path / "ck")))
    health = manifest["meta"]["health"]
    assert health["status"] == "healthy" and health["rollbacks"] == 0


def test_latest_healthy_selection(tmp_path):
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    root = str(tmp_path / "ck")
    for step, status in ((4, "healthy"), (8, "healthy"), (12, "suspect")):
        mgr = ckpt.CheckpointManager(root, async_snapshots=False)
        mgr.snapshot(arrays={"arg:w": np.zeros(2, np.float32)}, step=step,
                     meta={"health": {"status": status}})
        mgr.close()
    assert ckpt.latest(root).endswith("%010d" % 12)
    assert ckpt.latest_healthy(root).endswith("%010d" % 8)
    assert ckpt.latest_healthy(root, max_step=7).endswith("%010d" % 4)
    assert ckpt.latest_healthy(root, max_step=3) is None


def test_rollback_without_checkpoint_dir_does_not_raise(monkeypatch,
                                                        fast_guardian):
    monkeypatch.setenv("MXNET_GUARDIAN_MAX_FAILURES", "100")
    faults.configure("seed=7;loss.spike:error(at=10)")
    mod = _fit(tmx)
    st = mod._guardian.stats()
    assert st["spikes"] >= 1 and st["rollbacks"] == 0
    assert "spike-unrecoverable" in {f.code for f in guardian.findings()}


# -- the budgets --------------------------------------------------------------

def test_divergence_names_step_and_shard_like_jax(monkeypatch,
                                                  fast_guardian):
    monkeypatch.setenv("MXNET_GUARDIAN_MAX_FAILURES", "2")
    spec = "seed=7;grad.nonfinite:error(at=3-12)"
    errs = []
    for pkg, fl, exc in ((tmx, faults, TrainingDivergedError),
                         (jmx, jfaults, jguardian.TrainingDivergedError)):
        fl.configure(spec)
        with pytest.raises(exc) as ei:
            _fit(pkg)
        fl.clear()
        errs.append(ei.value)
    terr, jerr = errs
    assert (terr.step, terr.shard) == (jerr.step, jerr.shard)
    assert terr.signal is None or not np.isfinite(terr.signal)
    assert "ndarray[" in str(terr)
    assert "MXNET_GUARDIAN_MAX_FAILURES" in str(terr)


def test_rollback_budget_escalates(tmp_path, monkeypatch, fast_guardian):
    monkeypatch.setenv("MXNET_GUARDIAN_MAX_ROLLBACKS", "0")
    faults.configure("seed=7;loss.spike:error(at=10)")
    with pytest.raises(TrainingDivergedError, match="rollback") as ei:
        _fit(tmx, ckpt=str(tmp_path / "ck"))
    assert ei.value.step == 10


# -- the quarantine -----------------------------------------------------------

def test_quarantine_skipped_on_resume_like_jax(tmp_path, fast_guardian):
    spec = "seed=7;grad.nonfinite:error(at=5)"
    runs = {}
    for name, pkg, fl in (("t", tmx, faults), ("j", jmx, jfaults)):
        ck = str(tmp_path / name)
        fl.configure(spec)
        _fit(pkg, ckpt=ck, num_epoch=1)
        fl.clear()
        runs[name] = _fit(pkg, ckpt=ck, num_epoch=2, resume=True)
    entries = _held_quarantine(str(tmp_path / "t" / "quarantine.jsonl"),
                               str(tmp_path / "j" / "quarantine.jsonl"))
    assert len(entries) == 1 and entries[0]["reason"] == "nonfinite"
    pos = (entries[0]["epoch"], entries[0]["nbatch"])
    g = runs["t"]._guardian
    assert g.should_skip(*pos) and g.stats()["skips"] == 0
    _held_stats(runs["t"], runs["j"])
    _close_params(runs["t"], runs["j"])


def test_quarantine_log_format_reads_across_packages(tmp_path):
    log = QuarantineLog(str(tmp_path / "q.jsonl"))
    log.append(reason="nonfinite", epoch=0, nbatch=3, step=4)
    log.append(reason="corrupt_record", source="x.rec", record=17)
    log.close()
    lines = (tmp_path / "q.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all("pid" in json.loads(l) for l in lines)
    for cls in (QuarantineLog, jguardian.QuarantineLog):
        other = cls(str(tmp_path / "q.jsonl"))
        assert other.batch_positions() == {(0, 3)}
        assert other.records("x.rec") == {17}


# -- several workers ----------------------------------------------------------

class _StubKV:
    """A kvstore-shaped shared store over either package's NDArrays: push
    adds, pull reads (the accumulation the guardian's exchange
    assumes)."""

    num_workers = 2

    def __init__(self, store, pkg):
        self._store, self._pkg = store, pkg

    def init(self, key, value):
        self._store.setdefault(key, np.zeros_like(value.asnumpy()))

    def push(self, key, value):
        self._store[key] = self._store[key] + value.asnumpy()

    def pull(self, key, out):
        out[:] = self._pkg.nd.array(self._store[key], ctx=self._pkg.cpu())


def test_multi_worker_agreement_like_jax():
    outs = []
    for mod, pkg in ((guardian, tmx), (jguardian, jmx)):
        store = {}
        g_bad = mod.TrainingGuardian(interval=4, window=4)
        g_ok = mod.TrainingGuardian(interval=4, window=4)
        g_bad._wire_kvstore(_StubKV(store, pkg))
        g_ok._wire_kvstore(_StubKV(store, pkg))
        # worker A diagnosed a spike at step 9, worker B saw a clean window
        a = g_bad._agree(np.asarray([0, 1, 9], np.float64))
        b = g_ok._agree(np.asarray([0, 0, 0], np.float64))
        # the store sums across polls: a later clean window is a delta
        again = g_ok._agree(np.asarray([0, 0, 0], np.float64))
        outs.append([list(a), list(b), list(again)])
    assert outs[0] == outs[1]
    a, b, again = outs[0]
    assert a[1] >= 1 and b[1] >= 1 and a[2] == b[2] == 9
    assert again[0] == again[1] == 0


def test_agreement_degrades_to_local():
    g = TrainingGuardian(interval=4, window=4)

    def broken(vec):
        raise ConnectionError("store down")

    g._allreduce = broken
    local = np.asarray([1, 0, 0], np.float64)
    assert (g._agree(local) == local).all()
    assert g.stats()["sync_degraded"] == 1


# -- recordio corruption through the port's reader ----------------------------

def _write_rec(path, payloads):
    w = trecordio.MXRecordIO(str(path), "w")
    for p in payloads:
        w.write(p)
    w.close()


def test_recordio_torn_tail_skips_not_raises(tmp_path):
    rec = tmp_path / "t.rec"
    _write_rec(rec, [b"a" * 40, b"b" * 40, b"c" * 40])
    rec.write_bytes(rec.read_bytes()[:-25])
    r = trecordio.MXRecordIO(str(rec), "r")
    assert r.read() == b"a" * 40 and r.read() == b"b" * 40
    assert r.read() is None and r.corrupt_records == 1
    r.close()


def test_recordio_magic_mismatch_resyncs(tmp_path):
    rec = tmp_path / "m.rec"
    _write_rec(rec, [b"a" * 40, b"b" * 40, b"c" * 40])
    raw = bytearray(rec.read_bytes())
    raw[48] ^= 0xFF
    rec.write_bytes(bytes(raw))
    log = QuarantineLog(str(tmp_path / "q.jsonl"))
    r = trecordio.MXRecordIO(str(rec), "r")
    r.set_quarantine(log)
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    r.close()
    assert b"a" * 40 in got and b"c" * 40 in got
    assert r.corrupt_records >= 1
    assert log.load()[0]["reason"] == "corrupt_record"


def test_corrupt_kind_equals_jax_bytes():
    """`mutate` fires only corrupt clauses' damage, on the same hit, and
    flips the same bytes as the JAX registry under the same seed."""
    payload = bytes(range(64)) * 4
    got = []
    for fl in (faults, jfaults):
        fl.configure("seed=5;io.corrupt_record:corrupt(at=2)")
        fl.fire("io.corrupt_record")            # fire() skips corrupt
        assert fl.trace() == []
        a = fl.mutate("io.corrupt_record", payload)
        b = fl.mutate("io.corrupt_record", payload)
        assert a == payload and b != payload and len(b) == len(payload)
        assert fl.trace()[-1]["kind"] == "corrupt"
        fl.reset()
        fl.mutate("io.corrupt_record", payload)
        assert fl.mutate("io.corrupt_record", payload) == b
        fl.configure("seed=5;io.corrupt_record:corrupt(at=1,bytes=1,"
                     "offset=0)")
        one = fl.mutate("io.corrupt_record", b"\x00" * 8)
        assert one[1:] == b"\x00" * 7 and one != b"\x00" * 8
        got.append((b, one))
        fl.clear()
    assert got[0] == got[1]


def test_reader_corrupt_fault_quarantines_the_record(tmp_path):
    """A ``corrupt`` clause at ``io.corrupt_record`` damages one record
    the port's reader delivers, as in the JAX reader."""
    rec = tmp_path / "c.rec"
    _write_rec(rec, [bytes([65 + i]) * 40 for i in range(4)])
    outs = []
    for rio, fl in ((trecordio, faults), (jmx.recordio, jfaults)):
        fl.configure("seed=9;io.corrupt_record:corrupt(at=3)")
        r = rio.MXRecordIO(str(rec), "r")
        outs.append([r.read() for _ in range(4)])
        r.close()
        fl.clear()
    assert outs[0] == outs[1]
    assert outs[0][2] != b"C" * 40 and outs[0][3] == b"D" * 40


def test_image_iter_corrupt_record_quarantined(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from incubator_mxnet_tpu_torch.image import ImageRecordIterImpl
    rec = str(tmp_path / "c.rec")
    rng = np.random.RandomState(0)
    w = trecordio.MXRecordIO(rec, "w")
    for i in range(12):
        _, enc = cv2.imencode(
            ".png", rng.randint(0, 255, (40, 40, 3), dtype=np.uint8))
        w.write(trecordio.pack(trecordio.IRHeader(0, float(i), i, 0),
                               enc.tobytes()))
    w.close()
    log = QuarantineLog(str(tmp_path / "q.jsonl"))
    faults.configure("seed=6;io.corrupt_record:corrupt(record=5)")
    it = ImageRecordIterImpl(path_imgrec=rec, data_shape=(3, 32, 32),
                             batch_size=4, preprocess_threads=2)
    it.set_quarantine(log)
    # the pool builds batches from construction on: stop it, then run a
    # fresh epoch with the log attached and count what that epoch damaged
    it.close()
    c0 = it.corrupt_records
    it.reset()
    n = sum(b.data[0].shape[0] - b.pad for b in it)
    assert n == 12 and it.corrupt_records - c0 == 1
    it.close()
    faults.clear()
    bad = {e["record"] for e in log.load() if e.get("record") is not None}
    assert bad == {5}
    it2 = ImageRecordIterImpl(path_imgrec=rec, data_shape=(3, 32, 32),
                              batch_size=4, preprocess_threads=2)
    it2.apply_quarantine(log.load())
    labels = []
    for b in it2:
        labels.extend(
            b.label[0].asnumpy()[:b.data[0].shape[0] - b.pad].tolist())
    it2.close()
    assert len(labels) == 11 and 5.0 not in labels
    assert it2.corrupt_records == 0


# -- observability and knobs --------------------------------------------------

def test_guardian_events_in_findings_and_fault_trace(fast_guardian):
    faults.configure("seed=7;grad.nonfinite:error(at=5)")
    _fit(tmx)
    assert "skip-batch" in {f.code for f in guardian.findings()}
    events = [e.get("event") for e in faults.trace()]
    assert "skip-batch" in events and "quarantine" in events
    snap = tmx.obs.metrics.registry().collect()
    assert snap.get("guardian.skips") == 1
    guardian.reset_findings()
    assert guardian.findings() == []


def test_guardian_knobs_registered():
    from incubator_mxnet_tpu import config as jconfig
    from incubator_mxnet_tpu_torch import config
    for knob in ("MXNET_GUARDIAN", "MXNET_GUARDIAN_INTERVAL",
                 "MXNET_GUARDIAN_SPIKE_WINDOW", "MXNET_GUARDIAN_SPIKE_K",
                 "MXNET_GUARDIAN_MAX_FAILURES",
                 "MXNET_GUARDIAN_MAX_ROLLBACKS",
                 "MXNET_GUARDIAN_QUARANTINE"):
        assert config.KNOBS[knob][1] == jconfig.KNOBS[knob][1], knob
    assert config.get("MXNET_GUARDIAN") is True


def test_rollback_requested_is_internal():
    err = RollbackRequested(10, 9, 1e4, [(0, 9)])
    assert err.quarantined == [(0, 9)] and "step <= 9" in str(err)


# -- the non-primary rank's snapshots ----------------------------------------

def test_non_primary_rank_snapshot_is_rank_local(tmp_path):
    """A rank other than 0 writes only its rank-local state (optimizer
    states, iterator position, random streams) into ``rank-shards/``,
    with the guardian's health stamp; rank 0's commit of the same step
    adopts it, and `rank_shard` reads it back."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    root = str(tmp_path / "ck")
    mod = _module(tmx)
    it = _data(tmx, n=32)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in _params().items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LR, "momentum": 0.9})
    mod._guardian = TrainingGuardian(interval=4)
    mod.fit_step(next(iter(it)), tmx.metric.create("acc"))
    mgr1 = ckpt.CheckpointManager(root, rank=1, num_ranks=2)
    mod._elastic_snapshot(mgr1, it, 0, 1, 1)
    mgr1.flush()
    mgr1.close()
    shard = tmp_path / "ck" / "rank-shards" / "step-1-rank-1.bin"
    assert shard.is_file() and ckpt.latest(root) is None
    mgr0 = ckpt.CheckpointManager(root, rank=0, num_ranks=2)
    mod._elastic_snapshot(mgr0, it, 0, 1, 1)
    mgr0.flush()
    mgr0.close()
    data = ckpt.load(ckpt.latest(root))
    assert data.meta["health"]["status"] == "healthy"
    payload = data.rank_shard(1)
    assert payload["arrays"] == {}
    assert set(payload["blobs"]) == {ckpt.state.OPTIMIZER_BLOB,
                                     ckpt.state.ITERATOR_BLOB}
    assert payload["rng"] is not None


def test_refused_step_adds_nothing_to_a_metric_of_many_totals():
    """A device metric may return any number of totals (a detection
    metric returns four): the guarded step takes them all, and a refused
    step adds zero to each."""

    class Four(tmx.metric.EvalMetric):
        def __init__(self):
            super().__init__("four")
            self.totals = None

        def device_update(self, labels, preds):
            p = preds[0].data
            return (p.sum(), p.new_tensor(1.0), p.max(),
                    p.new_tensor(float(p.shape[0])))

        def _accumulate(self, *totals):
            prev = self.totals
            self.totals = totals if prev is None else \
                tuple(a + b for a, b in zip(prev, totals))

    mod = _module(tmx)
    it = _data(tmx, n=24)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in _params().items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LR})
    TrainingGuardian(interval=1000).attach(mod)
    metric = Four()
    batches = list(it)
    mod.fit_step(batches[0], metric)
    before = [t.clone() for t in metric.totals]
    faults.configure("grad.nonfinite:error(at=1)")
    mod.fit_step(batches[1], metric)
    faults.clear()
    assert all(torch.equal(a, b) for a, b in zip(before, metric.totals))
    mod.fit_step(batches[2], metric)
    assert metric.totals[3].item() == 16.0


@pytest.mark.parametrize("flag", [True, False])
def test_select_on_bit_patterns_is_exact(flag):
    """The guarded step's select (`fused._select`, a `torch.where` into
    the live tensor, on every device) gives the new tensors or the old
    ones bit for bit, NaN, infinities, -0.0 and subnormals included, in
    every float width and for booleans."""
    from incubator_mxnet_tpu_torch import fused
    rng = np.random.RandomState(7)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, -3.5, 7e30]
    live, old = [], []
    for dtype in (torch.float32, torch.float64, torch.float16,
                  torch.bfloat16):
        a = rng.standard_normal(64) * 10.0
        a[:len(special)] = special
        b = rng.standard_normal(64)
        b[-len(special):] = special
        live.append(torch.tensor(a).to(dtype))
        old.append(torch.tensor(b).to(dtype))
    live.append(torch.tensor(rng.rand(9) < 0.5))
    old.append(torch.tensor(rng.rand(9) < 0.5))
    want = [(t if flag else o).clone() for t, o in zip(live, old)]
    fused._select(torch.tensor(flag), live, old)
    for got, w in zip(live, want):
        assert got.dtype == w.dtype
        assert got.view(torch.uint8).numpy().tobytes() == \
            w.view(torch.uint8).numpy().tobytes()
