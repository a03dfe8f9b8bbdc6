"""`gluon.contrib.estimator.Estimator.fit` and the fused gluon step, and
BASELINE config #3's plain loop on a hybridized ResNet v2, in the port
against the JAX package on the CPU.

The Estimator nets are the JAX package's fused-step test nets
(`tests/test_gluon_fused_step.py:13-80`, its SGD rows: Dense(16) ->
Dense(3) with momentum, and Dense(16) -> BatchNorm -> Dense(3) without),
6 batches of 16, with the fused step on and off in each package.  The
thumbnail ResNet v2 (`ResNetV2(BottleneckV2, [1, 1, 1, 1], [16, 16, 32,
64, 128], classes=10, thumbnail=True)`: 14 convolutions, 14 BatchNorms,
4 residual adds) trains hybridized through record / backward /
`Trainer.step` for 3 steps at batch 4 of 3x32x32, SGD lr 0.05 momentum
0.9, from parameters drawn from one numpy seed in both packages.

Tolerances (`test_torch_resnet_fit.py`'s): float32, the same sums in
other orders through a few momentum steps, rtol 1e-4 + 1e-5 * max|ref|
on every parameter, momentum, BatchNorm moving statistic, loss and the
metric; a bias whose layer feeds a BatchNorm (zero gradient in exact
arithmetic, so it and its momentum are rounding noise, ~1e-9 here) is
held to |x| < 1e-6 instead.  Within the port, the fused step and the
eager loop run the same torch ops on the same values, and are held to
bitwise equality; a hybridized call runs the same ops as the eager one,
held to rtol 1e-6 + 1e-7 * max|ref|.
"""
import os
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import (
    block_params_to_numpy, trainer_states_to_numpy)

TOL = (1e-4, 1e-5)
HYBRID_TOL = (1e-6, 1e-7)
# a bias whose layer feeds a BatchNorm has a zero gradient in exact
# arithmetic; it and its momentum are rounding noise, held below this
NOISE = 1e-6


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    out = {}

    def run():
        out["v"] = fn()
    t = threading.Thread(target=run)
    t.start()
    t.join(300)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _data(n=64, d=12, k=3, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype("f4"),
            rng.randint(0, k, n).astype("f4"))


def _fused_test_net(mx, bn):
    """The JAX fused-step test's net and values (`_run` there)."""
    def build():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(16))
        if bn:
            net.add(mx.gluon.nn.BatchNorm())
        net.add(mx.gluon.nn.Dense(3))
        return net
    net = _fresh(build)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(np.zeros((2, 12), "f4"), ctx=mx.cpu()))
    rng = np.random.RandomState(9)
    for p in net.collect_params().values():
        r = rng.randn(*p.shape) * 0.2
        if p.name.endswith(("gamma", "running_var")):
            v = np.ones(p.shape, "f4")
        elif p.name.endswith(("beta", "running_mean", "bias")):
            v = np.zeros(p.shape, "f4")
        else:
            v = r.astype("f4")
        p.set_data(mx.nd.array(v, ctx=mx.cpu()))
    return net


def _fit(mx, fused, opt_params, bn, steps=6, handlers=()):
    """Estimator.fit over `steps` batches of 16; (parameters, metric,
    momenta, estimator)."""
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "1" if fused else "0"
    try:
        net = _fused_test_net(mx, bn)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(opt_params))
        est = mx.gluon.contrib.estimator.Estimator(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            train_metrics=[mx.metric.Accuracy()], trainer=trainer)
        X, y = _data()
        batches = [(mx.nd.array(X[i:i + 16], ctx=mx.cpu()),
                    mx.nd.array(y[i:i + 16], ctx=mx.cpu()))
                   for i in range(0, 64, 16)] * 2
        est.fit(iter(batches[:steps]), epochs=1,
                event_handlers=list(handlers))
        metric = est.train_metrics[0].get()[1]
        return (block_params_to_numpy(net), metric,
                trainer_states_to_numpy(trainer), est)
    finally:
        os.environ.pop("MXNET_FUSED_TRAIN_STEP", None)


ROWS = [({"learning_rate": 0.1, "momentum": 0.9}, False),
        ({"learning_rate": 0.1}, True)]


@pytest.mark.parametrize("opt_params,bn", ROWS,
                         ids=["sgd-momentum", "sgd-batchnorm"])
def test_estimator_fit_matches_jax(opt_params, bn):
    """Fused on and off, in each package: parameters (moving statistics
    included), accuracy and momenta after 6 batches; the port's fused
    step ran every batch and equals its eager loop bitwise."""
    runs = {}
    for fused in (True, False):
        runs["jax", fused] = _fit(jmx, fused, opt_params, bn)
        with tmx.cpu():
            runs["port", fused] = _fit(tmx, fused, opt_params, bn)
    est = runs["port", True][3]
    assert est._fused is not None and est._fused.steps == 6
    assert runs["port", False][3]._fused is None
    # the first Dense feeds the BatchNorm
    bn_fed = {est.net[0].bias.name} if bn else set()
    for fused in (True, False):
        got, want = runs["port", fused], runs["jax", fused]
        for name in want[0]:
            if name in bn_fed:
                assert np.abs(got[0][name]).max() < NOISE, name
                continue
            _close(got[0][name], want[0][name], what=f"{fused} {name}")
        _close(got[1], want[1], what="accuracy")
        for i in want[2]:
            if want[2][i] is not None:
                _close(got[2][i], want[2][i], what=f"momentum {i}")
    fused, eager = runs["port", True], runs["port", False]
    for name in eager[0]:
        assert np.array_equal(fused[0][name], eager[0][name]), name
    assert fused[1] == eager[1]
    for i in eager[2]:
        assert (eager[2][i] is None) == (fused[2][i] is None)
        if eager[2][i] is not None:
            assert np.array_equal(fused[2][i], eager[2][i]), i


def test_estimator_fused_falls_back_on_dropout():
    """A net with Dropout draws random numbers: the fused step declines,
    and the eager loop trains it (JAX
    `test_estimator_fused_falls_back_on_dropout`)."""
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(16, activation="relu"))
        net.add(tmx.gluon.nn.Dropout(0.5))
        net.add(tmx.gluon.nn.Dense(3))
        net.initialize(tmx.initializer.Xavier())
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        est = tmx.gluon.contrib.estimator.Estimator(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer=trainer)
        X, y = _data()
        batches = [(tmx.nd.array(X[:16]), tmx.nd.array(y[:16]))] * 4
        est.fit(iter(batches), epochs=1, event_handlers=[])
        before = block_params_to_numpy(net)
        est.fit(iter(batches), epochs=1, event_handlers=[])
    assert est._fused is None
    after = block_params_to_numpy(net)
    for name, v in after.items():
        assert np.isfinite(v).all()
    assert any(not np.array_equal(after[n], before[n]) for n in after)


def test_fused_step_refuses_a_random_op():
    """An op that draws random numbers inside the fused step raises
    rather than train on a stream the eager loop would not draw."""
    class Noisy(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Dropout(x, p=0.5)

    from incubator_mxnet_tpu_torch.gluon.fused_step import GluonFusedStep
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(3, in_units=12), Noisy())
        net.initialize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", {})
        step = GluonFusedStep.try_build(
            net, tmx.gluon.loss.L2Loss(), trainer, [tmx.metric.Accuracy()])
        assert step is not None
        with pytest.raises(tmx.MXNetError, match="random"):
            step(tmx.nd.ones((4, 12)), tmx.nd.ones((4, 3)), 4)


def test_fused_step_declines_as_jax_does():
    """No fused step for a metric without device_update, nor for a net
    with a parameter the trainer does not own."""
    class HostMetric(tmx.metric.EvalMetric):
        def update(self, labels, preds):
            pass

    from incubator_mxnet_tpu_torch.gluon.fused_step import GluonFusedStep
    with tmx.cpu():
        net = _fused_test_net(tmx, False)
        params = net.collect_params()
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        full = tmx.gluon.Trainer(params, "sgd", {})
        part = tmx.gluon.Trainer(list(params.values())[:2], "sgd", {})
        assert GluonFusedStep.try_build(net, loss, full,
                                        [HostMetric("host")]) is None
        assert GluonFusedStep.try_build(net, loss, part, []) is None
        assert GluonFusedStep.try_build(net, loss, full, []) is not None


class _Probe:
    """Records every hook as the loop fires it, with the accuracy a
    batch_end handler reads."""

    def __init__(self):
        self.seen = []

    def train_begin(self, est):
        self.seen.append("train_begin")

    def epoch_begin(self, est):
        self.seen.append(f"epoch_begin {est.epoch}")

    def batch_begin(self, est):
        self.seen.append(f"batch_begin {est.batch_idx}")

    def batch_end(self, est):
        self.seen.append(f"batch_end {est.batch_idx} "
                         f"{est.train_metrics[0].get()[1]:.6f}")

    def epoch_end(self, est):
        self.seen.append(f"epoch_end {est.epoch}")

    def train_end(self, est):
        self.seen.append("train_end")


def test_handlers_fire_per_batch(tmp_path):
    """Every handler hook fires as the JAX package's loop fires it, the
    fused step taking every batch, with the accuracy of each batch seen
    by batch_end; CheckpointHandler writes each epoch's parameters and
    EarlyStoppingHandler stops the fit."""
    E = tmx.gluon.contrib.estimator
    probe, jprobe = _Probe(), _Probe()
    with tmx.cpu():
        _, _, _, est = _fit(tmx, True, ROWS[0][0], False, steps=3,
                            handlers=[probe, E.LoggingHandler(1),
                                      E.CheckpointHandler(str(tmp_path))])
        assert est._fused.steps == 3
    _fit(jmx, True, ROWS[0][0], False, steps=3, handlers=[jprobe])
    seen, jseen = probe.seen, jprobe.seen
    assert [s.split()[:2] for s in seen] == [s.split()[:2] for s in jseen]
    assert len(seen) == 2 + 2 + 2 * 3
    got = [float(s.split()[2]) for s in seen if s.startswith("batch_end")]
    want = [float(s.split()[2]) for s in jseen if s.startswith("batch_end")]
    _close(got, want, what="accuracy seen by batch_end")
    assert os.path.exists(tmp_path / "model-epoch0.params")

    with tmx.cpu():
        net = _fused_test_net(tmx, False)
        est = E.Estimator(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          trainer=tmx.gluon.Trainer(
                              net.collect_params(), "sgd",
                              {"learning_rate": 0.0}))
        X, y = _data()
        batches = [(tmx.nd.array(X[:16]), tmx.nd.array(y[:16]))]
        stop = E.EarlyStoppingHandler("accuracy", mode="max", patience=2)
        est.fit(batches, epochs=10, event_handlers=[stop])
    assert est._epochs_done == 3 and stop.waited == 2


def test_estimator_fused_then_eager_state_shared():
    """The fused step keeps the optimizer states in the trainer's updater
    (JAX `test_estimator_fused_then_eager_state_shared`): 3 fused batches
    then 3 eager ones on the same estimator equal 6 eager ones."""
    opt = ROWS[0][0]
    with tmx.cpu():
        p_eager, _, s_eager, _ = _fit(tmx, False, opt, False, steps=6)
        net = _fused_test_net(tmx, False)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", opt)
        est = tmx.gluon.contrib.estimator.Estimator(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
            train_metrics=[tmx.metric.Accuracy()], trainer=trainer)
        X, y = _data()
        batches = [(tmx.nd.array(X[i:i + 16]), tmx.nd.array(y[i:i + 16]))
                   for i in range(0, 64, 16)] * 2
        est.fit(iter(batches[:3]), epochs=1, event_handlers=[])
        assert est._fused.steps == 3
        assert all(v is not None for v in trainer._updaters[0].states.values())
        os.environ["MXNET_FUSED_TRAIN_STEP"] = "0"
        try:
            est.fit(iter(batches[3:6]), epochs=1, event_handlers=[])
        finally:
            os.environ.pop("MXNET_FUSED_TRAIN_STEP", None)
        assert est._fused.steps == 3
    for name, v in block_params_to_numpy(net).items():
        assert np.array_equal(v, p_eager[name]), name


def test_estimator_evaluate_and_default_trainer():
    with tmx.cpu():
        net = _fused_test_net(tmx, True)
        est = tmx.gluon.contrib.estimator.Estimator(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        X, y = _data()
        batches = [(tmx.nd.array(X[:16]), tmx.nd.array(y[:16]))]
        est.fit(batches, val_data=batches, event_handlers=[])
        assert isinstance(est.trainer, tmx.gluon.Trainer)
        acc = est.val_metrics[0].get()[1]
    assert 0.0 <= acc <= 1.0


# -- BASELINE config #3 at thumbnail size: hybridized ResNet v2 -------------

BATCH, STEPS, IMAGE = 4, 3, (3, 32, 32)


def _thumbnail(mx):
    def build():
        v = mx.gluon.model_zoo.vision
        return v.ResNetV2(v.BottleneckV2, [1, 1, 1, 1],
                          [16, 16, 32, 64, 128], classes=10, thumbnail=True)
    net = _fresh(build)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1,) + IMAGE, "f4"), ctx=mx.cpu()))
    return net


def _resnet_values(net, seed=1):
    """Gaussian weights (fan-in scaled), gamma near 1, small beta and
    bias, zeros/ones for the moving statistics, from one numpy seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        s = p.shape
        if name.endswith("weight"):
            v = rng.normal(0, 1, s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif name.endswith("gamma"):
            v = rng.uniform(0.8, 1.2, s)
        elif name.endswith("running_mean"):
            v = np.zeros(s)
        elif name.endswith("running_var"):
            v = np.ones(s)
        else:
            v = rng.normal(0, 0.1, s)
        out[name] = v.astype(np.float32)
    return out


def _resnet_loop(mx, values, hybrid=True):
    net = _thumbnail(mx)
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(values[name], ctx=mx.cpu()))
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    losses, states = [], []
    for _ in range(STEPS):
        x = mx.nd.array(rng.uniform(-1, 1, (BATCH,) + IMAGE).astype("f4"),
                        ctx=mx.cpu())
        y = mx.nd.array(rng.randint(0, 10, BATCH).astype("f4"), ctx=mx.cpu())
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
        states.append((block_params_to_numpy(net),
                       trainer_states_to_numpy(trainer)))
    return losses, states


def test_hybridized_resnet_v2_plain_loop_matches_jax():
    """3 steps of record / backward / step on the hybridized thumbnail
    ResNet v2: every loss, and after every step every parameter, moving
    statistic and momentum, against the JAX package's eager loop.

    The JAX package's hybridized backward of this net parts from its own
    eager one (the first convolution's gradient by 1e-2 in relative L2,
    in float32 and with float64 data alike; ROADMAP Queue 3), while its
    eager gradients agree with the port's within 3e-6: the port's
    hybridized call is held to the JAX eager loop, and to its own eager
    loop within HYBRID_TOL."""
    values = _resnet_values(_thumbnail(jmx))
    want = _resnet_loop(jmx, values, hybrid=False)
    with tmx.cpu():
        got = _resnet_loop(tmx, values)
        eager = _resnet_loop(tmx, values, hybrid=False)
    for k in range(STEPS):
        _close(got[0][k], want[0][k], what=f"loss step {k + 1}")
        (gp, gs), (wp, ws), (ep, _) = got[1][k], want[1][k], eager[1][k]
        assert list(gp) == list(wp)
        for name in wp:
            _close(gp[name], wp[name], what=f"step {k + 1} {name}")
            _close(gp[name], ep[name], HYBRID_TOL,
                   f"step {k + 1} {name}, hybridized vs eager")
        for i in ws:
            _close(gs[i], ws[i], what=f"step {k + 1} momentum {i}")
    moved = [n for n in want[1][-1][0] if n.endswith("running_mean") and
             np.abs(got[1][-1][0][n]).sum() > 0]
    assert len(moved) == 14
