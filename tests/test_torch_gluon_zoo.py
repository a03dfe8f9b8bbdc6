"""The port's model zoo (slice 15: AlexNet, SqueezeNet, MobileNet v1/v2,
DenseNet, Inception v3, beside ResNet and VGG) against the JAX package's
on the CPU.

Every `get_model` name of the JAX package builds in the port, composes
to the same graph JSON and infers the same parameter shapes.  Each new
family at `classes=10` and the smallest input it admits runs a forward
(eager and hybridized) and one `Trainer` step from the same
seeded initial values; AlexNet composed on a Symbol trains through
`Module.fit` under ``MXNET_SUBGRAPH_BACKEND=TPU_PALLAS``, where its two
FC+ReLU layers become K1 nodes (here `fc_relu_ref`, the kernel's plain
version, on CPU tensors; the JAX package's through its interpreted
Pallas kernel).

Dropout: the packages draw their masks from different generators (the
port's torch generator on the array's device; JAX's PRNGKey), so a mask
cannot be held across packages.  Parity runs with every Dropout block's
rate set to 0 in both (AlexNet, SqueezeNet, Inception); the rate-0.5
path is checked statistically on the port alone (the kept share and the
1/(1-p) scale), which holds the only arithmetic the rate adds.

Tolerances: a forward or one step of float32 sums in other orders,
rtol 1e-4 + 1e-5 * max|ref| (`TOL`), for the nets without BatchNorm
(AlexNet, SqueezeNet), in train mode.  The nets with BatchNorm cannot
be held elementwise in train mode at the batches they admit here: the
JAX BatchNorm rounds through float32 even for float64 data (`ops/
nn.py:257-259` of the JAX package), and statistics over a few values
amplify that rounding (MobileNet v1 at batch 2, 64x64: 1.9e-5 of the
output's max through its last BatchNorm over 8 values; Inception v3 at
batch 1: ~15 % of some updates); in float32 a pre-activation within
rounding of 0 flips a ReLU besides (one at 4e-6 in DenseNet's stage 4
moves some updates by 6 %).  So MobileNet v1/v2, DenseNet-121 and
Inception v3 run in float64 and in predict mode (BatchNorm on its
moving statistics; the gradient still passes every layer), where the
JAX BatchNorm's float32 rounding (6e-8 relative at each of up to ~100
layers) bounds the agreement: rtol 1e-5 + 1e-6 * max|ref| (`F64_TOL`).
Train-mode BatchNorm is held against JAX by `test_torch_batchnorm.py`
and the ResNet tests, and in float64 card against CPU by
`chip_smoke.py` 17d.
"""
import json
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import block_params_to_numpy

TOL = (1e-4, 1e-5)
F64_TOL = (1e-5, 1e-6)
# a parameter whose gradient is 0 but for rounding (MobileNet v2's
# BatchNorm betas behind a ReLU6 that passes nothing: 1e-20 to 1e-16
# after the step, which JAX's float32 BatchNorm gives other noise) is held
# to 1e-12 absolute, not relatively
F64_FLOOR = 1e-12
FIT_TOL = (1e-4, 1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one intra-op thread: these nets' float64
    convolutions would otherwise take every core from the tests the
    suite runs beside them (timing tests among them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol, what="", floor=0.0):
    """|got - want| <= rtol*|want| + max(atol*max|want|, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=tol[0],
        atol=max(tol[1] * max(np.abs(want).max(), 1e-30), floor),
        err_msg=what)


def _fresh(fn):
    out = {}

    def run():
        try:
            out["v"] = fn()
        except BaseException as e:     # re-raised in the caller
            out["e"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(600)
    assert not t.is_alive()
    if "e" in out:
        raise out["e"]
    return out["v"]


def _zoo(pkg, name, **kw):
    return pkg.gluon.model_zoo.vision.get_model(name, **kw)


def _no_dropout(net):
    """Every Dropout block's rate to 0 (see the module docstring)."""
    n = 0
    for b in _blocks(net):
        if type(b).__name__ == "Dropout":
            b._rate = 0.0
            n += 1
    return n


def _blocks(net):
    yield net
    for c in net._children.values():
        yield from _blocks(c)


def _graph(sym):
    g = json.loads(sym.tojson())
    return {k: g[k] for k in ("nodes", "arg_nodes", "heads")}


def _jax_names():
    """The JAX package's get_model name table (every name it accepts)."""
    try:
        jmx.gluon.model_zoo.vision.get_model("no_such_model")
    except ValueError as e:
        return sorted(eval(str(e).split("Available: ", 1)[1]))
    raise AssertionError("the JAX get_model accepted an unknown name")


NEW_FAMILIES = {
    # name: (input: the smallest each admits, as tests/test_gluon.py:
    # 247-256 runs them; has BatchNorm, so float64 and predict mode)
    "alexnet": ((2, 3, 63, 63), False),
    "squeezenet1.0": ((1, 3, 64, 64), False),
    "squeezenet1.1": ((1, 3, 64, 64), False),
    "mobilenet0.25": ((1, 3, 32, 32), True),
    "mobilenetv2_0.25": ((1, 3, 32, 32), True),
    "densenet121": ((1, 3, 224, 224), True),
    "inceptionv3": ((1, 3, 299, 299), True),
}


def test_get_model_names_equal_jax():
    """The port's get_model takes exactly the JAX package's names."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import _MODELS
    assert sorted(_MODELS) == _jax_names()
    assert len(_MODELS) == 34


def _composed(pkg, name):
    def build():
        net = _zoo(pkg, name, classes=1000)
        return pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                     name="softmax")
    return _fresh(build)


@pytest.mark.parametrize("name", _jax_names())
def test_every_zoo_name_composes_as_jax(name):
    """Each name at 1000 classes: the composed graph JSON equals the JAX
    package's, and the port infers the same argument and aux shapes at
    224x224 (299 for Inception v3), as the JAX graph's own declared
    shapes and its op rules give them."""
    tsym, jsym = _composed(tmx, name), _composed(jmx, name)
    assert _graph(tsym) == _graph(jsym)
    side = 299 if name == "inceptionv3" else 224
    args, outs, aux = tsym.infer_shape(data=(1, 3, side, side))
    jargs, jouts, jaux = jsym.infer_shape(data=(1, 3, side, side))
    assert args == [tuple(s) for s in jargs]
    assert aux == [tuple(s) for s in jaux]
    assert outs == [(1, 1000)] == [tuple(s) for s in jouts]


def _step(pkg, name, x, y, f64):
    """net(x) eagerly under record (in float64 and predict mode for the
    deep nets, see the module docstring; else float32 and train mode),
    the loss, backward and one Trainer SGD step (lr 0.1, momentum 0.9, wd
    1e-4); returns (the initial values, the output, the values after the
    step)."""
    def go():
        net = _zoo(pkg, name, classes=10)
        _no_dropout(net)
        pkg.random.seed(3)
        # He-scaled weights keep activations and gradients at unit scale
        # through the depth (the default Uniform(0.07) shrinks them toward
        # 0, where every ReLU sits at its kink)
        net.initialize(pkg.initializer.Xavier(magnitude=2), ctx=pkg.cpu())
        dt = "float64" if f64 else "float32"
        xa = pkg.nd.array(x, ctx=pkg.cpu(), dtype=dt)
        net(xa)                                   # finish deferred shapes
        # BatchNorm betas off 0: with beta 0 a channel a ReLU zeroed leaves
        # the next ReLU6's input at exactly 0, where the JAX clip's
        # gradient is not the reference's (see the clip test below)
        rs = np.random.RandomState(7)
        for k, p in sorted(net.collect_params().items()):
            if k.endswith("_beta"):
                p.set_data(pkg.nd.array(rs.uniform(-0.1, 0.1, p.shape),
                                        ctx=pkg.cpu()))
        if f64:
            net.cast("float64")
        before = block_params_to_numpy(net)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
        lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record(train_mode=not f64):
            out = net(xa)
            loss = lossf(out, pkg.nd.array(y, ctx=pkg.cpu(), dtype=dt))
        loss.backward()
        tr.step(x.shape[0])
        return before, out.asnumpy(), block_params_to_numpy(net)
    return _fresh(go)


@pytest.mark.parametrize("name", sorted(NEW_FAMILIES))
def test_family_forward_and_trainer_step_match_jax(name):
    """Each new family at classes=10: the initial values bitwise equal
    under one seed, the train-mode forward, and every parameter and
    moving statistic after one Trainer step, against JAX."""
    shape, f64 = NEW_FAMILIES[name]
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    y = np.arange(shape[0], dtype=np.float32) % 10
    tol = F64_TOL if f64 else TOL
    tb, tout, ta = _step(tmx, name, x, y, f64)
    jb, jout, ja = _step(jmx, name, x, y, f64)
    assert list(tb) == list(jb)
    assert all(tb[k].tobytes() == jb[k].tobytes() for k in tb)
    assert tout.shape == (shape[0], 10)
    _close(tout, jout, tol, "forward")
    assert list(ta) == list(ja)
    for k in ta:
        _close(ta[k], ja[k], tol, k, F64_FLOOR if f64 else 0.0)


@pytest.mark.parametrize("name", ["alexnet", "squeezenet1.1",
                                  "mobilenet0.25"])
def test_family_hybridized_predict_equals_eager(name):
    """Predict mode: the hybridized net answers as the eager one (the
    same interpreter over the same ops), and as the JAX package's with
    the same values."""
    shape, _ = NEW_FAMILIES[name]
    x = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)

    def run(pkg):
        net = _zoo(pkg, name, classes=10)
        pkg.random.seed(4)
        net.initialize(ctx=pkg.cpu())
        out = net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy()
        return net, out
    tnet, tout = _fresh(lambda: run(tmx))
    jnet, jout = _fresh(lambda: run(jmx))
    _close(tout, jout, TOL, "eager")
    tnet.hybridize()
    _close(tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), tout, (0, 0),
           "hybridized")


def test_clip_gradient_at_its_bounds_is_the_reference():
    """`clip`'s gradient is 1 on [a_min, a_max], bounds included, as the
    reference's `clip` backward passes it (`matrix_op-inl.h`); the JAX
    package's `jnp.clip` splits a tie and gives 0.5 at a bound (ROADMAP
    Queue 3).  MobileNet v2 meets that: a channel a ReLU6 zeroed leaves
    the next BatchNorm its beta, and with beta 0 the next ReLU6 (a `clip`)
    an input of exactly 0; so the Trainer-step test draws the betas off 0
    (in both packages alike)."""
    x = tmx.nd.array(np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32),
                     ctx=tmx.cpu())
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.clip(x, a_min=0, a_max=6)
    y.backward()
    assert x.grad.asnumpy().tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]
    jx = jmx.nd.array(np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32))
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jmx.nd.clip(jx, a_min=0, a_max=6)
    jy.backward()
    assert jx.grad.asnumpy().tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_dropout_rate_half_keeps_half_and_scales_by_two():
    """AlexNet's Dropout(0.5) in training on the port: the kept share of
    a large activation is 0.5 within 0.02, kept values scaled by 2 and
    the rest 0 (the path the parity tests set to 0)."""
    drop = _fresh(lambda: tmx.gluon.nn.Dropout(0.5))
    x = tmx.nd.array(np.ones((64, 4096), np.float32), ctx=tmx.cpu())
    with tmx.autograd.train_mode():
        out = drop(x).asnumpy()
    assert set(np.unique(out)) == {0.0, 2.0}
    assert abs((out == 2.0).mean() - 0.5) < 0.02
    with tmx.autograd.predict_mode():
        assert (drop(x).asnumpy() == 1.0).all()


def test_pretrained_raises_for_new_families():
    for name in ("alexnet", "densenet121", "inceptionv3", "mobilenet1.0",
                 "mobilenetv2_0.5", "squeezenet1.0"):
        with pytest.raises(tmx.MXNetError, match="pretrained"):
            _zoo(tmx, name, pretrained=True)


def _alexnet_symbol(pkg, classes=10):
    def build():
        net = _zoo(pkg, "alexnet", classes=classes)
        assert _no_dropout(net) == 2
        return pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                     name="softmax")
    return _fresh(build)


def test_alexnet_partitions_to_k1_as_jax():
    """Under TPU_PALLAS both FC+ReLU layers (fc6, fc7) become K1 nodes;
    the partitioned graph JSON equals the JAX package's, and at 224x224
    fc6 is (9216 -> 4096)."""
    tsym = tmx.subgraph.partition_graph(_composed(tmx, "alexnet"),
                                        "TPU_PALLAS")
    jsym = jmx.subgraph.partition_graph(_composed(jmx, "alexnet"),
                                        "TPU_PALLAS")
    assert _graph(tsym) == _graph(jsym)
    ops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert ops.count("_sg_pallas_fc_relu") == 2
    assert ops.count("FullyConnected") == 1
    args, _, _ = tsym.infer_shape(data=(128, 3, 224, 224))
    shapes = dict(zip(tsym.list_arguments(), args))
    fc = sorted(s for n, s in shapes.items() if n.endswith("dense0_weight")
                or n.endswith("dense1_weight"))
    assert fc == [(4096, 4096), (4096, 9216)]


def _alexnet_fit(pkg, sym, params, x, y, batch):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    it = pkg.io.NDArrayIter(x, y, batch)
    losses = []

    def record(p):
        losses.append(p.eval_metric.get()[1] * (p.nbatch + 1))

    mod.fit(it, eval_metric="ce", batch_end_callback=record,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in
                        params.items()},
            num_epoch=1)
    steps = np.diff([0.0] + losses)
    return steps, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        mod


def test_alexnet_module_fit_with_k1_matches_jax(monkeypatch):
    """AlexNet (classes 10, 63x63, so fc6 is 256 -> 4096) composed on a
    Symbol, partitioned by TPU_PALLAS at bind, through the port's
    Module.fit for 3 steps at batch 4: K1's plain version runs twice per
    train forward, and the per-step losses and every parameter equal the
    JAX package's per-batch fit of the same graph from the same values."""
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    sym = _alexnet_symbol(tmx)
    rs = np.random.RandomState(6)
    shapes, _, _ = sym.infer_shape(data=(4, 3, 63, 63))
    params = {n: (rs.standard_normal(s) * np.sqrt(2.0 / max(
        int(np.prod(s[1:])), 1))).astype(np.float32)
        for n, s in zip(sym.list_arguments(), shapes)
        if n not in ("data", "softmax_label")}
    x = rs.uniform(-1, 1, (12, 3, 63, 63)).astype(np.float32)
    y = (np.arange(12) % 10).astype(np.float32)
    calls = []
    ref = fused_ops.fc_relu_ref

    def counting(xx, w, b):
        if xx.device.type != "meta":       # not shape inference
            calls.append((tuple(xx.shape), tuple(w.shape)))
        return ref(xx, w, b)
    monkeypatch.setattr(fused_ops, "fc_relu_ref", counting)
    losses, args, mod = _alexnet_fit(tmx, sym, params, x, y, 4)
    assert calls == [((4, 256), (4096, 256)), ((4, 4096), (4096, 4096))] * 3
    # the JAX package cannot infer shapes of a loaded composed JSON (its
    # __shape__ attrs load as strings), so it composes its own, equal one
    jsym = _alexnet_symbol(jmx)
    assert _graph(jsym) == _graph(sym)
    jlosses, jargs, _ = _alexnet_fit(jmx, jsym, params, x, y, 4)
    assert len(losses) == len(jlosses) == 3
    _close(losses, jlosses, FIT_TOL, "per-step loss")
    for k, v in args.items():
        _close(v, jargs[k], FIT_TOL, k)
