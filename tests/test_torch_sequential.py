"""`SequentialModule`, `PythonModule`/`PythonLossModule`, `Monitor` and
`AttrScope` in the PyTorch port against the JAX package's own, on the
CPU, on train_mnist's mlp cut to small widths (20 -> 32 -> 16 -> 4,
batch 8) and split as upstream's `example/module/sequential_module.py`
splits it: data -> fc1 -> relu1, then fc2 -> relu2 -> fc3 ->
SoftmaxOutput (``take_labels``, ``auto_wiring``).

The JAX package's `SequentialModule` cannot bind such a chain: its
`Module.output_shapes` is empty until the first forward, so the second
module gets no data shapes (``auto_wiring`` asserts).  The reference is
therefore the same computation in the JAX package without the split:
one `Module` of the whole mlp, and, for a `PythonLossModule` last
stage, the JAX Module stepped by hand with the loss gradient as its
output gradient.  Both packages start from the same parameters
(Mixed(Orthogonal, MSRAPrelu) under one seed draws the same host
stream), train 4 batches of SGD with momentum through `fit`, with fc1
made under ``AttrScope(lr_mult=0.5)`` and a `Monitor(interval=1)`; the
parameters, the metric and the monitor's statistic of every name the
two runs share agree to rtol 1e-5 plus 1e-6 of the largest value
(float32 in another order).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
DIMS = dict(n_in=20, h1=32, h2=16, classes=4, batch=8, n=32)


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (DIMS["n"], DIMS["n_in"])).astype(np.float32)
    y = (x[:, :DIMS["classes"]].argmax(1)).astype(np.float32)
    return x, y


def _ctx(pkg):
    return {"context": tmx.cpu()} if pkg is tmx else {}


def _layers(pkg, lr_mult):
    """(relu1, the SoftmaxOutput on it, the graph from a new "data")."""
    sym = pkg.sym
    with pkg.AttrScope(lr_mult=lr_mult):
        data = sym.Variable("data")
        fc1 = sym.FullyConnected(data, name="fc1", num_hidden=DIMS["h1"])
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")

    def head(x):
        fc2 = sym.FullyConnected(x, name="fc2", num_hidden=DIMS["h2"])
        act2 = sym.Activation(fc2, name="relu2", act_type="relu")
        fc3 = sym.FullyConnected(act2, name="fc3",
                                 num_hidden=DIMS["classes"])
        return sym.SoftmaxOutput(fc3, name="softmax")
    return act1, head(act1), head(sym.Variable("data"))


def _seq_mlp(pkg, lr_mult=0.5):
    """The mlp as a SequentialModule of two Modules."""
    act1, _, out = _layers(pkg, lr_mult)
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(act1, label_names=[], **_ctx(pkg)))
    seq.add(pkg.mod.Module(out, **_ctx(pkg)), take_labels=True,
            auto_wiring=True)
    return seq


def _one_mlp(pkg, lr_mult=0.5):
    """The same mlp as one Module."""
    return pkg.mod.Module(_layers(pkg, lr_mult)[1], **_ctx(pkg))


def _iter(pkg, x, y):
    return pkg.io.NDArrayIter(x, y, batch_size=DIMS["batch"])


def _init(pkg):
    return pkg.init.Mixed([".*fc1.*", ".*"],
                          [pkg.init.Orthogonal(), pkg.init.MSRAPrelu()])


def _fit(pkg, mod, metric, monitor=None, epochs=1):
    x, y = _data()
    pkg.random.seed(7)
    mod.fit(_iter(pkg, x, y), num_epoch=epochs, initializer=_init(pkg),
            optimizer="sgd", eval_metric=metric, monitor=monitor,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod


def _err(label, pred):
    return float((pred.argmax(1) != label).mean())


def _monitor(pkg):
    """A Monitor(interval=1) and the {(step, name): value} its
    statistics land in."""
    rows = {}
    mon = pkg.monitor.Monitor(1)

    def keep():
        for step, name, text in mon.toc():
            rows.setdefault((step, name), []).append(float(text.strip()))
    mon.toc_print = keep
    return mon, rows


def test_sequential_mlp_matches_jax():
    """4 fit steps of the split mlp under a Monitor, an AttrScope and a
    composite metric with a CustomMetric: parameters, metric and monitor
    statistics against the unsplit mlp in the JAX package."""
    runs = {}
    for pkg, make in ((tmx, _seq_mlp), (jmx, _one_mlp)):
        mon, rows = _monitor(pkg)
        metric = pkg.metric.create(["acc", "nll_loss", _err])
        mod = _fit(pkg, make(pkg), metric, monitor=mon)
        args, _ = mod.get_params()
        runs[pkg] = ({k: v.asnumpy() for k, v in args.items()},
                     metric.get(), rows, mon.step)
    (targs, tmet, trows, tsteps), (jargs, jmet, jrows, jsteps) = \
        runs[tmx], runs[jmx]
    assert sorted(targs) == sorted(jargs)
    for k in jargs:
        _close(targs[k], jargs[k], k)
    assert tmet[0] == jmet[0]
    _close(tmet[1], jmet[1], "metric")
    assert tsteps == jsteps == DIMS["n"] // DIMS["batch"]
    # "data" is the input of both modules of the chain: held only once
    shared = [k for k in jrows if k in trows and len(trows[k]) == 1]
    names = {name for _, name in shared}
    assert {"fc1_weight", "fc1_bias", "fc2_weight", "fc3_bias",
            "softmax_label"} <= names
    # the JAX Module's fit runs forward and backward as one executor call
    # that reports no outputs; the port's executors report both modules'
    assert {"relu1_output", "softmax_output"} <= {n for _, n in trows}
    _close([trows[k][0] for k in shared], [jrows[k][0] for k in shared],
           "monitor statistics")


def test_attr_scope_reaches_optimizer():
    """fc1's parameters carry ``__lr_mult__`` 0.5 into the optimizer's
    lr_mult; with plain SGD their first update is half the rate of the
    same graph without the scope."""
    x, y = _data()
    deltas = {}
    for mult in (0.5, 1.0):
        seq = _seq_mlp(tmx, lr_mult=mult)
        seq.bind(data_shapes=[("data", (DIMS["batch"], DIMS["n_in"]))],
                 label_shapes=[("softmax_label", (DIMS["batch"],))])
        tmx.random.seed(7)
        seq.init_params(initializer=_init(tmx))
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        first = seq._modules[0]
        assert first._optimizer.lr_mult.get("fc1_weight") == \
            mult
        before = first.get_params()[0]["fc1_weight"].asnumpy()
        batch = next(iter(_iter(tmx, x, y)))
        seq.forward_backward(batch)
        seq.update()
        deltas[mult] = first.get_params()[0]["fc1_weight"].asnumpy() - before
    _close(deltas[0.5], 0.5 * deltas[1.0], "half-rate update")
    attrs = _seq_mlp(jmx)._modules[0].symbol.attr_dict()
    tattrs = _seq_mlp(tmx)._modules[0].symbol.attr_dict()
    for name in ("fc1_weight", "fc1_bias", "data"):
        assert tattrs[name]["__lr_mult__"] == attrs[name]["__lr_mult__"]


def test_sequential_module_shapes_and_grads():
    """bind chains output shapes; the second module takes input
    gradients and hands them back to the first."""
    seq = _seq_mlp(tmx)
    seq.bind(data_shapes=[("data", (DIMS["batch"], DIMS["n_in"]))],
             label_shapes=[("softmax_label", (DIMS["batch"],))])
    assert seq.output_shapes == [("softmax_output",
                                  (DIMS["batch"], DIMS["classes"]))]
    assert seq._modules[1].data_shapes[0].name == "data"
    assert seq._modules[1].inputs_need_grad
    assert not seq._modules[0].inputs_need_grad
    seq.init_params()
    x, y = _data()
    seq.forward_backward(next(iter(_iter(tmx, x, y))))
    g = seq._modules[1].get_input_grads()[0]
    assert g.shape == (DIMS["batch"], DIMS["h1"])
    assert np.isfinite(g.asnumpy()).all()


def _grad_func(scores, labels):
    """d/ds of 0.5 * |s - onehot|^2."""
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(int)
    one = np.zeros_like(s)
    one[np.arange(len(lab)), lab] = 1.0
    return s - one


def test_python_loss_module():
    """The JAX package's own case (tests/test_module.py): forward keeps
    the scores, backward calls grad_func."""
    m = tmx.mod.PythonLossModule(grad_func=_grad_func)
    m.bind(data_shapes=[tmx.io.DataDesc("data", (4, 3))],
           label_shapes=[tmx.io.DataDesc("softmax_label", (4,))])
    m.init_params()
    m.init_optimizer()
    assert m.output_shapes == [("pyloss_output", (4, 3))]
    rng = np.random.RandomState(0)
    scores = tmx.nd.array(rng.rand(4, 3).astype("f4"), ctx=tmx.cpu())
    labels = tmx.nd.array(np.array([0, 1, 2, 1], "f4"), ctx=tmx.cpu())
    m.forward(tmx.io.DataBatch(data=[scores], label=[labels]))
    np.testing.assert_allclose(m.get_outputs()[0].asnumpy(),
                               scores.asnumpy())
    m.backward()
    np.testing.assert_allclose(m.get_input_grads()[0].asnumpy(),
                               _grad_func(scores, labels), rtol=1e-6)
    assert m.get_params() == ({}, {})
    with pytest.raises(NotImplementedError):
        m.install_monitor(None)


def _loss_chain(pkg):
    """fc1 -> relu -> fc2 scores, then a PythonLossModule (squared error
    against the one-hot label)."""
    sym = pkg.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, name="fc1", num_hidden=DIMS["h1"])
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, name="fc2", num_hidden=DIMS["classes"])
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net, label_names=[], **_ctx(pkg)))
    seq.add(pkg.mod.PythonLossModule(grad_func=_grad_func),
            take_labels=True, auto_wiring=True)
    return seq


def test_python_loss_module_in_sequential_matches_jax():
    """A PythonLossModule as the last stage trains the chain (3 epochs,
    the squared error falling) as the JAX package's Module does when
    stepped by hand with the same loss gradient."""
    x, y = _data()
    seq = _loss_chain(tmx)
    metric = tmx.metric.create("mse")
    losses = []
    tmx.random.seed(3)
    seq.fit(_iter(tmx, x, y), num_epoch=3, initializer=tmx.init.Xavier(),
            optimizer="sgd", eval_metric=metric,
            epoch_end_callback=lambda *a: losses.append(metric.get()[1]),
            optimizer_params={"learning_rate": 0.05})
    net = _loss_chain(jmx)._modules[0].symbol
    mod = jmx.mod.Module(net, label_names=[])
    it = _iter(jmx, x, y)
    mod.bind(data_shapes=it.provide_data, inputs_need_grad=False)
    jmx.random.seed(3)
    mod.init_params(initializer=jmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    for _ in range(3):
        it.reset()
        for batch in it:
            mod.forward(jmx.io.DataBatch(data=batch.data), is_train=True)
            g = _grad_func(mod.get_outputs()[0], batch.label[0])
            mod.backward([jmx.nd.array(g)])
            mod.update()
    jargs = mod.get_params()[0]
    targs = seq.get_params()[0]
    assert sorted(targs) == sorted(jargs)
    for k in jargs:
        _close(targs[k].asnumpy(), jargs[k].asnumpy(), k)
    assert len(losses) == 3 and losses[-1] < losses[0]
