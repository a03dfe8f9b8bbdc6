"""The port's gluon blocks of slice 15 against the JAX package's on the
CPU: the activation blocks, `Embedding`, `InstanceNorm`, `SyncBatchNorm`,
`Lambda`/`HybridLambda`, the transposed convolutions, `ReflectionPad2D`,
forward hooks and `summary`, `SymbolBlock` with `export`/`imports`,
`CTCLoss`, `autograd.get_symbol`, `gluon.contrib` (`nn`, `rnn`, `data`)
and `nn.SparseEmbedding` over the sharded table.

Each block is built in a fresh thread in each package (the name counters
start at 0 in both), seeded alike so the default initializers draw the
same values, and run on the same numpy inputs eagerly and hybridized
under `autograd.record()`; the outputs, the inputs' and the parameters'
gradients are held to the JAX package's.  Tolerance: float32 sums in
other orders over a few small layers, rtol 1e-5 + 1e-6 * max|ref|
(`TOL`); the CTC log-likelihood sums over every path in log space,
rtol 1e-4 + 1e-5 * max|ref| (`CTC_TOL`).
"""
import io
import json
import contextlib
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import (
    block_params_from_numpy, block_params_to_numpy)

TOL = (1e-5, 1e-6)
CTC_TOL = (1e-4, 1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one intra-op thread: these nets' float64
    convolutions would otherwise take every core from the tests the
    suite runs beside them (timing tests among them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    """fn() in a new thread (fresh name counters); returns its result."""
    out = {}

    def run():
        try:
            out["v"] = fn()
        except BaseException as e:     # re-raised in the caller
            out["e"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(300)
    assert not t.is_alive()
    if "e" in out:
        raise out["e"]
    return out["v"]


def _rs(seed, *shape, low=-1.0, high=1.0):
    return np.random.RandomState(seed).uniform(low, high, size=shape).astype(
        np.float32)


def _head(k, shape):
    return _rs(99 + k, *shape)


def _run(pkg, build, inputs, hybridize=False, seed=0, grad_inputs=None,
         train=True, head=_head):
    """Build the block with `build(pkg)`, initialize it under `seed` on the
    CPU, run it on `inputs` (numpy) under record() (train mode unless
    `train` is False), backpropagate a fixed random head gradient, and
    return (block, outputs, {input index: grad}, {param: grad})."""
    def go():
        block = build(pkg)
        pkg.random.seed(seed)
        block.initialize(ctx=pkg.cpu())
        if hybridize:
            block.hybridize()
        xs = [pkg.nd.array(a, ctx=pkg.cpu(), dtype=a.dtype) for a in inputs]
        which = range(len(xs)) if grad_inputs is None else grad_inputs
        for i in which:
            xs[i].attach_grad()
        with pkg.autograd.record(train_mode=train):
            out = block(*xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        heads = [pkg.nd.array(head(k, o.shape), ctx=pkg.cpu())
                 for k, o in enumerate(outs)]
        pkg.autograd.backward(outs, heads)
        grads = {i: xs[i].grad.asnumpy() for i in which}
        pgrads = {n: p.grad().asnumpy()
                  for n, p in block.collect_params().items()
                  if p.grad_req != "null"}
        return block, [o.asnumpy() for o in outs], grads, pgrads
    return _fresh(go)


def _hold(build, inputs, hybridize=False, tol=TOL, **kw):
    """The port's block against the JAX package's: parameter names and
    initial values bitwise, outputs and gradients within `tol`."""
    tb, tout, tg, tpg = _run(tmx, build, inputs, hybridize, **kw)
    jb, jout, jg, jpg = _run(jmx, build, inputs, False, **kw)
    assert list(block_params_to_numpy(tb)) == list(block_params_to_numpy(jb))
    assert len(tout) == len(jout)
    for k, (a, b) in enumerate(zip(tout, jout)):
        _close(a, b, tol, f"output {k}")
    assert tg.keys() == jg.keys() and tpg.keys() == jpg.keys()
    for i in tg:
        _close(tg[i], jg[i], tol, f"input {i} grad")
    for n in tpg:
        _close(tpg[n], jpg[n], tol, f"{n} grad")
    return tb, tout


def _graph_json(pkg, build, n_inputs=1):
    def go():
        block = build(pkg)
        data = [pkg.sym.Variable(f"data{i}" if n_inputs > 1 else "data")
                for i in range(n_inputs)]
        out = block(*data)
        if isinstance(out, (list, tuple)):
            out = pkg.sym.Group(list(out))
        g = json.loads(out.tojson())
        return {k: g[k] for k in ("nodes", "arg_nodes", "heads")}
    return _fresh(go)


ACTIVATIONS = {
    "leaky": lambda nn: nn.LeakyReLU(0.1),
    "prelu": lambda nn: nn.PReLU(),
    "elu": lambda nn: nn.ELU(0.7),
    "selu": lambda nn: nn.SELU(),
    "gelu": lambda nn: nn.GELU(),
    "swish": lambda nn: nn.Swish(1.5),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind", sorted(ACTIVATIONS))
def test_activation_blocks_match_jax(kind, hybridize):
    """Each activation block, eager and hybridized, forward and the
    gradients of the input (and of PReLU's alpha) against JAX eager; the
    composed graph JSON equals the JAX one (node names included)."""
    build = lambda pkg: ACTIVATIONS[kind](pkg.gluon.nn)   # noqa: E731
    x = _rs(1, 3, 4, 5) * 3
    x[0, 0, :2] = 0.0          # the kink itself
    tb, _ = _hold(build, [x], hybridize)
    assert _graph_json(tmx, build) == _graph_json(jmx, build)
    if kind == "prelu":
        assert tb.alpha.data().asnumpy().tolist() == [0.25]


@pytest.mark.parametrize("hybridize", [False, True])
def test_embedding_matches_jax(hybridize):
    """Embedding: the weight's name, shape and initial values, the lookup
    and the weight's scatter-added gradient (repeated ids)."""
    ids = np.array([[1, 5, 5, 0], [9, 1, 2, 2]], np.float32)
    build = lambda pkg: pkg.gluon.nn.Embedding(10, 6)     # noqa: E731
    tb, _ = _hold(build, [ids], hybridize, grad_inputs=[])
    assert tb.weight.shape == (10, 6)
    assert repr(tb) == "Embedding(10 -> 6, float32)"
    assert _graph_json(tmx, build) == _graph_json(jmx, build)


@pytest.mark.parametrize("axis,scale", [(1, False), (1, True), (2, True),
                                        (-1, False)])
def test_instance_norm_matches_jax(axis, scale):
    """InstanceNorm with a deferred channel count, at axis 1 and (swapped
    to 1 and back) 2 and -1, with and without a learned gamma.  The JAX
    block cannot run an axis other than 1 (its ``x.swapaxes(1, axis)``
    passes the axes as inputs of the op: ROADMAP Queue 3), so there the
    port is held to the JAX block at axis 1 on the swapped input, with
    the head gradient, the output and the input's gradient swapped the
    same way."""
    x = _rs(2, 2, 3, 5, 4) * 2 + 0.5

    def build(ax):
        return lambda pkg: pkg.gluon.nn.InstanceNorm(
            axis=ax, scale=scale, epsilon=1e-3)
    for hyb in (False, True):
        if axis == 1:
            tb, _ = _hold(build(1), [x], hyb)
            continue
        tb, tout, tg, tpg = _run(tmx, build(axis), [x], hyb)
        _, jout, jg, jpg = _run(
            jmx, build(1), [np.swapaxes(x, 1, axis)],
            head=lambda k, shape: np.swapaxes(_head(k, x.shape), 1, axis))
        _close(tout[0], np.swapaxes(jout[0], 1, axis), TOL, "output")
        _close(tg[0], np.swapaxes(jg[0], 1, axis), TOL, "input grad")
        assert tpg.keys() == jpg.keys()
        for n in tpg:
            _close(tpg[n], jpg[n], TOL, n)
        with pytest.raises(TypeError):
            _run(jmx, build(axis), [x])
    assert tb.beta.shape == (x.shape[axis],)


def test_sync_batchnorm_is_batchnorm_on_one_card():
    """The one-card SyncBatchNorm: the op's sync attribute in the graph
    (as the JAX package writes it), and in training the same outputs,
    gradients and moving statistics as BatchNorm, in both packages."""
    x = _rs(3, 4, 3, 5, 5) * 2 + 1
    runs = {}
    for cls in ("BatchNorm", "SyncBatchNorm"):
        build = lambda pkg, c=cls: getattr(pkg.gluon.nn, c)()  # noqa: E731
        tb, tout = _hold(build, [x])
        runs[cls] = (tout[0], tb.running_mean.data().asnumpy(),
                     tb.running_var.data().asnumpy())
    for a, b in zip(runs["BatchNorm"], runs["SyncBatchNorm"]):
        _close(a, b, (0, 0))
    sync = lambda pkg: pkg.gluon.nn.SyncBatchNorm()   # noqa: E731
    g = _graph_json(tmx, sync)
    assert g == _graph_json(jmx, sync)
    assert g["nodes"][-1]["attrs"]["sync"] == "True"
    contrib = lambda pkg: pkg.gluon.contrib.nn.SyncBatchNorm(  # noqa: E731
        in_channels=3)
    assert _graph_json(tmx, contrib) == _graph_json(jmx, contrib)


def test_lambda_blocks_match_jax():
    """Lambda (an nd function's name, a callable) and HybridLambda (a
    name both nd and sym have, a callable of F) against JAX, the hybrid
    one hybridized too; an unknown name is refused."""
    x = _rs(4, 3, 7)
    for build in (lambda pkg: pkg.gluon.nn.Lambda("tanh"),
                  lambda pkg: pkg.gluon.nn.Lambda(lambda a: a * a + 1)):
        _hold(build, [x])
    for build in (lambda pkg: pkg.gluon.nn.HybridLambda("sigmoid"),
                  lambda pkg: pkg.gluon.nn.HybridLambda(
                      lambda F, a: F.relu(a) * 2)):
        _hold(build, [x])
        _hold(build, [x], hybridize=True)
        assert _graph_json(tmx, build) == _graph_json(jmx, build)
    assert repr(_fresh(lambda: tmx.gluon.nn.HybridLambda("tanh"))) == \
        "HybridLambda(tanh)"
    with pytest.raises(tmx.MXNetError, match="not found"):
        tmx.gluon.nn.Lambda("no_such_function")
    with pytest.raises(tmx.MXNetError, match="not found"):
        tmx.gluon.nn.HybridLambda("no_such_function")


TRANSPOSES = {
    "1d": (lambda nn: nn.Conv1DTranspose(4, 3, strides=2, padding=1,
                                         output_padding=1), (2, 3, 7)),
    "2d": (lambda nn: nn.Conv2DTranspose(5, (3, 2), strides=(2, 1),
                                         padding=(1, 0), output_padding=(1, 0),
                                         groups=1), (2, 4, 5, 6)),
    "2d_groups": (lambda nn: nn.Conv2DTranspose(6, 3, strides=2, groups=2,
                                                in_channels=4,
                                                activation="relu"),
                  (1, 4, 4, 4)),
    "3d": (lambda nn: nn.Conv3DTranspose(3, 2, strides=2, use_bias=False),
           (1, 2, 3, 4, 3)),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind", sorted(TRANSPOSES))
def test_transposed_convolutions_match_jax(kind, hybridize):
    """Conv1D/2D/3DTranspose over Deconvolution: the weight (in_channels,
    channels / groups, *kernel), deferred or given, stride, padding,
    output padding (adj), groups, an activation and no bias."""
    make, shape = TRANSPOSES[kind]
    build = lambda pkg: make(pkg.gluon.nn)       # noqa: E731
    tb, _ = _hold(build, [_rs(5, *shape)], hybridize)
    channels = tb._channels // tb._kwargs["num_group"]
    assert tb.weight.shape[:2] == (shape[1], channels)
    assert _graph_json(tmx, build) == _graph_json(jmx, build)


@pytest.mark.parametrize("hybridize", [False, True])
def test_reflection_pad_matches_jax(hybridize):
    """ReflectionPad2D by an int and by an explicit pad_width."""
    x = _rs(6, 2, 3, 5, 6)
    for build in (lambda pkg: pkg.gluon.nn.ReflectionPad2D(2),
                  lambda pkg: pkg.gluon.nn.ReflectionPad2D(
                      (0, 0, 0, 0, 1, 2, 3, 0))):
        _, out = _hold(build, [x], hybridize)
    assert out[0].shape == (2, 3, 8, 9)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("dims,factor,shape", [
    (1, 3, (2, 6, 5)), (2, (2, 3), (2, 12, 3, 4)),
    (3, 2, (1, 16, 2, 3, 2))])
def test_pixel_shuffle_matches_jax(dims, factor, shape, hybridize):
    build = lambda pkg: getattr(pkg.gluon.contrib.nn,   # noqa: E731
                                f"PixelShuffle{dims}D")(factor)
    _, out = _hold(build, [_rs(7, *shape)], hybridize)
    f = (factor,) * dims if isinstance(factor, int) else factor
    assert out[0].shape == (shape[0], shape[1] // int(np.prod(f))) + tuple(
        s * k for s, k in zip(shape[2:], f))


def _concurrent(pkg, hybrid):
    cnn, nn = pkg.gluon.contrib.nn, pkg.gluon.nn
    net = (cnn.HybridConcurrent if hybrid else cnn.Concurrent)(axis=1)
    with net.name_scope():
        net.add(nn.Dense(3, flatten=False), cnn.Identity(),
                nn.Dense(2, activation="tanh", flatten=False))
    return net


@pytest.mark.parametrize("hybrid,hybridize", [(False, False), (True, False),
                                              (True, True)])
def test_concurrent_identity_and_sparse_embedding_match_jax(hybrid,
                                                            hybridize):
    """Concurrent / HybridConcurrent over Dense, Identity and Dense
    (outputs concatenated), and contrib's dense-delegating
    SparseEmbedding, against JAX."""
    x = _rs(8, 4, 5)
    _, out = _hold(lambda pkg: _concurrent(pkg, hybrid), [x], hybridize)
    assert out[0].shape == (4, 10)
    ids = np.array([3, 0, 3, 7], np.float32)
    _hold(lambda pkg: pkg.gluon.contrib.nn.SparseEmbedding(8, 3), [ids],
          grad_inputs=[])


def test_forward_hooks_run_around_forward():
    """Pre-hooks see the inputs before, hooks the inputs and output
    after, in registration order, in both packages alike."""
    x = _rs(9, 2, 4)

    def trace(pkg):
        seen = []
        net = pkg.gluon.nn.Dense(3, in_units=4)
        net.register_forward_pre_hook(
            lambda b, a: seen.append(("pre", b.name, a[0].shape)))
        h = net.register_forward_hook(
            lambda b, a, o: seen.append(("post", b.name, o.shape)))
        net.register_forward_hook(lambda b, a, o: seen.append(("post2",)))
        net.initialize(ctx=pkg.cpu())
        net(pkg.nd.array(x, ctx=pkg.cpu()))
        net._forward_hooks.pop(h)
        net(pkg.nd.array(x, ctx=pkg.cpu()))
        return seen
    got = _fresh(lambda: trace(tmx))
    assert got == _fresh(lambda: trace(jmx))
    assert got == [("pre", "dense_0", (2, 4)), ("post", "dense_0", (2, 3)),
                   ("post2",), ("pre", "dense_0", (2, 4)), ("post2",)]


def _summary_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(), nn.PReLU(),
                nn.MaxPool2D(), nn.Flatten(), nn.Dense(5),
                nn.Embedding(7, 2))
    return net


def test_summary_rows_equal_jax():
    """summary prints the JAX package's rows for the same net (names,
    types, output shapes, parameter counts, the total), and leaves no
    hook behind."""
    x = _rs(10, 2, 3, 4, 4)

    def printed(pkg):
        net = _summary_net(pkg)
        pkg.random.seed(0)
        net.initialize(ctx=pkg.cpu())
        net(pkg.nd.array(x, ctx=pkg.cpu()))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            net.summary(pkg.nd.array(x, ctx=pkg.cpu()))
        hooks = [len(b._forward_hooks) for b in [net] + list(net)]
        return buf.getvalue(), hooks
    got, hooks = _fresh(lambda: printed(tmx))
    want, _ = _fresh(lambda: printed(jmx))
    assert got == want
    assert not any(hooks)
    rows = got.splitlines()
    assert rows[0].startswith("Layer") and rows[-1] == "Total params: 228"
    assert rows[2].split() == ["hybridsequential_0_conv2d0", "Conv2D",
                               "(2,", "4,", "4,", "4)", "112"]


def test_symbol_block_imports_an_export(tmp_path):
    """export of a hybridized net, then SymbolBlock.imports onto the CPU in
    both packages (either package's files): the same forward as the
    block, the aux states with grad_req null, every parameter once under
    its symbol name, and a Trainer step on the imported block equal to
    one on the original."""
    x = _rs(11, 2, 3, 6, 6)

    def export(pkg, prefix):
        net = _summary_net(pkg)
        pkg.random.seed(1)
        net.initialize(ctx=pkg.cpu())
        net.hybridize()
        out = net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy()
        net.export(prefix)
        return net, out
    tnet, tout = _fresh(lambda: export(tmx, str(tmp_path / "t")))
    jnet, jout = _fresh(lambda: export(jmx, str(tmp_path / "j")))
    _close(tout, jout, TOL, "exported forward")
    for src in ("t", "j"):
        p = str(tmp_path / src)
        sb = tmx.gluon.SymbolBlock.imports(p + "-symbol.json", "data",
                                           p + "-0000.params", ctx=tmx.cpu())
        _close(sb(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), tout, TOL,
               f"imported from {src}")
        names = list(sb.collect_params())
        assert sorted(names) == sorted(block_params_to_numpy(tnet))
        aux = [n for n in names if "running" in n]
        assert aux and all(sb.collect_params()[n].grad_req == "null"
                           for n in aux)
    jsb = jmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                        "data", str(tmp_path / "t-0000.params"))
    _close(jsb(jmx.nd.array(x)).asnumpy(), tout, TOL, "JAX imports the port")
    # one SGD step through each: the imported block trains as the original
    y = _rs(12, *tout.shape)

    def step(net):
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        with tmx.autograd.record():
            out = net(tmx.nd.array(x, ctx=tmx.cpu()))
            loss = tmx.gluon.loss.L2Loss()(out, tmx.nd.array(y,
                                                             ctx=tmx.cpu()))
        loss.backward()
        tr.step(2)
        return {n: v for n, v in block_params_to_numpy(net).items()}
    p = str(tmp_path / "t")
    sb = tmx.gluon.SymbolBlock.imports(p + "-symbol.json", "data",
                                       p + "-0000.params", ctx=tmx.cpu())
    sb.hybridize()
    after = step(sb)
    ref = step(tnet)
    for n in ref:
        _close(after[n], ref[n], TOL, n)
    values = block_params_to_numpy(tnet)
    block_params_from_numpy(sb, values, ctx=tmx.cpu())
    assert all(block_params_to_numpy(sb)[k].tobytes() == v.tobytes()
               for k, v in values.items())


def test_symbol_block_defaults_to_the_current_context(tmp_path,
                                                      monkeypatch):
    """imports without ctx loads onto current_context() (the card's
    gpu(0) by default; here a CPU context is made current), and a
    SymbolBlock needs NDArray inputs."""
    net = tmx.gluon.nn.Dense(2, in_units=3, prefix="d_")
    net.initialize(ctx=tmx.cpu())
    net.hybridize()
    net(tmx.nd.array(np.ones((1, 3), np.float32), ctx=tmx.cpu()))
    net.export(str(tmp_path / "d"))
    with tmx.cpu(1):
        sb = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "d-symbol.json"), ["data"],
            str(tmp_path / "d-0000.params"))
    assert sb.collect_params()["d_weight"].list_ctx() == [tmx.cpu(1)]
    with pytest.raises(tmx.MXNetError, match="NDArray"):
        sb(tmx.sym.Variable("data"))


def test_get_symbol_raises_as_jax():
    x = tmx.nd.array(np.ones(2, np.float32), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError) as e:
        tmx.autograd.get_symbol(x)
    with pytest.raises(jmx.MXNetError) as j:
        jmx.autograd.get_symbol(jmx.nd.ones((2,)))
    assert str(e.value) == str(j.value)


@pytest.mark.parametrize("layout,label_layout,lengths", [
    ("NTC", "NT", False), ("TNC", "TN", False), ("NTC", "TN", True),
    ("TNC", "NT", True)])
def test_ctc_loss_matches_jax(layout, label_layout, lengths):
    """CTCLoss in both layouts and label layouts, with and without data
    and label lengths, eager and hybridized: the per-sample loss and the
    prediction's gradient against JAX (label 0 is the blank)."""
    n, t, c, l = 3, 9, 5, 4
    pred = _rs(13, n, t, c) * 2
    label = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 4, 1, 3]], np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    inputs = [pred, label]
    if lengths:
        inputs += [np.array([9, 7, 8], np.float32),
                   np.array([3, 2, 4], np.float32)]
    build = lambda pkg: pkg.gluon.loss.CTCLoss(layout, label_layout)  # noqa
    for hyb in (False, True):
        _, out = _hold(build, inputs, hyb, tol=CTC_TOL, grad_inputs=[0])
    assert out[0].shape == (n,) and np.isfinite(out[0]).all()
    assert _graph_json(tmx, build, len(inputs)) == \
        _graph_json(jmx, build, len(inputs))
    with pytest.raises(ValueError, match="layout"):
        tmx.gluon.loss.CTCLoss("NCT")


def _unroll(pkg, make, x, layout="NTC", seed=0, train=False):
    """make(pkg) unrolled over x (merged outputs), with gradients of x and
    of the parameters; returns (outputs, states, grads)."""
    def go():
        cell = make(pkg)
        pkg.random.seed(seed)
        cell.initialize(ctx=pkg.cpu())
        xa = pkg.nd.array(x, ctx=pkg.cpu())
        xa.attach_grad()
        with pkg.autograd.record(train_mode=train):
            out, states = cell.unroll(x.shape[1], xa, layout=layout,
                                      merge_outputs=True)
            loss = (out * pkg.nd.array(_rs(77, *out.shape),
                                       ctx=pkg.cpu())).sum()
            for s in states:
                loss = loss + s.sum()
        loss.backward()
        grads = {n: p.grad().asnumpy()
                 for n, p in cell.collect_params().items()}
        grads["x"] = xa.grad.asnumpy()
        return cell, out.asnumpy(), [s.asnumpy() for s in states], grads
    return _fresh(go)


def _hold_cell(make, x, **kw):
    tc, tout, ts, tg = _unroll(tmx, make, x, **kw)
    jc, jout, js, jg = _unroll(jmx, make, x, **kw)
    assert list(block_params_to_numpy(tc)) == list(block_params_to_numpy(jc))
    _close(tout, jout, TOL, "outputs")
    for a, b in zip(ts, js):
        _close(a, b, TOL, "states")
    assert tg.keys() == jg.keys()
    for n in tg:
        _close(tg[n], jg[n], TOL, f"{n} grad")
    return tc, tout


CONV_CELLS = [(f"Conv{d}D{k}Cell", d) for d in (1, 2, 3)
              for k in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("name,dims", CONV_CELLS)
def test_conv_rnn_cells_match_jax(name, dims):
    """Every convolutional cell unrolled over 3 steps: outputs, final
    states, the input's and every weight's gradient against JAX."""
    spatial = (5, 4, 3)[:dims]
    x = _rs(14, 2, 3, 2, *spatial)

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, name)(
            input_shape=(2,) + spatial, hidden_channels=3, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)
    cell, out = _hold_cell(make, x)
    assert out.shape == (2, 3, 3) + spatial
    assert type(cell).__name__ == name
    with pytest.raises(tmx.MXNetError, match="odd"):
        getattr(tmx.gluon.contrib.rnn, name)((2,) + spatial, 3, 3, 2)


def test_lstmp_cell_matches_jax():
    """LSTMPCell (hidden 6, projection 3, deferred input size) unrolled
    over 4 steps, and composed on a Symbol with the JAX graph."""
    x = _rs(15, 2, 4, 5)
    make = lambda pkg: pkg.gluon.contrib.rnn.LSTMPCell(6, 3)  # noqa: E731
    cell, out = _hold_cell(make, x)
    assert out.shape == (2, 4, 3)
    assert cell.h2r_weight.shape == (3, 6)

    def graph(pkg):
        cell = make(pkg)
        out, _ = cell.unroll(4, pkg.sym.Variable("data"), merge_outputs=True,
                             begin_state=[pkg.sym.Variable("h"),
                                          pkg.sym.Variable("c")])
        nodes = json.loads(out.tojson())["nodes"]
        for n in nodes:      # the loop body's graph, without its header
            if "subgraph" in n["attrs"]:
                g = json.loads(n["attrs"]["subgraph"])
                n["attrs"]["subgraph"] = {k: g[k] for k in (
                    "nodes", "arg_nodes", "heads")}
        return nodes
    assert _fresh(lambda: graph(tmx)) == _fresh(lambda: graph(jmx))


def test_variational_dropout_cell():
    """VariationalDropoutCell over an LSTMCell: in predict mode the JAX
    package's outputs and gradients; in training one mask per unroll,
    the same at every step, and a new one after reset."""
    x = _rs(16, 3, 5, 4)

    def make(pkg):
        return pkg.gluon.contrib.rnn.VariationalDropoutCell(
            pkg.gluon.rnn.LSTMCell(6), drop_inputs=0.5, drop_states=0.3,
            drop_outputs=0.4)
    _hold_cell(make, x)
    cell = _fresh(lambda: make(tmx))
    cell.initialize(ctx=tmx.cpu())
    ones = np.ones((3, 5, 4), np.float32)
    with tmx.autograd.train_mode():
        out, _ = cell.unroll(5, tmx.nd.array(ones, ctx=tmx.cpu()),
                             merge_outputs=True)
        mask = cell._input_mask.asnumpy()
        first = cell._output_mask.asnumpy()
        assert set(np.unique(mask)) <= {0.0, 2.0} and 0 < mask.mean() < 2
        cell.unroll(5, tmx.nd.array(ones, ctx=tmx.cpu()), merge_outputs=True)
        assert not np.array_equal(cell._output_mask.asnumpy(), first)
    # the output mask multiplies every step's output alike
    o = out.asnumpy()
    dropped = first == 0
    assert dropped.any() and (o[:, :, :][np.broadcast_to(
        dropped[:, None, :], o.shape)] == 0).all()


def test_interval_sampler_matches_jax():
    from incubator_mxnet_tpu.gluon.contrib.data import IntervalSampler as J
    from incubator_mxnet_tpu_torch.gluon.contrib.data import \
        IntervalSampler as T
    for length, interval, rollover in ((10, 3, True), (10, 3, False),
                                       (7, 7, True), (13, 4, False)):
        t, j = T(length, interval, rollover), J(length, interval, rollover)
        assert list(t) == list(j) and len(t) == len(j)
    assert list(T(10, 3)) == [0, 3, 6, 9, 1, 4, 7, 2, 5, 8]
    with pytest.raises(ValueError):
        T(3, 4)


def test_gluon_exports_what_jax_exports():
    """gluon, gluon.nn and gluon.contrib's subpackages export every name
    the JAX ones do."""
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")}
    for path in ("gluon", "gluon.nn", "gluon.contrib", "gluon.contrib.nn",
                 "gluon.contrib.rnn", "gluon.contrib.data",
                 "gluon.model_zoo.vision"):
        t, j = tmx, jmx
        for part in path.split("."):
            t, j = getattr(t, part), getattr(j, part)
        missing = {n for n in names(j) - names(t)
                   if not isinstance(getattr(j, n), type(json))}
        assert not missing, (path, sorted(missing))


def test_sparse_embedding_over_the_sharded_table(monkeypatch):
    """nn.SparseEmbedding on two parameter-server shards: the forward
    returns the table's rows, the gradient reaches the shards row-sparse
    through push_grads (duplicate ids summed), as in the JAX package on
    its own servers."""
    from tests.test_torch_embedding import Both, _close as eclose
    monkeypatch.setenv("MXNET_PS_REQUEST_TIMEOUT", "60")
    both = Both(2, "t", 12, 3, seed=4, cache_rows=6,
                make_opt=lambda pkg: pkg.optimizer.SGD(learning_rate=0.5))
    try:
        ids = np.array([[1, 7, 7], [11, 0, 1]], np.float32)
        head = _rs(17, 2, 3, 3)
        res = {}
        for pkg, jax in ((tmx, False), (jmx, True)):
            emb = pkg.gluon.nn.SparseEmbedding(both.t[jax])
            with pkg.autograd.record():
                out = emb(pkg.nd.array(ids, ctx=pkg.cpu()))
                loss = (out * pkg.nd.array(head, ctx=pkg.cpu())).sum()
            loss.backward()
            emb.push_grads()
            assert emb._pending == []
            res[jax] = (out.asnumpy(), both.t[jax].pull_rows(np.arange(12)))
        eclose(res[False][0], res[True][0], what="lookup")
        eclose(res[False][1], res[True][1], what="table after the push")
        assert "2 shards" in repr(tmx.gluon.nn.SparseEmbedding(both.t[False]))
    finally:
        both.close()


@pytest.mark.parametrize("kind", ["prelu", "lstmp", "conv_lstm", "zoo"])
def test_weights_carry_from_jax_by_name(kind):
    """compat.weights carries a JAX block's values into the port's block
    of the same name (PReLU's alpha, LSTMPCell's projection, a conv
    cell's weights, a zoo family's BatchNorm statistics), bitwise, and
    the two then answer alike."""
    def build(pkg):
        if kind == "prelu":
            nn = pkg.gluon.nn
            net = nn.HybridSequential()
            with net.name_scope():
                net.add(nn.Dense(6), nn.PReLU(), nn.Dense(3))
            return net
        if kind == "lstmp":
            return pkg.gluon.contrib.rnn.LSTMPCell(5, 2, input_size=4)
        if kind == "conv_lstm":
            return pkg.gluon.contrib.rnn.Conv2DLSTMCell((2, 5, 5), 3, 3, 3,
                                                        i2h_pad=1)
        return pkg.gluon.model_zoo.vision.get_model("mobilenetv2_0.25",
                                                    classes=4)
    shape = {"prelu": (3, 4), "lstmp": (2, 3, 4), "conv_lstm": (1, 3, 2, 5, 5),
             "zoo": (1, 3, 32, 32)}[kind]
    x = _rs(18, *shape)

    def run(pkg, net):
        xa = pkg.nd.array(x, ctx=pkg.cpu())
        if kind in ("lstmp", "conv_lstm"):
            out, _ = net.unroll(shape[1], xa, merge_outputs=True)
            return out.asnumpy()
        return net(xa).asnumpy()

    def jax_side():
        net = build(jmx)
        jmx.random.seed(5)
        net.initialize(jmx.initializer.Xavier())
        run(jmx, net)                            # deferred shapes
        for k, p in net.collect_params().items():
            if k.endswith("alpha"):              # off its initial 0.25
                p.set_data(jmx.nd.array(np.full(p.shape, 0.1, "f4")))
        return block_params_to_numpy(net), run(jmx, net)
    values, want = _fresh(jax_side)
    tnet = _fresh(lambda: build(tmx))
    block_params_from_numpy(tnet, values, ctx=tmx.cpu())
    got = block_params_to_numpy(tnet)
    assert list(got) == list(values)
    assert all(got[k].tobytes() == values[k].tobytes() for k in values)
    _close(run(tmx, tnet), want, TOL, kind)
