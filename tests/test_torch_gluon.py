"""The port's gluon (Parameter, Block, HybridBlock, nn layers, the model
zoo's ResNet and VGG; the other families are in test_torch_gluon_zoo.py)
against the JAX package's on the CPU.

Networks are built in a fresh thread in each package, so the per-thread
name counters start at 0 in both and composition gives the same names.
Parameters cross between the packages bitwise (the `.params` format, or
numpy).  Tolerance of an imperative forward: float32 sums in other
orders through up to 18 layers, rtol 1e-4 + 1e-5 * max|ref|.
"""
import json
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import (
    block_params_from_numpy, block_params_to_numpy)
from incubator_mxnet_tpu_torch.gluon import nn as tnn

FWD_TOL = (1e-4, 1e-5)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    """fn() in a new thread (fresh name counters); returns its result."""
    out = {}

    def run():
        out["v"] = fn()

    t = threading.Thread(target=run)
    t.start()
    t.join(120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _zoo(pkg, name, **kw):
    return pkg.gluon.model_zoo.vision.get_model(name, **kw)


def _composed(pkg, name, **kw):
    """(net, SoftmaxOutput over the net composed on Variable("data"))."""
    def build():
        net = _zoo(pkg, name, **kw)
        return net, pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                          name="softmax")
    return _fresh(build)


def _graph(sym):
    g = json.loads(sym.tojson())
    return {k: g[k] for k in ("nodes", "arg_nodes", "heads")}


def _small_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(2, 2), nn.Conv2D(4, 1, activation="relu"),
                nn.GlobalAvgPool2D(), nn.Dense(6, activation="tanh"),
                nn.Dense(3))
    return net


def test_layers_compose_with_the_names_and_graph_of_jax():
    """Conv2D / BatchNorm / Activation / pooling / Dense in a
    HybridSequential: the same parameter names (with the per-class
    counters), the same symbol JSON and the same inferred shapes."""
    tnet, tsym = _fresh(lambda: (lambda n: (n, n(tmx.sym.Variable("data"))))(
        _small_net(tmx)))
    jnet, jsym = _fresh(lambda: (lambda n: (n, n(jmx.sym.Variable("data"))))(
        _small_net(jmx)))
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert "hybridsequential_0_batchnorm0_running_var" in tnet.collect_params()
    assert tnet.collect_params()["hybridsequential_0_conv2d0_weight"].shape \
        == (8, 0, 3, 3)
    assert _graph(tsym) == _graph(jsym)
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    shapes = tsym.infer_shape(data=(2, 5, 8, 8))
    jshapes = jsym.infer_shape(data=(2, 5, 8, 8))
    for got, want in zip(shapes, jshapes):
        assert got == [tuple(s) for s in want]


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2",
                                  "resnet50_v1", "vgg11_bn"])
def test_model_zoo_symbol_json_equals_jax(name):
    """The composed network's graph JSON (nodes with op, name, attrs and
    inputs; arg nodes; heads) equals the JAX package's, so parameter and
    aux names and the op-node names (``fwd``) match too."""
    _, tsym = _composed(tmx, name, classes=1000)
    _, jsym = _composed(jmx, name, classes=1000)
    assert _graph(tsym) == _graph(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()


def test_resnet50_v1_infer_shape_matches_jax():
    """resnet50_v1(classes=1000) + SoftmaxOutput at (128, 3, 224, 224),
    composed but not run: 193 learned arguments of 25,575,912 values and
    106 aux states of 53,120, as the JAX package infers them."""
    _, tsym = _composed(tmx, "resnet50_v1", classes=1000)
    _, jsym = _composed(jmx, "resnet50_v1", classes=1000)
    shape = (128, 3, 224, 224)
    args, outs, aux = tsym.infer_shape(data=shape)
    jargs, jouts, jaux = jsym.infer_shape(data=shape)
    assert args == [tuple(s) for s in jargs]
    assert aux == [tuple(s) for s in jaux]
    assert outs == [tuple(s) for s in jouts] == [(128, 1000)]
    learned = [s for n, s in zip(tsym.list_arguments(), args)
               if n not in ("data", "softmax_label")]
    assert len(learned) == 193
    assert sum(int(np.prod(s)) for s in learned) == 25_575_912
    assert len(aux) == 106 and sum(int(np.prod(s)) for s in aux) == 53_120
    ops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert {op: ops.count(op) for op in set(ops) if op != "null"} == {
        "Convolution": 53, "BatchNorm": 53, "Activation": 49,
        "broadcast_add": 16, "Pooling": 2, "FullyConnected": 1,
        "SoftmaxOutput": 1}


def test_jax_resnet50_json_loads_binds_and_infers_in_the_port():
    """The JAX package's composed resnet50_v1 JSON loads in the port
    (BatchNorm is registered), infers the same shapes and binds."""
    _, jsym = _composed(jmx, "resnet50_v1", classes=1000)
    sym = tmx.sym.load_json(jsym.tojson())
    args, _, aux = sym.infer_shape(data=(2, 3, 224, 224))
    jargs, _, jaux = jsym.infer_shape(data=(2, 3, 224, 224))
    assert args == [tuple(s) for s in jargs] and \
        aux == [tuple(s) for s in jaux]
    exe = sym.simple_bind(tmx.cpu(), grad_req="null", data=(2, 3, 224, 224))
    assert exe.aux_dict["resnetv1_0_batchnorm0_running_var"].shape == (64,)


def _initialized(pkg, name, seed, x):
    """A model-zoo net (10 classes) initialized under `seed` by its first
    imperative call on `x`; returns (net, output as numpy)."""
    def build():
        net = _zoo(pkg, name, classes=10)
        pkg.random.seed(seed)
        net.initialize(ctx=pkg.cpu())
        out = net(pkg.nd.array(x, ctx=pkg.cpu()))
        return net, out.asnumpy()
    return _fresh(build)


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2"])
def test_imperative_predict_forward_matches_jax(name):
    """net.initialize(); net(x) at (1, 3, 32, 32), as the JAX package's
    model-zoo smoke test runs it: deferred shapes finished from the
    input, the default Uniform draws bitwise the same values under one
    seed, and the predict-mode output (BatchNorm on its moving
    statistics) agrees."""
    x = np.random.RandomState(0).uniform(size=(1, 3, 32, 32)).astype(
        np.float32)
    tnet, tout = _initialized(tmx, name, 3, x)
    jnet, jout = _initialized(jmx, name, 3, x)
    assert tout.shape == (1, 10)
    tvals, jvals = block_params_to_numpy(tnet), block_params_to_numpy(jnet)
    assert list(tvals) == list(jvals)
    for k, v in tvals.items():
        assert v.tobytes() == jvals[k].tobytes(), k
    _close(tout, jout, FWD_TOL, "forward")
    tnet.hybridize()
    _close(tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), tout, (0, 0),
           "hybridized")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_and_load_parameters_cross_packages(tmp_path, writer):
    """save_parameters' file (structural names) from one package loads
    into the other's uninitialized net bitwise, and the two nets then
    answer alike; ParameterDict.save's full names load too."""
    x = np.random.RandomState(1).uniform(size=(2, 3, 32, 32)).astype(
        np.float32)
    src_pkg, dst_pkg = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    src, src_out = _initialized(src_pkg, "resnet18_v1", 4, x)
    path = str(tmp_path / "net.params")
    src.save_parameters(path)

    def load():
        net = _zoo(dst_pkg, "resnet18_v1", classes=10)
        net.load_parameters(path, ctx=dst_pkg.cpu())
        return net, net(dst_pkg.nd.array(x, ctx=dst_pkg.cpu())).asnumpy()
    dst, dst_out = _fresh(load)
    want = block_params_to_numpy(src)
    got = block_params_to_numpy(dst)
    assert got.keys() == want.keys()
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    _close(dst_out, src_out, FWD_TOL, "forward after load")
    full = str(tmp_path / "full.params")
    src.collect_params().save(full, strip_prefix=src.prefix)
    again = _fresh(lambda: _zoo(dst_pkg, "resnet18_v1", classes=10))
    again.load_parameters(full, ctx=dst_pkg.cpu())
    assert all(block_params_to_numpy(again)[k].tobytes() == want[k].tobytes()
               for k in want)


def test_block_params_carry_through_numpy():
    """block_params_to_numpy of a JAX block into the port's through
    block_params_from_numpy, and back: bitwise; a missing name raises."""
    x = np.random.RandomState(2).uniform(size=(1, 3, 32, 32)).astype(
        np.float32)
    jnet, jout = _initialized(jmx, "resnet18_v2", 5, x)
    values = block_params_to_numpy(jnet)
    tnet = _fresh(lambda: _zoo(tmx, "resnet18_v2", classes=10))
    block_params_from_numpy(tnet, values, ctx=tmx.cpu())
    back = block_params_to_numpy(tnet)
    assert all(back[k].tobytes() == values[k].tobytes() for k in values)
    _close(tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), jout, FWD_TOL,
           "forward")
    other = _fresh(lambda: _zoo(tmx, "resnet18_v2", classes=10))
    values.pop(next(iter(values)))
    with pytest.raises(tmx.MXNetError, match="missing"):
        block_params_from_numpy(other, values, ctx=tmx.cpu())


def test_deferred_initialization_and_parameter_api():
    """A Dense without in_units defers its weight until the first call
    (reading it raises DeferredInitializationError), then takes the
    input's width; set_data, cast, zero_grad and grad_req behave as the
    JAX package's."""
    net = _fresh(lambda: tnn.Dense(4, prefix="fc_"))
    w = net.weight
    assert w.shape == (4, 0) and w.var().attr("__shape__") == (4, 0)
    net.initialize(ctx=tmx.cpu())
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        w.data()
    out = net(tmx.nd.array(np.ones((2, 7), np.float32), ctx=tmx.cpu()))
    assert out.shape == (2, 4) and w.shape == (4, 7)
    w.set_data(np.full((4, 7), 0.5, np.float32))
    net.bias.set_data(np.zeros(4, np.float32))
    np.testing.assert_allclose(
        net(tmx.nd.array(np.ones((1, 7), np.float32),
                         ctx=tmx.cpu())).asnumpy(), np.full((1, 4), 3.5))
    assert w.grad().shape == (4, 7)
    w.grad().data.fill_(1.0)
    net.collect_params().zero_grad()
    assert not w.grad().asnumpy().any()
    net.cast("float16")
    assert w.data().data.dtype == tmx.base.torch_dtype("float16")
    w.grad_req = "null"
    with pytest.raises(tmx.MXNetError, match="grad_req='null'"):
        w.grad()
    assert list(net.collect_params(".*bias")) == ["fc_bias"]


def test_pretrained_raises_and_get_model_names():
    """pretrained=True raises (nothing is downloaded); a name neither
    package has is refused by both; the port's get_model takes exactly
    the JAX package's names, in any case."""
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        _zoo(tmx, "resnet50_v1", pretrained=True)
    for pkg in (tmx, jmx):
        with pytest.raises(ValueError, match="not supported") as e:
            _zoo(pkg, "resnet7_v3")
        names = sorted(eval(str(e.value).split("Available: ", 1)[1]))
        if pkg is tmx:
            port_names = names
    assert port_names == names and "squeezenet1.1" in names
    assert isinstance(_fresh(lambda: _zoo(tmx, "ResNet152_V2")),
                      tmx.gluon.model_zoo.vision.ResNetV2)
    assert isinstance(_fresh(lambda: _zoo(tmx, "SqueezeNet1.1")),
                      tmx.gluon.model_zoo.vision.SqueezeNet)


def test_export_serves_through_module(tmp_path):
    """export writes the traced graph and arg:/aux: params; Module.load
    of the pair predicts what the block answers."""
    x = np.random.RandomState(6).uniform(size=(2, 3, 32, 32)).astype(
        np.float32)
    net, out = _initialized(tmx, "resnet18_v1", 7, x)
    prefix = str(tmp_path / "r18")
    net.export(prefix)
    mod = tmx.mod.Module.load(prefix, 0, data_names=("data",),
                              label_names=None, context=tmx.cpu())
    mod.bind([("data", x.shape)], for_training=False)
    _close(mod.predict(x).asnumpy(), out, (1e-6, 1e-7), "Module.predict")
