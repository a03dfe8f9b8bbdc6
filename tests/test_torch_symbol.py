"""The PyTorch port's Symbol layer against the JAX package: JSON in both
directions, shape inference, the VGG graph, and op-by-op evaluation."""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo.vision import vgg16

import incubator_mxnet_tpu_torch as tmx


def _graph(mod):
    """Conv / pool / FC / reshape / softmax graph built with either
    package's `sym` API."""
    s = mod.sym
    x = s.var("data")
    x = s.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=4, name="c1")
    x = s.Activation(x, act_type="relu", name="r1")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="p1")
    x = s.Convolution(x, kernel=(3, 3), stride=(2, 2), num_filter=6,
                      no_bias=True, name="c2")
    x = s.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type="avg", pooling_convention="full",
                  count_include_pad=False, name="p2")
    x = s.Flatten(x, name="flat")
    x = s.FullyConnected(x, num_hidden=12, name="fc1")
    x = s.Activation(x, act_type="tanh", name="t1")
    x = s.Dropout(x, p=0.5, name="drop")
    x = s.Reshape(x, shape=(0, -1, 3), name="rs")
    x = s.FullyConnected(x, num_hidden=5, flatten=False, name="fc2")
    return s.softmax(x, axis=-1, name="sm")


def _nodes(js):
    g = json.loads(js)
    return g["nodes"], g["heads"], g["arg_nodes"]


def test_jax_json_loads_in_port_and_round_trips():
    js = _graph(jmx).tojson()
    port = tmx.sym.load_json(js)
    assert _nodes(port.tojson()) == _nodes(js)
    assert port.list_arguments() == jmx.sym.load_json(js).list_arguments()


def test_port_json_loads_in_jax_and_round_trips():
    js = _graph(tmx).tojson()
    assert _nodes(js) == _nodes(_graph(jmx).tojson())
    back = jmx.sym.load_json(js)
    assert _nodes(back.tojson()) == _nodes(js)
    part = tmx.subgraph.partition_graph(tmx.model_zoo.vgg_symbol(11),
                                        "TPU_PALLAS")
    assert _nodes(jmx.sym.load_json(part.tojson()).tojson()) == \
        _nodes(part.tojson())


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 3, 20, 18)])
def test_infer_shape_matches(shape):
    want = _graph(jmx).infer_shape(data=shape)
    got = _graph(tmx).infer_shape(data=shape)
    assert got == want


def test_vgg16_symbol_matches_gluon_graph():
    want = vgg16(prefix="vgg0_")(jmx.sym.var("data"))
    got = tmx.model_zoo.vgg_symbol(16)
    assert _nodes(got.tojson()) == _nodes(want.tojson())
    assert got.list_arguments() == want.list_arguments()
    # the stringly __shape__ attrs a saved VGG carries are read back
    loaded = tmx.sym.load_json(got.tojson())
    assert loaded.infer_shape(data=(1, 3, 224, 224))[1] == [(1, 1000)]


def _params(sym, shape, seed):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=shape)
    return {n: rng.normal(0, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}


def _jax_forward(sym, args, x):
    exe = sym.simple_bind(ctx=jmx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()}, {})
    return exe.forward(is_train=False, data=jmx.nd.array(x))[0].asnumpy()


def _port_forward(sym, args, x):
    gfn, arg_nodes, _ = tmx.sym.graph_eval_fn(sym, False)
    feed = {k: torch.from_numpy(v) for k, v in args.items()}
    feed["data"] = torch.from_numpy(x)
    return gfn([feed[n.name] for n in arg_nodes], [])[0][0].numpy()


@pytest.mark.parametrize("pool", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False, pooling_convention="full"),
    dict(kernel=(2, 2), stride=(1, 1), pool_type="sum"),
    dict(global_pool=True, pool_type="avg"),
])
def test_pooling_matches(pool):
    x = np.random.RandomState(4).normal(0, 1, (2, 3, 9, 7)).astype(np.float32)
    want = _jax_forward(jmx.sym.Pooling(jmx.sym.var("data"), **pool), {}, x)
    got = _port_forward(tmx.sym.Pooling(tmx.sym.var("data"), **pool), {}, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_graph_forward_matches():
    """Conv (padded, strided, no bias), pools, FC with and without
    flatten, reshape codes, softmax, inference Dropout: float32 sums in
    different orders, so 1e-5."""
    x = np.random.RandomState(5).normal(0, 1, (3, 3, 16, 16)).astype(
        np.float32)
    jsym = _graph(jmx)
    args = _params(jsym, x.shape, seed=6)
    np.testing.assert_allclose(_port_forward(_graph(tmx), args, x),
                               _jax_forward(jsym, args, x),
                               rtol=1e-5, atol=1e-6)
