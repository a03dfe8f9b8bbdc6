"""ONNX interchange in the port (`contrib/onnx/`) against the JAX package
on the CPU: the port's file is the JAX exporter's byte for byte but for
``producer_name``; the JAX package's protobuf bindings parse it (here,
in the test; the port never imports `google.protobuf`, which a child
process checks); the port imports files the JAX exporter wrote; the
round trips of `tests/test_onnx.py`, and one over every op the exporter
maps; the wire codec against protobuf's on each message of the subset;
an imported Gemm -> Relu fused into K1 under `TPU_PALLAS`, which the
JAX importer's ``flatten=False`` Gemm prevents.

Tolerances: bytes, graphs and parameters equal; a forward through the
original graph and through its round trip computes the same ops on the
same values, rtol 1e-5 + 1e-6 * max|ref| (the JAX test's 1e-4 / 1e-5
where it is ported as it is).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import onnx as jonnx
from incubator_mxnet_tpu.contrib.onnx import onnx_subset_pb2 as PB

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.contrib import onnx as tonnx
from incubator_mxnet_tpu_torch.contrib.onnx import _wire

CPU = tmx.cpu()
TOL = (1e-5, 1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _convnet(mx):
    data = mx.sym.Variable("data")
    x = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv0")
    x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn0")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=10, name="fc0")
    return mx.sym.softmax(x)


def _mlp_and_ops(mx):
    a = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(a, num_hidden=16, name="l1")
    h = mx.sym.Activation(h, act_type="tanh")
    h2 = mx.sym.FullyConnected(h, num_hidden=16, name="l2", no_bias=True)
    s = mx.sym.broadcast_add(h, h2)
    s = mx.sym.Reshape(s, shape=(-1, 4, 4))
    s = mx.sym.transpose(s, axes=(0, 2, 1))
    return mx.sym.Reshape(s, shape=(0, -1))


def _every_op(mx):
    """A graph over every op the exporter maps."""
    s = mx.sym
    data = s.Variable("data")
    c = s.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      stride=(1, 1), num_group=1, name="c0")
    c = s.BatchNorm(c, fix_gamma=False, eps=1e-3, name="bn")
    c = s.LeakyReLU(c, slope=0.1, name="lk")
    c1 = s.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                   name="avg")
    c2 = s.Pooling(c, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                   pool_type="max", name="mx")
    c = s.Concat(c1, c2, dim=1, name="cat")
    g1 = s.Pooling(c, kernel=(1, 1), global_pool=True, pool_type="avg",
                   name="gavg")
    g2 = s.Pooling(c, kernel=(1, 1), global_pool=True, pool_type="max",
                   name="gmax")
    g = s.broadcast_mul(s.Flatten(g1, name="f1"), s.Flatten(g2, name="f2"),
                        name="mul")
    g = s.broadcast_sub(g, s.Activation(g, act_type="sigmoid", name="sg"),
                        name="sub")
    g = s.broadcast_div(g, s.Activation(
        s.Activation(g, act_type="softrelu", name="sp"), act_type="relu",
        name="rl"), name="div")
    g = s.Dropout(g, p=0.25, name="drop")
    h = s.FullyConnected(g, num_hidden=6, name="fc")
    h = s.Activation(h, act_type="softsign", name="ss")
    h = s.dot(h, s.transpose(h, axes=(1, 0), name="tr"), name="dot")
    return s.SoftmaxOutput(s.softmax(h, axis=-1, name="sm"), name="out")


def _params(sym, data_shape, seed=0):
    shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    args = {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "out_label")}
    auxs = {n: np.abs(rng.normal(1.0, 0.1, s)).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _forward(mx, sym, args, auxs, x):
    kw = {"ctx": CPU} if mx is tmx else {}
    exe = sym.simple_bind(ctx=CPU if mx is tmx else mx.cpu(),
                          grad_req="null", data=x.shape)
    exe.copy_params_from({k: mx.nd.array(v, **kw) if isinstance(
        v, np.ndarray) else v for k, v in args.items()},
        {k: mx.nd.array(v, **kw) if isinstance(v, np.ndarray) else v
         for k, v in auxs.items()}, allow_extra_params=True)
    return exe.forward(is_train=False, data=mx.nd.array(x, **kw))[0] \
        .asnumpy()


def _export(mx, onnx, build, values, shape, path):
    def run():
        sym = build(mx)
        kw = {"ctx": CPU} if mx is tmx else {}
        params = {k: mx.nd.array(v, **kw) for k, v in values.items()}
        onnx.export_model(sym, params, in_shapes=[shape],
                          onnx_file_path=str(path))
        return sym
    return _fresh(run)


_GRAPHS = {"convnet": (_convnet, (2, 3, 8, 8)),
           "mlp_and_ops": (_mlp_and_ops, (4, 6)),
           "every_op": (_every_op, (2, 3, 8, 8))}


def _values(name):
    build, shape = _GRAPHS[name]
    sym = _fresh(lambda: build(tmx))
    args, auxs = _params(sym, shape)
    return {**args, **auxs}, shape


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_export_bytes_equal_jax(tmp_path, name):
    """The port's file is the JAX exporter's, byte for byte, once the
    producer's name is the same; the JAX bindings parse it."""
    values, shape = _values(name)
    build = _GRAPHS[name][0]
    _export(jmx, jonnx, build, values, shape, tmp_path / "j.onnx")
    _export(tmx, tonnx, build, values, shape, tmp_path / "t.onnx")
    jbytes = (tmp_path / "j.onnx").read_bytes()
    tbytes = (tmp_path / "t.onnx").read_bytes()
    m = PB.ModelProto()
    m.ParseFromString(tbytes)
    assert m.producer_name == "incubator_mxnet_tpu_torch"
    assert m.ir_version == 8 and m.opset_import[0].version == 13
    m.producer_name = "incubator_mxnet_tpu"
    assert m.SerializeToString() == jbytes


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_port_imports_jax_files(tmp_path, name):
    """A file the JAX exporter wrote, imported by the port: the same
    parameters, and a forward equal to the original graph's in the JAX
    package; the JAX importer's own graph gives the same."""
    values, shape = _values(name)
    build = _GRAPHS[name][0]
    jsym = _export(jmx, jonnx, build, values, shape, tmp_path / "j.onnx")
    x = np.random.RandomState(1).normal(0, 1, shape).astype(np.float32)
    args = {k: v for k, v in values.items() if k in jsym.list_arguments()}
    auxs = {k: v for k, v in values.items() if k not in args}
    ref = _forward(jmx, jsym, args, auxs, x)
    sym, targs, tauxs = _fresh(lambda: tonnx.import_model(
        str(tmp_path / "j.onnx")))
    assert set(tauxs) == set(auxs)
    for k, v in {**targs, **tauxs}.items():
        if k in values:
            np.testing.assert_array_equal(v.asnumpy(), values[k])
        assert v.context == CPU
    _close(_forward(tmx, sym, targs, tauxs, x), ref, what=name)
    jsym2, jargs2, jauxs2 = _fresh(lambda: jonnx.import_model(
        str(tmp_path / "j.onnx")))
    _close(_forward(jmx, jsym2, jargs2, jauxs2, x), ref, what=name)


def test_roundtrip_convnet(tmp_path):
    """`tests/test_onnx.py::test_roundtrip_convnet` in the port."""
    values, shape = _values("convnet")
    sym = _export(tmx, tonnx, _convnet, values, shape, tmp_path / "m.onnx")
    x = np.random.RandomState(1).normal(0, 1, shape).astype(np.float32)
    args = {k: v for k, v in values.items() if k in sym.list_arguments()}
    auxs = {k: v for k, v in values.items() if k not in args}
    ref = _forward(tmx, sym, args, auxs, x)
    sym2, args2, auxs2 = tonnx.import_model(str(tmp_path / "m.onnx"))
    np.testing.assert_allclose(_forward(tmx, sym2, args2, auxs2, x), ref,
                               rtol=1e-4, atol=1e-5)


def test_roundtrip_mlp_and_ops(tmp_path):
    """`tests/test_onnx.py::test_roundtrip_mlp_and_ops` in the port."""
    values, shape = _values("mlp_and_ops")
    sym = _export(tmx, tonnx, _mlp_and_ops, values, shape,
                  tmp_path / "mlp.onnx")
    x = np.random.RandomState(2).normal(0, 1, shape).astype(np.float32)
    ref = _forward(tmx, sym, values, {}, x)
    sym2, args2, auxs2 = tonnx.import_model(str(tmp_path / "mlp.onnx"))
    np.testing.assert_allclose(_forward(tmx, sym2, args2, auxs2, x), ref,
                               rtol=1e-4, atol=1e-5)


def test_roundtrip_every_op_and_embedding(tmp_path):
    """Every op the exporter maps, and an Embedding (Gather), round trip
    through the port's file to the same forward."""
    values, shape = _values("every_op")
    sym = _export(tmx, tonnx, _every_op, values, shape, tmp_path / "e.onnx")
    x = np.random.RandomState(3).normal(0, 1, shape).astype(np.float32)
    args = {k: v for k, v in values.items() if k in sym.list_arguments()}
    auxs = {k: v for k, v in values.items() if k not in args}
    ref = _forward(tmx, sym, args, auxs, x)
    sym2, args2, auxs2 = tonnx.import_model(str(tmp_path / "e.onnx"))
    _close(_forward(tmx, sym2, args2, auxs2, x), ref)

    emb = tmx.sym.Embedding(tmx.sym.Variable("data"), input_dim=9,
                            output_dim=3, name="emb")
    table = np.random.RandomState(4).randn(9, 3).astype(np.float32)
    tonnx.export_model(emb, {"emb_weight": tmx.nd.array(table, ctx=CPU)},
                       in_shapes=[(2, 4)], onnx_file_path=str(
                           tmp_path / "g.onnx"))
    sym3, args3, _ = tonnx.import_model(str(tmp_path / "g.onnx"))
    ids = np.array([[0, 8, 3, 3], [1, 2, 7, 5]], np.float32)
    exe = sym3.simple_bind(ctx=CPU, grad_req="null", data=ids.shape)
    exe.copy_params_from(args3, {})
    got = exe.forward(is_train=False, data=tmx.nd.array(ids, ctx=CPU))[0]
    np.testing.assert_array_equal(got.asnumpy(), table[ids.astype(int)])


def _pb_case(kind):
    """The same message built with protobuf's classes and the port's."""
    if kind == "attributes":
        pb, mine = PB.NodeProto(), _wire.NodeProto()
        pb.input.extend(["a", "b"])
        pb.output.append("o")
        pb.name, pb.op_type, pb.domain = "n", "Op", "ai.x"
        mine.input, mine.output = ["a", "b"], ["o"]
        mine.name, mine.op_type, mine.domain = "n", "Op", "ai.x"
        for name, typ, value in (("i0", 2, 0), ("neg", 2, -5),
                                 ("big", 2, 2 ** 40), ("f", 1, 0.1),
                                 ("z", 1, 0.0), ("s", 3, b"text"),
                                 ("ints", 7, [1, -2, 0, 300]),
                                 ("fl", 6, [0.5, -1.25, 3.0])):
            a = pb.attribute.add()
            a.name, a.type = name, typ
            field = {2: "i", 1: "f", 3: "s", 7: "ints", 6: "floats"}[typ]
            if typ in (6, 7):
                getattr(a, field).extend(value)
            else:
                setattr(a, field, value)
            mine.attribute.append(_wire.AttributeProto(
                name=name, type=typ, **{field: value}))
        return pb, mine
    pb, mine = PB.ModelProto(), _wire.ModelProto()
    pb.ir_version, pb.model_version, pb.doc_string = 8, -3, "doc"
    mine.ir_version, mine.model_version, mine.doc_string = 8, -3, "doc"
    t = pb.graph.initializer.add()
    t.name, t.data_type = "t", 7
    t.dims.extend([2, 0, 3])
    t.int64_data.extend([-1, 2 ** 33])
    t.float_data.extend([1.5])
    t.double_data.extend([2.5, -0.0])
    t.int32_data.extend([-7])
    t.uint64_data.extend([2 ** 63])
    vi = pb.graph.input.add()
    vi.name = "x"
    vi.type.tensor_type.elem_type = 1
    vi.type.tensor_type.shape.dim.add().dim_value = 0
    vi.type.tensor_type.shape.dim.add().dim_param = "batch"
    pb.graph.output.add().name = "y"
    op = pb.opset_import.add()
    op.version = 13
    mine.graph = _wire.GraphProto(
        initializer=[_wire.TensorProto(
            name="t", data_type=7, dims=[2, 0, 3], int64_data=[-1, 2 ** 33],
            float_data=[1.5], double_data=[2.5, -0.0], int32_data=[-7],
            uint64_data=[2 ** 63])],
        input=[_wire.ValueInfoProto(name="x", type=_wire.TypeProto(
            tensor_type=_wire.TypeProtoTensor(
                elem_type=1, shape=_wire.TensorShapeProto(dim=[
                    _wire.Dimension(dim_value=0),
                    _wire.Dimension(dim_param="batch")]))))],
        output=[_wire.ValueInfoProto(name="y")])
    mine.opset_import = [_wire.OperatorSetIdProto(version=13)]
    return pb, mine


@pytest.mark.parametrize("kind", ["attributes", "model"])
def test_wire_codec_matches_protobuf(kind):
    """The port's encoder writes protobuf's bytes for the same message
    (negative and 64-bit varints, packed runs, defaults left out, an
    empty submessage and a oneof of 0 written), and its decoder reads
    them back, packed or not."""
    pb, mine = _pb_case(kind)
    data = pb.SerializeToString()
    assert _wire.encode(mine) == data
    back = _wire.decode(type(mine).__name__, data)
    assert _wire.encode(back) == data
    if kind == "model":
        t = back.graph.initializer[0]
        assert t.int64_data == [-1, 2 ** 33] and t.uint64_data == [2 ** 63]
        assert back.model_version == -3
        dims = back.graph.input[0].type.tensor_type.shape.dim
        assert dims[0].dim_value == 0 and dims[1].dim_param == "batch"
        # the same field unpacked, as an older writer may send it
        unpacked = b"".join(b"\x08" + _wire._varint(d) for d in (2, 0, 3))
        tp = _wire.decode("TensorProto", unpacked)
        assert tp.dims == [2, 0, 3]


def test_no_protobuf_on_the_port_path(tmp_path):
    """An export and an import in a fresh process load neither
    `google.protobuf` nor the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch.contrib import onnx\n"
        "s = mx.sym.FullyConnected(mx.sym.Variable('data'), num_hidden=3,"
        " name='fc')\n"
        "p = {'fc_weight': mx.nd.array(np.ones((3, 4)), ctx=mx.cpu()),"
        " 'fc_bias': mx.nd.zeros((3,), ctx=mx.cpu())}\n"
        f"path = {str(tmp_path / 'x.onnx')!r}\n"
        "onnx.export_model(s, p, in_shapes=[(2, 4)], onnx_file_path=path)\n"
        "onnx.import_model(path)\n"
        "bad = [m for m in sys.modules if m.startswith('google.protobuf')"
        " or m == 'jax' or m.startswith('incubator_mxnet_tpu.')]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _classifier(mx):
    x = mx.sym.Flatten(mx.sym.Variable("data"), name="flat")
    h = mx.sym.FullyConnected(x, num_hidden=16, name="fc6")
    h = mx.sym.Activation(h, act_type="relu", name="relu6")
    return mx.sym.FullyConnected(h, num_hidden=4, name="fc8")


def test_imported_gemm_relu_runs_k1(tmp_path, monkeypatch):
    """An exported FC -> ReLU comes back Gemm -> Relu; the port imports
    the Gemm as FullyConnected(flatten=True), so TPU_PALLAS fuses it into
    K1 (here its plain version, once a forward); the JAX importer's
    flatten=False Gemm is left unfused by the JAX partitioner (ROADMAP
    Queue 3)."""
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    sym = _fresh(lambda: _classifier(tmx))
    args, _ = _params(sym, (3, 2, 4, 4), seed=5)
    _export(tmx, tonnx, _classifier, args, (3, 2, 4, 4), tmp_path / "c.onnx")
    tsym, targs, _ = _fresh(lambda: tonnx.import_model(
        str(tmp_path / "c.onnx")))
    part = tmx.subgraph.partition_graph(tsym, "TPU_PALLAS")
    assert [n["op"] for n in json.loads(part.tojson())["nodes"]].count(
        "_sg_pallas_fc_relu") == 1
    jsym, _, _ = _fresh(lambda: jonnx.import_model(str(tmp_path /
                                                       "c.onnx")))
    jpart = jmx.subgraph.partition_graph(jsym, "TPU_PALLAS")
    assert "_sg_pallas_fc_relu" not in jpart.tojson()
    calls = []
    ref = fused_ops.fc_relu_ref

    def counting(xx, w, b):
        if xx.device.type != "meta":
            calls.append(tuple(w.shape))
        return ref(xx, w, b)
    monkeypatch.setattr(fused_ops, "fc_relu_ref", counting)
    x = np.random.RandomState(6).normal(0, 1, (3, 2, 4, 4)).astype(
        np.float32)
    want = _forward(tmx, sym, args, {}, x)
    assert calls == []
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    got = _forward(tmx, tsym, targs, {}, x)
    assert calls == [(16, 32)]
    _close(got, want)


def _gluon_named_distinct(mx):
    """Three ops sharing the name gluon gives every traced op, over
    weights of their own names (as gluon's are)."""
    x = mx.sym.FullyConnected(mx.sym.Variable("data"),
                              mx.sym.Variable("a_weight"),
                              mx.sym.Variable("a_bias"), num_hidden=5,
                              name="fwd")
    x = mx.sym.Activation(x, act_type="tanh", name="fwd")
    return mx.sym.FullyConnected(x, mx.sym.Variable("b_weight"),
                                 mx.sym.Variable("b_bias"), num_hidden=3,
                                 name="fwd")


def test_export_of_nodes_sharing_a_name(tmp_path):
    """Nodes that share a name (a composed gluon net's ``fwd``): the
    port's file gives each its own output and round trips; the JAX
    exporter writes one output name three times, and the imported graph
    computes another function (ROADMAP Queue 3)."""
    rng = np.random.RandomState(7)
    sym = _fresh(lambda: _gluon_named_distinct(tmx))
    jsym = _fresh(lambda: _gluon_named_distinct(jmx))
    args = {"a_weight": rng.randn(5, 4).astype(np.float32),
            "a_bias": rng.randn(5).astype(np.float32),
            "b_weight": rng.randn(3, 5).astype(np.float32),
            "b_bias": rng.randn(3).astype(np.float32)}
    x = rng.randn(2, 4).astype(np.float32)
    ref = _forward(tmx, sym, args, {}, x)
    tonnx.export_model(sym, {k: tmx.nd.array(v, ctx=CPU)
                             for k, v in args.items()}, in_shapes=[x.shape],
                       onnx_file_path=str(tmp_path / "t.onnx"))
    jonnx.export_model(jsym, {k: jmx.nd.array(v) for k, v in args.items()},
                       in_shapes=[x.shape],
                       onnx_file_path=str(tmp_path / "j.onnx"))
    m = PB.ModelProto()
    m.ParseFromString((tmp_path / "t.onnx").read_bytes())
    outs = [o for n in m.graph.node for o in n.output]
    assert len(set(outs)) == len(outs)
    sym2, args2, _ = tonnx.import_model(str(tmp_path / "t.onnx"))
    _close(_forward(tmx, sym2, args2, {}, x), ref)
    m.ParseFromString((tmp_path / "j.onnx").read_bytes())
    jouts = [o for n in m.graph.node for o in n.output]
    assert jouts.count("fwd_out") == 3
