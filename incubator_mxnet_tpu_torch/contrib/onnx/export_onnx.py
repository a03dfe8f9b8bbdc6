"""Symbol -> ONNX exporter (reference
`python/mxnet/contrib/onnx/mx2onnx/export_model.py`).

PyTorch port of `incubator_mxnet_tpu/contrib/onnx/export_onnx.py`: the
same op table, node names, initializers and opset (13), so the file's
bytes equal the JAX exporter's but for ``producer_name``.  The messages
are the port's own (`_wire`); an initializer's ``raw_data`` is a view of
the parameter's host copy, joined into the file's bytes once.

One divergence: a node whose name an earlier node took (a composed
gluon net names every op ``fwd``) gets a numbered name, so each ONNX
output is written once; the JAX exporter gives them one output name, and
its file wires every consumer to the last of them.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from . import _wire as OP

_DT = {np.dtype("float32"): 1, np.dtype("uint8"): 2, np.dtype("int8"): 3,
       np.dtype("int32"): 6, np.dtype("int64"): 7, np.dtype("bool"): 9,
       np.dtype("float16"): 10, np.dtype("float64"): 11}

OPSET = 13
PRODUCER = "incubator_mxnet_tpu_torch"


def _tensor(name, arr):
    arr = np.ascontiguousarray(arr)
    return OP.TensorProto(name=name, dims=list(arr.shape),
                          data_type=_DT[arr.dtype], raw_data=memoryview(arr))


def _attr(name, value):
    a = OP.AttributeProto(name=name)
    if isinstance(value, bool):
        a.type, a.i = OP.INT, int(value)
    elif isinstance(value, int):
        a.type, a.i = OP.INT, value
    elif isinstance(value, float):
        a.type, a.f = OP.FLOAT, value
    elif isinstance(value, str):
        a.type, a.s = OP.STRING, value.encode()
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            a.type, a.floats = OP.FLOATS, list(value)
        else:
            a.type, a.ints = OP.INTS, [int(v) for v in value]
    else:
        raise MXNetError(f"onnx export: bad attribute {name}={value!r}")
    return a


def _pair(p, key, default):
    v = p.get(key) or default
    v = (v, v) if isinstance(v, int) else tuple(v)
    return v if v else default


def _value_info(name, elem_type, dims=()):
    tensor = OP.TypeProtoTensor(elem_type=elem_type)
    if dims:
        tensor.shape = OP.TensorShapeProto(
            dim=[OP.Dimension(dim_value=int(d)) for d in dims])
    return OP.ValueInfoProto(name=name, type=OP.TypeProto(tensor_type=tensor))


class _Exporter:
    def __init__(self, sym, params, in_shapes, in_types, graph_name):
        self.sym = sym
        self.params = params
        self.nodes = []
        self.initializers = []
        self.inputs = []
        self.counter = 0
        self.used = set()
        self.graph_name = graph_name
        self.in_shapes = in_shapes
        self.in_types = in_types

    def _name(self, base):
        self.counter += 1
        return f"{base}_{self.counter}"

    def node(self, op_type, inputs, outputs=None, name=None, **attrs):
        name = name or self._name(op_type.lower())
        if name in self.used:
            # a name two MXNet nodes share (gluon names every traced op
            # "fwd") would give two ONNX nodes one output
            name = self._name(name)
        self.used.add(name)
        n = OP.NodeProto(op_type=op_type, name=name, input=list(inputs))
        n.output = list(outputs or [n.name + "_out"])
        n.attribute = [_attr(k, v) for k, v in attrs.items()
                       if v is not None]
        self.nodes.append(n)
        return n.output[0]

    def add_initializer(self, name, arr):
        self.initializers.append(_tensor(name, np.asarray(arr)))

    def const_i64(self, values):
        name = self._name("const")
        self.add_initializer(name, np.asarray(values, np.int64))
        return name

    # -- op translators ------------------------------------------------------
    def convert(self, node, in_names):
        op = node.op.name
        p = node.attrs
        nm = node.name

        if op == "Convolution":
            pad = _pair(p, "pad", (0, 0))
            return self.node(
                "Conv", in_names, name=nm,
                kernel_shape=_pair(p, "kernel", (1, 1)),
                strides=_pair(p, "stride", (1, 1)),
                pads=list(pad) + list(pad),
                dilations=_pair(p, "dilate", (1, 1)),
                group=int(p.get("num_group", 1)))
        if op == "FullyConnected":
            data = in_names[0]
            if p.get("flatten", True):
                data = self.node("Flatten", [data], axis=1)
            return self.node("Gemm", [data] + list(in_names[1:3]), name=nm,
                             alpha=1.0, beta=1.0, transB=1)
        if op == "Activation":
            table = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
                     "softrelu": "Softplus", "softsign": "Softsign"}
            act = table.get(p["act_type"])
            if act is None:
                raise MXNetError(f"onnx export: Activation act_type="
                                 f"{p['act_type']!r} not yet mapped")
            return self.node(act, in_names, name=nm)
        if op == "LeakyReLU":
            return self.node("LeakyRelu", in_names, name=nm,
                             alpha=float(p.get("slope", 0.25)))
        if op == "Pooling":
            ptype = p.get("pool_type", "max")
            if ptype not in ("max", "avg"):
                raise MXNetError(f"onnx export: pool_type={ptype!r} has no "
                                 "ONNX counterpart (only max/avg)")
            if p.get("global_pool"):
                return self.node("GlobalMaxPool" if ptype == "max"
                                 else "GlobalAveragePool", in_names, name=nm)
            pad = _pair(p, "pad", (0, 0))
            return self.node(
                "MaxPool" if ptype == "max" else "AveragePool", in_names,
                name=nm, kernel_shape=_pair(p, "kernel", (1, 1)),
                strides=_pair(p, "stride", (1, 1)),
                pads=list(pad) + list(pad))
        if op in ("BatchNorm", "BatchNorm_v1"):
            return self.node("BatchNormalization", in_names, name=nm,
                             epsilon=float(p.get("eps", 1e-5)),
                             momentum=float(p.get("momentum", 0.9)))
        if op == "Flatten":
            return self.node("Flatten", in_names, name=nm, axis=1)
        if op == "Reshape":
            shape = [int(d) for d in p["shape"]]
            if any(d < -1 for d in shape):
                # MXNet's -2/-3/-4 split/merge codes have no ONNX meaning
                raise MXNetError(
                    f"onnx export: Reshape shape {tuple(shape)} uses MXNet "
                    "special codes (<-1) that ONNX Reshape cannot express")
            # 0 = copy-dim in both conventions (ONNX allowzero=0 default)
            return self.node("Reshape",
                             [in_names[0], self.const_i64(shape)], name=nm)
        if op == "transpose":
            return self.node("Transpose", in_names, name=nm,
                             perm=list(p["axes"]))
        if op in ("concat", "Concat"):
            return self.node("Concat", in_names, name=nm,
                             axis=int(p.get("dim", 1)))
        if op in ("elemwise_add", "broadcast_add", "_plus"):
            return self.node("Add", in_names, name=nm)
        if op in ("elemwise_sub", "broadcast_sub"):
            return self.node("Sub", in_names, name=nm)
        if op in ("elemwise_mul", "broadcast_mul"):
            return self.node("Mul", in_names, name=nm)
        if op in ("elemwise_div", "broadcast_div"):
            return self.node("Div", in_names, name=nm)
        if op == "dot":
            return self.node("MatMul", in_names, name=nm)
        if op in ("softmax", "SoftmaxActivation"):
            return self.node("Softmax", in_names, name=nm,
                             axis=int(p.get("axis", -1)))
        if op == "SoftmaxOutput":
            # inference semantics: plain softmax over the class axis
            return self.node("Softmax", in_names[:1], name=nm, axis=1)
        if op == "Dropout":
            # opset 13 takes ratio as an optional input tensor
            ratio = self._name("dropout_ratio")
            self.add_initializer(ratio, np.float32(p.get("p", 0.5)))
            return self.node("Dropout", [in_names[0], ratio], name=nm)
        if op == "Embedding":
            # onnx Gather(weight, indices)
            return self.node("Gather", [in_names[1], in_names[0]], name=nm,
                             axis=0)
        raise MXNetError(f"onnx export: operator {op} not yet mapped "
                         "(extend mx2onnx op table)")

    def run(self):
        memo = {}
        for node in self.sym._topo():
            if node.is_variable:
                if node.name in self.params:
                    self.add_initializer(node.name,
                                         self.params[node.name].asnumpy())
                else:
                    self.inputs.append(_value_info(
                        node.name,
                        _DT[np.dtype(self.in_types.get(node.name,
                                                       "float32"))],
                        self.in_shapes.get(node.name, ())))
                memo[id(node)] = [node.name]
                continue
            ins = []
            for src, idx in node.inputs:
                outs = memo[id(src)]
                if idx >= len(outs):
                    raise MXNetError(
                        f"onnx export: {src.name} output {idx} is consumed "
                        "but only its first output is exported (multi-"
                        "output ops are not yet mapped)")
                ins.append(outs[idx])
            memo[id(node)] = [self.convert(node, ins)]

        outputs = []
        for node, idx in self.sym._entries:
            outs = memo[id(node)]
            if idx >= len(outs):
                raise MXNetError(
                    f"onnx export: graph output {node.name}[{idx}] refers "
                    "to an unexported secondary output")
            outputs.append(_value_info(outs[idx], 1))
        graph = OP.GraphProto(name=self.graph_name, node=self.nodes,
                              initializer=self.initializers,
                              input=self.inputs, output=outputs)
        return OP.ModelProto(
            ir_version=8, producer_name=PRODUCER, graph=graph,
            opset_import=[OP.OperatorSetIdProto(domain="", version=OPSET)])


def export_model(sym, params, in_shapes=None, in_types=None,
                 onnx_file_path="model.onnx", verbose=False, **kwargs):
    """Reference `mx2onnx/export_model.py:export_model` surface.

    sym: Symbol (or path to -symbol.json); params: dict (or .params path);
    returns the path written.
    """
    from ... import symbol as _sym
    from ...ndarray import utils as _nd_utils
    if isinstance(sym, str):
        sym = _sym.load(sym)
    if isinstance(params, str):
        params = _nd_utils.load(params)
        params = {k.split(":", 1)[-1]: v for k, v in params.items()}
    shapes = {}
    types = {}
    data_names = [n for n in sym.list_arguments() if n not in params]
    if in_shapes is not None:
        for name, s in zip(data_names, in_shapes):
            shapes[name] = tuple(s)
    if in_types is not None:
        for name, t in zip(data_names, in_types):
            types[name] = np.dtype(t).name
    # the graph keeps the reference schema's name, so the bytes equal the
    # JAX exporter's but for the producer
    model = _Exporter(sym, params, shapes, types,
                      "incubator_mxnet_tpu").run()
    with open(onnx_file_path, "wb") as f:
        f.write(OP.encode(model))
    return onnx_file_path
