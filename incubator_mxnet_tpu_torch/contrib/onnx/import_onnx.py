"""ONNX -> Symbol importer (reference
`python/mxnet/contrib/onnx/onnx2mx/import_model.py`).

PyTorch port of `incubator_mxnet_tpu/contrib/onnx/import_onnx.py`, with
its op table, read through the port's own codec (`_wire`).  One
divergence: a ``Gemm`` becomes ``FullyConnected(flatten=True)``, where
the JAX importer writes ``flatten=False``.  ONNX's Gemm takes 2-D
operands only, for which the two are the same function, and only the
first lets the ``TPU_PALLAS`` backend fuse an imported Gemm -> Relu into
K1.  The parameters land on the CPU, as `nd.load`'s do.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from . import _wire as OP

_NP = {1: "float32", 2: "uint8", 3: "int8", 6: "int32", 7: "int64",
       9: "bool", 10: "float16", 11: "float64"}


def _to_numpy(t):
    dt = np.dtype(_NP[t.data_type])
    if len(t.raw_data):
        arr = np.frombuffer(t.raw_data, dtype=dt)
    elif t.float_data:
        arr = np.asarray(t.float_data, np.float32).astype(dt)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, np.int64).astype(dt)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, np.int32).astype(dt)
    elif t.double_data:
        arr = np.asarray(t.double_data, np.float64).astype(dt)
    else:
        arr = np.zeros(0, dt)
    return arr.reshape(tuple(t.dims))


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == OP.INT:
            out[a.name] = int(a.i)
        elif a.type == OP.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == OP.STRING:
            out[a.name] = bytes(a.s).decode()
        elif a.type == OP.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == OP.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
        elif a.type == OP.TENSOR:
            out[a.name] = _to_numpy(a.t)
    return out


def _pads2(a, default=(0, 0)):
    pads = a.get("pads")
    if not pads:
        return default
    # onnx pads: [x1b, x2b, x1e, x2e] — symmetric only (our conv surface)
    half = len(pads) // 2
    begin, end = pads[:half], pads[half:]
    if list(begin) != list(end):
        raise MXNetError("onnx import: asymmetric pads unsupported")
    return tuple(int(v) for v in begin)


def import_model(model_file):
    """Returns (sym, arg_params, aux_params), the parameters on the CPU
    (reference `onnx2mx/import_model.py:import_model`)."""
    from ... import symbol as sym_mod
    from ...context import cpu
    from ...ndarray.ndarray import array
    from ...symbol.symbol import Symbol, _sym_apply

    with open(model_file, "rb") as f:
        model = OP.decode("ModelProto", f.read())
    g = model.graph

    params = {}
    for t in g.initializer:
        params[t.name] = _to_numpy(t)

    env = {}
    for vi in g.input:
        if vi.name not in params:
            env[vi.name] = sym_mod.Variable(vi.name)
    for name in params:
        env[name] = sym_mod.Variable(name)

    aux_names = set()

    def one(s):
        return s[0] if len(s._entries) > 1 else s

    for node in g.node:
        op = node.op_type
        a = _attrs(node)
        ins = [env[i] for i in node.input if i]
        if op in ("Conv", "Gemm", "Gather") and len(node.input) > 1 \
                and node.input[1 if op != "Gather" else 0] not in params:
            raise MXNetError(
                f"onnx import: {op} weight {node.input[1]!r} is a graph "
                "input, not an initializer — externally-fed weights are "
                "not yet supported")
        if op == "Conv":
            out = _sym_apply("Convolution", ins, {
                "kernel": tuple(a.get("kernel_shape", (1, 1))),
                "stride": tuple(a.get("strides", (1, 1))),
                "pad": _pads2(a),
                "dilate": tuple(a.get("dilations", (1, 1))),
                "num_group": a.get("group", 1),
                "num_filter": int(params[node.input[1]].shape[0]),
                "no_bias": len(ins) < 3})
        elif op == "Gemm":
            if a.get("transB", 0) != 1 or a.get("alpha", 1.0) != 1.0 \
                    or a.get("beta", 1.0) != 1.0:
                raise MXNetError("onnx import: general Gemm (alpha/beta/"
                                 "transB beyond FC semantics) unsupported")
            out = _sym_apply("FullyConnected", ins, {
                "num_hidden": int(params[node.input[1]].shape[0]),
                "no_bias": len(ins) < 3, "flatten": True})
        elif op == "MatMul":
            out = _sym_apply("dot", ins, {})
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
            act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
                   "Softplus": "softrelu", "Softsign": "softsign"}[op]
            out = _sym_apply("Activation", ins, {"act_type": act})
        elif op == "LeakyRelu":
            out = _sym_apply("LeakyReLU", ins,
                             {"slope": a.get("alpha", 0.01)})
        elif op in ("MaxPool", "AveragePool"):
            out = _sym_apply("Pooling", ins, {
                "kernel": tuple(a.get("kernel_shape", (1, 1))),
                "stride": tuple(a.get("strides", (1, 1))),
                "pad": _pads2(a),
                "pool_type": "max" if op == "MaxPool" else "avg"})
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            out = _sym_apply("Pooling", ins, {
                "kernel": (1, 1), "global_pool": True,
                "pool_type": "max" if op == "GlobalMaxPool" else "avg"})
        elif op == "BatchNormalization":
            out = _sym_apply("BatchNorm", ins, {
                "eps": a.get("epsilon", 1e-5),
                "momentum": a.get("momentum", 0.9),
                "fix_gamma": False, "use_global_stats": True})
            aux_names.update(node.input[3:5])
        elif op == "Flatten":
            out = _sym_apply("Flatten", ins[:1], {})
        elif op == "Reshape":
            shape = params.get(node.input[1])
            if shape is None:
                raise MXNetError("onnx import: dynamic Reshape unsupported")
            out = _sym_apply("Reshape", ins[:1],
                             {"shape": tuple(int(d) for d in shape)})
            params.pop(node.input[1], None)
        elif op == "Transpose":
            out = _sym_apply("transpose", ins, {"axes": tuple(a["perm"])})
        elif op == "Concat":
            out = _sym_apply("Concat", ins,
                             {"dim": a.get("axis", 1),
                              "num_args": len(ins)})
        elif op in ("Add", "Sub", "Mul", "Div"):
            name = {"Add": "broadcast_add", "Sub": "broadcast_sub",
                    "Mul": "broadcast_mul", "Div": "broadcast_div"}[op]
            out = _sym_apply(name, ins, {})
        elif op == "Softmax":
            out = _sym_apply("softmax", ins, {"axis": a.get("axis", -1)})
        elif op == "Dropout":
            kw = {}
            if len(node.input) > 1 and node.input[1] in params:
                kw["p"] = float(params.pop(node.input[1]).reshape(-1)[0])
            out = _sym_apply("Dropout", ins[:1], kw)
        elif op == "Gather":
            if a.get("axis", 0) != 0:
                raise MXNetError("onnx import: Gather axis != 0")
            weight = params.get(node.input[0])
            out = _sym_apply("Embedding", [ins[1], ins[0]], {
                "input_dim": int(weight.shape[0]),
                "output_dim": int(weight.shape[1])})
        else:
            raise MXNetError(f"onnx import: operator {op} not yet mapped")
        outs = [out[i] for i in range(len(node.output))] \
            if len(node.output) > 1 else [out]
        for name, o in zip(node.output, outs):
            env[name] = one(o)

    entries = []
    for vi in g.output:
        entries.extend(env[vi.name]._entries)
    sym = Symbol(entries)

    arg_params, aux_params = {}, {}
    for name, arr in params.items():
        nd = array(arr, ctx=cpu(), dtype=arr.dtype)
        if name in aux_names:
            aux_params[name] = nd
        else:
            arg_params[name] = nd
    return sym, arg_params, aux_params
