"""Network visualization (reference `python/mxnet/visualization.py`):
`print_summary` and `plot_network` (graphviz-gated).

PyTorch port of `incubator_mxnet_tpu/visualization.py`, with one
difference: the JAX package prints 0 in the "Param #" column for every
layer (its `count_params` always returns 0 and its per-layer count is
never updated, `visualization.py:38-59`); the port prints each layer's
parameter count as the reference does (the product of the inferred
shape of every variable input that is not data or a label, so a
BatchNorm counts its moving statistics too), and the total below the
table (README, "Declared divergences of slice 22").
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a table of `symbol`'s layers: name (op), output shape (with
    `shape`, {input name: shape}), parameter count, previous layers
    (reference `visualization.py print_summary`)."""
    shape_dict = {}
    if shape is not None:
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        shape_dict.update(zip(symbol.list_arguments(), arg_shapes or ()))
        shape_dict.update(zip(symbol.list_auxiliary_states(),
                              aux_shapes or ()))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]

    def print_row(fields, positions_):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions_[i]]
            line += " " * (positions_[i] - len(line))
        print(line)

    positions = [int(line_length * p) for p in positions]
    print("_" * line_length)
    print_row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"],
              positions)
    print("=" * line_length)
    total_params = 0
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        out_shape = ""
        key = name + "_output"
        if shape is not None and key in shape_dict:
            out_shape = str(shape_dict[key])
        pre_nodes = [nodes[item[0]]["name"] for item in node["inputs"]
                     if nodes[item[0]]["op"] != "null"]
        # parameter count: the sizes of the variable inputs
        params = 0
        for item in node["inputs"]:
            src = nodes[item[0]]
            if src["op"] == "null" and not src["name"].endswith(
                    ("data", "label")) and shape_dict.get(src["name"]):
                params += int(np.prod(shape_dict[src["name"]]))
        total_params += params
        print_row([f"{name}({op})", out_shape, params,
                   ",".join(pre_nodes)], positions)
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Reference `visualization.py plot_network` — requires graphviz."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library") from None
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    hidden = set()
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            if hide_weights and not name.endswith("data"):
                hidden.add(i)
                continue
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label=f"{name}\n{op}", shape="box")
    for i, node in enumerate(nodes):
        if node["op"] == "null" or i in hidden:
            continue
        for item in node["inputs"]:
            if item[0] in hidden:
                continue
            dot.edge(nodes[item[0]]["name"], node["name"])
    return dot
