"""Symbol: the symbolic graph API.

PyTorch port of `incubator_mxnet_tpu/symbol/symbol.py`.  A Symbol is a
DAG of op nodes over variable leaves; composition is bookkeeping only.
Graph JSON (`tojson`/`load`) keeps the reference schema — nodes with
{op, name, attrs, inputs}, arg_nodes, heads — and the JAX package's node
order, so a graph saved by either package loads in the other.

Divergences from the JAX package, both deliberate:

* `graph_eval_fn` is an eager interpreter over the topological order.
  The JAX package builds a function for XLA to compile and therefore
  carries a scan-over-layers plan and an NHWC layout pass
  (`ops/layout.py`); both exist only for XLA and have no counterpart
  here.  The interpreter frees each intermediate after its last use.
* `infer_shape` evaluates the ops on ``meta`` tensors (no data, no
  device), and reads a ``__shape__`` attribute whether it is a tuple or
  the string a loaded JSON carries.
"""
from __future__ import annotations

import json
import re
import threading

import torch

from ..base import MXNetError, py_literal
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "graph_eval_fn"]


class _NameManager:
    _tls = threading.local()

    @classmethod
    def next_name(cls, hint):
        if not hasattr(cls._tls, "counts"):
            cls._tls.counts = {}
        c = cls._tls.counts.get(hint, 0)
        cls._tls.counts[hint] = c + 1
        return f"{hint}{c}"


class _Node:
    """One graph node: an op application or a variable leaf."""

    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op              # OpDef or None for variables
        self.name = name
        self.attrs = attrs        # canonicalized op params
        self.inputs = inputs      # list[(Node, int out_index)]
        self._extra_attrs = {}    # user attrs (__shape__, __lr_mult__, ...)

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        if self.op is None:
            return 1
        return self.op.num_outputs(self.attrs)


class Symbol:
    """An output list over a graph (reference `Symbol`)."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)  # list[(Node, out_index)]

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        names = [n.name for n, _ in self._entries]
        return f"<Symbol {' '.join(names)}>"

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        for i in range(len(self._entries)):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            outs = self.list_outputs()
            if index in outs:
                return Symbol([self._entries[outs.index(index)]])
            raise MXNetError(f"Cannot find output {index}")
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __copy__(self):
        return Symbol(self._entries)

    # -- graph walks ---------------------------------------------------------
    def _topo(self):
        """Post-order topological node list (DFS input order — the
        reference's DFSVisit ordering used for argument lists)."""
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for src, _ in node.inputs:
                visit(src)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def _aux_node_ids(self):
        """Variable nodes feeding aux-state slots."""
        aux = set()
        for node in self._topo():
            if node.is_variable:
                continue
            naux = node.op.num_aux(node.attrs)
            if naux:
                for src, _ in node.inputs[-naux:]:
                    if src.is_variable:
                        aux.add(id(src))
        return aux

    def list_arguments(self):
        """Reference `symbol.py list_arguments` (excludes aux states)."""
        aux = self._aux_node_ids()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_node_ids()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) in aux]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.num_outputs() > 1:
                out.append(f"{node.name}_output{idx}")
            else:
                out.append(f"{node.name}_output")
        return out

    def get_internals(self):
        """All intermediate outputs as a grouped Symbol."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    def attr(self, key):
        if len(self._entries) == 1:
            return self._entries[0][0]._extra_attrs.get(key)
        return None

    # -- shape inference -----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input shapes
        (positional in `list_arguments` order, or by name)."""
        arg_names = self.list_arguments()
        shapes = {n: s for n, s in zip(arg_names, args) if s is not None}
        shapes.update({k: v for k, v in kwargs.items() if v is not None})
        known, out_shapes = _infer_graph(self, shapes)
        return ([known.get(n) for n in arg_names], out_shapes,
                [known.get(n) for n in self.list_auxiliary_states()])

    # -- composition ---------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Composition: replace variable leaves with other symbols."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        kwargs.pop("name", None)
        if args and kwargs:
            raise MXNetError("compose only accepts input Symbols "
                             "either as positional or keyword arguments, not both")
        mapping = {}
        if args:
            free_vars = [n for n in self._topo() if n.is_variable]
            if len(args) > len(free_vars):
                raise MXNetError("too many positional inputs to compose")
            for node, sym in zip(free_vars, args):
                mapping[id(node)] = sym._entries[0]
        for k, v in kwargs.items():
            for node in self._topo():
                if node.is_variable and node.name == k:
                    mapping[id(node)] = v._entries[0]
        if not mapping:
            return
        remap = {}

        def rebuild(node):
            if id(node) in remap:
                return remap[id(node)]
            if id(node) in mapping:
                src = mapping[id(node)][0]
            elif node.is_variable:
                src = node
            else:
                src = _Node(node.op, node.name, node.attrs,
                            [(rebuild(s), i) for s, i in node.inputs])
                src._extra_attrs = dict(node._extra_attrs)
            remap[id(node)] = src
            return src

        self._entries = [(rebuild(n), i) for n, i in self._entries]

    # -- serialization -------------------------------------------------------
    def tojson(self):
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "attrs": {k: str(v) for k, v in
                          (n.attrs.items() if n.op else
                           n._extra_attrs.items())},
                "inputs": [[nid[id(src)], idx, 0] for src, idx in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        heads = [[nid[id(n)], i, 0] for n, i in self._entries]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10200],
                                     "framework":
                                         ["str", "incubator_mxnet_tpu_torch"]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operator overloads --------------------------------------------------
    def __add__(self, other):
        return _sym_binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_binary(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _sym_binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _sym_binary(self, other, None, "_rdiv_scalar")

    def __hash__(self):
        return id(self)


def _sym_apply(op_name, inputs, kwargs):
    op = _reg.get(op_name)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    if name is not None and not str(name).strip():
        raise MXNetError(f"Operator {op_name}: node name must be a "
                         "non-empty string")
    params = op.canonicalize_params(kwargs)
    params.pop("ctx", None)
    if name is None:
        hint = re.sub("^_", "", op.name.lower())
        name = _NameManager.next_name(hint if hint.endswith("_")
                                      else hint + "_")
    entries = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise TypeError(f"Operator {op_name}: inputs must be Symbol, got "
                            f"{type(s).__name__}")
        if len(s._entries) != 1:
            raise MXNetError("cannot use a multi-output Symbol as an op input; "
                             "select one output first")
        entries.append(s._entries[0])
    # auto-create variables for missing trailing inputs (weights, biases):
    # the canonical `{name}_weight` / `{name}_bias` argument names
    slot_names = op.list_input_names(params)
    if slot_names is not None:
        for slot in slot_names[len(entries):]:
            entries.append((_Node(None, f"{name}_{slot}", {}, []), 0))
    node = _Node(op, name, params, entries)
    if attr:
        node._extra_attrs.update(attr)
    nout = node.num_outputs()
    return Symbol([(node, i) for i in range(nout)])


def _sym_binary(lhs, rhs, tensor_op, scalar_op):
    if isinstance(rhs, Symbol):
        if tensor_op is None:
            raise TypeError("unsupported operand")
        return _sym_apply(tensor_op, [lhs, rhs], {})
    if isinstance(rhs, (int, float, bool)):
        return _sym_apply(scalar_op, [lhs], {"scalar": float(rhs)})
    return NotImplemented


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a symbolic variable (reference `symbol.py Variable`)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    if not name.strip():
        raise MXNetError("variable name must be a non-empty string")
    node = _Node(None, name, {}, [])
    extra = {"__shape__": None if shape is None else tuple(shape),
             "__dtype__": dtype, "__lr_mult__": lr_mult,
             "__wd_mult__": wd_mult, "__init__": init}
    node._extra_attrs.update({k: v for k, v in extra.items()
                              if v is not None})
    if attr:
        node._extra_attrs.update(attr)
    node._extra_attrs.update(kwargs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output Symbol."""
    return Symbol([e for s in symbols for e in s._entries])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Rebuild a Symbol from graph JSON (reference `symbol.py load`,
    versioned loader `src/nnvm/legacy_json_util.cc`)."""
    from ..compat.legacy_json import upgrade_json
    g = upgrade_json(json_str)
    nodes = []
    for jn in g["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("param", {})))
        if jn["op"] == "null":
            node = _Node(None, jn["name"], {}, [])
            node._extra_attrs.update(attrs)
        else:
            op = _reg.get(jn["op"])
            params = op.canonicalize_params(attrs)
            params.pop("ctx", None)
            node = _Node(op, jn["name"], params,
                         [(nodes[i], oi) for i, oi, *_ in jn["inputs"]])
        nodes.append(node)
    heads = g.get("heads")
    if heads:
        entries = [(nodes[i], oi) for i, oi, *_ in heads]
    else:
        entries = [(nodes[-1], 0)]
    return Symbol(entries)


# ---------------------------------------------------------------------------
# Evaluation and shape inference
# ---------------------------------------------------------------------------

def graph_eval_fn(symbol, is_train):
    """An eager interpreter for `symbol`.

    Returns ``(fn, arg_nodes, aux_nodes)`` where
    ``fn(arg_values, aux_values, generator=None) -> (outputs, new_aux)``
    runs every op in topological order on the tensors it is given (values
    ordered like `arg_nodes` / `aux_nodes`).  ``generator`` feeds the ops
    that draw random numbers (Dropout in training)."""
    topo = symbol._topo()
    aux_ids = symbol._aux_node_ids()
    arg_nodes = [n for n in topo if n.is_variable and id(n) not in aux_ids]
    aux_nodes = [n for n in topo if n.is_variable and id(n) in aux_ids]
    ops = [n for n in topo if not n.is_variable]
    heads = {id(n) for n, _ in symbol._entries}
    # each op output is dropped after its last consumer has run
    uses = {}
    for node in ops:
        for src, _ in node.inputs:
            uses[id(src)] = uses.get(id(src), 0) + 1

    def fn(arg_values, aux_values, generator=None):
        env = {}
        for node, v in zip(arg_nodes, arg_values):
            env[id(node)] = (v,)
        new_aux = {}
        for node, v in zip(aux_nodes, aux_values):
            env[id(node)] = (v,)
            new_aux[id(node)] = v
        left = dict(uses)
        for node in ops:
            params = dict(node.attrs)
            if node.op.mode_dependent:
                params["_train"] = bool(is_train)
            ins = [env[id(src)][idx] for src, idx in node.inputs]
            if node.op.needs_rng:
                ins.append(generator)
            out = node.op.fn(params, *ins)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            nout = node.op.num_outputs(params)
            naux = node.op.num_aux(params)
            if naux and len(out) > nout:
                for (src, _), upd in zip(node.inputs[-naux:], out[nout:]):
                    if id(src) in new_aux:
                        new_aux[id(src)] = upd
            env[id(node)] = tuple(out[:nout])
            for src, _ in node.inputs:
                left[id(src)] -= 1
                if (left[id(src)] == 0 and not src.is_variable
                        and id(src) not in heads):
                    del env[id(src)]
        outputs = tuple(env[id(n)][i] for n, i in symbol._entries)
        return outputs, tuple(new_aux[id(n)] for n in aux_nodes)

    return fn, arg_nodes, aux_nodes


def _declared_shape(node):
    """A variable's ``__shape__`` attr as a tuple (it is a string once the
    graph went through JSON), or None."""
    shape = node._extra_attrs.get("__shape__")
    if shape is None:
        return None
    return tuple(int(d) for d in py_literal(shape))


def _infer_graph(symbol, shapes):
    """Shape inference by evaluating every op on meta tensors; parameter
    variables without a known shape are solved from their consumer's
    attrs (`_solve_param_shapes`).  Returns ({var name: shape}, [output
    shapes])."""
    env = {}

    def meta(shape):
        return torch.empty(tuple(shape), device="meta")

    with torch.no_grad():
        for node in symbol._topo():
            if node.is_variable:
                cand = shapes.get(node.name)
                if cand is None:
                    cand = _declared_shape(node)
                # dims of 0 are unknown (deferred init): solve them later
                if cand is not None and all(d > 0 for d in cand):
                    env[id(node)] = (meta(cand),)
                else:
                    env[id(node)] = None
                continue
            if any(env[id(src)] is None for src, _ in node.inputs):
                _solve_param_shapes(node, env, meta)
            bad = [src.name for src, _ in node.inputs if env[id(src)] is None]
            if bad:
                raise MXNetError(
                    f"infer_shape: cannot determine shape of {bad} for op "
                    f"{node.name}; provide them")
            params = dict(node.attrs)
            if node.op.mode_dependent:
                params["_train"] = False
            ins = [env[id(src)][idx] for src, idx in node.inputs]
            if node.op.needs_rng:
                ins.append(None)
            try:
                out = node.op.fn(params, *ins)
            except Exception as e:
                raise MXNetError(f"infer_shape failed at {node.op.name} "
                                 f"'{node.name}': {e}") from e
            if not isinstance(out, (tuple, list)):
                out = (out,)
            env[id(node)] = tuple(out[:node.op.num_outputs(params)])
    known = {n.name: tuple(env[id(n)][0].shape) for n in symbol._topo()
             if n.is_variable and env[id(n)] is not None}
    outs = [tuple(env[id(n)][i].shape) for n, i in symbol._entries]
    return known, outs


def _solve_param_shapes(node, env, meta):
    """Infer unbound parameter-variable shapes from op attrs and the known
    data shape (the rules of the JAX package's `_solve_param_shapes` for
    the ops the port carries)."""
    src0, oi0 = node.inputs[0]
    if env[id(src0)] is None:
        return
    d = tuple(env[id(src0)][oi0].shape)
    p = node.attrs

    def setvar(i, shape):
        src, _ = node.inputs[i]
        if src.is_variable and env[id(src)] is None:
            env[id(src)] = (meta(shape),)

    if node.op.name in ("FullyConnected", "_sg_pallas_fc_relu"):
        num_hidden = int(p["num_hidden"])
        in_units = d[-1]
        if p.get("flatten", True):
            in_units = 1
            for s in d[1:]:
                in_units *= s
        setvar(1, (num_hidden, in_units))
        if not p.get("no_bias"):
            setvar(2, (num_hidden,))
    elif node.op.name == "Convolution":
        nf = int(p["num_filter"])
        g = int(p.get("num_group", 1))
        setvar(1, (nf, d[1] // g) + tuple(p["kernel"]))
        if not p.get("no_bias"):
            setvar(2, (nf,))
