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

`simple_bind` and `bind` return an eager `executor.Executor`;
`simple_bind` partitions the graph with the backend that
``MXNET_SUBGRAPH_BACKEND`` names, as the JAX package's does.
"""
from __future__ import annotations

import json
import re
import threading

import numpy as _np
import torch

from ..attribute import current_attrs
from ..base import MXNetError, py_literal
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "graph_eval_fn", "check_unique_names"]


def check_unique_names(symbol):
    """Reject graphs whose variable names shadow each other (the bind-time
    gate of the JAX package's `check_unique_names`): two distinct nodes
    sharing a name where one is a variable would collapse in `arg_dict`
    and bind the wrong arrays.  Same-name op pairs are tolerated; empty
    names always raise."""
    seen = {}
    for node in symbol._topo():
        if not str(node.name).strip():
            kind = "variable" if node.is_variable else f"op {node.op.name}"
            raise MXNetError(f"invalid graph: {kind} node has an empty "
                             "name")
        first = seen.setdefault(node.name, node)
        if first is not node and (node.is_variable or first.is_variable):
            raise MXNetError(
                f"invalid graph: two distinct nodes share the name "
                f"'{node.name}' "
                f"({'variable' if first.is_variable else first.op.name} vs "
                f"{'variable' if node.is_variable else node.op.name}); "
                "rename one")


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

    def attr_dict(self):
        """{node name: {attr: str value}} over the graph, user attrs
        (``__init__``, ``__lr_mult__``, ...) and op params alike."""
        out = {}
        for node in self._topo():
            d = {k: str(v) for k, v in node._extra_attrs.items()}
            if node.op is not None:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

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

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types): the given types, float32 for
        the rest, as the JAX package's `infer_type` reports them, except
        that an output of ImageNormalize has the op's ``dtype``."""
        arg_names = self.list_arguments()
        dtypes = {n: t for n, t in zip(arg_names, args) if t is not None}
        dtypes.update(kwargs)
        out_types = [_out_dtype(n.attrs.get("dtype", "float32"))
                     if not n.is_variable and n.op.name == "ImageNormalize"
                     else _np.dtype(_np.float32) for n, _ in self._entries]
        return ([_np.dtype(dtypes.get(n, _np.float32)) for n in arg_names],
                out_types,
                [_np.dtype(dtypes.get(n, _np.float32))
                 for n in self.list_auxiliary_states()])

    # -- binding -------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_arg_names=None, shared_exec=None, **kwargs):
        """Allocate argument, gradient and aux arrays from the shapes
        inferred from ``kwargs`` and return an `Executor` (reference
        `symbol.py simple_bind`).  With ``MXNET_SUBGRAPH_BACKEND`` set the
        graph is partitioned with that backend first.  The arguments named
        in `shared_arg_names`, their gradients, and every aux state take
        `shared_exec`'s arrays themselves (of the same shape) instead of
        new ones."""
        from .. import config as _config
        from ..context import current_context
        from ..executor import Executor
        sym = self
        backend = _config.get("MXNET_SUBGRAPH_BACKEND")
        if backend:
            from ..subgraph import partition_graph
            sym = partition_graph(self, backend)
        return Executor._simple_bind(sym, ctx or current_context(), grad_req,
                                     type_dict, kwargs, shared_exec,
                                     shared_arg_names)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind caller-provided arrays (reference `symbol.py bind`)."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

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

    def __pow__(self, other):
        return _sym_binary(self, other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _sym_apply("negative", [self], {})

    def __gt__(self, other):
        return _sym_binary(self, other, "broadcast_greater",
                           "_greater_scalar")

    def __ge__(self, other):
        return _sym_binary(self, other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return _sym_binary(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _sym_binary(self, other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)


def _sym_apply(op_name, inputs, kwargs):
    op = _reg.get(op_name)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    if name is not None and not str(name).strip():
        raise MXNetError(f"Operator {op_name}: node name must be a "
                         "non-empty string")
    if op.variadic_param and op.variadic_param not in kwargs:
        kwargs[op.variadic_param] = len(inputs)
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
    # the canonical `{name}_weight` / `{name}_bias` argument names; they
    # and the node take the attributes of the active `AttrScope`s
    scope_attrs = current_attrs()
    slot_names = op.list_input_names(params)
    if slot_names is not None:
        for slot in slot_names[len(entries):]:
            vnode = _Node(None, f"{name}_{slot}", {}, [])
            vnode._extra_attrs.update(scope_attrs)
            entries.append((vnode, 0))
    node = _Node(op, name, params, entries)
    node._extra_attrs.update(scope_attrs)
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
    node._extra_attrs.update(current_attrs())
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
        device = arg_values[0].device if arg_values else None
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
            out = node.op.fn(params, *ins) if node.op.nin else \
                node.op.fn(params, *ins, device=device)
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


def _out_dtype(name):
    """numpy dtype of a dtype param; bfloat16, which numpy lacks, as the
    torch dtype (as `NDArray.dtype` reports it)."""
    name = str(name)
    return torch.bfloat16 if name == "bfloat16" else _np.dtype(name)


def _declared_shape(node):
    """A variable's ``__shape__`` attr as a tuple (it is a string once the
    graph went through JSON), or None."""
    shape = node._extra_attrs.get("__shape__")
    if shape is None:
        return None
    return tuple(int(d) for d in py_literal(shape))


def _infer_graph(symbol, shapes, partial=False):
    """Shape inference by evaluating every op on meta tensors; parameter
    variables without a known shape are solved from their consumer's
    attrs (`_solve_param_shapes`).  Returns ({var name: shape}, [output
    shapes]); with `partial`, what cannot be inferred is left out (an
    output's shape is then None) instead of raising.

    A variable declared with a 0 batch dim and a ``__layout__`` (an RNN
    cell's begin state) takes the batch size: the N of a bound input
    with a layout first, else each of the first two dims of the first
    bound shape in turn, the first that infers cleanly (the JAX
    package's `_infer_graph` hints)."""
    hints = []
    for n in symbol._topo():
        if n.is_variable and shapes.get(n.name):
            layout = n._extra_attrs.get("__layout__")
            bound = tuple(shapes[n.name])
            if layout:
                bpos = str(layout).find("N")
                if 0 <= bpos < len(bound) and bound[bpos] > 0:
                    hints.append(bound[bpos])
    first = next((tuple(v) for v in shapes.values()
                  if v and tuple(v)[0] > 0), None)
    if first:
        hints += [d for d in first[:2] if d > 0]
    last_err = None
    for hint in list(dict.fromkeys(hints)) or [None]:
        try:
            return _infer_graph_with_hint(symbol, shapes, partial, hint)
        except MXNetError as e:
            last_err = e
    raise last_err


def _infer_graph_with_hint(symbol, shapes, partial, batch_hint):
    env = {}

    def meta(shape):
        return torch.empty(tuple(shape), device="meta")

    with torch.no_grad():
        for node in symbol._topo():
            if node.is_variable:
                cand = shapes.get(node.name)
                if cand is None:
                    cand = _declared_shape(node)
                    layout = node._extra_attrs.get("__layout__")
                    if cand and batch_hint is not None and layout:
                        bpos = str(layout).find("N")
                        if 0 <= bpos < len(cand) and cand[bpos] == 0:
                            cand = cand[:bpos] + (batch_hint,) + \
                                cand[bpos + 1:]
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
                if partial:
                    env[id(node)] = None
                    continue
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
                out = node.op.fn(params, *ins) if node.op.nin else \
                    node.op.fn(params, *ins, device="meta")
            except Exception as e:
                raise MXNetError(f"infer_shape failed at {node.op.name} "
                                 f"'{node.name}': {e}") from e
            if not isinstance(out, (tuple, list)):
                out = (out,)
            env[id(node)] = tuple(out[:node.op.num_outputs(params)])
    known = {n.name: tuple(env[id(n)][0].shape) for n in symbol._topo()
             if n.is_variable and env[id(n)] is not None}
    outs = [None if env[id(n)] is None else tuple(env[id(n)][i].shape)
            for n, i in symbol._entries]
    return known, outs


def _solve_subgraph_shapes(node, env, meta):
    """Shapes of a control-flow node's unknown inputs from its subgraphs:
    each subgraph's own inference with the shapes known at the node's
    inputs (a `_foreach` data slice loses its axis 0), the variables it
    solves written back to the outer graph (the JAX package's
    `_solve_subgraph_shapes`; reference ForeachShape/WhileLoopShape)."""
    from ..ops import control_flow as _cf
    p = node.attrs
    op_name = node.op.name
    ins = node.inputs
    if op_name == "_foreach":
        nd_, ns = int(p["num_data"]), int(p["num_states"])
        base = {"d": 0, "s": nd_, "c": nd_ + ns}
        graphs = [(p["subgraph"], p["arg_map"])]
    elif op_name == "_while_loop":
        base = {"v": 0, "c": int(p["num_vars"])}
        graphs = [(p["cond_subgraph"], p["cond_arg_map"]),
                  (p["func_subgraph"], p["func_arg_map"])]
    else:
        base = {"c": 1}
        graphs = [(p["then_subgraph"], p["then_arg_map"]),
                  (p["else_subgraph"], p["else_arg_map"])]

    def slot(tag):
        return base[tag[0]] + int(tag[1:])

    for gjson, amap in graphs:
        sub = _cf._subgraph(_cf._json_str(gjson))
        known = {}
        for name, tag in amap:
            src, oi = ins[slot(tag)]
            if env[id(src)] is not None:
                shp = tuple(env[id(src)][oi].shape)
                known[name] = shp[1:] if (op_name == "_foreach" and
                                          tag[0] == "d") else shp
        try:
            solved, _ = _infer_graph(sub, known, partial=True)
        except MXNetError:
            continue
        for name, tag in amap:
            shp = solved.get(name)
            src, _ = ins[slot(tag)]
            if shp and all(d > 0 for d in shp) and src.is_variable and \
                    env[id(src)] is None:
                env[id(src)] = (meta(shp),)


def _solve_param_shapes(node, env, meta):
    """Infer unbound parameter-variable shapes from op attrs and the known
    data shape (the rules of the JAX package's `_solve_param_shapes` for
    the ops the port carries)."""
    if node.op.name in ("_foreach", "_while_loop", "_cond"):
        _solve_subgraph_shapes(node, env, meta)
        return
    src0, oi0 = node.inputs[0]
    if env[id(src0)] is None:
        return
    d = tuple(env[id(src0)][oi0].shape)
    p = node.attrs

    def setvar(i, shape, dtype=None):
        src, _ = node.inputs[i]
        if src.is_variable and env[id(src)] is None:
            env[id(src)] = (meta(shape) if dtype is None else
                            torch.empty(shape, dtype=dtype, device="meta"),)

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
    elif node.op.name in ("_contrib_quantized_conv",
                          "_contrib_quantized_fully_connected"):
        if node.op.name == "_contrib_quantized_conv":
            nf = int(p["num_filter"])
            shape = (nf, d[1] // int(p.get("num_group", 1))) + \
                tuple(p["kernel"])
        else:
            nf = int(p["num_hidden"])
            in_units = 1
            for s in d[1:]:
                in_units *= s
            shape = (nf, in_units if p.get("flatten", True) else d[-1])
        setvar(1, shape, torch.int8)
        first_minmax = 2
        if not p.get("no_bias"):
            setvar(2, (nf,), torch.int8)
            first_minmax = 3
        for i in range(first_minmax, len(node.inputs)):
            setvar(i, (1,))
    elif node.op.name == "Deconvolution":
        nf = int(p["num_filter"])
        g = int(p.get("num_group", 1))
        setvar(1, (d[1], nf // g) + tuple(p["kernel"]))
        if not p.get("no_bias"):
            setvar(2, (nf,))
    elif node.op.name == "BatchNorm":
        c = d[int(p.get("axis", 1)) % len(d)]
        for i in range(1, 5):
            setvar(i, (c,))
    elif node.op.name == "LayerNorm":
        c = d[int(p.get("axis", -1)) % len(d)]
        setvar(1, (c,))
        setvar(2, (c,))
    elif node.op.name == "InstanceNorm":
        setvar(1, (d[1],))
        setvar(2, (d[1],))
    elif node.op.name == "Embedding":
        setvar(1, (int(p["input_dim"]), int(p["output_dim"])))
    elif node.op.name == "LeakyReLU" and p.get("act_type") == "prelu" \
            and len(node.inputs) > 1:
        setvar(1, (d[1],))
    elif node.op.name == "RNN":
        from ..ops.nn import rnn_param_size
        h, layers = int(p["state_size"]), int(p["num_layers"])
        bidir = bool(p.get("bidirectional"))
        setvar(1, (rnn_param_size(p["mode"], d[2], h, layers, bidir),))
        for i in range(2, len(node.inputs)):
            setvar(i, (layers * (2 if bidir else 1), d[1], h))
    elif node.op.name == "SoftmaxOutput":
        setvar(1, (d[0],) + d[2:] if p.get("multi_output") else d[:-1])
