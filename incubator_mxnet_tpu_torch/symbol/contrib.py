"""`mx.sym.contrib`: symbolic control flow (reference
`python/mxnet/symbol/contrib.py:215,378,601`).

PyTorch port of the builders in `incubator_mxnet_tpu/symbol/contrib.py`.
`foreach`, `while_loop` and `cond` trace a Python callable ONCE over
fresh Variables; every other variable (or computed symbol) the body
captures becomes a closure input of the node, and the subgraph ships in
the attrs as symbol JSON (`ops/control_flow.py` runs it).  The nodes,
attrs and names are the JAX package's, so a graph built in either
package loads and runs in the other.
"""
from __future__ import annotations

from ..base import MXNetError
from .symbol import Symbol, Variable, Group, _sym_apply
from ..ops import registry as _reg
from . import register as _register

__all__ = ["foreach", "while_loop", "cond", "foreach_unroll"]

# the registry's ``_contrib_*`` ops under their short names
# (``contrib.MultiBoxPrior``, ``contrib.box_nms``), as in the JAX package
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        globals()[_short] = _register._make_function(_reg.get(_name), _short)


_cf_uid = [0]


def _uid():
    _cf_uid[0] += 1
    return _cf_uid[0]


def _flatten(args):
    if isinstance(args, (list, tuple)):
        flat, fmts = [], []
        for a in args:
            f, fmt = _flatten(a)
            flat.extend(f)
            fmts.append(fmt)
        return flat, fmts
    return [args], None


def _regroup(flat, fmt, pos=0):
    if fmt is None:
        return flat[pos], pos + 1
    out = []
    for f in fmt:
        v, pos = _regroup(flat, f, pos)
        out.append(v)
    return out, pos


def _classify_args(sub, mine, seen=None, closures=None):
    """arg_map entries + closure input symbols for a built subgraph.

    `mine` maps id(variable node) -> slot tag for the Variables created to
    stand in for loop slices/states.  Every OTHER variable leaf is a
    closure input — shared BY NODE with the outer graph, so composition
    into the enclosing Symbol works exactly like any other op input.
    Pass `seen`/`closures` to share one closure pool across several
    subgraphs (while_loop's cond+func, cond's then+else)."""
    if sub.list_auxiliary_states():
        raise MXNetError(
            "control-flow bodies may not contain layers with auxiliary "
            "states (e.g. BatchNorm running stats); keep them outside "
            "the loop")
    arg_map = []
    closure_syms = closures if closures is not None else []
    seen = seen if seen is not None else {}
    for node in sub._topo():
        if not node.is_variable:
            continue
        tag = mine.get(id(node))
        if tag is None:
            j = seen.get(id(node))
            if j is None:
                j = len(seen)
                seen[id(node)] = j
                closure_syms.append(Symbol([(node, 0)]))
            arg_map.append((node.name, f"c{j}"))
        else:
            arg_map.append((node.name, tag))
    return arg_map, closure_syms, seen


def _apply(op_name, inputs, attrs):
    attrs["num_args"] = len(inputs)
    return _sym_apply(op_name, inputs, attrs)


def foreach(body, data, init_states, name="foreach"):
    """Symbolic foreach: ONE `_foreach` node running `body(data_t,
    states) -> (outputs, new_states)` over axis 0 of `data` (reference
    `symbol/contrib.py:215`)."""
    uname = f"{name}{_uid()}"
    data_list, data_fmt = _flatten(data)
    states_list, state_fmt = _flatten(init_states)
    data_vars = [Variable(f"{uname}_d{i}") for i in range(len(data_list))]
    state_vars = [Variable(f"{uname}_s{i}")
                  for i in range(len(states_list))]
    d_in, _ = _regroup(data_vars, data_fmt)
    s_in, _ = _regroup(state_vars, state_fmt)
    outs, new_states = body(d_in, s_in)
    outs_list, out_fmt = _flatten(outs)
    new_list, _ = _flatten(new_states)
    if len(new_list) != len(states_list):
        raise MXNetError(
            f"foreach body returned {len(new_list)} states, expected "
            f"{len(states_list)}")
    sub = Group(list(outs_list) + list(new_list))
    mine = {id(v._entries[0][0]): f"d{i}" for i, v in enumerate(data_vars)}
    mine.update({id(v._entries[0][0]): f"s{i}"
                 for i, v in enumerate(state_vars)})
    arg_map, closure_syms, _ = _classify_args(sub, mine)
    res = _apply("_foreach", list(data_list) + list(states_list) +
                 closure_syms,
                 {"subgraph": sub.tojson(), "arg_map": tuple(arg_map),
                  "num_data": len(data_list),
                  "num_states": len(states_list),
                  "num_out_data": len(outs_list), "name": uname})
    n_out = len(outs_list)
    outs_r, _ = _regroup([res[i] for i in range(n_out)], out_fmt)
    states_r, _ = _regroup([res[n_out + i] for i in range(len(states_list))],
                           state_fmt)
    return outs_r, states_r


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Symbolic while_loop: one `_while_loop` node (reference
    `symbol/contrib.py:378`); as in the reference's symbolic op,
    max_iterations is required and the per-step outputs are padded to
    it."""
    if max_iterations is None:
        raise MXNetError("while_loop: max_iterations is required in the "
                         "symbolic form (static shapes)")
    uname = f"{name}{_uid()}"
    vars_list, var_fmt = _flatten(loop_vars)
    var_syms = [Variable(f"{uname}_v{i}") for i in range(len(vars_list))]
    v_in, _ = _regroup(var_syms, var_fmt)
    call_args = v_in if isinstance(v_in, list) else [v_in]
    cond_out = cond(*call_args)
    outs, new_vars = func(*call_args)
    outs_list, out_fmt = _flatten(outs)
    new_list, _ = _flatten(new_vars)
    if len(new_list) != len(vars_list):
        raise MXNetError(
            f"while_loop func returned {len(new_list)} loop_vars, expected "
            f"{len(vars_list)}")
    cond_sub = Group([cond_out])
    func_sub = Group(list(outs_list) + list(new_list))
    mine = {id(v._entries[0][0]): f"v{i}" for i, v in enumerate(var_syms)}
    # one closure pool shared by the cond and func graphs
    c_map, closures, seen = _classify_args(cond_sub, mine)
    f_map, closures, seen = _classify_args(func_sub, mine, seen, closures)
    res = _apply("_while_loop", list(vars_list) + closures,
                 {"cond_subgraph": cond_sub.tojson(),
                  "func_subgraph": func_sub.tojson(),
                  "cond_arg_map": tuple(c_map),
                  "func_arg_map": tuple(f_map),
                  "num_vars": len(vars_list),
                  "num_out_data": len(outs_list),
                  "max_iterations": int(max_iterations), "name": uname})
    n_out = len(outs_list)
    outs_r, _ = _regroup([res[i] for i in range(n_out)], out_fmt)
    vars_r, _ = _regroup([res[n_out + i] for i in range(len(vars_list))],
                         var_fmt)
    return outs_r, vars_r


def cond(pred, then_func, else_func, name="cond"):
    """Symbolic cond: one `_cond` node (reference
    `symbol/contrib.py:601`)."""
    uname = f"{name}{_uid()}"
    t_list, t_fmt = _flatten(then_func())
    e_list, _ = _flatten(else_func())
    if len(t_list) != len(e_list):
        raise MXNetError(
            f"cond branches must produce the same number of outputs "
            f"({len(t_list)} vs {len(e_list)})")
    t_sub = Group(list(t_list))
    e_sub = Group(list(e_list))
    # one closure pool shared by the then and else graphs
    t_map, closures, seen = _classify_args(t_sub, {})
    e_map, closures, seen = _classify_args(e_sub, {}, seen, closures)
    res = _apply("_cond", [pred] + closures,
                 {"then_subgraph": t_sub.tojson(),
                  "else_subgraph": e_sub.tojson(),
                  "then_arg_map": tuple(t_map),
                  "else_arg_map": tuple(e_map),
                  "num_outputs": len(t_list), "name": uname})
    outs_r, _ = _regroup([res[i] for i in range(len(t_list))], t_fmt)
    return outs_r


def foreach_unroll(step, inputs, begin_state, layout, length):
    """One-node unroll shared by the RNN cell packages (gluon and
    legacy): swap the sequence T-major, slice it to `length` (binding
    fails when the data is shorter, as a static split would), run
    `step(x, states)` under foreach, swap back."""
    from .. import symbol as sym_mod
    axis = layout.find("T")
    seq = inputs if axis == 0 else \
        sym_mod.swapaxes(inputs, dim1=0, dim2=axis)
    seq = sym_mod.slice_axis(seq, axis=0, begin=0, end=int(length))
    outs, states = foreach(step, seq, begin_state)
    if axis != 0:
        outs = sym_mod.swapaxes(outs, dim1=0, dim2=axis)
    return outs, states
