"""Control-flow operators: `_foreach`, `_while_loop`, `_cond`.

PyTorch port of `incubator_mxnet_tpu/ops/control_flow.py` (reference
`src/operator/control_flow.cc:1255-1423`).  The ops keep the JAX
package's names, param tables and input layout, so a graph holding one
saves and loads in either package: the subgraphs travel as symbol JSON
in the attrs, and ``arg_map`` gives each subgraph argument its slot
("d0"/"s1"/"v0"/"c2": data, state, loop variable, closure).  Tensor
inputs are [data..., states..., closure...] for `_foreach`,
[vars..., closure...] for `_while_loop`, [pred, closure...] for `_cond`.

The JAX package lowers them to `lax.scan` / a masked scan / `lax.cond`.
Here they run eagerly, as the reference's own loops do: each step is one
pass of the Symbol interpreter (`symbol.graph_eval_fn`) over the body,
and autograd through the loop gives the gradient `lax.scan`'s VJP
gives.  `_while_loop` and `_cond` read their predicate on the host at
every iteration, as the reference does (`control_flow.cc`); the JAX
package keeps it on the device.  The ops pass the interpreter's
`torch.Generator` to the body, so the body draws its random numbers in
sequence; the JAX package splits a key per step, so a body with dropout
draws other numbers there (README "Declared divergences").

On ``meta`` tensors (shape inference, `symbol._infer_graph`) a body
runs once: the shapes do not depend on the step.
"""
from __future__ import annotations

import functools
import json

import torch

from .registry import register, REQUIRED
from ..base import MXNetError


def _json_str(v):
    """Keep subgraph attrs as canonical JSON strings: `py_literal` may have
    parsed a pure-literal JSON document into a dict on symbol reload."""
    if isinstance(v, str):
        return v
    return json.dumps(_delist(v))


def _delist(v):
    if isinstance(v, tuple):
        return [_delist(x) for x in v]
    if isinstance(v, dict):
        return {k: _delist(x) for k, x in v.items()}
    return v


@functools.lru_cache(maxsize=256)
def _subgraph(json_str):
    from ..symbol.symbol import load_json
    sym = load_json(json_str)
    if sym.list_auxiliary_states():
        raise MXNetError(
            "control-flow subgraphs with auxiliary states (BatchNorm "
            "running stats) are not supported; move the stateful layer "
            "outside the loop body")
    return sym


@functools.lru_cache(maxsize=256)
def _sub_eval(json_str, train):
    """(eval_fn, arg_names) for a stored subgraph, one interpreter per
    (graph, mode)."""
    from ..symbol.symbol import graph_eval_fn
    sym = _subgraph(json_str)
    gfn, _, _ = graph_eval_fn(sym, train)
    return gfn, sym.list_arguments()


def _binder(arg_names, arg_map):
    """Positions of each subgraph argument: (kind, index) per name.

    `arg_map` entries are emitted in the subgraph's topo order over
    variable nodes (`symbol/contrib.py _classify_args`) — the SAME order
    `list_arguments()` yields after the JSON round trip — so binding is
    POSITIONAL.  Binding through a name->tag dict would collapse two
    distinct outer Variables that share a name (legal in the symbol API,
    and common in nested foreach/while_loop bodies reusing inner names)
    onto one slot, silently computing with the wrong input."""
    entries = [(n, t) for n, t in arg_map]
    if len(entries) == len(arg_names) and \
            all(n == en for n, (en, _t) in zip(arg_names, entries)):
        return [(t[0], int(t[1:])) for _n, t in entries]
    # name order disagrees (a hand-edited graph JSON): fall back to
    # name-keyed binding, refusing ambiguity instead of mis-binding
    amap = {}
    for n, t in entries:
        if n in amap and amap[n] != t:
            raise MXNetError(
                f"control-flow subgraph has two inputs named {n!r} with "
                "different slots and a reordered arg_map; cannot bind "
                "unambiguously — give loop-body inputs unique names")
        amap[n] = t
    slots = []
    for n in arg_names:
        tag = amap.get(n)
        if tag is None:
            raise MXNetError(f"control-flow subgraph argument {n!r} has no "
                             "slot mapping (corrupt arg_map)")
        slots.append((tag[0], int(tag[1:])))
    return slots


def _on_meta(tensors):
    return any(t.device.type == "meta" for t in tensors)


def _host_true(c):
    """A one-element predicate read on the host."""
    return bool(c.reshape(()) != 0)


_FOREACH_PARAMS = {
    "num_args": REQUIRED, "subgraph": REQUIRED, "arg_map": REQUIRED,
    "num_data": REQUIRED, "num_states": REQUIRED, "num_out_data": REQUIRED,
}


@register("_foreach", nin=-1, params=_FOREACH_PARAMS,
          param_types={"subgraph": _json_str},
          nout=lambda p: int(p["num_out_data"]) + int(p["num_states"]),
          needs_rng=True, mode_dependent=True)
def _foreach(params, *arrays):
    """Reference control_flow.cc:1255 (ForeachState + ForeachComputeExCPU):
    the body over axis 0 of the data, the states carried, the per-step
    outputs stacked."""
    train = bool(params.get("_train", False))
    gfn, arg_names = _sub_eval(params["subgraph"], train)
    slots = _binder(arg_names, params["arg_map"])
    nd_ = int(params["num_data"])
    ns = int(params["num_states"])
    n_out = int(params["num_out_data"])
    gen = arrays[-1]
    arrays = arrays[:-1]
    data = arrays[:nd_]
    states = tuple(arrays[nd_:nd_ + ns])
    closure = arrays[nd_ + ns:]
    length = int(data[0].shape[0]) if data else 0

    def step(t, st):
        vals = [data[i][t] if k == "d" else st[i] if k == "s" else
                closure[i] for k, i in slots]
        outs, _ = gfn(vals, [], gen)
        return outs[:n_out], tuple(outs[n_out:])

    if not length:
        raise MXNetError("_foreach: the data has no steps along axis 0")
    if _on_meta(arrays):
        outs, states = step(0, states)
        return tuple(o.expand(length, *o.shape) for o in outs) + states
    rows = [[] for _ in range(n_out)]
    for t in range(length):
        outs, states = step(t, states)
        for row, o in zip(rows, outs):
            row.append(o)
    return tuple(torch.stack(r) for r in rows) + states


_WHILE_PARAMS = {
    "num_args": REQUIRED, "cond_subgraph": REQUIRED, "func_subgraph": REQUIRED,
    "cond_arg_map": REQUIRED, "func_arg_map": REQUIRED,
    "num_vars": REQUIRED, "num_out_data": REQUIRED,
    "max_iterations": REQUIRED,
}


@register("_while_loop", nin=-1, params=_WHILE_PARAMS,
          param_types={"cond_subgraph": _json_str,
                       "func_subgraph": _json_str},
          nout=lambda p: int(p["num_out_data"]) + int(p["num_vars"]),
          needs_rng=True, mode_dependent=True)
def _while_loop(params, *arrays):
    """Reference control_flow.cc `_while_loop`: at most max_iterations
    steps; the condition is read on the host before each step and the
    loop stops at the first false one, so `func` never runs past
    termination (its gradient cannot be poisoned by a step the
    condition excluded, `tests/test_control_flow.py:257`).  Per-step
    outputs are padded to max_iterations with zeros, as in the JAX
    package (the reference leaves the padding undefined); with no
    per-step outputs nothing is padded and the cost follows the
    iterations actually run."""
    train = bool(params.get("_train", False))
    cfn, c_names = _sub_eval(params["cond_subgraph"], train)
    ffn, f_names = _sub_eval(params["func_subgraph"], train)
    c_slots = _binder(c_names, params["cond_arg_map"])
    f_slots = _binder(f_names, params["func_arg_map"])
    nv = int(params["num_vars"])
    n_out = int(params["num_out_data"])
    max_iter = int(params["max_iterations"])
    gen = arrays[-1]
    arrays = arrays[:-1]
    vals = tuple(arrays[:nv])
    closure = arrays[nv:]

    def pick(slots, vs):
        return [vs[i] if k == "v" else closure[i] for k, i in slots]

    def run(vs):
        outs, _ = ffn(pick(f_slots, vs), [], gen)
        return outs[:n_out], tuple(outs[n_out:])

    if _on_meta(arrays):
        outs, vals = run(vals)
        return tuple(torch.empty((max_iter,) + tuple(o.shape),
                                 dtype=o.dtype, device="meta")
                     for o in outs) + vals
    rows = [[] for _ in range(n_out)]
    for _ in range(max_iter):
        (c,), _ = cfn(pick(c_slots, vals), [], gen)
        if not _host_true(c):
            break
        outs, vals = run(vals)
        for row, o in zip(rows, outs):
            row.append(o)
    if not n_out:
        return vals
    if rows[0]:
        likes = [r[0] for r in rows]
    else:   # no step ran: the outputs' shapes from a pass on meta
        device = vals[0].device
        closure = [v.to("meta") for v in closure]
        likes, _ = run(tuple(v.to("meta") for v in vals))
        likes = [torch.empty(o.shape, dtype=o.dtype, device=device)
                 for o in likes]
    outs = []
    for row, like in zip(rows, likes):
        pad = torch.zeros((max_iter - len(row),) + tuple(like.shape),
                          dtype=like.dtype, device=like.device)
        outs.append(torch.cat([torch.stack(row), pad]) if row else pad)
    return tuple(outs) + vals


_COND_PARAMS = {
    "num_args": REQUIRED, "then_subgraph": REQUIRED, "else_subgraph": REQUIRED,
    "then_arg_map": REQUIRED, "else_arg_map": REQUIRED,
    "num_outputs": REQUIRED,
}


@register("_cond", nin=-1, params=_COND_PARAMS,
          param_types={"then_subgraph": _json_str,
                       "else_subgraph": _json_str},
          nout=lambda p: int(p["num_outputs"]),
          needs_rng=True, mode_dependent=True)
def _cond(params, *arrays):
    """Reference control_flow.cc `_cond`: `pred` read on the host, one
    branch run (the JAX package selects the branch on the device)."""
    train = bool(params.get("_train", False))
    gen = arrays[-1]
    pred = arrays[0]
    closure = arrays[1:-1]
    which = "then" if pred.device.type == "meta" or _host_true(pred) \
        else "else"
    fn, names = _sub_eval(params[f"{which}_subgraph"], train)
    slots = _binder(names, params[f"{which}_arg_map"])
    outs, _ = fn([closure[i] for _k, i in slots], [], gen)
    return tuple(outs)
