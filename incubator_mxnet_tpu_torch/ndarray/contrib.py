"""`mx.nd.contrib`: imperative control flow (reference
`python/mxnet/ndarray/contrib.py`, `src/operator/control_flow.cc:1255-1423`).

PyTorch port of `foreach`, `while_loop` and `cond` in
`incubator_mxnet_tpu/ndarray/contrib.py`: Python loops over NDArray
calls, which `autograd.record()` records op by op, as the reference's
imperative fallback runs them.
"""
from __future__ import annotations

from .ndarray import invoke
from ..ops import registry as _reg
from . import register as _register

__all__ = ["foreach", "while_loop", "cond"]

# the registry's ``_contrib_*`` ops under their short names
# (``contrib.MultiBoxPrior``, ``contrib.box_nms``), as in the JAX package
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        globals()[_short] = _register._make_function(_reg.get(_name), _short)


def _stack(rows):
    return invoke(_reg.get("stack"), rows, {"num_args": len(rows),
                                            "axis": 0})


def foreach(body, data, init_states):
    """`body(data[i], states) -> (outputs, states)` for each i along axis
    0; the outputs stacked."""
    states = init_states
    outputs = []
    multi = isinstance(data, (list, tuple))
    for i in range(data[0].shape[0] if multi else data.shape[0]):
        outs, states = body([d[i] for d in data] if multi else data[i],
                            states)
        outputs.append(outs)
    if isinstance(outputs[0], (list, tuple)):
        return [_stack([o[j] for o in outputs])
                for j in range(len(outputs[0]))], states
    return _stack(outputs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """`func(*vars) -> (outputs, vars)` while `cond(*vars)` holds, at most
    `max_iterations` times; the outputs stacked, not padded."""
    steps = 0
    outputs = []
    vars_ = list(loop_vars)
    while bool(cond(*vars_)):
        outs, vars_ = func(*vars_)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        outputs.append(outs)
        steps += 1
        if max_iterations is not None and steps >= max_iterations:
            break
    if not outputs:
        return [], vars_
    return [_stack([o[j] for o in outputs])
            for j in range(len(outputs[0]))], vars_


def cond(pred, then_func, else_func):
    """`then_func()` if `pred` is true, else `else_func()`."""
    return then_func() if bool(pred) else else_func()
