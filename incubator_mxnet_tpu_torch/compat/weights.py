"""Parameters from numpy: run the JAX package and the port on one weight set.

`params_from_numpy` takes parameter dicts whose values are numpy arrays,
or anything with ``asnumpy()`` (an NDArray of either package, a value read
from a `.params` file), and returns the port's ``{name: NDArray}`` dicts
on `ctx` (the Module and serving route).

`block_params_to_numpy` and `block_params_from_numpy` carry a gluon
block's parameters, by full name, as numpy: out of a block of either
package, and into one of the port's (a `.params` file that either
package's `save_parameters` wrote loads with `Block.load_parameters`).

`lm_params_from_numpy` carries a transformer LM's parameters (a JAX
`TransformerLM`'s, a Module arg dict, or a `.params` file's ``arg:``
keys) into the port's `TransformerLM`, or into the arg dict
`DecodeEngine` and `Module.set_params` take.

`trainer_states_to_numpy` and `trainer_states_from_numpy` carry a gluon
`Trainer`'s optimizer states the same way (``trainer._updaters[0].
states``, by parameter index: SGD's momentum, or ``(momentum or None,
fp32 master weight)`` under ``multi_precision``), so both packages can
start a step from the same parameters and optimizer state;
`module_states_to_numpy` and `module_states_from_numpy` do so for a
`Module`'s (``mod._updater.states``), which is how momenta cross between
the packages' checkpoints (each package pickles its optimizer blob in
its own format).
"""
from __future__ import annotations

import numpy as _np

from ..ndarray.ndarray import array

__all__ = ["params_from_numpy", "block_params_to_numpy",
           "block_params_from_numpy", "lm_params_from_numpy",
           "trainer_states_to_numpy", "trainer_states_from_numpy",
           "module_states_to_numpy", "module_states_from_numpy"]


def _np_of(v):
    return _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)


def params_from_numpy(arg_params, aux_params=None, ctx=None):
    """-> (arg_params, aux_params) as the port's NDArrays on `ctx`
    (default `current_context()`), each keeping its numpy dtype."""
    def convert(params):
        out = {}
        for k, v in (params or {}).items():
            a = _np_of(v)
            out[k] = array(a, ctx=ctx, dtype=a.dtype)
        return out
    return convert(arg_params), convert(aux_params)


def block_params_to_numpy(block):
    """{full parameter name: numpy array} of a gluon block of either
    package (the aux states, BatchNorm's running statistics, included)."""
    return {name: _np_of(p.data())
            for name, p in block.collect_params().items()}


def block_params_from_numpy(block, values, ctx=None):
    """Write `values` ({full parameter name: array}) into the port's
    `block`, every parameter of it and nothing else; a parameter not
    initialized yet takes the value's shape and is initialized with it on
    `ctx` (default: its own context, else the CPU)."""
    from ..gluon.parameter import _load_into
    _load_into(dict(block.collect_params().items()),
               {k: _np_of(v) for k, v in values.items()}, "the given values",
               ctx, False, False)


def lm_params_from_numpy(values, block=None, ctx=None):
    """An LM's parameters, {name: array} under the `llm.model` names
    (``lm_embed_weight``, ``lm_block0_qkv_weight``, ...; a ``arg:``
    prefix, as a Module checkpoint's `.params` file has, is dropped),
    into the port's `TransformerLM` `block`, which is returned; without
    a block, the port's {name: NDArray} arg dict on `ctx`."""
    arrays = {k[4:] if k.startswith("arg:") else k: v
              for k, v in values.items() if not k.startswith("aux:")}
    if block is not None:
        block_params_from_numpy(block, arrays, ctx)
        return block
    return params_from_numpy(arrays, ctx=ctx)[0]


def _map_state(state, fn):
    if isinstance(state, (tuple, list)):
        return tuple(None if v is None else fn(v) for v in state)
    return None if state is None else fn(state)


def trainer_states_to_numpy(trainer):
    """{parameter index: state as numpy} of a gluon Trainer of either
    package; a state is an array, a tuple of arrays and Nones, or
    None."""
    return {i: _map_state(s, _np_of)
            for i, s in trainer._updaters[0].states.items()}


def trainer_states_from_numpy(trainer, states):
    """Make `states` ({parameter index: state}, as `trainer_states_to_
    numpy` gives them) the port `trainer`'s optimizer states, each array
    on its parameter's context in the value's dtype; the next update
    starts from them."""
    updater = trainer._updaters[0]
    for i, state in states.items():
        ctx = trainer._params[i].list_ctx()[0]
        updater.states[i] = _map_state(
            state, lambda v: array(_np_of(v), ctx=ctx,
                                   dtype=_np_of(v).dtype))


def module_states_to_numpy(mod):
    """{parameter index: state as numpy} of a Module of either package
    (its updater's states, indexed like its parameter names)."""
    return {i: _map_state(s, _np_of) for i, s in mod._updater.states.items()}


def module_states_from_numpy(mod, states):
    """Make `states` (as `module_states_to_numpy` gives them) the port
    Module `mod`'s optimizer states, each on its parameter's device."""
    arrays = mod._exec_group.param_arrays
    for i, state in states.items():
        ctx = arrays[i][0].context
        mod._updater.states[i] = _map_state(
            state, lambda v: array(_np_of(v), ctx=ctx,
                                   dtype=_np_of(v).dtype))
