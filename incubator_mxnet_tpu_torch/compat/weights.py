"""Parameters from numpy: run the JAX package and the port on one weight set.

`params_from_numpy` takes parameter dicts whose values are numpy arrays,
or anything with ``asnumpy()`` (an NDArray of either package, a value read
from a `.params` file), and returns the port's ``{name: NDArray}`` dicts
on `ctx` (the Module and serving route).

`block_params_to_numpy` and `block_params_from_numpy` carry a gluon
block's parameters, by full name, as numpy: out of a block of either
package, and into one of the port's (a `.params` file that either
package's `save_parameters` wrote loads with `Block.load_parameters`).
"""
from __future__ import annotations

import numpy as _np

from ..ndarray.ndarray import array

__all__ = ["params_from_numpy", "block_params_to_numpy",
           "block_params_from_numpy"]


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
