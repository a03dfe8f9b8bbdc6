"""Parameters from numpy: run the JAX package and the port on one weight set.

`params_from_numpy` takes parameter dicts whose values are numpy arrays,
or anything with ``asnumpy()`` (an NDArray of either package, a value read
from a `.params` file), and returns the port's ``{name: NDArray}`` dicts
on `ctx`.
"""
from __future__ import annotations

import numpy as _np

from ..ndarray.ndarray import array

__all__ = ["params_from_numpy"]


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
