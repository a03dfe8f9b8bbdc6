"""NDArray save/load (reference `python/mxnet/ndarray/utils.py`).

`save` writes the reference's dmlc binary container byte for byte
(`compat.mxnet_params`), so `.params` files interchange with the JAX
package and with reference MXNet in both directions.
"""
from __future__ import annotations

from .ndarray import NDArray
from ..base import MXNetError


def save(fname, data):
    """Save NDArrays (reference `mx.nd.save`): a list is saved unnamed
    (loading yields a list), a dict named."""
    from ..compat.mxnet_params import save_params
    if isinstance(data, NDArray):
        data = [data]
    if not isinstance(data, (dict, list, tuple)):
        raise MXNetError("save: data must be NDArray, list, or dict")
    save_params(fname, data)


def load(fname, ctx=None):
    """Load NDArrays saved by `save`, by the JAX package or by reference
    MXNet; they land on the CPU unless `ctx` names another context."""
    from ..compat.mxnet_params import load_params
    out = load_params(fname)
    if ctx is not None:
        if isinstance(out, dict):
            return {k: v.as_in_context(ctx) for k, v in out.items()}
        return [v.as_in_context(ctx) for v in out]
    return out
