"""One `nd.<Op>` function per registered op (reference
`python/mxnet/ndarray/register.py`).

PyTorch port of `incubator_mxnet_tpu/ndarray/register.py`: every op of
the registry becomes a function of `incubator_mxnet_tpu_torch.ndarray`
(public names) and of its ``_internal`` namespace (every name), each
calling `ndarray.invoke`.  Positional arguments are NDArrays (or lists
of them); keywords are the op's params, plus ``out``.  The ops of
`_METHOD_OPS` are also NDArray methods (``x.sum(axis=1)``), as in the
JAX package.
"""
from __future__ import annotations

import types

from ..ops import registry as _reg
from .ndarray import NDArray, invoke


def _make_function(op, public_name):
    count = op.variadic_param     # filled from the inputs

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        data = []
        for a in args:
            if isinstance(a, NDArray):
                data.append(a)
            elif isinstance(a, (list, tuple)) and all(
                    isinstance(x, NDArray) for x in a):
                data.extend(a)
            else:
                raise TypeError(f"Operator {op.name}: positional arguments "
                                f"must be NDArray, got {type(a).__name__}")
        nd_kwargs = [k for k, v in kwargs.items() if isinstance(v, NDArray)]
        for k in nd_kwargs:
            data.append(kwargs.pop(k))
        if count and count not in kwargs:
            kwargs[count] = len(data)
        return invoke(op, data, kwargs, out=out)

    fn.__name__ = public_name
    fn.__doc__ = op.doc or f"Operator `{op.name}` on NDArrays."
    return fn


# the ops NDArray has as methods (the JAX package's list, where ported)
_METHOD_OPS = [
    "sum", "mean", "prod", "max", "min", "argmax", "argmin", "norm",
    "abs", "sign", "exp", "log", "log2", "log10", "log1p", "expm1",
    "sqrt", "rsqrt", "square", "sin", "cos", "tan", "arcsin", "arccos",
    "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
    "sigmoid", "relu", "softmax", "log_softmax", "clip", "round", "rint",
    "floor", "ceil", "trunc", "fix", "flatten", "expand_dims", "squeeze",
    "swapaxes", "split", "transpose", "dot", "batch_dot", "broadcast_to",
    "broadcast_like", "broadcast_axes", "zeros_like", "ones_like",
    "nansum", "nanprod", "reciprocal", "erf", "softsign", "argmax_channel",
]


def _make_method(op):
    def method(self, *args, **kwargs):
        out = kwargs.pop("out", None)
        return invoke(op, [self] + list(args), kwargs, out=out)
    method.__name__ = op.name
    return method


def populate(target_module):
    """Attach one frontend per registered op: public names on
    `target_module` (unless it already has the name), every name on its
    ``_internal`` namespace."""
    internal = types.ModuleType(target_module.__name__ + "._internal")
    for name in _reg.list_ops():
        f = _make_function(_reg.get(name), name)
        setattr(internal, name, f)
        if not name.startswith("_") and not hasattr(target_module, name):
            setattr(target_module, name, f)
    target_module._internal = internal
    for name in _METHOD_OPS:
        if not hasattr(NDArray, name):
            setattr(NDArray, name, _make_method(_reg.get(name)))
