"""Elementwise arithmetic behind `Symbol`'s operator overloads.

PyTorch port of the broadcast and scalar arithmetic ops of
`incubator_mxnet_tpu/ops/elemwise.py` (same names and aliases).
"""
from __future__ import annotations

import operator

from .registry import register, REQUIRED

_BINARY = {
    "broadcast_add": (operator.add, ("broadcast_plus", "elemwise_add",
                                     "_add", "_plus", "_Plus")),
    "broadcast_sub": (operator.sub, ("broadcast_minus", "elemwise_sub",
                                     "_sub", "_minus", "_Minus")),
    "broadcast_mul": (operator.mul, ("elemwise_mul", "_mul", "_Mul")),
    "broadcast_div": (operator.truediv, ("elemwise_div", "_div", "_Div")),
}

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
}


def _binary(f):
    return lambda params, a, b: f(a, b)


def _scalar(f):
    return lambda params, x: f(x, float(params["scalar"]))


for _name, (_f, _aliases) in _BINARY.items():
    register(_name, nin=2, aliases=_aliases)(_binary(_f))

for _name, _f in _SCALAR.items():
    register(_name, params={"scalar": REQUIRED})(_scalar(_f))
