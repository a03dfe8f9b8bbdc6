"""Elementwise operators: unary, binary with broadcasting, scalar, logic.

PyTorch port of `incubator_mxnet_tpu/ops/elemwise.py` (same names and
aliases; reference `src/operator/tensor/elemwise_*`).  A comparison
returns 0/1 in the operands' dtype, as in MXNet.  Scalars are static
params, so ``x * 2.0`` keeps x's dtype.
"""
from __future__ import annotations

import operator

import torch

from .registry import register, REQUIRED

# ---------------------------------------------------------------------------
# Unary
# ---------------------------------------------------------------------------

def _cbrt(x):
    """The real cube root (torch has none): sign(x) * |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": (torch.abs, ("_abs",)),
    "sign": (torch.sign, ()),
    "rint": (torch.round, ()),
    "round": (torch.round, ()),
    "ceil": (torch.ceil, ()),
    "floor": (torch.floor, ()),
    "trunc": (torch.trunc, ()),
    "fix": (torch.trunc, ()),
    "square": (torch.square, ()),
    "sqrt": (torch.sqrt, ()),
    "rsqrt": (torch.rsqrt, ()),
    "cbrt": (_cbrt, ()),
    "rcbrt": (lambda x: 1.0 / _cbrt(x), ()),
    "exp": (torch.exp, ()),
    "log": (torch.log, ()),
    "log10": (torch.log10, ()),
    "log2": (torch.log2, ()),
    "log1p": (torch.log1p, ()),
    "expm1": (torch.expm1, ()),
    "sin": (torch.sin, ()),
    "cos": (torch.cos, ()),
    "tan": (torch.tan, ()),
    "arcsin": (torch.arcsin, ()),
    "arccos": (torch.arccos, ()),
    "arctan": (torch.arctan, ()),
    "sinh": (torch.sinh, ()),
    "cosh": (torch.cosh, ()),
    "tanh": (torch.tanh, ()),
    "arcsinh": (torch.arcsinh, ()),
    "arccosh": (torch.arccosh, ()),
    "arctanh": (torch.arctanh, ()),
    "degrees": (torch.rad2deg, ()),
    "radians": (torch.deg2rad, ()),
    "sigmoid": (torch.sigmoid, ()),
    "softsign": (torch.nn.functional.softsign, ()),
    "relu": (torch.relu, ()),
    "reciprocal": (torch.reciprocal, ()),
    "erf": (torch.erf, ()),
    "erfinv": (torch.erfinv, ()),
    "gammaln": (torch.lgamma, ()),
    "logical_not": (lambda x: (x == 0).to(x.dtype), ()),
    "negative": (torch.neg, ("_np_negative",)),
}


def _unary(f):
    return lambda params, x: f(x)


for _name, (_f, _aliases) in _UNARY.items():
    register(_name, aliases=_aliases)(_unary(_f))


@register("gamma")
def _gamma(params, x):
    """tgamma (reference `elemwise_unary_op_basic.cc` gamma), as
    `jax.scipy.special.gamma`: exp(lgamma(x)) with the sign of Gamma,
    negative on (-1, 0), (-3, -2), ..."""
    neg = (x < 0) & (torch.remainder(torch.floor(x), 2) != 0)
    return torch.exp(torch.lgamma(x)) * torch.where(neg, -1.0, 1.0).to(
        x.dtype)


@register("_copy", aliases=("identity",))
def _copy(params, x):
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient", "block_grad"),
          stop_grad=True)
def _block_grad(params, x):
    """The identity whose gradient is zero (reference
    `elemwise_unary_op_basic.cc` BlockGrad)."""
    return x.detach()


@register("make_loss", aliases=("MakeLoss_simple",))
def _make_loss(params, x):
    return x


@register("zeros_like")
def _zeros_like(params, x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(params, x):
    return torch.ones_like(x)


@register("clip", params={"a_min": None, "a_max": None})
def _clip(params, x):
    """Reference `matrix_op.cc` clip; with neither bound, `x` (as
    `jnp.clip` returns it; `torch.clamp` refuses two Nones)."""
    if params["a_min"] is None and params["a_max"] is None:
        return x
    return torch.clamp(x, params["a_min"], params["a_max"])


# ---------------------------------------------------------------------------
# Binary with broadcasting (the broadcast_* family) and the same-shape
# elemwise_* names
# ---------------------------------------------------------------------------

def _cmp(f):
    def g(x, y):
        return f(x, y).to(torch.promote_types(x.dtype, y.dtype))
    return g


_BINARY = {
    "broadcast_add": (operator.add, ("broadcast_plus", "elemwise_add",
                                     "_add", "_plus", "_Plus")),
    "broadcast_sub": (operator.sub, ("broadcast_minus", "elemwise_sub",
                                     "_sub", "_minus", "_Minus")),
    "broadcast_mul": (operator.mul, ("elemwise_mul", "_mul", "_Mul")),
    "broadcast_div": (operator.truediv, ("elemwise_div", "_div", "_Div")),
    "broadcast_mod": (torch.remainder, ("_mod",)),
    "broadcast_power": (torch.pow, ("_power", "_Power", "pow")),
    "broadcast_maximum": (torch.maximum, ("_maximum",)),
    "broadcast_minimum": (torch.minimum, ("_minimum",)),
    "broadcast_hypot": (torch.hypot, ("_hypot",)),
    "broadcast_equal": (_cmp(torch.eq), ("_equal",)),
    "broadcast_not_equal": (_cmp(torch.ne), ("_not_equal",)),
    "broadcast_greater": (_cmp(torch.gt), ("_greater",)),
    "broadcast_greater_equal": (_cmp(torch.ge), ("_greater_equal",)),
    "broadcast_lesser": (_cmp(torch.lt), ("_lesser",)),
    "broadcast_lesser_equal": (_cmp(torch.le), ("_lesser_equal",)),
    "broadcast_logical_and": (_cmp(torch.logical_and), ("_logical_and",)),
    "broadcast_logical_or": (_cmp(torch.logical_or), ("_logical_or",)),
    "broadcast_logical_xor": (_cmp(torch.logical_xor), ("_logical_xor",)),
}


def _binary(f):
    return lambda params, a, b: f(a, b)


for _name, (_f, _aliases) in _BINARY.items():
    register(_name, nin=2, aliases=_aliases)(_binary(_f))


@register("smooth_l1", params={"scalar": 1.0})
def _smooth_l1(params, x):
    """Reference `elemwise_binary_scalar_op_extended.cc` smooth_l1:
    0.5 (s x)^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = float(params["scalar"]) ** 2
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       ax - 0.5 / s2)


# ---------------------------------------------------------------------------
# Scalar ops (`elemwise_binary_scalar_op_*.cc`): the scalar is a static
# param, as in the reference
# ---------------------------------------------------------------------------

def _as(x, cond):
    return cond.to(x.dtype)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
    "_hypot_scalar": lambda x, s: torch.hypot(x, torch.full_like(x, s)),
    "_equal_scalar": lambda x, s: _as(x, x == s),
    "_not_equal_scalar": lambda x, s: _as(x, x != s),
    "_greater_scalar": lambda x, s: _as(x, x > s),
    "_greater_equal_scalar": lambda x, s: _as(x, x >= s),
    "_lesser_scalar": lambda x, s: _as(x, x < s),
    "_lesser_equal_scalar": lambda x, s: _as(x, x <= s),
    "_logical_and_scalar": lambda x, s: _as(x, torch.logical_and(
        x, torch.tensor(bool(s)))),
    "_logical_or_scalar": lambda x, s: _as(x, torch.logical_or(
        x, torch.tensor(bool(s)))),
    "_logical_xor_scalar": lambda x, s: _as(x, torch.logical_xor(
        x, torch.tensor(bool(s)))),
}


def _scalar(f):
    return lambda params, x: f(x, float(params["scalar"]))


for _name, _f in _SCALAR.items():
    register(_name, params={"scalar": REQUIRED})(_scalar(_f))
