"""`mx.sym.random` (reference `python/mxnet/symbol/random.py`): the
random ops as graph nodes, ``_sample_*`` when the parameters are
Symbols."""
from __future__ import annotations

from .symbol import Symbol, _sym_apply

__all__ = ["uniform", "normal", "gamma", "multinomial", "shuffle"]


def uniform(low=0, high=1, shape=(), dtype="float32", **kwargs):
    if isinstance(low, Symbol):
        return _sym_apply("_sample_uniform", [low, high],
                          {"shape": shape, "dtype": dtype, **kwargs})
    return _sym_apply("_random_uniform", [],
                      {"low": low, "high": high, "shape": shape,
                       "dtype": dtype, **kwargs})


def normal(loc=0, scale=1, shape=(), dtype="float32", **kwargs):
    if isinstance(loc, Symbol):
        return _sym_apply("_sample_normal", [loc, scale],
                          {"shape": shape, "dtype": dtype, **kwargs})
    return _sym_apply("_random_normal", [],
                      {"loc": loc, "scale": scale, "shape": shape,
                       "dtype": dtype, **kwargs})


def gamma(alpha=1, beta=1, shape=(), dtype="float32", **kwargs):
    if isinstance(alpha, Symbol):
        return _sym_apply("_sample_gamma", [alpha, beta],
                          {"shape": shape, "dtype": dtype, **kwargs})
    return _sym_apply("_random_gamma", [],
                      {"alpha": alpha, "beta": beta, "shape": shape,
                       "dtype": dtype, **kwargs})


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    return _sym_apply("_sample_multinomial", [data],
                      {"shape": shape, "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kwargs):
    return _sym_apply("_shuffle", [data], kwargs)
