"""`mx.nd.random` (reference `python/mxnet/ndarray/random.py`).

PyTorch port of `incubator_mxnet_tpu/ndarray/random.py`: each sampler
runs the registered random op, ``_random_*`` for scalar parameters and
``_sample_*`` when the parameters are NDArrays (one draw of `shape` per
parameter element).  The draws come from `random.generator` on the
output's device (see `ops/random_ops.py`).
"""
from __future__ import annotations

from .ndarray import NDArray, invoke
from ..ops import registry as _reg

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "seed"]


def _rand(opname, sample_opname, *dist_args, shape=(), dtype="float32",
          ctx=None, out=None, **kwargs):
    if dist_args and isinstance(dist_args[0], NDArray):
        return invoke(_reg.get(sample_opname), list(dist_args),
                      {"shape": shape, "dtype": dtype}, out=out)
    params = dict(kwargs)
    params.update({"shape": shape, "dtype": dtype, "ctx": ctx})
    return invoke(_reg.get(opname), [], params, out=out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None):
    if isinstance(low, NDArray):
        return _rand("_random_uniform", "_sample_uniform", low, high,
                     shape=shape, dtype=dtype, out=out)
    return _rand("_random_uniform", "_sample_uniform", shape=shape,
                 dtype=dtype, ctx=ctx, out=out, low=low, high=high)


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None):
    if isinstance(loc, NDArray):
        return _rand("_random_normal", "_sample_normal", loc, scale,
                     shape=shape, dtype=dtype, out=out)
    return _rand("_random_normal", "_sample_normal", shape=shape,
                 dtype=dtype, ctx=ctx, out=out, loc=loc, scale=scale)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc=loc, scale=scale, shape=shape, dtype=dtype, ctx=ctx)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None):
    if isinstance(alpha, NDArray):
        return _rand("_random_gamma", "_sample_gamma", alpha, beta,
                     shape=shape, dtype=dtype, out=out)
    return _rand("_random_gamma", "_sample_gamma", shape=shape, dtype=dtype,
                 ctx=ctx, out=out, alpha=alpha, beta=beta)


def exponential(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _rand("_random_exponential", None, shape=shape, dtype=dtype,
                 ctx=ctx, out=out, lam=lam)


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _rand("_random_poisson", None, shape=shape, dtype=dtype, ctx=ctx,
                 out=out, lam=lam)


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None):
    return _rand("_random_negative_binomial", None, shape=shape, dtype=dtype,
                 ctx=ctx, out=out, k=k, p=p)


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None):
    return _rand("_random_generalized_negative_binomial", None, shape=shape,
                 dtype=dtype, ctx=ctx, out=out, mu=mu, alpha=alpha)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return _rand("_random_randint", None, shape=shape, dtype=dtype, ctx=ctx,
                 out=out, low=low, high=high)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32"):
    return invoke(_reg.get("_sample_multinomial"), [data],
                  {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                  out=out)


def shuffle(data, out=None):
    return invoke(_reg.get("_shuffle"), [data], {}, out=out)


def seed(seed_state, ctx="all"):
    from .. import random as _random
    _random.seed(seed_state, ctx)
