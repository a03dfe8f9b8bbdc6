"""Weight initializers (reference `python/mxnet/initializer.py`).

PyTorch port of `incubator_mxnet_tpu/initializer.py`: `InitDesc`, the
`Initializer` dispatch, `Zero`, `One`, `Constant`, `Uniform`, `Normal`,
`Xavier`, `MSRAPrelu`, `Orthogonal`, `Bilinear`, `LSTMBias`, `Load` and
`Mixed`.  The random ones draw on the host
from `random.host_rng()`, the JAX package's stream, so under one
`mx.random.seed(n)` both packages initialise parameters bitwise alike;
the values are then written into the array in place, cast to its dtype.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Load", "Mixed", "register", "create"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """Name + attrs descriptor (reference `initializer.py InitDesc`)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    name = klass.__name__.lower()
    _INIT_REGISTRY[name] = klass
    # the reference registers plural aliases for Zero/One
    if name in ("zero", "one"):
        _INIT_REGISTRY[name + "s"] = klass
    return klass


class Initializer:
    """Base initializer, callable on (InitDesc, NDArray); dispatches on
    the desc's ``__init__`` attr, else on the name's suffix (reference
    `initializer.py:Initializer`)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be string or InitDesc")
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = str(desc)
        if name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("beta"):
            self._init_zero(name, arr)
        elif name.endswith("gamma"):
            self._init_one(name, arr)
        elif name.endswith(("moving_mean", "running_mean", "moving_inv_var",
                            "moving_avg", "min", "max")):
            self._init_zero(name, arr)
        elif name.endswith(("moving_var", "running_var")):
            self._init_one(name, arr)
        elif name.endswith("parameters"):
            # FusedRNNCell's flat parameter vector: the initializer where
            # it takes a vector, else U(-0.07, 0.07) from the host stream
            # (a fan-in scheme such as Xavier cannot), as the JAX package
            try:
                self._init_weight(name, arr)
            except ValueError:
                self._set(arr, _random.host_rng().uniform(-0.07, 0.07,
                                                          arr.shape))
        else:
            self._init_default(name, arr)

    @staticmethod
    def _set(arr, values):
        """Write host values into `arr` in place, rounded once to its
        dtype (numpy's cast where numpy has the dtype, torch's for
        bfloat16)."""
        values = np.asarray(values)
        dt = arr.data.dtype
        if dt == torch.bfloat16:
            t = torch.from_numpy(values.astype(np.float64)).to(dt)
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                values.astype(np.dtype(arr.dtype), copy=False)))
        arr._set_data(t)

    def _init_zero(self, _, arr):
        self._set(arr, np.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._set(arr, np.ones(arr.shape))

    def _init_bias(self, _, arr):
        self._set(arr, np.zeros(arr.shape))

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default "
            "initialization is limited to \"weight\", \"bias\", \"gamma\" "
            "and \"beta\". Please use mx.sym.Variable(init=mx.init.*) to "
            "set initialization pattern")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, np.zeros(arr.shape))


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, np.ones(arr.shape))


@register
class Constant(Initializer):
    def __init__(self, value=0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        if isinstance(self.value, NDArray):
            self._set(arr, self.value.asnumpy())
        else:
            self._set(arr, np.full(arr.shape, self.value))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, _random.host_rng().uniform(-self.scale, self.scale,
                                                  arr.shape))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, _random.host_rng().normal(0, self.sigma, arr.shape))


@register
class Xavier(Initializer):
    """Reference `initializer.py Xavier`."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(f"Xavier initializer cannot be applied to "
                             f"vector {name}. It requires at least 2D.")
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, _random.host_rng().uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, _random.host_rng().normal(0, scale, shape))
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He et al. (2015): Gaussian Xavier with magnitude 2 / (1 +
    slope^2) (reference `initializer.py MSRAPrelu`)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """Saxe et al. (2014): the orthonormal factor of the SVD of a random
    (out, in) matrix, times `scale` (reference `initializer.py
    Orthogonal`).  The SVD is numpy's on the host, as in the JAX
    package, so both give the same bits."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _random.host_rng().uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _random.host_rng().normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        self._set(arr, (self.scale * res).reshape(arr.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a Deconvolution weight
    (reference `initializer.py Bilinear`)."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        size = int(np.prod(shape))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(size)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))).astype(
            np.float32)
        self._set(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """An LSTM bias: zeros but the forget gate's quarter, `forget_bias`
    (gate order i, f, g, o; reference `initializer.py LSTMBias`)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype="float32")
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    def _init_bias(self, name, arr):
        self._init_weight(name, arr)


class Load:
    """Values from a saved parameter dict (``arg:``/``aux:`` prefixes
    dropped), `default_init` for the names it lacks (reference
    `initializer.py Load`)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError(f"Parameter {name} cannot be initialized "
                                 "from loading. Shape mismatch, target "
                                 f"{arr.shape} vs loaded {src.shape}")
            arr._set_data(src.data if isinstance(src, NDArray) else src)
        else:
            if self.default_init is None:
                raise ValueError(f"Cannot Initialize {name}. Not found in "
                                 "loaded param and no default Initializer "
                                 "is provided.")
            self.default_init(name, arr)


class Mixed:
    """The first initializer whose pattern matches the name (reference
    `initializer.py Mixed`)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers mismatch")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(f"Parameter name {name} did not match any pattern")


def create(init, **kwargs):
    """An initializer from an instance, a callable, a name or the JSON of
    `Initializer.dumps`."""
    if isinstance(init, Initializer) or callable(init):
        return init
    if isinstance(init, str):
        if init.startswith("["):
            name, args = json.loads(init)
            return _INIT_REGISTRY[name.lower()](**args)
        if init.lower() not in _INIT_REGISTRY:
            raise MXNetError(f"Unknown initializer {init}")
        return _INIT_REGISTRY[init.lower()](**kwargs)
    raise MXNetError(f"Cannot create initializer from {init!r}")
