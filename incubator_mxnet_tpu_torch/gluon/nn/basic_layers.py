"""Basic layers (reference `python/mxnet/gluon/nn/basic_layers.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/nn/basic_layers.py`:
`Sequential`, `HybridSequential`, `Dense`, `Dropout`, `Embedding`,
`BatchNorm`, `SyncBatchNorm`, `InstanceNorm`, `LayerNorm`, `Flatten`,
`Lambda` and `HybridLambda`, with the same parameter names, defaults
and op attributes.  The JAX `HybridSequential` can lower runs of equal
children to one `lax.scan` inside its fused step; an eager interpreter
has no use for that, so the children run one after another.
`SyncBatchNorm` sets the op's ``sync``: under a bound mesh of ranks its
statistics are summed over the mesh's ``sync_axis`` group.
"""
from __future__ import annotations

from ...base import MXNetError
from .activations import Activation
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "SyncBatchNorm", "InstanceNorm", "LayerNorm",
           "Flatten", "Lambda", "HybridLambda"]


class _Stack:
    """What both sequential containers share: `add`, length, indexing
    (a slice is a new container over the same children) and
    iteration."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Children applied in order (reference `basic_layers.py:
    Sequential`)."""

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Hybrid children applied in order (reference `basic_layers.py:
    HybridSequential`)."""

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """`FullyConnected` with ``flatten`` and an optional activation
    (reference `basic_layers.py:142 Dense`); ``in_units=0`` defers the
    weight's second dim to the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten,
                                   name="fwd")
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return f"Dense({shape[1] if shape[1] else None} -> {shape[0]}, " \
               f"linear)"


class Dropout(HybridBlock):
    """Reference `basic_layers.py:Dropout`."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """The `Embedding` op over a (input_dim, output_dim) weight
    (reference `basic_layers.py:369 Embedding`)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim}, " \
               f"{self._kwargs['dtype']})"


class BatchNorm(HybridBlock):
    """The `BatchNorm` op over learned gamma/beta and the running mean and
    variance as aux states (``grad_req="null"``); ``scale=False`` fixes
    gamma at 1 (reference `basic_layers.py:273 BatchNorm`)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        return f"BatchNorm(axis={self._axis}, " \
               f"in_channels={self.gamma.shape[0]})"


class SyncBatchNorm(BatchNorm):
    """`BatchNorm` with the op's ``sync`` set (reference
    `basic_layers.py:312 SyncBatchNorm`): statistics over every
    data-parallel replica, the ranks of the ``sync_axis`` axis of a
    bound mesh of ranks (the batch's own without one);
    ``num_devices`` is kept for the API."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, sync_axis="dp", **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._kwargs["sync"] = True
        self._kwargs["sync_axis"] = sync_axis
        self._num_devices = num_devices


class InstanceNorm(HybridBlock):
    """The `InstanceNorm` op over ``beta`` and (``scale=True``) a learned
    ``gamma``; ``axis`` other than 1 is swapped to 1 and back (reference
    `basic_layers.py:337 InstanceNorm`)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd", **self._kwargs)
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        out = F.InstanceNorm(x, gamma, beta, name="fwd", **self._kwargs)
        return F.swapaxes(out, dim1=1, dim2=self._axis)


class LayerNorm(HybridBlock):
    """The `LayerNorm` op over learned gamma and beta (reference
    `basic_layers.py:532 LayerNorm`); ``in_channels=0`` defers their
    shape to the first input."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis}
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, name="fwd", **self._kwargs)

    def __repr__(self):
        return f"LayerNorm(axis={self._axis}, " \
               f"in_channels={self.gamma.shape[0]})"


class Flatten(HybridBlock):
    """Reference `basic_layers.py:Flatten`."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function of NDArrays as a Block: a callable, or the name of a
    function of the port's `nd` (reference `basic_layers.py:398
    Lambda`)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            if not hasattr(nd_mod, function):
                raise MXNetError(f"Function name {function} is not found "
                                 "in ndarray.")
            self._func_impl = getattr(nd_mod, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` as a HybridBlock: a callable, or the name
    of a function both the port's `nd` and `sym` have (reference
    `basic_layers.py:422 HybridLambda`)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            from ... import symbol as sym_mod
            if not (hasattr(nd_mod, function) and
                    hasattr(sym_mod, function)):
                raise MXNetError(f"Function name {function} is not found "
                                 "in ndarray/symbol.")
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("Unrecognized function in lambda")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"
