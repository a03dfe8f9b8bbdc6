"""Convolution and pooling layers (reference
`python/mxnet/gluon/nn/conv_layers.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/nn/conv_layers.py`: the
`_Conv` and `_Pooling` bases, `Conv1D`-`Conv3D` (the `Convolution` op),
`Conv1DTranspose`-`Conv3DTranspose` (the `Deconvolution` op, whose weight
is (in_channels, channels / groups, *kernel) and whose ``adj`` is the
output padding), the max, average and global pooling blocks in 1-3 D
and `ReflectionPad2D` (the `Pad` op).
"""
from __future__ import annotations

from .activations import Activation
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """`Convolution` over a weight of (channels, in_channels / groups,
    *kernel), or `Deconvolution` over one of (in_channels, channels /
    groups, *kernel), and an optional bias (reference `conv_layers.py:
    _Conv`); ``in_channels=0`` defers the weight's input dim to the first
    input."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            self._kwargs = {
                "kernel": kernel_size, "stride": _to_tuple(strides, ndim),
                "dilate": _to_tuple(dilation, ndim),
                "pad": _to_tuple(padding, ndim), "num_filter": channels,
                "num_group": groups, "no_bias": not use_bias,
                "layout": layout}
            self._op_name = op_name
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + kernel_size
            else:
                wshape = (in_channels, channels // groups) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, name="fwd", **self._kwargs)
        else:
            out = op(x, weight, bias, name="fwd", **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return f"{self.__class__.__name__}({self._channels}, " \
               f"kernel_size={self._kwargs['kernel']}, " \
               f"stride={self._kwargs['stride']})"


def _conv_class(ndim, layout):
    class Conv(_Conv):
        def __init__(self, channels, kernel_size, strides=(1,) * ndim,
                     padding=(0,) * ndim, dilation=(1,) * ndim, groups=1,
                     layout=layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            super().__init__(channels, _to_tuple(kernel_size, ndim),
                             strides, padding, dilation, groups, layout,
                             in_channels, activation, use_bias,
                             weight_initializer, bias_initializer, **kwargs)
    Conv.__name__ = Conv.__qualname__ = f"Conv{ndim}D"
    Conv.__doc__ = f"{ndim}-D convolution, {layout} (reference " \
        f"`conv_layers.py:Conv{ndim}D`)."
    return Conv


Conv1D = _conv_class(1, "NCW")
Conv2D = _conv_class(2, "NCHW")
Conv3D = _conv_class(3, "NCDHW")


def _deconv_class(ndim, layout):
    class ConvTranspose(_Conv):
        def __init__(self, channels, kernel_size, strides=(1,) * ndim,
                     padding=(0,) * ndim, output_padding=(0,) * ndim,
                     dilation=(1,) * ndim, groups=1, layout=layout,
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            super().__init__(channels, _to_tuple(kernel_size, ndim),
                             strides, padding, dilation, groups, layout,
                             in_channels, activation, use_bias,
                             weight_initializer, bias_initializer,
                             op_name="Deconvolution",
                             adj=_to_tuple(output_padding, ndim), **kwargs)
    name = f"Conv{ndim}DTranspose"
    ConvTranspose.__name__ = ConvTranspose.__qualname__ = name
    ConvTranspose.__doc__ = f"{ndim}-D transposed convolution, {layout} " \
        f"(reference `conv_layers.py:{name}`)."
    return ConvTranspose


Conv1DTranspose = _deconv_class(1, "NCW")
Conv2DTranspose = _deconv_class(2, "NCHW")
Conv3DTranspose = _deconv_class(3, "NCDHW")


class _Pooling(HybridBlock):
    """`Pooling` (reference `conv_layers.py:_Pooling`); the block is named
    ``pool{n}_``."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": _to_tuple(strides, ndim),
            "pad": _to_tuple(padding, ndim), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return f"{self.__class__.__name__}(size={self._kwargs['kernel']}, " \
               f"stride={self._kwargs['stride']})"


def _pool_class(ndim, pool_type, layout):
    if pool_type == "max":
        def __init__(self, pool_size=(2,) * ndim, strides=None, padding=0,
                     layout=layout, ceil_mode=False, **kwargs):
            _Pooling.__init__(self, _to_tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, "max", **kwargs)
    else:
        def __init__(self, pool_size=(2,) * ndim, strides=None, padding=0,
                     layout=layout, ceil_mode=False, count_include_pad=True,
                     **kwargs):
            _Pooling.__init__(self, _to_tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, "avg",
                              count_include_pad, **kwargs)
    name = f"{pool_type.capitalize()}Pool{ndim}D"
    return type(name, (_Pooling,), {
        "__init__": __init__, "__doc__": f"{ndim}-D {pool_type} pooling "
        f"(reference `conv_layers.py:{name}`)."})


def _global_pool_class(ndim, pool_type, layout):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, pool_type,
                          **kwargs)
    name = f"Global{pool_type.capitalize()}Pool{ndim}D"
    return type(name, (_Pooling,), {
        "__init__": __init__, "__doc__": f"{ndim}-D global {pool_type} "
        f"pooling (reference `conv_layers.py:{name}`)."})


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
MaxPool1D, MaxPool2D, MaxPool3D = (_pool_class(n, "max", _LAYOUTS[n])
                                   for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool_class(n, "avg", _LAYOUTS[n])
                                   for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(n, "max", _LAYOUTS[n]) for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(n, "avg", _LAYOUTS[n]) for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two dims by ``padding`` (an int, or
    the `Pad` op's 8-entry ``pad_width``) (reference `conv_layers.py:281
    ReflectionPad2D`)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
