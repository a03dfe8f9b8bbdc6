"""VGG 11/13/16/19 as a Symbol (reference
`python/mxnet/gluon/model_zoo/vision/vgg.py`).

`vgg_symbol` builds the graph that the JAX package's gluon
``VGG(...)(sym.var("data"))`` produces — the same node sequence, op
attributes, node names (gluon names every traced op ``fwd``) and
parameter names and attributes — without a gluon layer, which the port
does not carry yet.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError

__all__ = ["vgg_symbol", "vgg_spec"]

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def _param(name, shape):
    # gluon's Parameter.var(): deferred dims are 0 until the first input
    return sym.var(name, shape=shape, dtype="float32", lr_mult=1.0,
                   wd_mult=1.0)


def _dense(x, prefix, i, units, relu):
    w = _param(f"{prefix}dense{i}_weight", (units, 0))
    b = _param(f"{prefix}dense{i}_bias", (units,))
    x = sym.FullyConnected(x, w, b, num_hidden=units, no_bias=False,
                           flatten=True, name="fwd")
    return sym.Activation(x, act_type="relu", name="fwd") if relu else x


def vgg_symbol(num_layers, classes=1000, batch_norm=False, prefix="vgg0_"):
    """The VGG-`num_layers` inference graph over ``data`` (N, 3, H, W)."""
    if batch_norm:
        raise MXNetError("vgg_symbol: batch_norm=True needs BatchNorm, "
                         "which the port does not carry yet")
    layers, filters = vgg_spec[num_layers]
    x = sym.var("data")
    conv = 0
    for num, nf in zip(layers, filters):
        for _ in range(num):
            w = _param(f"{prefix}conv2d{conv}_weight", (nf, 0, 3, 3))
            b = _param(f"{prefix}conv2d{conv}_bias", (nf,))
            x = sym.Convolution(x, w, b, kernel=(3, 3), stride=(1, 1),
                                dilate=(1, 1), pad=(1, 1), num_filter=nf,
                                num_group=1, no_bias=False, layout="NCHW",
                                name="fwd")
            x = sym.Activation(x, act_type="relu", name="fwd")
            conv += 1
        x = sym.Pooling(x, kernel=(2, 2), pool_type="max", global_pool=False,
                        pooling_convention="valid", stride=(2, 2),
                        pad=(0, 0), name="fwd")
    for i in range(2):
        x = _dense(x, prefix, i, 4096, relu=True)
        x = sym.Dropout(x, p=0.5, axes=(), name="fwd")
    return _dense(x, prefix, 2, classes, relu=False)
