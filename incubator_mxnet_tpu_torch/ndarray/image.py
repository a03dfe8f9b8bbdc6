"""`mx.nd.image`: the vision transforms' ops (reference
`src/operator/image/image_random.cc`): `to_tensor`, `normalize` and the
flips.

PyTorch port of `incubator_mxnet_tpu/ndarray/image.py`.  The ops run on
the array's own device; datasets and transforms hand them host arrays.
The flips follow the reference, whose image ops take HWC (or NHWC)
images: `flip_left_right` reverses W (axis -2) and `flip_top_bottom` H
(axis -3).  The JAX package reverses axes -1 and -2 whatever the layout,
which on an HWC image reverses the colour channels (ROADMAP Queue 3).  A
2-D (H, W) image flips axes -1 and -2.  The random flips draw one coin
from `random.generator` of the array's device.
"""
from __future__ import annotations

import torch

from .. import random as _random
from .ndarray import NDArray

__all__ = ["to_tensor", "normalize", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom"]


def to_tensor(data):
    """HWC (NHWC) uint8 in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""
    x = data.data.to(torch.float32) / 255.0
    if x.dim() == 3:
        x = x.permute(2, 0, 1)
    elif x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    return NDArray(x.contiguous(), ctx=data.context)


def normalize(data, mean, std):
    """(x - mean) / std per channel of a CHW (NCHW) tensor."""
    x = data.data
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    shape = (-1,) + (1,) * (2 if x.dim() >= 3 else 0)
    return NDArray((x - mean.reshape(shape)) / std.reshape(shape),
                   ctx=data.context)


def _axes(x):
    """(W axis, H axis) of an HWC/NHWC image, or of an (H, W) one."""
    return (-2, -3) if x.dim() >= 3 else (-1, -2)


def flip_left_right(data):
    return NDArray(torch.flip(data.data, (_axes(data.data)[0],)),
                   ctx=data.context)


def flip_top_bottom(data):
    return NDArray(torch.flip(data.data, (_axes(data.data)[1],)),
                   ctx=data.context)


def _coin(data):
    """One fair coin from the device chain of `data`'s device."""
    dev = data.data.device
    return bool(torch.rand((), generator=_random.generator(dev),
                           device=dev) < 0.5)


def random_flip_left_right(data):
    return flip_left_right(data) if _coin(data) else data


def random_flip_top_bottom(data):
    return flip_top_bottom(data) if _coin(data) else data
