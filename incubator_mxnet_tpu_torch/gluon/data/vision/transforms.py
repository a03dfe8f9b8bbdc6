"""Vision transforms (reference `python/mxnet/gluon/data/vision/
transforms.py`), over `nd.image` and the augmenters' primitives of
`image.py`.

PyTorch port of `incubator_mxnet_tpu/gluon/data/vision/transforms.py`:
the same 13 classes, each taking and returning host NDArrays.  The
random transforms draw as the JAX package draws: `RandomResizedCrop`
and the jitters from Python's `random`, in the same order, so a seeded
pipeline in one thread gives the JAX package's pixels; the flips one
coin from the framework's generator (`nd.image`).  The flips mirror an
HWC image's width (height), as the reference does.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from .... import image as _img
from ....context import cpu
from ....ndarray import image as _nd_image
from ....ndarray.ndarray import array
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation"]


def _pair(size):
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


class Compose(Sequential):
    """Transforms applied in order (reference `transforms.py:Compose`)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """The image in `dtype`."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(Block):
    """HWC uint8 -> CHW float32 in [0, 1] (`nd.image.to_tensor`)."""

    def forward(self, x):
        return _nd_image.to_tensor(x)


class Normalize(Block):
    """(x - mean) / std per channel of a CHW tensor."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def forward(self, x):
        return _nd_image.normalize(x, self._mean, self._std)


class Resize(Block):
    """To `size` (w, h), or the shorter edge to min(size) with
    `keep_ratio`; bilinear, as `image._resize_np` resizes."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = _pair(size)
        self._keep = keep_ratio

    def forward(self, x):
        img = x.asnumpy()
        if self._keep:
            return _img.resize_short(img, min(self._size))
        return array(_img._resize_np(img, self._size[0], self._size[1]),
                     ctx=cpu(), dtype="uint8" if img.dtype == np.uint8
                     else "float32")


class CenterCrop(Block):
    """The centred (w, h) crop, resized up where the image is smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = _pair(size)

    def forward(self, x):
        return _img.center_crop(x, self._size)[0]


class RandomResizedCrop(Block):
    """A crop of random area share and aspect ratio, resized to `size`
    (`image.random_size_crop`)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4., 4 / 3.),
                 interpolation=1):
        super().__init__()
        self._size = _pair(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        return _img.random_size_crop(x, self._size, self._scale,
                                     self._ratio)[0]


class RandomFlipLeftRight(HybridBlock):
    def hybrid_forward(self, F, x):
        return _nd_image.random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def hybrid_forward(self, F, x):
        return _nd_image.random_flip_top_bottom(x)


class _RandomJitter(Block):
    def __init__(self, jitter):
        super().__init__()
        self._jitter = jitter

    def _alpha(self):
        return 1.0 + _pyrandom.uniform(-self._jitter, self._jitter)


def _clipped(arr):
    return array(np.clip(arr, 0, 255), ctx=cpu(), dtype="float32")


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return _clipped(x.asnumpy().astype("float32") * self._alpha())


class RandomContrast(_RandomJitter):
    def forward(self, x):
        arr = x.asnumpy().astype("float32")
        mean = arr.mean()
        return _clipped(mean + (arr - mean) * self._alpha())


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        arr = x.asnumpy().astype("float32")
        gray = arr.mean(axis=-1, keepdims=True)
        return _clipped(gray + (arr - gray) * self._alpha())
