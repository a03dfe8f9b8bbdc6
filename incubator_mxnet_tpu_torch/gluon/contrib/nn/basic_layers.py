"""Contrib layers (reference `python/mxnet/gluon/contrib/nn/
basic_layers.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py`:
`Concurrent` and `HybridConcurrent` (children on one input, outputs
concatenated), `Identity`, a `SparseEmbedding` that delegates to the
dense `nn.Embedding` (the gradient of a gather is a dense scatter-add
here too), `SyncBatchNorm` at its contrib path and the pixel shuffles
in 1-3 D as reshapes and one transpose over the channel dim.
"""
from __future__ import annotations

from ...block import Block, HybridBlock
from ...nn import (Sequential, HybridSequential, Embedding,
                   SyncBatchNorm as _NnSyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Children on the same input, outputs concatenated along `axis`
    (reference `basic_layers.py:Concurrent`)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable `Concurrent` (reference `basic_layers.py:46`)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """The input, unchanged: the skip branch of a `HybridConcurrent`."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """The reference's sparse-gradient embedding, delegating to the dense
    `nn.Embedding` (reference `basic_layers.py:SparseEmbedding`)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._embed = Embedding(input_dim, output_dim, dtype=dtype,
                                weight_initializer=weight_initializer)
        self.register_child(self._embed)

    def forward(self, x):
        return self._embed(x)


class SyncBatchNorm(_NnSyncBatchNorm):
    """`gluon.nn.SyncBatchNorm` at its contrib path."""


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, dims, **kwargs):
        super().__init__(**kwargs)
        self._factors = ((factor,) * dims if isinstance(factor, int)
                         else tuple(factor))
        if len(self._factors) != dims:
            raise ValueError(f"PixelShuffle{dims}D: {dims} factors "
                             f"expected, got {self._factors}")

    def hybrid_forward(self, F, x):
        f = self._factors
        if len(f) == 1:
            x = F.reshape(x, shape=(0, -4, -1, f[0], 0))     # (N, C, f, W)
            x = F.transpose(x, axes=(0, 1, 3, 2))
            return F.reshape(x, shape=(0, 0, -3))
        if len(f) == 2:
            x = F.reshape(x, shape=(0, -4, -1, f[0] * f[1], 0, 0))
            x = F.reshape(x, shape=(0, 0, -4, f[0], f[1], 0, 0))
            x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
            return F.reshape(x, shape=(0, 0, -3, -3))
        # -4 splits one dim in two: three splits factor the channel dim
        # into (C, f1, f2, f3)
        x = F.reshape(x, shape=(0, -4, -1, f[0] * f[1] * f[2], 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f[0], f[1] * f[2], 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, 0, -4, f[1], f[2], 0, 0, 0))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(x, shape=(0, 0, -3, -3, -3))


class PixelShuffle1D(_PixelShuffle):
    """(N, C*f, W) -> (N, C, W*f)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)
