"""`gluon.contrib.nn` (reference `python/mxnet/gluon/contrib/nn/`)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm, PixelShuffle1D,
                           PixelShuffle2D, PixelShuffle3D)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]
