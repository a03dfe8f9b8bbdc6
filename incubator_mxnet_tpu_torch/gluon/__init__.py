"""Gluon: Blocks composed imperatively or symbolically (reference
`python/mxnet/gluon/`).

PyTorch port of the part of `incubator_mxnet_tpu/gluon/` that composes
networks: `Parameter`, `Block`, `HybridBlock`, the layers of `nn` whose
ops are ported, and `model_zoo` (ResNet, VGG).  A network trains through
`Module` on its composed symbol; `Trainer`, `loss`, `data`, `rnn` and
the autograd tape are not ported yet.
"""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError
from .block import Block, HybridBlock
from . import nn
from . import model_zoo

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "nn",
           "model_zoo"]
