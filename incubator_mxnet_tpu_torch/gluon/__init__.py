"""Gluon: Blocks composed imperatively or symbolically, and their
training (reference `python/mxnet/gluon/`).

PyTorch port of `incubator_mxnet_tpu/gluon/`: `Parameter` (autograd
leaves with gradient arrays), `Block`, `HybridBlock` (eager on NDArrays,
a cached traced graph after `hybridize()`, composed on Symbols for
`Module`), the layers of `nn` whose ops are ported, `model_zoo`
(ResNet, VGG), `Trainer`, `loss`, `data` (datasets, samplers,
`DataLoader`), `utils` and `contrib.estimator.Estimator` with its fused
step (`fused_step`) and `rnn` (the cells and the fused RNN, LSTM and GRU
layers).  `contrib.rnn`, `SymbolBlock`, `CTCLoss` and the vision datasets
are not ported yet.
"""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError
from .block import Block, HybridBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from . import fused_step
from . import contrib
from . import rnn
from .utils import split_and_load

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "Trainer",
           "nn", "loss", "data", "utils", "model_zoo", "fused_step",
           "contrib", "rnn", "split_and_load"]
