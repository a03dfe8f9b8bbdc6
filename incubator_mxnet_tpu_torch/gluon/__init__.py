"""Gluon: Blocks composed imperatively or symbolically, and their
training (reference `python/mxnet/gluon/`).

PyTorch port of `incubator_mxnet_tpu/gluon/`: `Parameter` (autograd
leaves with gradient arrays), `Block` (forward hooks, `summary`),
`HybridBlock` (eager on NDArrays, a cached traced graph after
`hybridize()`, composed on Symbols for `Module`), `SymbolBlock`, the
layers of `nn`, `model_zoo` (every JAX family: ResNet, VGG, AlexNet,
DenseNet, Inception v3, MobileNet v1/v2, SqueezeNet), `Trainer`, `loss`
(with `CTCLoss`), `data` (datasets, samplers, `DataLoader`), `utils`,
`contrib` (`nn`, `rnn`, `data` and `estimator.Estimator` with its fused
step, `fused_step`) and `rnn` (the cells and the fused RNN, LSTM and
GRU layers).  `DataLoader(num_workers>0)`, `RecordFileDataset` and the
vision datasets and transforms are not ported yet (README).
"""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
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
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "data", "utils",
           "model_zoo", "fused_step", "contrib", "rnn", "split_and_load"]
