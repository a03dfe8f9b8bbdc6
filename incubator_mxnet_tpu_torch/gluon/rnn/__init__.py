"""`gluon.rnn` (reference `python/mxnet/gluon/rnn/`): recurrent cells and
the fused layers over the `RNN` op.  PyTorch port of
`incubator_mxnet_tpu/gluon/rnn/`."""
from .rnn_cell import *
from .rnn_layer import *
