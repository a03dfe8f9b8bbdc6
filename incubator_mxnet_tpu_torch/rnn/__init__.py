"""Legacy symbolic RNN API (reference `python/mxnet/rnn/`): cell classes
that unroll into Symbol graphs, plus `BucketSentenceIter` for
variable-length corpora (`example/rnn/bucketing`).  PyTorch port of
`incubator_mxnet_tpu/rnn/`."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter", "encode_sentences"]
