"""`gluon.contrib` (reference `python/mxnet/gluon/contrib/`): `nn`
(concurrent containers, `Identity`, `SparseEmbedding`, `SyncBatchNorm`,
pixel shuffles), `rnn` (convolutional cells, `VariationalDropoutCell`,
`LSTMPCell`), `data` (`IntervalSampler`) and the `Estimator` training
loop."""
from . import data, estimator, nn, rnn  # noqa: F401
from .estimator import Estimator  # noqa: F401
