"""`gluon.contrib` (reference `python/mxnet/gluon/contrib/`): the
`Estimator` training loop."""
from . import estimator  # noqa: F401
from .estimator import Estimator  # noqa: F401
