"""`gluon.data.vision` (reference `python/mxnet/gluon/data/vision/`): the
vision datasets and `transforms`."""
from .datasets import *  # noqa: F401,F403
from .datasets import __all__ as _datasets_all
from . import transforms

__all__ = list(_datasets_all) + ["transforms"]
