"""`gluon.model_zoo` (reference `python/mxnet/gluon/model_zoo/`)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
