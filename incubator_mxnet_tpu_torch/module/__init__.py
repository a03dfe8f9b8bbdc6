"""`mx.mod`: the classic symbolic training API (reference
`python/mxnet/module/`)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
