"""Operator registry and the ops the port carries so far."""
from . import registry
from . import nn, matrix, elemwise  # noqa: F401  (registration side effects)

__all__ = ["registry"]
