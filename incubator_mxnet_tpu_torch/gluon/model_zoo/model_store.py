"""Pretrained weights (reference `model_zoo/model_store.py`).

The port downloads nothing and reads no file outside its checkout, so
every model-zoo network is built with random weights: `get_model_file`
raises for every name.  Load a `.params` file with `load_parameters`
instead.
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["get_model_file"]


def get_model_file(name, root=None):
    raise MXNetError(f"{name}: pretrained weights are not available "
                     "(nothing is downloaded); build with pretrained=False "
                     "and load_parameters from a file")
