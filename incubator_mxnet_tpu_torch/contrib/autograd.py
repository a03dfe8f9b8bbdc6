"""The pre-1.0 autograd surface (reference `python/mxnet/contrib/
autograd.py`), kept for old scripts: aliases over `mx.autograd`.

PyTorch port of `incubator_mxnet_tpu/contrib/autograd.py`.
"""
from __future__ import annotations

from .. import autograd as _ag
from ..autograd import backward, grad, mark_variables, pause, record

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "grad", "compute_gradient"]


def set_is_training(is_train):
    """Turn recording and training mode on or off together; returns the
    previous recording state."""
    prev = _ag.set_recording(is_train)
    _ag.set_training(is_train)
    return prev


def train_section():
    """The old name of ``autograd.record()``."""
    return record(train_mode=True)


def test_section():
    """The old name of ``autograd.pause()``."""
    return pause(train_mode=False)


def compute_gradient(outputs):
    """Backward from `outputs`; the gradient array of each (None where
    it has none)."""
    backward(outputs)
    return [getattr(o, "grad", None) for o in outputs]
