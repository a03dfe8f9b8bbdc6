"""Activation blocks (reference `python/mxnet/gluon/nn/activations.py`).

PyTorch port of `Activation` from `incubator_mxnet_tpu/gluon/nn/
activations.py`; the blocks over `LeakyReLU` and `sigmoid` wait for
those ops.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """``act_type`` of the `Activation` op; the block is named after it
    (``relu0_``)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return f"Activation({self._act_type})"
