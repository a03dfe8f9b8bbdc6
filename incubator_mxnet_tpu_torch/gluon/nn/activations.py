"""Activation blocks (reference `python/mxnet/gluon/nn/activations.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/nn/activations.py`:
`Activation` over the `Activation` op; `LeakyReLU`, `PReLU` (a learned
slope, ``alpha``), `ELU`, `SELU` and `GELU` (exact, through erf) over the
`LeakyReLU` op; `Swish` as ``x * sigmoid(beta * x)``.  Node names are
the JAX package's (``fwd``, none for `ELU`), so composed graphs match.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


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


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """`LeakyReLU` with a learned slope ``alpha`` of shape (1,), 0.25 at
    first (reference `activations.py:PReLU`)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` below 0."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU with the self-normalising constants."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class GELU(HybridBlock):
    """``x * Phi(x)``, exact (erf)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
