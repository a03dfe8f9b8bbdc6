"""The gluon training step in one call, for `Estimator.fit`.

PyTorch port of `GluonFusedStep` in `incubator_mxnet_tpu/gluon/
fused_step.py`, in the manner of `fused.FusedTrainStep` (the Module
side).  The eager loop

    with autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward(); trainer.step(batch_size)

writes every gradient into the parameters' gradient arrays, walks the
tape for them and updates the metric by a second pass over the outputs.
One `GluonFusedStep` call does the same work with less: the net's
forward (eager or hybridized, in training mode, BatchNorm's moving
statistics written into their Parameters as the forward runs) and the
loss under `autograd.record()`, `torch.autograd.grad` of the summed
loss over the
trainer's parameters, the trainer's `Updater.update_multi`
on those gradients (they never land in the gradient arrays), and each
metric's `device_update`, whose totals stay on the device until `get`.
Nothing in a step waits for the device.  The gradients, the update and
the metric are the eager loop's, bitwise, on the same inputs.

The JAX class traces the step into one donated XLA program (and K steps
into one scan); this one runs eagerly, one batch per call.  Capturing it
as a CUDA graph is ROADMAP work (Queue 1, item 6b).

`try_build` declines, and Estimator keeps the eager loop, where the JAX
package's declines: a trainer on more than one context, a parameter of
the net the trainer does not own, a metric without `device_update`, and
a net that draws random numbers (a `Dropout` with a rate above 0; an op
that draws anyway raises during the step).  The trainer's updater holds
the optimizer states, so the fused and the eager step share them.
"""
from __future__ import annotations

import contextlib

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .. import autograd as _autograd
from .. import random as _random

__all__ = ["GluonFusedStep"]


def _draws_random(net):
    from .nn.basic_layers import Dropout
    found = []
    net.apply(lambda b: found.append(b) if isinstance(b, Dropout) and
              b._rate > 0 else None)
    return bool(found)


@contextlib.contextmanager
def _no_rng():
    """Refuse a random draw during the step (reference `fused._no_rng`):
    `try_build` declines nets with Dropout, and this catches any other
    op that draws."""
    def refuse(device):
        raise MXNetError("the gluon fused step cannot run an op that draws "
                         "random numbers")

    draw, _random.generator = _random.generator, refuse
    try:
        yield
    finally:
        _random.generator = draw


class GluonFusedStep:
    """Forward, loss, gradients, update and metric of one batch in one
    call; ``steps`` counts the batches it took."""

    @classmethod
    def try_build(cls, net, loss_fn, trainer, metrics):
        """A step for this net, loss, trainer and metrics, or None where
        the eager loop must run."""
        if trainer is None or len(trainer._contexts) != 1:
            return None
        owned = {p.name for p in trainer._params}
        if not set(net.collect_params().keys()) <= owned:
            return None
        if any(getattr(m, "device_update", None) is None for m in metrics):
            return None
        if _draws_random(net):
            return None
        return cls(net, loss_fn, trainer, metrics)

    def __init__(self, net, loss_fn, trainer, metrics):
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._metrics = list(metrics)
        self._ctx = trainer._contexts[0]
        self._train_params = [p for p in trainer._params
                              if p.grad_req != "null"]
        self._indices = [trainer._param2idx[p.name]
                         for p in self._train_params]
        self._params = list(net.collect_params().values())
        self.steps = 0
        self.last_loss = None
        self.last_outputs = None

    def __call__(self, data, label, batch_size):
        """Run one step on (`data`, `label`); False, having done nothing,
        when it cannot (an input that is not an NDArray, a parameter
        whose deferred shape the first eager forward has to finish)."""
        if not isinstance(data, NDArray) or not isinstance(label, NDArray):
            return False
        if self._params and any(p._data is None for p in self._params):
            return False
        self._params = ()       # every parameter is initialized from here
        trainer, ctx = self._trainer, self._ctx
        trainer._optimizer.rescale_grad = trainer._scale / batch_size
        data, label = data.as_in_context(ctx), label.as_in_context(ctx)
        weights = [p.data(ctx) for p in self._train_params]
        with _autograd.record(), _no_rng():
            out = self._net(data)
            losses = self._loss_fn(out, label)
        loss = losses.data
        grads = torch.autograd.grad(loss, [w.data for w in weights],
                                    torch.ones_like(loss), allow_unused=True)
        trainer._updaters[0].update_multi(
            self._indices,
            [NDArray(torch.zeros_like(w.data) if g is None else g, ctx=ctx)
             for w, g in zip(weights, grads)], weights)
        outputs = out.detach()
        for m in self._metrics:
            m._accumulate(*m.device_update([label], [outputs]))
        self.steps += 1
        self.last_loss = losses.detach()
        self.last_outputs = outputs
        return True

