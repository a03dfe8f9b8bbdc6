"""SVRG, stochastic variance-reduced gradient training (reference
`python/mxnet/contrib/svrg_optimization/`: `SVRGModule`).

PyTorch port of `incubator_mxnet_tpu/contrib/svrg_optimization.py`.
Every `update_freq` epochs the module keeps the parameters as the
snapshot w_snap and runs one pass over the data for mu, the mean
gradient at w_snap.  Each step then runs the batch twice, at the live
parameters and at w_snap, writes g(w) - g(w_snap) + mu into the
executor's gradient arrays in place (the arrays `Module.update` reads)
and updates.  w_snap and mu stay on the executor's device, and the swap
to w_snap and back copies into the bound parameter and aux tensors in
place, so nothing the executor or K1 holds is rebound and no step goes
through the host.

`fit` is `Module.fit`'s loop: the snapshot is taken at the start of
every `update_freq`-th epoch (`_fit_epoch_begin`) and each batch runs
the SVRG step (`_batch_step`), so callbacks, scoring, a Monitor and
elastic checkpoints work as for any module.  The SVRG step is the
per-batch path: the fused train step and the h2d ring it places are not
built (`_fusable`), and ``resume=True`` is refused, since a checkpoint
holds neither w_snap nor mu.

The JAX class swaps back to a dict that the swap itself overwrote, so
its parameters stay at w_snap after every step (ROADMAP Queue 3); here
the live parameters are copied before the swap and restored.  One
context only, as in the reference: `fit` refuses a kvstore other than
None or ``"local"``, and initializes with ``Uniform(0.01)`` by default.
"""
from __future__ import annotations

from ..base import MXNetError
from ..module import Module

__all__ = ["SVRGModule"]


def _copies(arrays):
    return {k: v.copyto(v.context) for k, v in arrays.items()}


def _write(arrays, values):
    for k, v in arrays.items():
        v._set_data(values[k])


class SVRGModule(Module):
    """A `Module` trained by SVRG (reference `svrg_module.py:SVRGModule`)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, **kwargs)
        if update_freq < 1:
            raise MXNetError("update_freq must be >= 1")
        self.update_freq = update_freq
        self._snap_params = None      # w_snap
        self._mu = None               # the full gradient at w_snap

    def _live(self, kind):
        """{name: the executor's array} of its parameters (``"param"``),
        their gradients (``"grad"``) or its aux states (``"aux"``)."""
        eg = self._exec_group
        names = eg.aux_names if kind == "aux" else eg.param_names
        arrays = getattr(eg, kind + "_arrays")
        return {name: arrays[i][0] for i, name in enumerate(names)}

    def _live_grads(self):
        """{parameter name: its gradient array in the executor}."""
        return self._live("grad")

    def _take_snapshot(self, train_data):
        """w_snap <- w; mu <- the mean over `train_data`'s batches of the
        gradient at w_snap."""
        self._snap_params = _copies(self._live("param"))
        sums = None
        n_batches = 0
        train_data.reset()
        for batch in train_data:
            self.forward_backward(batch)
            grads = self._live_grads()
            if sums is None:
                sums = _copies(grads)
            else:
                for k, g in grads.items():
                    sums[k] += g
            n_batches += 1
        if not n_batches:
            raise MXNetError("SVRG snapshot: train_data yielded no batches")
        self._mu = {k: v / float(n_batches) for k, v in sums.items()}
        train_data.reset()

    def _grad_at_snapshot(self, batch):
        """The gradients of `batch` at w_snap, by value; the parameters
        and aux states are back at their live values afterwards."""
        params, aux = self._live("param"), self._live("aux")
        live, live_aux = _copies(params), _copies(aux)
        _write(params, self._snap_params)
        self.forward_backward(batch)
        snap_grads = _copies(self._live_grads())
        _write(params, live)
        _write(aux, live_aux)
        return snap_grads

    def _fusable(self, kvstore=None):
        # the corrected gradient is written between backward and update
        return False

    def _fit_epoch_begin(self, epoch, train_data):
        if epoch % self.update_freq == 0 or self._mu is None:
            self._take_snapshot(train_data)

    def _batch_step(self, data_batch, eval_metric):
        """One SVRG step: the batch at w and at w_snap, the corrected
        gradient written in place, the update; the metric sees the
        outputs at w."""
        self.forward_backward(data_batch)
        # the live gradients and outputs by value: the pass at the
        # snapshot reuses the executor's arrays
        live = _copies(self._live_grads())
        outputs = [o.copyto(o.context) for o in self.get_outputs()]
        snap = self._grad_at_snapshot(data_batch)
        for k, g in self._live_grads().items():
            g._set_data(live[k] - snap[k] + self._mu[k])
        self.update()
        eval_metric.update(data_batch.label, outputs)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch=None, optimizer="sgd", optimizer_params=None,
            initializer=None, kvstore=None, batch_end_callback=None,
            epoch_end_callback=None, validation_metric=None, **kwargs):
        """`Module.fit` with SVRG steps, in the JAX class's argument
        order; the other keywords of `Module.fit` pass through."""
        if num_epoch is None:
            raise MXNetError("num_epoch required")
        if kvstore not in (None, "local"):
            raise MXNetError("SVRGModule trains on one context (as the "
                             "reference module does); kvstore is not "
                             "supported")
        if kwargs.get("resume"):
            raise MXNetError("SVRGModule cannot resume: a checkpoint holds "
                             "neither the snapshot w_snap nor mu")
        self._mu = None
        super().fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                    num_epoch=num_epoch, optimizer=optimizer,
                    optimizer_params=optimizer_params or
                    (("learning_rate", 0.01),),
                    initializer=initializer, kvstore=None,
                    batch_end_callback=batch_end_callback,
                    epoch_end_callback=epoch_end_callback,
                    validation_metric=validation_metric, **kwargs)
        return self
