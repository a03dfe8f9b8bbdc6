"""Estimator: the event-driven gluon training loop (reference
`python/mxnet/gluon/contrib/estimator/estimator.py`, `event_handler.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/contrib/estimator.py`.  The
loop is the JAX package's: per batch, the fused gluon step
(`gluon.fused_step.GluonFusedStep`, on by default, ``MXNET_FUSED_TRAIN_
STEP=0`` turns it off) where it can take the batch, else the eager
``record`` / ``backward`` / ``trainer.step`` / metric update; every
cross-cutting concern (logging, checkpoints, early stopping) is an
`EventHandler` called at train, epoch and batch begin and end.  Batches
move to the net's context first.  `checkpoint.ElasticCheckpointHandler`
resumes a fit mid-epoch (it sets ``_epochs_done``, ``_resume_batches``
and ``_resume_total_epochs`` in ``train_begin``).  The JAX package's
K-batch blocks (``MXNET_FUSED_STEP_BLOCK``) and its h2d staging ring are
not ported: every batch is one call.
"""
from __future__ import annotations

import copy
import logging
import os
import time

from ...base import MXNetError

__all__ = ["Estimator", "EventHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "StopTraining"]


class StopTraining(Exception):
    """Raised by handlers (early stopping) to end fit() cleanly."""


class EventHandler:
    def train_begin(self, estimator):
        pass

    def epoch_begin(self, estimator):
        pass

    def batch_begin(self, estimator):
        pass

    def batch_end(self, estimator):
        pass

    def epoch_end(self, estimator):
        pass

    def train_end(self, estimator):
        pass


def _metric_items(metric):
    names, vals = metric.get()
    if not isinstance(names, list):
        names, vals = [names], [vals]
    return list(zip(names, vals))


class LoggingHandler(EventHandler):
    """Per-epoch (and optionally per-N-batches) metric logging
    (reference `event_handler.py:LoggingHandler`)."""

    def __init__(self, log_interval="epoch", logger=None):
        self.log_interval = log_interval
        self.logger = logger or logging.getLogger("Estimator")

    def train_begin(self, est):
        self._t0 = time.time()

    def batch_end(self, est):
        if self.log_interval == "epoch" or \
                est.batch_idx % self.log_interval:
            return
        msg = " ".join(f"{n}={v:.6f}" for m in est.train_metrics
                       for n, v in _metric_items(m))
        self.logger.info("[epoch %d][batch %d] %s", est.epoch,
                         est.batch_idx, msg)

    def epoch_end(self, est):
        parts = [f"train_{n}={v:.6f}" for m in est.train_metrics
                 for n, v in _metric_items(m)]
        parts += [f"val_{n}={v:.6f}" for m in est.val_metrics
                  for n, v in _metric_items(m)]
        self.logger.info("[epoch %d] %s time=%.1fs", est.epoch,
                         " ".join(parts), time.time() - self._t0)


class CheckpointHandler(EventHandler):
    """Save parameters each epoch; keep the best by a monitored metric
    (reference `event_handler.py:CheckpointHandler`).

    Parameters only."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.best = float("inf") if mode == "min" else -float("inf")
        self.mode = mode
        os.makedirs(model_dir, exist_ok=True)

    def epoch_end(self, est):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-epoch{est.epoch}.params")
        est.net.save_parameters(path)
        if self.save_best and self.monitor is not None:
            val = _metric_value(est, self.monitor)
            better = val < self.best if self.mode == "min" else \
                val > self.best
            if better:
                self.best = val
                est.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(EventHandler):
    """Stop when the monitored metric stops improving (reference
    `event_handler.py:EarlyStoppingHandler`)."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf") if mode == "min" else -float("inf")
        self.waited = 0

    def epoch_end(self, est):
        val = _metric_value(est, self.monitor)
        improved = (val < self.best - self.min_delta if self.mode == "min"
                    else val > self.best + self.min_delta)
        if improved:
            self.best = val
            self.waited = 0
        else:
            self.waited += 1
            if self.waited >= self.patience:
                raise StopTraining(
                    f"early stop: {self.monitor} plateaued at {self.best}")


def _metric_value(est, name):
    # prefer validation, but a never-updated val metric (no val_data)
    # reports nan and must not shadow the train metric of the same name
    candidates = []
    for m in list(est.val_metrics) + list(est.train_metrics):
        for n, v in _metric_items(m):
            if n == name:
                candidates.append(v)
    for v in candidates:
        if v == v:                       # not nan
            return v
    if candidates:
        return candidates[0]
    raise MXNetError(f"EarlyStopping/Checkpoint: metric {name!r} not found")


class Estimator:
    """Fit a gluon net with event handlers (reference
    `estimator.py:Estimator`)."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        from ... import metric as metric_mod
        self.net = net
        self.loss = loss
        metrics = train_metrics if train_metrics is not None \
            else [metric_mod.Accuracy()]
        if not isinstance(metrics, (list, tuple)):
            metrics = [metrics]
        self.train_metrics = list(metrics)
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        for m in self.val_metrics:
            m.reset()
        self.trainer = trainer
        self.context = context
        self.epoch = 0
        self.batch_idx = 0
        self._epochs_done = 0
        self._resume_batches = 0  # set by checkpoint.ElasticCheckpointHandler
        self._fused = None

    def _ctx(self):
        if self.context is not None:
            return self.context
        params = list(self.net.collect_params().values())
        return params[0].list_ctx()[0] if params else None

    def _place(self, data, label):
        """The batch on the net's context (the reference's
        split_and_load, for one context)."""
        ctx = self._ctx()
        if ctx is not None:
            data = data.as_in_context(ctx)
            label = label.as_in_context(ctx)
        return data, label

    def evaluate(self, val_data):
        """Update the validation metrics over `val_data` (predict mode)."""
        for m in self.val_metrics:
            m.reset()
        for data, label in val_data:
            data, label = self._place(data, label)
            out = self.net(data)
            for m in self.val_metrics:
                m.update([label], [out])
        return self.val_metrics

    def _fused_step(self):
        """The fused step for the current trainer, loss and metrics, or
        None where the eager loop runs."""
        from ... import config as _config
        fused = self._fused
        if fused is not None and (
                fused._trainer is not self.trainer or
                fused._loss_fn is not self.loss or
                fused._metrics != list(self.train_metrics)):
            fused = self._fused = None   # trainer/loss/metrics replaced
        if not _config.get("MXNET_FUSED_TRAIN_STEP"):
            return None
        if fused is None:
            from ..fused_step import GluonFusedStep
            fused = self._fused = GluonFusedStep.try_build(
                self.net, self.loss, self.trainer, self.train_metrics)
        return fused

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None):
        """Train for `epochs` passes over `train_data` ((data, label)
        pairs), firing `event_handlers` (default: a `LoggingHandler`)."""
        from ... import autograd
        if self.trainer is None:
            from ..trainer import Trainer
            self.trainer = Trainer(self.net.collect_params(), "sgd",
                                   {"learning_rate": 0.01})
        fused = self._fused_step()
        handlers = list(event_handlers or [LoggingHandler()])
        try:
            for h in handlers:
                h.train_begin(self)
            end_epoch = self._epochs_done + epochs
            if getattr(self, "_resume_total_epochs", False):
                # a resumed run relaunches the same command: `epochs` is
                # the total, not more epochs on top of the restored ones
                self._resume_total_epochs = False
                end_epoch = max(epochs, self._epochs_done)
            for self.epoch in range(self._epochs_done, end_epoch):
                for m in self.train_metrics:
                    m.reset()
                for h in handlers:
                    h.epoch_begin(self)
                self.batch_idx = 0
                data_iter = iter(train_data)
                # mid-epoch resume: skip the batches the restored state
                # already trained on
                skip, self._resume_batches = int(self._resume_batches), 0
                for _ in range(skip):
                    if next(data_iter, None) is None:
                        break
                    self.batch_idx += 1
                for data, label in data_iter:
                    data, label = self._place(data, label)
                    for h in handlers:
                        h.batch_begin(self)
                    if fused is None or not fused(data, label,
                                                  data.shape[0]):
                        with autograd.record():
                            out = self.net(data)
                            loss = self.loss(out, label)
                        loss.backward()
                        self.trainer.step(data.shape[0])
                        for m in self.train_metrics:
                            m.update([label], [out])
                    for h in handlers:
                        h.batch_end(self)
                    self.batch_idx += 1
                if val_data is not None:
                    self.evaluate(val_data)
                self._epochs_done = self.epoch + 1
                for h in handlers:
                    h.epoch_end(self)
        except StopTraining as e:
            logging.getLogger("Estimator").info(str(e))
        for h in handlers:
            h.train_end(self)
        return self
