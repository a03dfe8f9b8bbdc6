"""BaseModule: the classic fit/score/predict loops (reference
`python/mxnet/module/base_module.py`).

PyTorch port of `incubator_mxnet_tpu/module/base_module.py`.  `fit` is the
per-batch loop of the JAX package's `_fit_epochs`: one `fit_step` per
batch (`Module`'s runs the fused train step where it can, else
`forward_backward`, `update` and `update_metric`), the batch-end
callbacks after each.  The planes the JAX `fit` wraps around that loop
are not ported (README "Declared divergences"): the fused step's K-step
blocks, the training guardian, the h2d staging ring, the supervisor,
the program cache and elastic checkpoints (``checkpoint_dir`` raises).
"""
from __future__ import annotations

import logging
import time

import numpy as _np

from ..base import MXNetError
from .. import metric as _metric
from .. import io as _io
from ..model import BatchEndParam
from ..ndarray.ndarray import NDArray, concatenate


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level API --------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit_step(self, data_batch, eval_metric):
        """One training step and its metric update."""
        self.forward_backward(data_batch)
        self.update()
        self.update_metric(eval_metric, data_batch.label)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """The metric over `eval_data` (reference `base_module.py score`)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without pad rows, nbatch, batch) per batch.  A
        batch of another size runs at its own size (the JAX package pads
        it to a compiled bucket instead, to spare XLA a compile)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            yield ([out[0:out.shape[0] - pad] for out in self.get_outputs()],
                   nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Outputs over `eval_data` (an iterator, NDArray or numpy
        array), pad rows dropped (reference `base_module.py predict`)."""
        assert self.binded and self.params_initialized
        if isinstance(eval_data, (NDArray, _np.ndarray)):
            if isinstance(eval_data, _np.ndarray):
                from ..ndarray import array
                from ..context import cpu
                eval_data = array(eval_data, ctx=cpu())
            self.forward(_io.DataBatch([eval_data]), is_train=False)
            return self.get_outputs()[0]
        output_list = [[o.copy() for o in outs] for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            if any(len(out) != num_outputs for out in output_list):
                raise ValueError("Cannot merge batches, as num of outputs "
                                 "is not the same in mini-batches.")
            merged = [concatenate([out[i] for out in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_dir=None):
        """The classic training loop (reference `base_module.py fit`):
        bind, init_params, init_optimizer, then per epoch one
        `fit_step` and the batch-end callbacks per batch, the epoch-end
        callbacks, and `score` on `eval_data`."""
        assert num_epoch is not None, "please specify number of epochs"
        if checkpoint_dir is not None:
            raise MXNetError("fit: elastic checkpoints (checkpoint_dir) are "
                             "not ported; save with epoch_end_callback="
                             "callback.do_checkpoint(prefix)")
        if monitor is not None:
            raise MXNetError("fit: monitors are not ported")
        from ..initializer import Uniform
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.fit_step(data_batch, eval_metric)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # -- properties / abstract -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)
