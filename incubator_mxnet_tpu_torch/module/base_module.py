"""BaseModule: the classic fit/score/predict loops (reference
`python/mxnet/module/base_module.py`).

PyTorch port of `incubator_mxnet_tpu/module/base_module.py`.  `fit` is the
per-batch loop of the JAX package's `_fit_epochs`: one `fit_step` per
batch (`Module`'s runs the fused train step where it can, else
`forward_backward`, `update` and `update_metric`), the batch-end
callbacks after each, and the elastic checkpoints of `_fit_attempt`
(``checkpoint_dir``, ``checkpoint_period``, ``checkpoint_keep_last``,
``resume``; `checkpoint/`).  The other planes the JAX `fit` wraps around
that loop are not ported (README "Declared divergences"): the fused
step's K-step blocks, the training guardian and its rollback, the h2d
staging ring, the supervisor, the program cache, failover after a lost
server and shrink-and-resume (``max_restarts``, ``mesh``).
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
            monitor=None, checkpoint_dir=None, checkpoint_period=100,
            checkpoint_keep_last=5, resume=False):
        """The classic training loop (reference `base_module.py fit`):
        bind, init_params, init_optimizer, then per epoch one
        `fit_step` and the batch-end callbacks per batch, the epoch-end
        callbacks, and `score` on `eval_data`.

        Elastic checkpoints (`checkpoint/`): with a ``checkpoint_dir``
        the loop snapshots the parameters, aux states, optimizer states,
        iterator position and random streams every ``checkpoint_period``
        processed batches and at each epoch's end, asynchronously,
        keeping the newest ``checkpoint_keep_last``; SIGTERM takes one
        final synchronous snapshot at the next batch boundary and exits
        143.  ``resume=True`` restarts from the newest valid checkpoint
        in that directory, mid-epoch, bit-identical to a run that was
        never stopped; a fresh run refuses a directory that holds
        another run's checkpoints."""
        assert num_epoch is not None, "please specify number of epochs"
        if monitor is not None:
            raise MXNetError("fit: monitors are not ported")
        from ..initializer import Uniform
        ckpt_resume = None
        resume_nbatch = 0
        gstep = 0
        if checkpoint_dir is not None:
            from .. import checkpoint as _ckpt
            if resume:
                path = _ckpt.latest(checkpoint_dir)
                ckpt_resume = _ckpt.load(path) if path is not None else None
            elif _ckpt.latest(checkpoint_dir, deep=False,
                              include_rejected=True) is not None:
                # the old run's higher step numbers would win latest()
                # after this run's first crash, and resume would silently
                # continue the abandoned run
                raise MXNetError(
                    f"checkpoint_dir {checkpoint_dir!r} already holds "
                    "checkpoints from a previous run; pass resume=True to "
                    "continue it, or point a fresh run at a fresh "
                    "directory (or delete the old checkpoints)")
            if ckpt_resume is not None:
                self.logger.info("resuming from %s (step %d, epoch %d, "
                                 "batch %d)", ckpt_resume.path,
                                 ckpt_resume.step, ckpt_resume.epoch,
                                 ckpt_resume.nbatch)
                arg_params, aux_params = _ckpt.state.split_params(
                    ckpt_resume.arrays)
                allow_missing = False
                force_init = True
                begin_epoch = ckpt_resume.epoch
                resume_nbatch = ckpt_resume.nbatch
                gstep = ckpt_resume.step
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        ckpt_mgr = None
        if checkpoint_dir is not None:
            ckpt_mgr = _ckpt.CheckpointManager(
                checkpoint_dir, keep_last=checkpoint_keep_last)
        if ckpt_resume is not None:
            # rebuilds the fused step around the restored optimizer
            _ckpt.state.restore_module_optimizer(
                self, ckpt_resume.blobs.get(_ckpt.state.OPTIMIZER_BLOB))
            _ckpt.state.restore_rng(ckpt_resume.rng)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if ckpt_mgr is not None:
            ckpt_mgr.install_preemption_hook()
        try:
            self._fit_epochs(
                train_data, eval_data, eval_metric, validation_metric,
                epoch_end_callback, batch_end_callback, eval_end_callback,
                eval_batch_end_callback, begin_epoch, num_epoch, ckpt_mgr,
                ckpt_resume, resume_nbatch, gstep, checkpoint_period)
        finally:
            if ckpt_mgr is not None:
                try:
                    ckpt_mgr.flush()
                finally:
                    ckpt_mgr.close()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    ckpt_mgr, ckpt_resume, resume_nbatch, gstep,
                    checkpoint_period):
        last_snap_step = gstep
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            if ckpt_resume is not None and epoch == begin_epoch:
                # continue mid-epoch: the iterator's own order and
                # position where it has them, reset + skip otherwise;
                # the train metric counts from here
                from .. import checkpoint as _ckpt
                _ckpt.state.restore_iterator(
                    train_data,
                    ckpt_resume.blobs.get(_ckpt.state.ITERATOR_BLOB),
                    resume_nbatch)
                nbatch = resume_nbatch
            for data_batch in train_data:
                self.fit_step(data_batch, eval_metric)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
                gstep += 1
                if ckpt_mgr is not None:
                    # batch boundary: parameters and (epoch, nbatch, step)
                    # agree, the only place a snapshot may be taken
                    ckpt_mgr.honor_preemption(
                        lambda: self._elastic_snapshot(
                            ckpt_mgr, train_data, epoch, nbatch, gstep,
                            sync=True, meta={"preempted": True}))
                    if gstep - last_snap_step >= checkpoint_period:
                        self._elastic_snapshot(ckpt_mgr, train_data, epoch,
                                               nbatch, gstep)
                        last_snap_step = gstep
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
            if ckpt_mgr is not None:
                # after the reset, so the next epoch's shuffle order
                # travels with the snapshot
                self._elastic_snapshot(ckpt_mgr, train_data, epoch + 1, 0,
                                       gstep)
                last_snap_step = gstep
                ckpt_mgr.honor_preemption(
                    lambda: self._elastic_snapshot(
                        ckpt_mgr, train_data, epoch + 1, 0, gstep,
                        sync=True, meta={"preempted": True}))

    def _elastic_snapshot(self, mgr, train_data, epoch, nbatch, step,
                          sync=False, meta=None):
        """Stage one elastic checkpoint: device-to-host copies queued on
        the train step's stream, serialization and the atomic commit in
        the background (`checkpoint/`)."""
        from .. import checkpoint as _ckpt
        arrays, blobs, staged = _ckpt.state.capture_module(self,
                                                           train_data)
        meta = dict(meta or {})
        optimizer = getattr(self, "_optimizer", None)
        if optimizer is not None:
            meta["optimizer"] = optimizer.state_dict()
        mgr.snapshot(arrays=arrays, blobs=blobs, step=step, epoch=epoch,
                     nbatch=nbatch, sync=sync, meta=meta, staged=staged)

    # -- properties / abstract -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)
