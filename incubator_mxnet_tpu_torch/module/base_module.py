"""BaseModule: the classic fit/score/predict loops (reference
`python/mxnet/module/base_module.py`).

PyTorch port of `incubator_mxnet_tpu/module/base_module.py`.  `fit` is the
per-batch loop of the JAX package's `_fit_epochs`: one `fit_step` per
batch (`Module`'s runs the fused train step where it can, else
`_batch_step`: `forward_backward`, `update` and `update_metric`), the
batch-end callbacks after each (with a ``monitor``, `Monitor.tic`,
`_batch_step` and `Monitor.toc_print` instead, as the JAX loop, so the
monitor sees every forward's outputs), `_fit_epoch_begin` before each
epoch, the elastic checkpoints of `_fit_attempt` (``checkpoint_dir``,
``checkpoint_period``, ``checkpoint_keep_last``, ``resume``;
`checkpoint/`; under a ``dist_*`` kvstore a rank other than 0 publishes
only its rank-local state into ``rank-shards/``), the h2d staging ring
around the training iterator (`_wrap_io_ring`, ``MXNET_IO_RING``), and
the training guardian (`resilience.guardian`, ``MXNET_GUARDIAN``, on by
default): skip-batch on a step that is not finite, quarantined positions
skipped, a forced poll and a ``health`` stamp at every snapshot, and
`fit`'s restart loop, which rolls back to the newest healthy checkpoint
after a loss spike.  The same loop fails over (``max_restarts``,
``MXNET_FIT_MAX_RESTARTS``): a lost parameter server (`ServerLostError`)
restarts the fit from the last checkpoint against its replacement, and a
lost host (`CollectiveTimeoutError` from the supervisor's watchdog)
shrinks the pod first, as in the JAX package.  A multi-worker dist fit
runs under a `resilience.supervisor.JobSupervisor` (``MXNET_SUPERVISOR``):
heartbeats, the hung-collective watchdog, stragglers; the ``host.step``
fault site fires before each step.  Not ported (README "Declared
divergences"): the fused step's K-step blocks, the program cache and its
``programs/`` payload.  ``mesh=`` lays a mesh over the module's contexts
(`Module.init_optimizer`).
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
        self._supervisor = None   # the JobSupervisor of the last dist fit

    # -- high-level API --------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def fit_step(self, data_batch, eval_metric):
        """One training step and its metric update."""
        self._batch_step(data_batch, eval_metric)

    def _batch_step(self, data_batch, eval_metric):
        """One step on the per-batch path (forward_backward, update, the
        metric): `fit_step`'s fallback, and the step a Monitor watches."""
        self.forward_backward(data_batch)
        self.update()
        self.update_metric(eval_metric, data_batch.label)

    def _fit_epoch_begin(self, epoch, train_data):
        """Called by `fit` before each epoch's first batch (nothing here;
        `SVRGModule` takes its snapshot)."""

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

    def _infer_buckets(self, eval_data):
        """The batch sizes an inference batch pads up to: the iterator's
        batch size and the bound batch (JAX `base_module.py:109`)."""
        buckets = set()
        bs = getattr(eval_data, "batch_size", 0) or 0
        if bs:
            buckets.add(int(bs))
        shapes = getattr(self, "_data_shapes", None) if self.binded else None
        if shapes:
            d = shapes[0]
            shape = d.shape if hasattr(d, "shape") else d[1]
            if shape:
                buckets.add(int(shape[0]))
        return sorted(buckets)

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without pad rows, nbatch, batch) per batch.  A
        ragged final batch is padded up to the iterator's (or the bound)
        batch size first (`io.pad_to_bucket`), so it runs on the bound
        executor: no rebind, no second executor."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        buckets = self._infer_buckets(eval_data)
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            if buckets:
                eval_batch = _io.pad_to_bucket(eval_batch, buckets)
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
            checkpoint_keep_last=5, resume=False, max_restarts=None,
            mesh=None):
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
        another run's checkpoints.

        Training guardian (`resilience.guardian`, ``MXNET_GUARDIAN``):
        the fused step computes a health word on the device and refuses
        a step that is not finite (skip-batch, its position
        quarantined); a diagnosed loss spike makes this loop restore the
        newest checkpoint stamped healthy at or before the last
        in-bounds step, replay from there and skip the quarantined
        window (rollback); past the failure or rollback budget a
        `TrainingDivergedError` names the step, the signal and the data
        shard.

        Failover: a distributed run that loses a parameter server for
        good (`ServerLostError`) restarts from the last committed
        checkpoint against the replacement at the same address, at most
        ``max_restarts`` times (``MXNET_FIT_MAX_RESTARTS``); without a
        ``checkpoint_dir`` or budget the error propagates.  A multi-worker
        dist fit runs under a `JobSupervisor`; a lost host surfaces as a
        `CollectiveTimeoutError` naming it, and the survivors shrink the
        pod (the epoch-fenced barrier), adopt their new dense ranks and
        restart from the last checkpoint at the smaller world size.  The
        guardian's rollbacks have their own budget."""
        import os as _os
        from ..resilience import ServerLostError, CollectiveTimeoutError
        from ..resilience import guardian as _guardian_mod
        if max_restarts is None:
            from .. import config as _config
            max_restarts = int(_config.get("MXNET_FIT_MAX_RESTARTS"))
        failed_over = False
        self._guardian = _guardian_mod.TrainingGuardian.maybe_create(
            checkpoint_dir, logger=self.logger)
        # every attempt gets these; the restart loop flips only the
        # resume and force flags
        fixed = dict(
            eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=optimizer, optimizer_params=optimizer_params,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            begin_epoch=begin_epoch, num_epoch=num_epoch,
            validation_metric=validation_metric, monitor=monitor,
            checkpoint_dir=checkpoint_dir,
            checkpoint_period=checkpoint_period,
            checkpoint_keep_last=checkpoint_keep_last)
        if mesh is not None:
            fixed["mesh"] = mesh
        while True:
            try:
                return self._fit_attempt(
                    train_data, force_rebind=force_rebind,
                    force_init=force_init, resume=resume, **fixed)
            except _guardian_mod.RollbackRequested as e:
                # a loss spike's update was applied: restore the newest
                # healthy checkpoint at or before the last in-bounds step
                # (the guardian's pending_rollback_step bounds the pick)
                # and replay; the spike window is quarantined, so the
                # resumed attempt skips it.  The guardian budgets these.
                if checkpoint_dir is None or self._guardian is None:
                    raise
                self.logger.warning(
                    "fit: %s — restarting from the last healthy "
                    "checkpoint in %r", e, checkpoint_dir)
                self._teardown_kvstore()
                resume = True
                force_rebind = True
                force_init = True
            except (ServerLostError, CollectiveTimeoutError,
                    ConnectionError, EOFError, TimeoutError) as e:
                # a raw connection error is recoverable only in a
                # restart's re-init (the handshake with the replacement
                # server); on a first attempt it is a configuration error
                if not isinstance(e, (ServerLostError,
                                      CollectiveTimeoutError)) \
                        and not failed_over:
                    raise
                if checkpoint_dir is None or max_restarts <= 0:
                    raise
                if not isinstance(kvstore, str):
                    # a caller's kvstore instance cannot be rebuilt
                    raise
                if isinstance(e, CollectiveTimeoutError):
                    # a host is gone: the survivors agree on the smaller
                    # world first (the epoch-fenced shrink barrier), then
                    # this worker adopts its new dense rank and epoch; the
                    # coordinator reset its store at the commit, so the
                    # resumed attempt re-inits it from the checkpoint
                    if getattr(self, "_supervisor", None) is None:
                        raise
                    try:
                        shrink = self._supervisor.shrink(reason=str(e))
                    except Exception as shrink_exc:
                        self.logger.error(
                            "fit: shrink barrier failed (%s) after %s",
                            shrink_exc, e)
                        raise e from shrink_exc
                    self.logger.warning(
                        "fit: %s — pod shrunk to world_size=%d at epoch "
                        "%d (this worker: rank %d -> %d)", e,
                        shrink.world_size, shrink.epoch,
                        self._supervisor.rank, shrink.rank)
                    self._last_shrink = shrink
                    _os.environ["DMLC_RANK"] = str(shrink.rank)
                    _os.environ["DMLC_NUM_WORKER"] = str(shrink.world_size)
                    _os.environ["MXNET_SUPERVISOR_EPOCH"] = \
                        str(shrink.epoch)
                    self._supervisor = None
                    # the old process group spans the dead host: forget it
                    # so the restarted store's collective plane forms anew
                    # at the surviving world size, on the new epoch's port
                    from ..dist import collective as _collective
                    _collective.shutdown()
                max_restarts -= 1
                failed_over = True
                self.logger.warning(
                    "fit: %s — restarting from the last checkpoint in %r "
                    "(%d restart(s) remaining)", e, checkpoint_dir,
                    max_restarts)
                self._teardown_kvstore()
                # the next attempt resumes this run's checkpoints (where
                # one exists its parameters win); the caller's arg_params
                # stay as the fallback for a crash before the first commit
                resume = True
                force_rebind = True
                force_init = True

    def _start_supervisor(self):
        """A started `JobSupervisor` for a multi-worker dist fit (also
        kept on ``self._supervisor`` for the restart loop's shrink
        barrier), activated so the kvstore's exchanges run under its
        watchdog; None for one process, a non-dist store, with
        ``MXNET_SUPERVISOR=0``, or when it cannot start (the fit then
        runs unsupervised)."""
        self._supervisor = None
        kv = getattr(self, "_kvstore", None)
        if kv is None or getattr(kv, "num_workers", 1) <= 1 or \
                not hasattr(kv, "_chan"):
            return None
        from .. import config as _config
        if not _config.get("MXNET_SUPERVISOR"):
            return None
        from ..resilience import supervisor as _sup_mod
        try:
            sup = _sup_mod.JobSupervisor.for_kvstore(kv).start()
        except Exception as e:
            self.logger.warning(
                "supervisor unavailable (%s); continuing unsupervised",
                str(e)[:200])
            return None
        _sup_mod.activate(sup)
        self._supervisor = sup
        return sup

    def _teardown_kvstore(self):
        """Drop the kvstore so the next `init_optimizer` builds a fresh
        one (the restart path).  A dist store's channels close without
        the protocol's 'stop': this worker restarts, it does not leave."""
        kv = getattr(self, "_kvstore", None)
        if kv is not None:
            try:
                if hasattr(kv, "_chans"):
                    kv.close(send_stop=False)
                elif hasattr(kv, "close"):
                    kv.close()
            except Exception:   # noqa: BLE001 - a dead store is expected
                pass
        self._kvstore = None
        self.optimizer_initialized = False

    def _fit_attempt(self, train_data, eval_data=None, eval_metric="acc",
                     epoch_end_callback=None, batch_end_callback=None,
                     kvstore="local", optimizer="sgd",
                     optimizer_params=(("learning_rate", 0.01),),
                     eval_end_callback=None, eval_batch_end_callback=None,
                     initializer=None, arg_params=None, aux_params=None,
                     allow_missing=False, force_rebind=False,
                     force_init=False, begin_epoch=0, num_epoch=None,
                     validation_metric=None, monitor=None,
                     checkpoint_dir=None, checkpoint_period=100,
                     checkpoint_keep_last=5, resume=False, **mesh):
        """One fit attempt; `RollbackRequested` propagates to `fit`'s
        restart loop with the checkpoint manager flushed and closed.
        ``mesh=``, when given, goes to `init_optimizer`."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform
        guardian = getattr(self, "_guardian", None)
        ckpt_resume = None
        resume_nbatch = 0
        gstep = 0
        if checkpoint_dir is not None:
            from .. import checkpoint as _ckpt
            if resume:
                if guardian is not None and \
                        guardian.pending_rollback_step is not None:
                    # rollback: newer checkpoints may carry the spike's
                    # damage, so pick by health stamp AND the last
                    # in-bounds step
                    path = _ckpt.latest_healthy(
                        checkpoint_dir,
                        max_step=guardian.pending_rollback_step)
                else:
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
        if ckpt_resume is not None:
            # a BucketingModule binds the buckets the snapshot had bound
            self._restore_checkpoint_layout(ckpt_resume)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params, **mesh)
        sup = self._start_supervisor()
        if monitor is not None:
            self.install_monitor(monitor)
        ckpt_mgr = None
        if checkpoint_dir is not None:
            # the dist layout: the kvstore names this process's rank;
            # rank 0 owns the parameters, the manifest and retention, the
            # other ranks publish side shards only
            kv = getattr(self, "_kvstore", None)
            rank = getattr(kv, "rank", 0) if kv is not None else 0
            num_ranks = getattr(kv, "num_workers", 1) if kv is not None \
                else 1
            ckpt_mgr = _ckpt.CheckpointManager(
                checkpoint_dir, keep_last=checkpoint_keep_last,
                rank=rank, num_ranks=num_ranks)
            if ckpt_resume is not None and rank != 0:
                # this worker's own iterator position and random streams
                # live in its shard; rank 0's must not stand in for them
                # (no shard: the manifest's nbatch alone)
                ckpt_resume.blobs.pop(_ckpt.state.ITERATOR_BLOB, None)
                ckpt_resume.rng = None
                shard = ckpt_resume.rank_shard(rank)
                if shard is not None:
                    ckpt_resume.blobs.update(shard.get("blobs") or {})
                    ckpt_resume.rng = shard.get("rng")
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
        # after init_optimizer (and the restore, which may rebuild the
        # fused step): the step's placement binds the ring
        train_data, io_ring = self._wrap_io_ring(train_data)
        if guardian is not None:
            if guardian.pending_rollback_step is not None:
                # the restore landed (or no healthy checkpoint existed and
                # this attempt starts from the caller's parameters)
                guardian.rollback_committed(
                    ckpt_resume.step if ckpt_resume is not None else 0)
            # after every path that rebuilds the fused step
            guardian.attach(self)
            guardian.attach_iterator(train_data)
        from ..resilience import CollectiveTimeoutError, ServerLostError
        lost = False
        try:
            self._fit_epochs(
                train_data, eval_data, eval_metric, validation_metric,
                epoch_end_callback, batch_end_callback, eval_end_callback,
                eval_batch_end_callback, begin_epoch, num_epoch, ckpt_mgr,
                ckpt_resume, resume_nbatch, gstep, checkpoint_period,
                monitor)
        except (ServerLostError, CollectiveTimeoutError):
            lost = True   # no deferred flush error may mask the failover
            raise
        finally:
            if io_ring is not None:
                # stop the feeder and drop the read-ahead; the inner
                # iterator stays usable for the caller
                io_ring._pause()
            if sup is not None:
                # stop the heartbeats but keep self._supervisor: the
                # restart loop's shrink barrier needs its identity and
                # view (the shrink rides a fresh channel)
                from ..resilience import supervisor as _sup_mod
                _sup_mod.deactivate(sup)
                try:
                    sup.stop()
                except Exception:
                    pass
            if ckpt_mgr is not None:
                try:
                    ckpt_mgr.flush()
                except MXNetError:
                    if not lost:
                        raise
                finally:
                    ckpt_mgr.close()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    ckpt_mgr, ckpt_resume, resume_nbatch, gstep,
                    checkpoint_period, monitor=None):
        from ..resilience import faults as _faults
        guardian = getattr(self, "_guardian", None)
        last_snap_step = gstep
        for epoch in range(begin_epoch, num_epoch):
            self._fit_epoch_begin(epoch, train_data)
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
                if guardian is not None and \
                        guardian.should_skip(epoch, nbatch):
                    # a quarantined position: consumed, never trained on;
                    # the position still advances, so resume stays
                    # aligned with the run that quarantined it
                    guardian.note_skipped(epoch, nbatch)
                    nbatch += 1
                    continue
                # the pod chaos site: a ``kill`` here is a whole-host
                # SIGKILL at a step boundary
                _faults.fire("host.step", nbatch=nbatch, epoch=epoch)
                step_tic = time.time()
                if monitor is not None:
                    monitor.tic()
                    self._batch_step(data_batch, eval_metric)
                    monitor.toc_print()
                else:
                    self.fit_step(data_batch, eval_metric)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
                gstep += 1
                sup = getattr(self, "_supervisor", None)
                if sup is not None:
                    # the step's wall time feeds the heartbeat EWMA the
                    # straggler rule compares; the counter keys lag
                    sup.record_step(time.time() - step_tic)
                if guardian is not None:
                    # pair the step's health token with its position, then
                    # run the ladder every MXNET_GUARDIAN_INTERVAL steps
                    # (one device read; may raise RollbackRequested or
                    # TrainingDivergedError)
                    guardian.tag(epoch, nbatch - 1, train_data)
                    guardian.maybe_poll(gstep)
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
            if guardian is not None:
                # the epoch's last tokens, before the boundary snapshot
                # stamps its manifest
                guardian.maybe_poll(gstep, force=True)
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

    def _wrap_io_ring(self, train_data):
        """The training iterator wrapped in the h2d staging ring
        (`io_plane.DevicePrefetchIter`) when ``MXNET_IO_RING`` is on and
        a fused train step supplies the placement; returns ``(iterator,
        ring or None)``, the caller pausing the ring when fit ends."""
        from .. import config as _config
        from .. import io_plane as _io_plane
        fs = getattr(self, "_fused_step", None)
        if fs is None or not _config.get("MXNET_IO_RING") or \
                isinstance(train_data, _io_plane.DevicePrefetchIter) or \
                not hasattr(train_data, "next") or \
                not hasattr(train_data, "reset"):
            return train_data, None
        wrapped = _io_plane.DevicePrefetchIter(
            train_data, placement=lambda: self._fused_step.ring_placement(),
            name="fit")
        return wrapped, wrapped

    def _checkpoint_capture(self, data_iter=None):
        """(arrays, blobs, staged) of one elastic snapshot
        (`checkpoint.state.capture_module`)."""
        from ..checkpoint import state as _state
        return _state.capture_module(self, data_iter)

    def _restore_checkpoint_layout(self, ckpt):
        """Rebuild what `_checkpoint_capture` records beyond the arrays,
        the optimizer, the iterator and the random streams (nothing
        here; `BucketingModule` binds its buckets)."""

    def _elastic_snapshot(self, mgr, train_data, epoch, nbatch, step,
                          sync=False, meta=None):
        """Stage one elastic checkpoint: device-to-host copies queued on
        the train step's stream, serialization and the atomic commit in
        the background (`checkpoint/`).  With a guardian, its pending
        tokens are read first (a snapshot never stamps itself healthy on
        stale evidence; an undetected spike raises here and no snapshot
        is taken) and the manifest carries its ``health`` stamp.  A rank
        other than 0 writes only its rank-local state: its iterator
        position and, with the optimizer on the worker, its states."""
        from .. import checkpoint as _ckpt
        guardian = getattr(self, "_guardian", None)
        meta = dict(meta or {})
        if guardian is not None:
            guardian.maybe_poll(step, force=True)
            meta["health"] = guardian.health_stamp()
        if mgr.rank != 0:
            blobs = {}
            if self.optimizer_initialized and \
                    not getattr(self, "_update_on_kvstore", False) and \
                    getattr(self, "_updater", None) is not None:
                blobs[_ckpt.state.OPTIMIZER_BLOB] = \
                    self._updater.get_states(dump_optimizer=True)
            it_blob = _ckpt.state.capture_iterator(train_data)
            if it_blob is not None:
                blobs[_ckpt.state.ITERATOR_BLOB] = it_blob
            mgr.snapshot(arrays={}, blobs=blobs, step=step, epoch=epoch,
                         nbatch=nbatch, sync=sync, meta=meta)
            return
        arrays, blobs, staged = self._checkpoint_capture(train_data)
        optimizer = getattr(self, "_optimizer", None)
        if optimizer is not None:
            meta["optimizer"] = optimizer.state_dict()
        mgr.snapshot(arrays=arrays, blobs=blobs, step=step, epoch=epoch,
                     nbatch=nbatch, sync=sync, meta=meta, staged=staged)

    # -- properties / abstract -------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def install_monitor(self, mon):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)
