"""Elastic checkpoint handler for the gluon Estimator.

PyTorch port of `incubator_mxnet_tpu/checkpoint/handler.py`.

Unlike `estimator.CheckpointHandler` (parameters only, once per epoch),
this handler captures the FULL training state — net parameters, Trainer
optimizer slots + update counts, RNG streams, epoch/batch position —
through the async snapshot plane, restores all of it on ``fit`` (resume
continues mid-epoch), and arms the preemption hook for the duration of
training.
"""
from __future__ import annotations

from ..gluon.contrib.estimator import EventHandler
from . import manager as _manager
from . import state as _state

__all__ = ["ElasticCheckpointHandler"]


class ElasticCheckpointHandler(EventHandler):
    def __init__(self, directory, period=100, keep_last=5, resume=True,
                 preemption_hook=True, manager=None):
        self.period = max(1, int(period))
        self.resume = bool(resume)
        self.preemption_hook = bool(preemption_hook)
        self.manager = manager or _manager.CheckpointManager(
            directory, keep_last=keep_last)
        self._step = 0

    # -- capture ---------------------------------------------------------------
    def _snapshot(self, est, epoch, nbatch, sync=False, meta=None):
        arrays = _state.capture_gluon_net(est.net)
        blobs = {}
        trainer_blob = _state.capture_trainer(est.trainer)
        if trainer_blob:
            blobs[_state.TRAINER_BLOB] = trainer_blob
        self.manager.snapshot(arrays=arrays, blobs=blobs, step=self._step,
                              epoch=epoch, nbatch=nbatch, sync=sync,
                              meta=meta)

    # -- events ----------------------------------------------------------------
    def train_begin(self, est):
        if self.resume:
            data = self.manager.load_latest()
            if data is not None:
                _state.restore_gluon_net(est.net, data.arrays)
                _state.restore_trainer(est.trainer,
                                       data.blobs.get(_state.TRAINER_BLOB))
                _state.restore_rng(data.rng)
                est._epochs_done = data.epoch
                est._resume_batches = data.nbatch
                # relaunch-the-same-command semantics: fit(epochs=N) after
                # resume trains TO N total epochs, not N more
                est._resume_total_epochs = True
                self._step = data.step
        if self.preemption_hook:
            self.manager.install_preemption_hook()

    def batch_end(self, est):
        self._step += 1
        # the resume position is the batches whose updates LANDED, which
        # in fused block mode runs ahead of batch_idx during the
        # post-block handler burst (estimator.fit applies the whole block
        # before firing its batch_end events) — recording batch_idx there
        # would make resume replay already-applied updates
        nbatch = getattr(est, "_applied_batches", est.batch_idx + 1)
        # batch boundary = the consistent point where a requested
        # preemption may snapshot (see CheckpointManager.honor_preemption)
        self.manager.honor_preemption(
            lambda: self._snapshot(est, est.epoch, nbatch, sync=True,
                                   meta={"preempted": True}))
        if self._step % self.period == 0:
            self._snapshot(est, est.epoch, nbatch)

    def epoch_end(self, est):
        # epoch boundary: resume starts the NEXT epoch from its first batch
        self._snapshot(est, est.epoch + 1, 0)

    def train_end(self, est):
        self.manager.flush()
        self.manager.uninstall_preemption_hook()
