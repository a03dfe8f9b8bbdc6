"""Elastic checkpointing & auto-resume.

PyTorch port of `incubator_mxnet_tpu/checkpoint/`.  The manifest and
the array shard are the JAX package's formats, so a checkpoint directory
written by either package validates and its parameters load in the
other; the optimizer and iterator blobs are each package's own pickles.
The dist (multi-rank) layout is ported in `CheckpointManager`; the
port's `Module.fit` trains on one card and always writes as rank 0.

The fault-tolerance primitive the reference lacks (its `save_checkpoint`
is synchronous, whole-model, and loses optimizer/iterator state): async
snapshots that overlap the train step, atomic manifests a killed writer
can never tear, full training-state capture, and auto-resume that
continues mid-epoch — including after SIGTERM preemption.

Entry points:

* ``CheckpointManager`` — owns a checkpoint directory (async writer,
  retention GC, resume, preemption hook)
* ``latest(dir)`` / ``load(path)`` — find and read valid checkpoints
* ``Module.fit(..., checkpoint_dir=..., resume=True)`` — classic API
  integration (see `module/base_module.py`)
* ``ElasticCheckpointHandler`` — gluon Estimator integration
* ``install_preemption_hook`` — final synchronous snapshot on SIGTERM

See the README section "Checkpointing & fault tolerance" for the
manifest format and the dist (multi-rank) layout.
"""
from __future__ import annotations

from . import manifest
from . import snapshot
from . import state
from .manifest import latest_healthy, stamp_rejected, rejection, is_rejected
from .manager import (CheckpointManager, CheckpointData, latest, load,
                      install_preemption_hook)
from .handler import ElasticCheckpointHandler

__all__ = ["CheckpointManager", "CheckpointData", "latest", "load",
           "latest_healthy", "stamp_rejected", "rejection", "is_rejected",
           "install_preemption_hook",
           "ElasticCheckpointHandler", "manifest", "snapshot", "state"]
