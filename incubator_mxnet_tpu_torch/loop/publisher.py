"""Trainer-side publisher: elastic checkpoints → registry versions.

PyTorch port of `incubator_mxnet_tpu/loop/publisher.py`.

`CheckpointPublisher` rides `Module.fit` as a batch-end callback.  On a
cadence (``MXNET_LOOP_PUBLISH_STEPS`` trained steps and/or
``MXNET_LOOP_PUBLISH_SECS`` wall-clock) it takes the newest
guardian-healthy elastic checkpoint and publishes it into a
`ModelRegistry` with:

* the guardian's health stamp copied from the checkpoint manifest —
  suspect snapshots are never published (fit's snapshot path already
  refuses to stamp one healthy mid-anomaly; the publisher re-filters via
  `latest_healthy` anyway, belt and braces);
* a data-shard WATERMARK — the max record position the snapshot's
  training had consumed, plus the wall-clock time the snapshot
  committed.  ``loop.freshness_lag_s`` on the serving side is measured
  against this time: data seen → model live;
* an optional holdout score from ``score_fn(checkpoint_path)`` —
  advisory on the trainer side; the serving canary re-scores on its own
  pinned holdout and trusts only that.

Guardian composition: when fit hands the callback a guardian (it is in
``BatchEndParam.locals``), the publisher watches its rollback counter
and fences the exact window the guardian disowned
(``guardian.last_rollback_window``) — this catches rollbacks that
resume at the very step they had reached and so show no callback-visible
regression.  Without a guardian handle, a step REGRESSION across
callbacks is the fallback signal: every version in the disowned window
``(step_now, max_step_seen]`` trained on quarantined data, so the
publisher fences that window out of the registry.
`fit()` (the wrapper entry point) additionally converts a
`TrainingDivergedError` escape into a fence from the last good step
before re-raising — divergence means nothing after the last rollback
point can be trusted.
"""
from __future__ import annotations

import logging
import os
import time

from .. import config as _config
from ..base import MXNetError
from ..checkpoint import manifest as _manifest
from ..obs import metrics as _metrics
from ..resilience import faults as _faults
from ..resilience.guardian import TrainingDivergedError
from .registry import ModelRegistry

_LOG = logging.getLogger(__name__)


class CheckpointPublisher:
    """Publish guardian-healthy checkpoints into a registry on a cadence.

    Use either as a plain batch-end callback on an existing ``fit``::

        pub = CheckpointPublisher(registry, ckpt_dir)
        mod.fit(it, ..., checkpoint_dir=ckpt_dir, batch_end_callback=pub)

    or via the wrapper, which also fences the registry when training
    diverges::

        pub.fit(mod, it, num_epoch=4, checkpoint_dir=ckpt_dir, ...)
    """

    def __init__(self, registry, checkpoint_dir, publish_steps=None,
                 publish_secs=None, score_fn=None):
        self.registry = (registry if isinstance(registry, ModelRegistry)
                         else ModelRegistry(registry))
        self.checkpoint_dir = str(checkpoint_dir)
        self.publish_steps = int(
            _config.get("MXNET_LOOP_PUBLISH_STEPS")
            if publish_steps is None else publish_steps)
        self.publish_secs = float(
            _config.get("MXNET_LOOP_PUBLISH_SECS")
            if publish_secs is None else publish_secs)
        self.score_fn = score_fn
        self._last_pub_step = -1      # step of the newest published version
        self._cadence_anchor = -1     # step the step-cadence counts from
        self._last_pub_time = time.time()
        self._max_step_seen = -1
        self._published = 0
        self._publish_failures = 0
        self._torn_publishes = 0
        self._fences = 0
        self._rollbacks_seen = 0
        _metrics.register_producer("loop.publisher", self.stats)

    # ------------------------------------------------------ fit plumbing
    def __call__(self, param):
        """Batch-end callback: cadence check + rollback-fence watch."""
        loc = getattr(param, "locals", None) or {}
        step = loc.get("gstep")
        if step is None:
            step = self._max_step_seen + 1
        train_data = loc.get("train_data")
        self.poll(int(step), train_data=train_data,
                  guardian=loc.get("guardian"))

    def fit(self, module, train_data, **kwargs):
        """`module.fit(train_data, ...)` with this publisher attached.

        A `TrainingDivergedError` escaping fit fences everything after
        the guardian's last good step out of the registry, then
        re-raises — the trainer is dead, the registry must not keep
        offering its contaminated tail to the fleet.
        """
        cbs = kwargs.pop("batch_end_callback", None)
        cbs = list(cbs) if isinstance(cbs, (list, tuple)) \
            else ([cbs] if cbs is not None else [])
        cbs.append(self)
        kwargs.setdefault("checkpoint_dir", self.checkpoint_dir)
        try:
            return module.fit(train_data, batch_end_callback=cbs, **kwargs)
        except TrainingDivergedError:
            lo = self._last_good_step(module) + 1
            self.fence_window(lo, max(self._max_step_seen, lo),
                              reason="training-diverged")
            raise

    # ----------------------------------------------------------- cadence
    def poll(self, step, train_data=None, guardian=None):
        """One cadence tick at trained step `step` (idempotent, cheap)."""
        step = int(step)
        if guardian is not None:
            # the authoritative rollback signal: the guardian's own
            # counter.  A rollback that resumes at exactly the step it
            # had reached shows NO step regression at the callbacks, but
            # the window (last_good, max_seen] is still disowned.
            rb = getattr(guardian, "_rollbacks", 0)
            if rb > self._rollbacks_seen:
                self._rollbacks_seen = rb
                win = getattr(guardian, "last_rollback_window", None)
                if win is not None:
                    lo, hi = int(win[0]), int(win[1])
                else:
                    lo = int(getattr(guardian, "_last_good_step",
                                     step)) + 1
                    hi = max(self._max_step_seen, step)
                self.fence_window(lo, max(hi, lo),
                                  reason="guardian-rollback")
                self._cadence_anchor = min(self._cadence_anchor, lo - 1)
        if 0 <= step < self._max_step_seen:
            # step regression across callbacks — a rollback seen without
            # a guardian handle (plain poll() callers): fence likewise
            self.fence_window(step + 1, self._max_step_seen,
                              reason="guardian-rollback")
            self._cadence_anchor = min(self._cadence_anchor, step)
        self._max_step_seen = max(self._max_step_seen, step)
        due = False
        if self.publish_steps > 0:
            due = step - self._cadence_anchor >= self.publish_steps
        if not due and self.publish_secs > 0:
            due = time.time() - self._last_pub_time >= self.publish_secs
        if not due:
            return None
        rec = self._publish_latest(train_data)
        if rec is not None or self.publish_steps <= 0:
            self._cadence_anchor = step
        self._last_pub_time = time.time()
        return rec

    def fence_window(self, lo, hi, reason=""):
        if hi < lo:
            return None
        self._fences += 1
        _LOG.warning("publisher: fencing registry versions [%d, %d] (%s)",
                     lo, hi, reason)
        try:
            return self.registry.fence(lo, hi, reason=reason)
        except MXNetError as e:
            self._publish_failures += 1
            _LOG.error("publisher: fence write failed: %s", e)
            return None

    # ----------------------------------------------------------- publish
    def _publish_latest(self, train_data=None):
        """Publish the newest healthy, unfenced, unrejected checkpoint
        newer than the last published version; None if there is none."""
        try:
            blocked = self._blocked
            path = _manifest.latest_healthy(self.checkpoint_dir,
                                            exclude=blocked)
        except MXNetError as e:
            self._publish_failures += 1
            _LOG.error("publisher: registry unavailable: %s", e)
            return None
        if path is None:
            return None
        try:
            man = _manifest.read_manifest(path)
        except (OSError, ValueError, MXNetError):
            return None
        step = int(man.get("step", 0))
        if step <= self._last_pub_step:
            return None
        watermark = self._watermark(path, man, train_data)
        score = None
        if self.score_fn is not None:
            try:
                score = float(self.score_fn(path))
            except Exception as e:   # advisory only — never kills training
                _LOG.warning("publisher: score_fn failed: %s", e)
        health = (man.get("meta") or {}).get("health") or {}
        try:
            rec = self.registry.publish(
                path, step=step, health=health, watermark=watermark,
                score=score, pin=True)
        except _faults.TornWrite:
            self._torn_publishes += 1
            _LOG.error("publisher: torn publish of step %d (will retry "
                       "next cadence)", step)
            return None
        except MXNetError as e:
            self._publish_failures += 1
            _LOG.error("publisher: publish of step %d failed: %s", step, e)
            return None
        self._published += 1
        self._last_pub_step = step
        return rec

    def _blocked(self, step):
        """exclude= hook for latest_healthy: fenced or rejected steps."""
        try:
            return (self.registry.fenced(step)
                    or self.registry.rejected(step) is not None)
        except MXNetError:
            return False

    def _watermark(self, path, man, train_data):
        """Max record position + wall time the snapshot's data reaches."""
        wm = {
            "step": int(man.get("step", 0)),
            "epoch": int(man.get("epoch", 0)),
            "nbatch": int(man.get("nbatch", 0)),
        }
        try:
            wm["time"] = os.path.getmtime(
                os.path.join(path, _manifest.MANIFEST_NAME))
        except OSError:
            wm["time"] = time.time()
        rr = None
        if train_data is not None:
            try:
                rr = train_data.record_range(wm["nbatch"])
            except Exception:
                rr = None
        if rr is not None:
            wm["source"], wm["record_lo"], wm["record_hi"] = \
                str(rr[0]), int(rr[1]), int(rr[2])
        return wm

    @staticmethod
    def _last_good_step(module):
        g = getattr(module, "_guardian", None)
        lg = getattr(g, "_last_good_step", None)
        return int(lg) if lg is not None else 0

    # ------------------------------------------------------------- stats
    def stats(self):
        return {
            "published": self._published,
            "publish_failures": self._publish_failures,
            "torn_publishes": self._torn_publishes,
            "fences": self._fences,
            "last_published_version": self._last_pub_step,
            "max_step_seen": self._max_step_seen,
        }
