"""Serving-side watcher + canary gate.

PyTorch port of `incubator_mxnet_tpu/loop/controller.py`, over the
port's `serving.ReplicaRouter` (`swap_one`, `swap_weights`).

`LoopController` closes the train-to-serve loop: it polls a
`ModelRegistry` for new versions and, instead of blind-swapping the
fleet, runs every candidate through a CANARY —

1. pick one healthy replica; score the INCUMBENT weights on a pinned
   holdout slice through the real inference path (`replica.submit`, the
   same deepcheck path health probes use);
2. swap ONLY that replica to the candidate checkpoint (the router's
   drain + zero-compile swap, scoped to one replica);
3. score the candidate on the same holdout, same replica —
   apples-to-apples, same device, same compiled programs;
4. promote iff ``canary_score >= incumbent_score - MXNET_LOOP_CANARY_TOL``
   via the existing rolling zero-compile `swap_weights` across the
   fleet; otherwise swap the canary replica BACK to the incumbent,
   stamp the version ``rejected`` in the registry (never retried), and
   raise `CanaryRejectedError` naming version and both scores.

Structured failure handling, never tear-down:

* `SwapInProgressError` from the router (another swap mid-flight) →
  back off, retry the same version on the next poll; if it is the
  canary ROLLBACK that collides with an external roll, the restore is
  deferred and retried at the next poll instead of destroying the
  replica;
* a replica LOST (or transport wedged) mid-canary/mid-promote → the
  router's swap contract keeps the fleet serving (each request is
  single-version); the controller counts a ``swap_failure``, returns a
  structured ``swap-failed`` status, and retries the whole canary on
  the next poll — never crashes the watch loop.  A promote that aborts
  AFTER the canary passed is resumed directly on the next poll (the
  verdict stands; re-canarying against a partially-rolled fleet could
  compare the candidate against itself);
* `RegistryUnavailableError` (registry directory vanished mid-poll) →
  count it, keep serving the incumbent;
* a failure scoring the INCUMBENT (before anything was swapped) is an
  eval problem, not a swap problem: counted under ``eval_failures``,
  returned as an ``eval-failed`` status, candidate retried next poll;
* a canary-eval failure (``canary.eval`` fault site, inference error,
  timeout) fails CLOSED: the candidate is treated as scoring -inf and
  rejected — a model that cannot be scored is never promoted.

On promote, the controller measures ``loop.freshness_lag_s`` — wall
clock now minus the version's data-seen watermark time — and publishes
it as an obs gauge under the ``loop`` namespace, with a trace span per
poll/canary/promote so the hand-off is visible end-to-end.
"""
from __future__ import annotations

import logging
import threading
import time

# on Python <= 3.10 this is NOT the builtin TimeoutError: a hung
# Future.result would otherwise escape every fail-closed handler below
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as _np

from .. import config as _config
from ..base import MXNetError
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..resilience import faults as _faults
from ..serving.replica import ReplicaLostError
from ..serving.router import SwapInProgressError
from .registry import ModelRegistry, RegistryUnavailableError

_LOG = logging.getLogger(__name__)


class CanaryRejectedError(MXNetError):
    """A candidate version failed the serving-side canary gate."""

    def __init__(self, version, incumbent_score, canary_score, tol=None):
        self.version = int(version)
        self.incumbent_score = incumbent_score
        self.canary_score = canary_score
        self.tol = tol
        super().__init__(
            f"canary rejected version {version}: canary scored "
            f"{canary_score} vs incumbent {incumbent_score}"
            + (f" (tol={tol})" if tol is not None else ""))


def _accuracy(outputs, labels):
    """Default holdout score: argmax accuracy of the first output."""
    out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
    out = out.asnumpy() if hasattr(out, "asnumpy") else _np.asarray(out)
    pred = out.argmax(axis=-1).reshape(-1)
    labels = _np.asarray(labels).reshape(-1)
    n = min(len(pred), len(labels))
    return float((pred[:n] == labels[:n]).mean()) if n else 0.0


class LoopController:
    """Watch a registry, canary every new version, promote or reject.

    `holdout` is ``(inputs, labels)``: inputs a dict of input-name →
    array sized to fit the fleet's bucket ladder, labels whatever
    ``score_fn(outputs, labels) -> float`` (higher is better) consumes;
    the default scorer is argmax accuracy of the first output.
    """

    def __init__(self, router, registry, holdout, score_fn=None,
                 canary_tol=None, poll_interval_s=None,
                 freshness_slo_s=None, eval_timeout_ms=30000,
                 incumbent_checkpoint=None):
        self.router = router
        # what a failed canary is restored FROM before any promotion has
        # happened: the checkpoint the fleet booted with
        self.incumbent_checkpoint = incumbent_checkpoint
        self.registry = (registry if isinstance(registry, ModelRegistry)
                         else ModelRegistry(registry, create=False))
        self.holdout_inputs, self.holdout_labels = holdout
        self.score_fn = score_fn or _accuracy
        self.canary_tol = float(
            _config.get("MXNET_LOOP_CANARY_TOL")
            if canary_tol is None else canary_tol)
        self.poll_interval_s = float(
            _config.get("MXNET_LOOP_POLL_S")
            if poll_interval_s is None else poll_interval_s)
        self.freshness_slo_s = float(
            _config.get("MXNET_LOOP_FRESHNESS_SLO_S")
            if freshness_slo_s is None else freshness_slo_s)
        self.eval_timeout_ms = int(eval_timeout_ms)
        self._live = None            # registry record of the live version
        # (version, incumbent_score, canary_score) of a candidate whose
        # canary PASSED but whose fleet-wide promote roll aborted — the
        # next poll resumes the roll instead of re-canarying (some
        # replicas already serve the candidate, so a fresh canary pick
        # could compare the candidate against itself)
        self._vetted = None
        # (rid, checkpoint) of a canary rollback deferred because an
        # external swap held the lock — retried first thing next poll
        self._pending_restore = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._polls = 0
        self._promotions = 0
        self._rejections = 0
        self._swap_busy = 0
        self._swap_failures = 0
        self._registry_errors = 0
        self._eval_failures = 0
        self._freshness_lag_s = None
        self._gauge = _metrics.gauge("loop.freshness_lag_s")
        _metrics.register_producer("loop", self.stats)

    # -------------------------------------------------------------- poll
    def poll_once(self):
        """One watch cycle; returns a structured status dict.

        Raises `CanaryRejectedError` on a failed canary (the background
        thread records and continues; a direct caller sees it).
        """
        self._polls += 1
        sp = _trace.start_span("loop.poll", cat="loop")
        try:
            if self._pending_restore is not None:
                # a canary rollback that lost the swap lock last poll:
                # finish it before looking at anything new — the replica
                # is still serving the rejected weights
                rid, restore_ckpt = self._pending_restore
                self._pending_restore = None
                self._restore_canary(rid, incumbent_ckpt=restore_ckpt)
            try:
                cand = self.registry.latest()
            except RegistryUnavailableError as e:
                self._registry_errors += 1
                _LOG.error("loop: %s — fleet keeps serving the incumbent",
                           e)
                return {"status": "registry-unavailable", "error": str(e)}
            if cand is None:
                return {"status": "idle"}
            live_v = self._live["version"] if self._live else -1
            if cand["version"] <= live_v:
                return {"status": "idle", "live_version": live_v}
            try:
                return self._canary_and_promote(cand)
            except SwapInProgressError as e:
                self._swap_busy += 1
                _LOG.info("loop: swap busy (in-flight %s) — backing off "
                          "to the next poll", e.version)
                return {"status": "swap-busy",
                        "in_flight": e.version,
                        "candidate": cand["version"]}
            except CanaryRejectedError:
                raise
            except (ReplicaLostError, TimeoutError, _FutTimeout,
                    MXNetError) as e:
                # a replica died (or the transport wedged) mid-swap.
                # The router's swap contract already guarantees the
                # fleet keeps serving — each request is single-version,
                # untouched replicas hold the incumbent — and `_live`
                # was not advanced, so the candidate stays eligible:
                # retry the whole canary on the next poll once the
                # router's health loop has dealt with the lost replica.
                self._swap_failures += 1
                _LOG.error("loop: swap of version %d failed (%s) — "
                           "fleet keeps serving; will retry next poll",
                           cand["version"], e)
                return {"status": "swap-failed",
                        "candidate": cand["version"],
                        "error": str(e)}
        finally:
            sp.end()

    def _canary_and_promote(self, cand):
        version, ckpt = cand["version"], cand["checkpoint"]
        if self._vetted is not None and self._vetted[0] == version:
            # this version already PASSED its canary; the promote roll
            # aborted partway, so some replicas may already serve it — a
            # fresh canary pick could score the candidate as its own
            # "incumbent".  The verdict stands: resume the roll.
            _, inc, can = self._vetted
            _LOG.info("loop: resuming aborted promote of version %d",
                      version)
            return self._promote(cand, inc, can)
        sp = _trace.start_span("loop.canary", cat="loop", version=version)
        try:
            rid, replica = self._pick_canary()
            try:
                incumbent_score = self._score_replica(replica, version,
                                                      phase="incumbent")
            except (MXNetError, ReplicaLostError, TimeoutError,
                    _FutTimeout) as e:
                # nothing was swapped yet: this is an eval problem, not
                # a swap problem — count it as such, retry next poll
                self._eval_failures += 1
                _LOG.error("loop: incumbent eval before canary of "
                           "version %d failed (%s) — will retry next "
                           "poll", version, e)
                return {"status": "eval-failed", "phase": "incumbent",
                        "candidate": version, "error": str(e)}
            self.router.swap_one(rid, checkpoint_dir=ckpt,
                                 version=version)
            try:
                canary_score = self._score_replica(replica, version,
                                                   phase="canary")
            except (MXNetError, ReplicaLostError, TimeoutError,
                    _FutTimeout) as e:
                # fail CLOSED: an unscorable candidate is a rejected one
                self._eval_failures += 1
                _LOG.error("loop: canary eval of version %d failed (%s)",
                           version, e)
                canary_score = float("-inf")
            ok = (canary_score == canary_score          # not NaN
                  and canary_score >= incumbent_score - self.canary_tol)
        finally:
            sp.end()
        if ok:
            # record the verdict BEFORE rolling: if swap_weights aborts
            # partway, the next poll resumes the promote instead of
            # canarying against a partially-rolled fleet
            self._vetted = (version, incumbent_score, canary_score)
            return self._promote(cand, incumbent_score, canary_score)
        return self._reject(cand, rid, incumbent_score, canary_score)

    # --------------------------------------------------- promote / reject
    def _promote(self, cand, incumbent_score, canary_score):
        version, ckpt = cand["version"], cand["checkpoint"]
        sp = _trace.start_span("loop.promote", cat="loop", version=version)
        try:
            self.router.swap_weights(checkpoint_dir=ckpt, version=version)
        finally:
            sp.end()
        self._vetted = None
        self._live = cand
        self._promotions += 1
        lag = self._measure_freshness(cand)
        _LOG.info("loop: promoted version %d (canary %.4f vs incumbent "
                  "%.4f, freshness lag %.1fs)", version, canary_score,
                  incumbent_score, lag if lag is not None else -1.0)
        return {"status": "promoted", "version": version,
                "incumbent_score": incumbent_score,
                "canary_score": canary_score,
                "freshness_lag_s": lag}

    def _reject(self, cand, rid, incumbent_score, canary_score):
        version = cand["version"]
        # roll the canary replica back to the incumbent BEFORE anything
        # else: the poisoned weights must not serve one extra request
        self._restore_canary(rid)
        try:
            self.registry.reject(version, reason="canary",
                                 incumbent_score=incumbent_score,
                                 canary_score=canary_score)
        except MXNetError as e:
            _LOG.error("loop: could not stamp version %d rejected: %s",
                       version, e)
        # stamp the checkpoint itself too, so trainer-side resume and
        # latest_healthy() skip it even without reading the registry.
        # With publish(pin=True) the record's "checkpoint" is the
        # registry-owned blobs/ copy — the trainer resumes from its own
        # ckpt-* directory, so the SOURCE path must carry the stamp too
        from ..checkpoint import manifest as _manifest
        stamped = set()
        for path in (cand.get("checkpoint"),
                     cand.get("source_checkpoint")):
            if not path or path in stamped:
                continue
            stamped.add(path)
            try:
                _manifest.stamp_rejected(path, reason="canary",
                                         incumbent_score=incumbent_score,
                                         canary_score=canary_score)
            except (OSError, MXNetError) as e:
                _LOG.warning("loop: could not stamp checkpoint %s of "
                             "version %d rejected: %s", path, version, e)
        self._rejections += 1
        raise CanaryRejectedError(version, incumbent_score, canary_score,
                                  tol=self.canary_tol)

    def _restore_canary(self, rid, incumbent_ckpt=None):
        if incumbent_ckpt is None:
            incumbent_ckpt = self._live["checkpoint"] if self._live \
                else self.incumbent_checkpoint
        try:
            if incumbent_ckpt is not None:
                self.router.swap_one(rid, checkpoint_dir=incumbent_ckpt)
            else:
                # no known-good checkpoint to restore from: the poisoned
                # replica must not serve — drop it from the fleet
                _LOG.error("loop: no incumbent checkpoint to restore "
                           "canary replica '%s' — declaring it lost", rid)
                self.router.declare_lost(rid)
        except SwapInProgressError as e:
            # an external roll holds the swap lock: the replica is
            # healthy, just serving the rejected weights one poll longer
            # — defer the restore and retry it first thing next poll
            # instead of destroying capacity
            self._swap_busy += 1
            self._pending_restore = (rid, incumbent_ckpt)
            _LOG.warning("loop: restore of canary replica '%s' blocked "
                         "by in-flight swap (%s) — will retry next poll",
                         rid, e.version)
        except (MXNetError, ReplicaLostError) as e:
            _LOG.error("loop: could not restore canary replica '%s' — "
                       "declaring it lost: %s", rid, e)
            try:
                self.router.declare_lost(rid)
            except MXNetError:
                pass

    # --------------------------------------------------------- scoring
    def _pick_canary(self):
        for rid in self.router.replicas():
            try:
                return rid, self.router.replica(rid)
            except MXNetError:
                continue
        raise MXNetError("loop: no live replica to canary on")

    def _score_replica(self, replica, version, phase):
        _faults.fire("canary.eval", version=version, phase=phase)
        fut = replica.submit(dict(self.holdout_inputs),
                             timeout_ms=self.eval_timeout_ms)
        try:
            outputs = fut.result(
                timeout=self.eval_timeout_ms / 1000.0 + 5.0)
        except _FutTimeout as e:
            # translate at the source: pre-3.11 this is not the builtin
            # TimeoutError, and a hung eval must hit the fail-closed
            # handlers, not escape them
            raise MXNetError(
                f"loop: holdout eval of version {version} ({phase}) "
                f"timed out after {self.eval_timeout_ms} ms") from e
        return float(self.score_fn(outputs, self.holdout_labels))

    # ------------------------------------------------------- freshness
    def _measure_freshness(self, cand):
        wm_time = (cand.get("watermark") or {}).get("time")
        if wm_time is None:
            wm_time = cand.get("published_unix")
        if wm_time is None:
            return None
        lag = max(0.0, time.time() - float(wm_time))
        self._freshness_lag_s = lag
        self._gauge.set(lag)
        return lag

    # ------------------------------------------------------ background
    def adopt(self, record):
        """Declare `record` (a registry record) already live — used when
        the fleet booted from the version's checkpoint directly."""
        self._live = record
        if record is not None:
            self._measure_freshness(record)

    def start(self):
        """Poll in a daemon thread until `stop()`."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="mx-loop-controller",
                                            daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except CanaryRejectedError as e:
                _LOG.error("loop: %s", e)
            except (MXNetError, ReplicaLostError, TimeoutError,
                    _FutTimeout) as e:
                _LOG.error("loop: poll failed: %s", e)
            self._stop.wait(self.poll_interval_s)

    def stop(self):
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    close = stop

    # ------------------------------------------------------------ stats
    def stats(self):
        out = {
            "polls": self._polls,
            "promotions": self._promotions,
            "canary_rejections": self._rejections,
            "swap_busy": self._swap_busy,
            "swap_failures": self._swap_failures,
            "registry_errors": self._registry_errors,
            "eval_failures": self._eval_failures,
            "live_version": self._live["version"] if self._live else -1,
            "freshness_slo_s": self.freshness_slo_s,
        }
        if self._freshness_lag_s is not None:
            out["freshness_lag_s"] = self._freshness_lag_s
            out["freshness_slo_met"] = int(
                self._freshness_lag_s <= self.freshness_slo_s)
        return out
