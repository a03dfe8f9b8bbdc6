"""Training guardian: the fused step's health word and a skip / rollback /
quarantine policy ladder.

PyTorch port of `incubator_mxnet_tpu/resilience/guardian.py`.  It
defends `Module.fit` against the silent failures: a non-finite gradient,
a loss spike, a corrupt input record, which either crash the loop or
poison the parameters that checkpoints then preserve.

Three layers:

* **the health word** (`fused.FusedTrainStep`, armed by
  `attach_guardian`): each step multiplies the gradients by this
  guardian's `step_multipliers` value (1.0, or NaN / 1e6 under fault
  injection), computes one all-finite flag over the gradients, the
  floating outputs and the applied update, and the displacement ratio
  ||new_w - w|| / ||w||, and hands both to `record_health` as device
  scalars.  A step that is not finite leaves the weights, the optimizer
  states, the BatchNorm aux and the metric's totals as they were (the
  select runs on the device); the update counts and the random streams
  still advance, so a skipped step is reproducible.  Nothing reads the
  device between polls: `maybe_poll` gathers the pending tokens in one
  read every ``MXNET_GUARDIAN_INTERVAL`` trained steps.

* **the ladder** (this module), on each poll:

  - a **non-finite step** (already refused on the device) is counted,
    its stream position quarantined and reported;
  - a **loss spike**: log(signal) more than ``MXNET_GUARDIAN_SPIKE_K``
    EW standard deviations (sigma banded to [0.25, 1.25]) above the
    log-space EWMA after a ``MXNET_GUARDIAN_SPIKE_WINDOW``-step warm-up,
    AND a displacement past 0.25 of the parameters' norm, has already
    applied its damage, so the guardian raises `RollbackRequested`:
    `Module.fit` restores the newest checkpoint stamped healthy at or
    before the last in-bounds step, replays, and skips the quarantined
    window;
  - consecutive failures past ``MXNET_GUARDIAN_MAX_FAILURES`` (or
    rollbacks past ``MXNET_GUARDIAN_MAX_ROLLBACKS``) raise
    `TrainingDivergedError`, naming the step, the signal and the shard.

* **the quarantine**: every skipped or rolled-back position (and every
  corrupt record an iterator detects) is one JSON line in
  ``<checkpoint_dir>/quarantine.jsonl`` (``MXNET_GUARDIAN_QUARANTINE``),
  written through `obs.jsonl_sink`; a resumed run loads it and skips the
  same positions.

With several workers the local health bits are summed through the
kvstore so every worker takes the same decision; where the store cannot
reduce, the guardian decides locally and counts a warning.

Events go to the fault trace (`faults.note`), the profiler
(`profiler.record_guardian`), the `guardian` producer of `obs.metrics`
and `findings()`.  Declared divergences (README, "Declared divergences
of slice 20"): plain `threading` locks stand in for `analysis.locks`;
`findings()` returns this module's `Finding` records, which the JAX
package reports through `analysis.findings` (ROADMAP item
14-analysis); the kvstore exchange runs without the supervisor's
watchdog (`supervisor.supervised`, ROADMAP item 14-dist).

Fault sites: ``grad.nonfinite`` (an ``error`` clause makes that step's
gradients NaN), ``loss.spike`` (scales them by 1e6),
``io.corrupt_record`` (`faults.mutate`'s ``corrupt`` kind).
"""
from __future__ import annotations

import math
import os
import threading

import numpy as _np

from ..base import MXNetError
from . import faults as _faults

__all__ = ["TrainingGuardian", "TrainingDivergedError", "RollbackRequested",
           "QuarantineLog", "Finding", "findings", "reset_findings"]

_SPIKE_SCALE = 1.0e6   # gradient multiplier an injected loss.spike applies
_LOG_FLOOR = 1.0e-30   # signal floor before taking logs (all-zero grads)
# the log-space sigma band: the lower bound keeps a near-constant
# signal's vanishing sigma from flagging noise (k * 0.25 ~ a 4.5x jump at
# k = 6), the upper keeps a fast-decaying warm-up's variance from hiding
# real spikes (k * 1.25 ~ an 1800x jump at k = 6)
_SIGMA_LO, _SIGMA_HI = 0.25, 1.25
# the absolute gate: a spike must also have moved the parameters by this
# fraction of their norm (a relative jump of a harmless size is a hard
# batch, not a divergence)
_SPIKE_MIN_DISPLACEMENT = 0.25


class TrainingDivergedError(MXNetError):
    """The guardian's ladder cannot recover: too many consecutive
    non-finite or spiking steps, or too many rollbacks.  Carries `step`,
    `signal` (None or NaN for a non-finite step), `shard` (the data
    range the iterator attributes, or None) and the reason."""

    def __init__(self, step, signal=None, shard=None, reason=""):
        self.step = int(step)
        self.signal = None if signal is None else float(signal)
        self.shard = shard
        sig = "non-finite" if self.signal is None or \
            not math.isfinite(self.signal) else f"{self.signal:.6g}"
        where = f" (offending data: {shard})" if shard else ""
        super().__init__(
            f"training diverged at step {self.step}: health signal "
            f"{sig}{where}"
            + (f" — {reason}" if reason else "")
            + "; the guardian's skip/rollback budget is exhausted — "
              "inspect the quarantine log, the data shard, and the "
              "learning-rate schedule before resuming")


class RollbackRequested(MXNetError):
    """Control flow between the guardian and `Module.fit`: a loss spike's
    update was applied, so fit restores the newest healthy checkpoint at
    or before `last_good_step` and skips the quarantined window.  User
    code sees `TrainingDivergedError` once the budget is spent."""

    def __init__(self, step, last_good_step, signal, quarantined=()):
        self.step = int(step)
        self.last_good_step = int(last_good_step)
        self.signal = float(signal)
        self.quarantined = list(quarantined)
        super().__init__(
            f"loss spike at step {self.step} (signal {self.signal:.6g}); "
            f"rolling back to the newest healthy checkpoint at step <= "
            f"{self.last_good_step} and skipping "
            f"{len(self.quarantined)} quarantined batch position(s)")


class Finding:
    """One guardian finding: `check` (``guardian.<rung>``), `code`
    (``skip-batch``, ``rollback``, ``spike-unrecoverable``), `severity`,
    `message`, `node` (the step it names) and `count` (repeats)."""

    __slots__ = ("check", "code", "severity", "message", "node", "count")

    def __init__(self, check, code, severity, message, node=None):
        self.check = check
        self.code = code
        self.severity = severity
        self.message = message
        self.node = node
        self.count = 1


_lock = threading.Lock()
_findings = []


def findings():
    """Guardian findings (skips, rollbacks, unrecoverable spikes) so far
    in this process."""
    with _lock:
        return list(_findings)


def reset_findings():
    with _lock:
        _findings.clear()


def _add_finding(code, message, key, severity="warn"):
    with _lock:
        for f in _findings:
            if f.code == code and f.node == key:
                f.count += 1
                return
        _findings.append(Finding("guardian." + code.split("-")[0], code,
                                 severity, message, node=key))


def _record_event(event, **args):
    """One guardian event into the fault trace and the profiler."""
    _faults.note(event, site="guardian", **args)
    try:
        from .. import profiler as _profiler
        _profiler.record_guardian(event, **args)
    except Exception:   # noqa: BLE001 - telemetry never stops training
        pass


class QuarantineLog:
    """Append-only JSONL quarantine file shared by every process of a run
    (`obs.jsonl_sink`: line-atomic appends, pid/rank/thread stamps).  An
    entry is one poisoned unit: a batch position ({'epoch', 'nbatch'}) or
    a record ({'source', 'record'})."""

    def __init__(self, path):
        from ..obs import jsonl_sink as _jsonl
        self.path = str(path)
        self._jsonl = _jsonl
        self._sink = _jsonl.sink(self.path)

    def append(self, **entry):
        self._sink.write(entry)

    def load(self):
        """Every entry written so far (any process), oldest first."""
        return self._jsonl.read_jsonl(self.path)

    def batch_positions(self):
        """{(epoch, nbatch)} of every quarantined stream position."""
        return {(int(e["epoch"]), int(e["nbatch"])) for e in self.load()
                if "nbatch" in e and "epoch" in e}

    def records(self, source=None):
        """{record id} quarantined for `source` (or any source)."""
        return {int(e["record"]) for e in self.load()
                if "record" in e and
                (source is None or e.get("source") == source)}

    def close(self):
        self._sink.close()


def _gather(leaves):
    """One blocking read of every pending device scalar or vector ->
    a float64 numpy array per leaf (the leaves on one device are
    concatenated there and copied once)."""
    import torch
    flat = [t.detach().reshape(-1) if isinstance(t, torch.Tensor)
            else torch.as_tensor(t, dtype=torch.float64).reshape(-1)
            for t in leaves]
    if len({t.device for t in flat}) > 1:
        flat = [t.cpu() for t in flat]
    host = torch.cat([t.to(torch.float64) for t in flat]).cpu().numpy()
    out, i = [], 0
    for t in flat:
        out.append(host[i:i + t.numel()])
        i += t.numel()
    return out


class TrainingGuardian:
    """Per-fit training health guardian (see the module docstring).

    `Module.fit` builds one per call (`maybe_create`), `attach`es it after
    `init_optimizer` (the fused step's health word, the kvstore's
    reduction) and `attach_iterator`s the training data, then calls `tag`
    and `maybe_poll` after each trained step and `health_stamp` at every
    snapshot."""

    @classmethod
    def maybe_create(cls, checkpoint_dir=None, logger=None):
        from .. import config as _config
        if not _config.get("MXNET_GUARDIAN"):
            return None
        return cls(checkpoint_dir=checkpoint_dir, logger=logger)

    def __init__(self, checkpoint_dir=None, interval=None, window=None,
                 spike_k=None, max_failures=None, max_rollbacks=None,
                 quarantine_path=None, logger=None):
        from .. import config as _config
        self.checkpoint_dir = checkpoint_dir
        self.interval = max(1, int(
            interval if interval is not None
            else _config.get("MXNET_GUARDIAN_INTERVAL")))
        self.window = max(2, int(
            window if window is not None
            else _config.get("MXNET_GUARDIAN_SPIKE_WINDOW")))
        self.spike_k = float(
            spike_k if spike_k is not None
            else _config.get("MXNET_GUARDIAN_SPIKE_K"))
        self.max_failures = int(
            max_failures if max_failures is not None
            else _config.get("MXNET_GUARDIAN_MAX_FAILURES"))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None
            else _config.get("MXNET_GUARDIAN_MAX_ROLLBACKS"))
        if quarantine_path is None:
            quarantine_path = str(
                _config.get("MXNET_GUARDIAN_QUARANTINE") or "")
            if not quarantine_path and checkpoint_dir is not None:
                os.makedirs(str(checkpoint_dir), exist_ok=True)
                quarantine_path = os.path.join(str(checkpoint_dir),
                                               "quarantine.jsonl")
        self.quarantine = QuarantineLog(quarantine_path) \
            if quarantine_path else None
        self._skip_positions = self.quarantine.batch_positions() \
            if self.quarantine is not None else set()
        self._logger = logger
        self.can_rollback = checkpoint_dir is not None
        self.in_graph = True     # the fused step arms its health word
        # pending health tokens [{'ok', 'sig', 'pos', 'k'}]: device
        # scalars until a poll reads them
        self._pending = []
        self._untagged = 0       # trailing pending entries without a pos
        self._gstep = 0          # trained-step counter (mirrors fit's)
        # the spike detector: EWMA and EW variance of log(signal)
        self._ewma = None
        self._ewvar = 0.0
        self._history = 0        # finite signals folded in so far
        self._last_good_step = 0
        self._consecutive_failures = 0
        self._rollbacks = 0
        self.pending_rollback_step = None   # armed from request to restore
        # (lo, hi): the step window the newest rollback disowned, which
        # `loop.CheckpointPublisher` fences out of the model registry
        self.last_rollback_window = None
        self._shard_info = None  # the last batch's (source, lo, hi)
        self._iterator = None
        self._allreduce = None   # the kvstore reduction (several workers)
        self._kv_seen = _np.zeros(3, _np.float64)
        self._stats = {"steps_observed": 0, "polls": 0, "skips": 0,
                       "spikes": 0, "rollbacks": 0, "quarantined": 0,
                       "sync_degraded": 0, "injected_nonfinite": 0,
                       "injected_spike": 0}
        from ..obs import metrics as _obs_metrics
        _obs_metrics.register_producer("guardian", self.stats)

    # -- wiring ---------------------------------------------------------------
    def attach(self, module):
        """Arm the module's fused step and, with several workers, the
        kvstore reduction.  Called again after a restart rebuilds them."""
        fs = getattr(module, "_fused_step", None)
        if fs is not None and hasattr(fs, "attach_guardian"):
            fs.attach_guardian(self)
        kv = getattr(module, "_kvstore", None)
        if kv is not None and getattr(kv, "num_workers", 1) > 1:
            self._wire_kvstore(kv)

    def attach_iterator(self, data_iter):
        """Hand the iterator the quarantine log (it appends the corrupt
        records it detects) and the records quarantined already."""
        self._iterator = data_iter
        if self.quarantine is None:
            return
        if hasattr(data_iter, "set_quarantine"):
            data_iter.set_quarantine(self.quarantine)
        if hasattr(data_iter, "apply_quarantine"):
            data_iter.apply_quarantine(self.quarantine.load())

    def _wire_kvstore(self, kv):
        """The health bits' reduction: each worker pushes its counters on
        a reserved key and pulls the sum, so one worker's verdict is every
        worker's; inside the supervisor's watchdog when one is active
        (`supervisor.supervised`), as in the JAX package."""
        from . import supervisor as _sup
        state = {"inited": False}
        key = "__guardian_health__"

        def allreduce(vec):
            from .. import nd
            from ..context import cpu

            def exchange():
                if not state["inited"]:
                    kv.init(key, nd.zeros(len(vec), ctx=cpu()))
                    state["inited"] = True
                kv.push(key, nd.array(_np.asarray(vec, _np.float32),
                                      ctx=cpu()))
                out = nd.zeros(len(vec), ctx=cpu())
                kv.pull(key, out)
                return out.asnumpy()

            return _sup.supervised("guardian.sync", exchange)

        self._allreduce = allreduce

    # -- the fused step's side ------------------------------------------------
    def step_multipliers(self, k):
        """One gradient multiplier a step of the next `k`: 1.0, NaN when
        a ``grad.nonfinite`` clause fires for that step, 1e6 when a
        ``loss.spike`` clause does."""
        out = []
        for _ in range(k):
            self._gstep += 1
            gm = 1.0
            try:
                _faults.fire("grad.nonfinite", step=self._gstep)
            except Exception:   # noqa: BLE001 - any firing kind
                gm = float("nan")
                self._stats["injected_nonfinite"] += 1
            try:
                _faults.fire("loss.spike", step=self._gstep)
            except Exception:   # noqa: BLE001 - any firing kind
                gm = _SPIKE_SCALE
                self._stats["injected_spike"] += 1
            out.append(gm)
        return out

    def record_health(self, k, ok, sig):
        """The last dispatch's health word: `ok` and `sig` are device
        scalars (or vectors of `k` steps).  No host read here."""
        self._pending.append({"ok": ok, "sig": sig, "k": int(k),
                              "pos": None})
        self._untagged += 1
        self._stats["steps_observed"] += int(k)
        if len(self._pending) > 1024:
            # a fused step driven outside fit (no polls): cap the backlog
            drop = len(self._pending) - 1024
            self._pending = self._pending[drop:]
            self._untagged = min(self._untagged, len(self._pending))

    # -- the fit loop's side --------------------------------------------------
    def tag(self, epoch, nbatch0, data_iter=None):
        """Attach stream positions (epoch, first nbatch) to the tokens
        recorded since the last tag, so a poll can quarantine by
        position."""
        first_nbatch = int(nbatch0)
        if self._untagged:
            for entry in self._pending[-self._untagged:]:
                entry["pos"] = (int(epoch), int(nbatch0))
                nbatch0 += entry["k"]
            self._untagged = 0
        it = data_iter if data_iter is not None else self._iterator
        if it is not None and hasattr(it, "record_range"):
            try:
                self._shard_info = it.record_range(first_nbatch)
            except Exception:   # noqa: BLE001 - attribution is best effort
                pass

    def should_skip(self, epoch, nbatch):
        """Whether this stream position is quarantined (fit consumes it
        without training; positions still advance)."""
        return (int(epoch), int(nbatch)) in self._skip_positions

    def note_skipped(self, epoch, nbatch):
        _record_event("quarantine-skip", epoch=int(epoch),
                      nbatch=int(nbatch))

    def maybe_poll(self, gstep, force=False):
        """Read the pending tokens and run the ladder, every ``interval``
        trained steps or on `force` (snapshots, epoch ends).  Raises
        `RollbackRequested` or `TrainingDivergedError`."""
        if not self._pending:
            return
        pending_steps = sum(e["k"] for e in self._pending)
        if not force and pending_steps < self.interval:
            return
        self._stats["polls"] += 1
        tokens = self._classify(self._materialize())
        local = self._ladder_inputs(tokens)
        agreed = self._agree(local)
        self._apply_ladder(agreed, tokens, gstep)

    def _materialize(self):
        """One blocking read of every pending token -> [(pos, step, ok,
        sig)] a step."""
        pending, self._pending = self._pending, []
        self._untagged = 0
        leaves = []
        for e in pending:
            leaves.append(e["ok"])
            leaves.append(e["sig"])
        host = _gather(leaves)
        out = []
        # the pending tokens are the last sum(k) dispatched steps, ending
        # at the step counter
        base_step = self._gstep - sum(e["k"] for e in pending)
        consumed = 0
        for i, e in enumerate(pending):
            ok = _np.atleast_1d(_np.asarray(host[2 * i]))
            sig = _np.atleast_1d(_np.asarray(host[2 * i + 1]))
            for j in range(e["k"]):
                pos = None
                if e["pos"] is not None:
                    pos = (e["pos"][0], e["pos"][1] + j)
                out.append((pos, base_step + consumed + 1,
                            float(ok[j]), float(sig[j])))
                consumed += 1
        return out

    def _classify(self, raw):
        """Classify each token once against the detector as it stood when
        its step ran -> [(pos, step, ok, sig, is_spike)]."""
        out = []
        contaminated = False
        for pos, step, ok, sig in raw:
            spike = False
            if ok >= 0.5 and not contaminated:
                spike = self._is_spike(sig)
                if not spike:
                    self._fold(sig)
                    self._last_good_step = max(self._last_good_step, step)
            # after a spike the window's later steps trained on damaged
            # parameters: they neither advance last_good nor feed the
            # EWMA (a non-finite step was refused, so it does not count)
            if spike:
                contaminated = True
            out.append((pos, step, ok, sig, spike))
        return out

    def _ladder_inputs(self, tokens):
        """Local health bits: [n_bad, n_spike, first_spike_step]."""
        n_bad = sum(1 for _, _, ok, _, _ in tokens if ok < 0.5)
        n_spike = sum(1 for *_, spike in tokens if spike)
        spike_step = next((step for _, step, _, _, spike in tokens
                           if spike), 0)
        return _np.asarray([n_bad, n_spike, spike_step], _np.float64)

    def _is_spike(self, sig):
        """A k-sigma jump of log(signal) over its EWMA AND a displacement
        past ``_SPIKE_MIN_DISPLACEMENT`` of the parameters' norm."""
        if self._history < self.window or self._ewma is None:
            return False
        if sig <= _SPIKE_MIN_DISPLACEMENT:
            return False
        logsig = math.log(max(sig, _LOG_FLOOR))
        sigma = min(max(math.sqrt(max(self._ewvar, 0.0)), _SIGMA_LO),
                    _SIGMA_HI)
        return logsig - self._ewma > self.spike_k * sigma

    def _fold(self, sig):
        """Fold one in-bounds signal into the log-space EWMA/variance."""
        logsig = math.log(max(sig, _LOG_FLOOR))
        if self._ewma is None:
            self._ewma = logsig
            self._ewvar = 0.0
        else:
            alpha = 2.0 / (self.window + 1.0)
            delta = logsig - self._ewma
            self._ewma += alpha * delta
            self._ewvar = (1.0 - alpha) * (self._ewvar
                                           + alpha * delta * delta)
        self._history += 1

    def _ewma_linear(self):
        return None if self._ewma is None else math.exp(self._ewma)

    def _agree(self, local):
        """Sum the local health bits across workers; the OR of the flags
        (sum > 0) carries one worker's verdict to the others.  Falls back
        to the local bits, counted, when the store cannot reduce."""
        if self._allreduce is None:
            return local
        try:
            pulled = _np.asarray(self._allreduce(list(local)), _np.float64)
            # the store sums every push across polls: this poll's verdict
            # is the delta against what was seen before
            total = pulled - self._kv_seen
            self._kv_seen = pulled
            if total[1] > 0 and local[1] == 0:
                # a peer diagnosed the spike: adopt its step (the mean of
                # the diagnosing workers')
                total[2] = total[2] / max(round(total[1]), 1)
            elif local[1] > 0:
                total[2] = local[2]
            return total
        except Exception as e:   # noqa: BLE001 - degrade, never stop
            self._stats["sync_degraded"] += 1
            if self._logger is not None:
                self._logger.warning(
                    "guardian: health-bit reduction unavailable (%s); "
                    "falling back to local decisions", str(e)[:200])
            return local

    def _apply_ladder(self, agreed, tokens, gstep):
        n_bad, n_spike = int(round(agreed[0])), int(round(agreed[1]))
        spike_step = int(round(agreed[2]))
        # the budget counts steps, not worker copies of a step: every
        # worker of a synchronous run reports the same bad step
        local_bad = sum(1 for _, _, ok, _, _ in tokens if ok < 0.5)
        budget_bad = max(local_bad, 1 if n_bad else 0)
        # rung 1: skip-batch (the device already refused the update)
        if n_bad:
            for pos, step, ok, sig, _ in tokens:
                if ok >= 0.5:
                    continue
                self._quarantine(pos, step, "nonfinite", sig)
                self._stats["skips"] += 1
                _record_event("skip-batch", step=step,
                              epoch=pos[0] if pos else -1,
                              nbatch=pos[1] if pos else -1)
                _add_finding(
                    "skip-batch",
                    f"non-finite gradients at step {step} — the update "
                    "was not applied (skipped on the device); the batch "
                    "position is quarantined", f"step{step}")
            self._consecutive_failures += budget_bad
        # rung 2: rollback (a spiking update was already applied)
        if n_spike:
            self._stats["spikes"] += 1
            self._consecutive_failures += 1
            sig = next((s for *_, s, spike in tokens if spike),
                       float("nan"))
            self._check_budget(spike_step or gstep, sig)
            quarantined = []
            for pos, step, ok, s, spike in tokens:
                # the spike window: the diagnosed step and every later
                # step of this poll
                if ok >= 0.5 and (spike or (spike_step and
                                            step >= spike_step)):
                    self._quarantine(pos, step, "loss-spike", s)
                    if pos is not None:
                        quarantined.append(pos)
            if self.can_rollback:
                self._rollbacks += 1
                self._stats["rollbacks"] += 1
                if self._rollbacks > self.max_rollbacks:
                    raise TrainingDivergedError(
                        spike_step or gstep, signal=sig,
                        shard=self._shard_desc(),
                        reason=f"{self._rollbacks - 1} rollback(s) already "
                               "spent (MXNET_GUARDIAN_MAX_ROLLBACKS)")
                self.pending_rollback_step = self._last_good_step
                self.last_rollback_window = (
                    self._last_good_step + 1, int(spike_step or gstep))
                _record_event("rollback", step=spike_step or gstep,
                              last_good_step=self._last_good_step)
                ew = self._ewma_linear()
                _add_finding(
                    "rollback",
                    f"loss spike at step {spike_step or gstep} (signal "
                    f"{sig:.6g} vs EWMA "
                    f"{'?' if ew is None else format(ew, '.6g')}) — "
                    "rolling back to the newest healthy checkpoint at "
                    f"step <= {self._last_good_step}", f"step{spike_step}")
                raise RollbackRequested(spike_step or gstep,
                                        self._last_good_step, sig,
                                        quarantined)
            _add_finding(
                "spike-unrecoverable",
                f"loss spike at step {spike_step or gstep} (signal "
                f"{sig:.6g}) but no checkpoint_dir to roll back to — "
                "training continues on the spiked parameters; pass "
                "checkpoint_dir= to Module.fit to arm rollback",
                f"step{spike_step}")
        if not n_bad and not n_spike:
            self._consecutive_failures = 0
        else:
            bad_step = next((st for _, st, ok, _, _ in tokens
                             if ok < 0.5), gstep)
            self._check_budget(bad_step, float("nan") if n_bad else None)

    def _check_budget(self, step, signal):
        if self._consecutive_failures > self.max_failures:
            _record_event("diverged", step=int(step))
            raise TrainingDivergedError(
                step, signal=signal, shard=self._shard_desc(),
                reason=f"{self._consecutive_failures} consecutive "
                       "unhealthy step(s) (MXNET_GUARDIAN_MAX_FAILURES="
                       f"{self.max_failures})")

    def _quarantine(self, pos, step, reason, signal):
        if pos is not None:
            self._skip_positions.add(pos)
        self._stats["quarantined"] += 1
        _record_event("quarantine", step=int(step), reason=reason)
        if self.quarantine is None:
            return
        entry = {"reason": reason, "step": int(step),
                 "signal": None if signal is None or
                 not math.isfinite(signal) else float(signal)}
        if pos is not None:
            entry["epoch"], entry["nbatch"] = int(pos[0]), int(pos[1])
        shard = self._shard_desc()
        if shard:
            entry["shard"] = shard
        self.quarantine.append(**entry)

    def _shard_desc(self):
        info = self._shard_info
        if not info:
            return None
        try:
            source, lo, hi = info
            return f"{source}[{lo}:{hi}]"
        except (TypeError, ValueError):
            return str(info)

    # -- the checkpoint's side ------------------------------------------------
    def health_stamp(self):
        """The ``health`` block of a snapshot's manifest: rollback selects
        only checkpoints stamped healthy (an unstamped manifest counts as
        healthy)."""
        status = "healthy" if self._consecutive_failures == 0 and \
            self.pending_rollback_step is None else "suspect"
        return {"status": status,
                "signal_ewma": self._ewma_linear(),
                "skips": self._stats["skips"],
                "rollbacks": self._rollbacks}

    def rollback_committed(self, step):
        """The rollback's restore landed: clear the request and the
        detector's history (the replayed window folds afresh); the
        failure counter survives, so thrashing still escalates."""
        self.pending_rollback_step = None
        self._ewma = None
        self._ewvar = 0.0
        self._history = 0
        self._pending = []
        self._untagged = 0
        self._last_good_step = int(step)
        self._gstep = int(step)
        _record_event("rollback-committed", step=int(step))

    def stats(self):
        out = dict(self._stats)
        out.update(consecutive_failures=self._consecutive_failures,
                   signal_ewma=self._ewma_linear(),
                   quarantine_path=self.quarantine.path
                   if self.quarantine is not None else None,
                   pending_rollback_step=self.pending_rollback_step)
        return out

    def close(self):
        if self.quarantine is not None:
            self.quarantine.close()
