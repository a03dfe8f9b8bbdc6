"""Coordinator-side membership for the elastic multi-host supervisor.

A copy of `incubator_mxnet_tpu/dist/membership.py` with a plain
condition variable in place of the JAX package's lock and sanitizer
hooks.  The root `ParameterServer` answers ``hb``, ``members`` and
``shrink`` from it; the supervisor that drives them is not ported.

On a TPU pod the failure that matters is not a dead parameter server but a
dead HOST: every surviving host then blocks inside an XLA collective with
no error and no timeout.  The first requirement for converting that hang
into a recoverable event is an authoritative answer to "who is still
here?" — this module is that answer, hosted by the root parameter server
(the process the workers already hold a control channel to) and driven by
`resilience.supervisor.JobSupervisor` heartbeats riding the existing
sequence-numbered `dist.transport` frames.

Three pieces:

* **liveness** — every host heartbeats (`hb` frames) with its membership
  epoch, step counter, and step-time EWMA; a host whose last heartbeat is
  older than ``deadline_s`` is *dead* in every subsequent view.  The
  judgement is breaker-like (consecutive silence trips it) but keyed on
  wall silence rather than failures: a heartbeat is its own probe.

* **epoch fencing** — the membership epoch bumps at every shrink commit.
  A heartbeat, shrink proposal, or (via `dist.server`) worker
  registration carrying a stale epoch is REJECTED: a host that missed a
  shrink (partitioned, wedged in a collective) cannot rejoin the pod and
  corrupt post-shrink state.  This is the TensorFlow-supervisor fencing
  token design (PAPERS.md) on the ps-lite control plane.

* **shrink barrier** — on confirmed host loss, every survivor proposes a
  shrink.  The barrier commits when every host still alive has proposed;
  at the deadline it commits with whoever arrived ONLY when the
  proposers form a strict majority of the hosts still alive — one host
  with a misfiring watchdog must not be able to shrink a healthy pod
  down to itself (its proposal fails instead, and it alone dies).  The
  commit bumps the epoch, densely re-ranks the survivors (old rank ->
  new rank, sorted order) and hands the server an ``on_commit`` callback
  to reset kvstore state for the new world.  Proposals for an
  already-committed epoch replay the committed result (idempotent: a
  resent proposal must not re-shrink).
"""
from __future__ import annotations

import threading
import time

__all__ = ["MembershipTable"]


class _Host:
    __slots__ = ("rank", "last", "step", "ewma", "beats", "label")

    def __init__(self, rank, now):
        self.rank = rank
        self.last = now       # monotonic time of the last heartbeat
        self.step = 0
        self.ewma = None      # step-time EWMA reported by the host
        self.beats = 0
        self.label = None     # human name (serving-fleet host ids)


class MembershipTable:
    """Per-pod membership: liveness view, epoch fence, shrink barrier.

    Thread-safe; the clock is injectable so death/deadline sequences are
    testable without sleeping (the `CircuitBreaker` convention).
    """

    def __init__(self, num_workers, deadline_s, clock=time.monotonic):
        self.deadline_s = float(deadline_s)
        self.expected = int(num_workers)   # current world size
        self.epoch = 0
        self._clock = clock
        self._cond = threading.Condition()
        # rank -> _Host; server handler threads (one per connection)
        # all mutate it — every access holds _cond's lock
        self._hosts = {}
        self._shrink = None                # in-flight barrier state
        self._last_shrink = None           # committed result (replayed)

    # -- liveness -------------------------------------------------------------
    def heartbeat(self, rank, epoch, step=None, step_time=None,
                  label=None):
        """One host heartbeat.  Returns the membership view, or an
        ``{"error": ...}`` dict when the host's epoch is stale (the fence:
        it must not be allowed to keep participating).  ``label`` is an
        optional human name carried into the view (the serving fleet
        beats by registry rank but reports by host id)."""
        with self._cond:
            fence = self._fence(rank, epoch, "heartbeat")
            if fence is not None:
                return fence
            now = self._clock()
            rec = self._hosts.get(rank)
            if rec is None:
                rec = self._hosts[rank] = _Host(int(rank), now)
            rec.last = now
            rec.beats += 1
            if step is not None:
                rec.step = int(step)
            if step_time is not None:
                rec.ewma = float(step_time)
            if label is not None:
                rec.label = str(label)
            self._cond.notify_all()
            return {"ok": True, "view": self._view_locked()}

    def view(self):
        """The current membership view without heartbeating."""
        with self._cond:
            return self._view_locked()

    def check_epoch(self, epoch):
        """Fence check for non-membership commands (`register`): None when
        current, an error dict naming the stale epoch otherwise."""
        with self._cond:
            return self._fence(None, epoch, "request")

    def _fence(self, rank, epoch, what):
        if int(epoch) == self.epoch:
            return None
        who = f"host {rank} " if rank is not None else ""
        return {"error": f"stale epoch: {who}{what} carries membership "
                         f"epoch {int(epoch)} but the pod is at epoch "
                         f"{self.epoch} — this host missed a shrink and is "
                         "fenced out (it must not rejoin; restart it "
                         "against the current epoch)"}

    def _view_locked(self):
        now = self._clock()
        alive, dead, ages = [], [], {}
        for rank, rec in sorted(self._hosts.items()):
            age = now - rec.last
            ages[rank] = round(age, 3)
            (dead if age > self.deadline_s else alive).append(rank)
        return {"epoch": self.epoch,
                "world_size": self.expected,
                "alive": alive,
                "dead": dead,
                "age": ages,
                "steps": {r: self._hosts[r].step for r in self._hosts},
                "ewma": {r: self._hosts[r].ewma for r in self._hosts
                         if self._hosts[r].ewma is not None},
                "labels": {r: self._hosts[r].label for r in self._hosts
                           if self._hosts[r].label is not None}}

    # -- shrink barrier -------------------------------------------------------
    def propose_shrink(self, rank, epoch, deadline_s, on_commit=None):
        """Epoch-fenced barrier-with-deadline.  Blocks until every host
        still alive has proposed (or ``deadline_s`` passes), then commits:
        epoch += 1, survivors = the proposers, dense re-rank.  Returns the
        committed result dict (identical for every proposer), including
        this proposer's ``rank_map``.  A proposal for the epoch that was
        JUST committed replays the result (idempotent resends)."""
        rank = int(rank)
        with self._cond:
            if int(epoch) == self.epoch - 1 and self._last_shrink is not None:
                # resent / late proposal for the committed shrink: replay
                # the result IF this host made the survivor cut — a host
                # that missed the barrier is fenced, not readmitted
                if rank in self._last_shrink["survivors"]:
                    return dict(self._last_shrink)
            fence = self._fence(rank, epoch, "shrink proposal")
            if fence is not None:
                return fence
            if self._shrink is None or self._shrink["epoch"] != self.epoch:
                self._shrink = {"epoch": self.epoch, "proposed": set(),
                                "t_end": self._clock() + float(deadline_s)}
            sh = self._shrink
            sh["proposed"].add(rank)
            # proposing proves liveness (the proposer may have spent its
            # heartbeat budget blocked in the hung collective)
            rec = self._hosts.get(rank)
            if rec is not None:
                rec.last = self._clock()
            self._cond.notify_all()
            while True:
                # a commit NEWER than this barrier's start epoch is THIS
                # barrier's commit (the epoch can only have advanced
                # through it) — every co-proposer replays it.  Comparing
                # against the CURRENT epoch would wrongly replay a
                # previous shrink's result on the next host loss.
                if self._last_shrink is not None and \
                        self._last_shrink["epoch"] > sh["epoch"]:
                    return dict(self._last_shrink)
                if self._shrink is not sh:
                    # another proposer aborted this barrier (no quorum)
                    return {"error": "shrink barrier aborted without a "
                                     "quorum — the pod majority is "
                                     "healthy; refusing to shrink"}
                view = self._view_locked()
                waiting_on = [r for r in view["alive"]
                              if r not in sh["proposed"]]
                if not waiting_on and \
                        len(sh["proposed"]) * 2 > self.expected:
                    # everyone still alive has proposed AND the proposers
                    # are a strict majority of the current world: commit
                    # early.  Without the majority clause, a healthy
                    # survivor whose heartbeats lapsed during its own
                    # teardown (stopped supervisor + long checkpoint
                    # flush BEFORE proposing) would be counted dead and
                    # fenced out by the first proposer; a sub-majority
                    # waits for it until the deadline instead.
                    return self._commit_locked(sh, on_commit)
                if self._clock() >= sh["t_end"]:
                    # deadline with live non-proposers: commit only on a
                    # strict proposer majority of everyone still alive —
                    # a single host whose watchdog misfired must not be
                    # able to shrink a healthy pod down to itself
                    alive = set(view["alive"]) | sh["proposed"]
                    if len(sh["proposed"]) * 2 > len(alive):
                        return self._commit_locked(sh, on_commit)
                    self._shrink = None
                    self._cond.notify_all()
                    return {"error": "shrink barrier timed out without a "
                                     f"quorum: {sorted(sh['proposed'])} "
                                     f"proposed but {sorted(alive)} are "
                                     "alive — the pod majority is healthy; "
                                     "refusing to shrink (check this "
                                     "host's collective/watchdog "
                                     "deadlines)"}
                # wake periodically: the alive set shrinks as deadlines
                # pass, with no event to signal it
                self._cond.wait(timeout=min(
                    0.05, max(sh["t_end"] - self._clock(), 0.0) + 0.01))

    def _commit_locked(self, sh, on_commit):
        survivors = sorted(sh["proposed"])
        self.epoch += 1
        self.expected = len(survivors)
        result = {"ok": True, "epoch": self.epoch,
                  "world_size": len(survivors),
                  "survivors": survivors,
                  "rank_map": {old: new for new, old in enumerate(survivors)},
                  "epoch_committed": self.epoch}
        # the new epoch starts with a clean slate: survivors re-register
        # and re-heartbeat under their NEW ranks; stale records must not
        # shadow them
        self._hosts.clear()
        if self._shrink is sh:
            self._shrink = None
        self._last_shrink = {**result, "epoch": self.epoch}
        if on_commit is not None:
            on_commit(result)
        self._cond.notify_all()
        return dict(result)
