"""Replica handles: the units a router spreads requests over.

PyTorch port of the contract part of `incubator_mxnet_tpu/serving/
replica.py`: the `Replica` base and `ReplicaLostError`, which the decode
engine's `DecodeReplica` implements and raises.  The concrete replicas
(`LocalReplica`, `RemoteReplica` over worker processes) wait for the
router and fleet (ROADMAP.md, Queue 1 item 14); `_load_checkpoint_params`
is the checkpoint swap's parameter source.

The contract a router relies on:

* ``submit(inputs, timeout_ms, rid, priority)`` returns a Future; the
  future fails with `ReplicaLostError` when the replica dies before
  resolving it (the failover trigger; anything else is a caller error
  that would fail identically on every replica).
* ``heartbeat()`` is a cheap liveness check; ``probe()`` is the
  deepcheck, a real request through the prepared programs.
* ``swap(...)`` replaces the parameter set in place (same shapes, same
  programs); ``version`` counts committed swaps.
* ``outstanding()`` / ``estimated_wait_s()`` drive least-loaded
  dispatch and priority shedding.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["Replica", "ReplicaLostError"]


class ReplicaLostError(MXNetError):
    """The replica died (engine killed or closed) before this request
    resolved.  Structured so a router can tell "this replica is gone —
    fail over" from "this request is bad — fail it everywhere":
    `replica_id` names the dead replica, `rid` the in-flight request."""

    def __init__(self, replica_id, rid=None, reason=""):
        self.replica_id = str(replica_id)
        self.rid = rid
        super().__init__(
            f"replica '{replica_id}' lost"
            + (f" with request {rid} in flight" if rid else "")
            + (f": {reason}" if reason else "")
            + " — the router fails over to a surviving replica")


class Replica:
    """Shared contract; see the module docstring."""

    replica_id = "?"
    version = 0          # committed weight-swap count

    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        raise NotImplementedError

    def heartbeat(self):
        raise NotImplementedError

    def probe(self):
        raise NotImplementedError

    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        raise NotImplementedError

    def outstanding(self):
        raise NotImplementedError

    def estimated_wait_s(self):
        return None

    def stats(self):
        return {}

    def close(self, drain=True):
        pass


def _load_checkpoint_params(checkpoint_dir):
    """(arg_params, aux_params) of the newest VALID elastic checkpoint
    under `checkpoint_dir`, or of that checkpoint directory itself (torn
    checkpoints are never selected)."""
    from ..checkpoint import load as _load, latest as _latest
    from ..checkpoint.state import split_params
    path = checkpoint_dir
    if not os.path.exists(os.path.join(path, "manifest.json")):
        found = _latest(path)
        if found is None:
            raise MXNetError(
                f"replica swap: no valid checkpoint under "
                f"{checkpoint_dir!r} (torn checkpoints are never selected)")
        path = found
    return split_params(_load(path).arrays)
