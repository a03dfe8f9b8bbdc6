"""Fault injection, retry and failover primitives.

PyTorch port of the part of `incubator_mxnet_tpu/resilience/` that the
dist kvstore, the sharded embedding table and the serving batcher use:
`RetryPolicy` and `RetryBudget` (exponential backoff with jitter,
deadlines, a shared budget), `CircuitBreaker` (consecutive-failure trip,
half-open probes), `ServerLostError`, the structured error a permanently
lost parameter server raises, `faults`, the deterministic fault
injection registry (``MXNET_FAULTS``; `inject`, `configure`, `fire`,
`mutate`, `trace`), and the training guardian (`guardian`:
`TrainingGuardian`, `TrainingDivergedError`, `RollbackRequested`,
`QuarantineLog`), which `Module.fit` arms by default, and the elastic
supervisor (`supervisor`: `JobSupervisor`, `CollectiveTimeoutError`,
`HostLostError`, `StaleEpochError`), which a multi-worker dist
`Module.fit` starts.
"""
from __future__ import annotations

from ..base import MXNetError
from . import faults
from .faults import (FaultInjected, TornWrite, configure, inject, clear,
                     reset, trace, fire, mutate, active)
from .retry import RetryPolicy, RetryBudget
from .breaker import CircuitBreaker
from . import supervisor
from .supervisor import (JobSupervisor, CollectiveTimeoutError,
                         HostLostError, StaleEpochError)
from . import guardian
from .guardian import (TrainingGuardian, TrainingDivergedError,
                       RollbackRequested, QuarantineLog)

__all__ = ["faults", "FaultInjected", "TornWrite", "configure", "inject",
           "clear", "reset", "trace", "fire", "mutate", "active",
           "RetryPolicy", "RetryBudget", "CircuitBreaker", "ServerLostError",
           "supervisor", "JobSupervisor", "CollectiveTimeoutError",
           "HostLostError", "StaleEpochError", "guardian", "TrainingGuardian", "TrainingDivergedError",
           "RollbackRequested", "QuarantineLog"]


class ServerLostError(MXNetError):
    """A parameter server is permanently gone (crashed, partitioned past
    the retry budget, or restarted empty): `server` (index), `addr`
    ("host:port") and `keys` (what that server owned), as in the JAX
    package (`resilience/__init__.py:54`)."""

    def __init__(self, server, addr, keys=(), reason=""):
        self.server = int(server)
        self.addr = str(addr)
        self.keys = sorted(str(k) for k in keys)
        shown = ", ".join(self.keys[:8])
        if len(self.keys) > 8:
            shown += f", ... ({len(self.keys)} keys)"
        super().__init__(
            f"parameter server {server} ({addr}) is lost"
            + (f": {reason}" if reason else "")
            + (f"; it owned key range(s) of [{shown}]" if self.keys else "")
            + " — restart the server and resume from the latest checkpoint")
