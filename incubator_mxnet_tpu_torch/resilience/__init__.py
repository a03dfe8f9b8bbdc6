"""Fault injection, retry and failover primitives.

PyTorch port of the part of `incubator_mxnet_tpu/resilience/` that the
dist kvstore, the sharded embedding table and the serving batcher use:
`RetryPolicy` and `RetryBudget` (exponential backoff with jitter,
deadlines, a shared budget), `CircuitBreaker` (consecutive-failure trip,
half-open probes), `ServerLostError`, the structured error a permanently
lost parameter server raises, and `faults`, the deterministic fault
injection registry (``MXNET_FAULTS``; `inject`, `configure`, `fire`,
`trace`).  The elastic supervisor and the training guardian are not
ported (README, "Declared divergences").
"""
from __future__ import annotations

from ..base import MXNetError
from . import faults
from .faults import (FaultInjected, TornWrite, configure, inject, clear,
                     reset, trace, fire, active)
from .retry import RetryPolicy, RetryBudget
from .breaker import CircuitBreaker

__all__ = ["faults", "FaultInjected", "TornWrite", "configure", "inject",
           "clear", "reset", "trace", "fire", "active", "RetryPolicy",
           "RetryBudget", "CircuitBreaker", "ServerLostError"]


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
