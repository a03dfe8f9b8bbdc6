"""Priority classes of the serving plane.

PyTorch port of the priority table of `incubator_mxnet_tpu/serving/
router.py`: the three classes a request carries and their dispatch rank,
which the decode engine's queue orders by.  The `ReplicaRouter` itself
(least-loaded dispatch, failover, shedding, rolling swaps) waits for
ROADMAP.md, Queue 1 item 14.
"""
from __future__ import annotations

__all__ = ["PRIORITIES", "PRIORITY_RANK"]

PRIORITIES = ("interactive", "batch", "best_effort")
# dispatch rank inside replica queues: interactive is served first even
# when lower classes were admitted ahead of it
PRIORITY_RANK = {"interactive": 0, "batch": 1, "best_effort": 2}
