"""Continuous train-to-serve loop (the closed production loop).

PyTorch port of `incubator_mxnet_tpu/loop/`.

Composes the subsystems that already exist — elastic checkpoints with
guardian health stamps, the replica router's zero-compile rolling swap,
the obs plane — into the loop production actually runs:

* `ModelRegistry` (registry.py) — the versioned, atomic hand-off
  directory between trainer and fleet; torn manifests invisible,
  ``rejected`` stamps and guardian ``fence`` windows hide versions
  permanently;
* `CheckpointPublisher` (publisher.py) — rides `Module.fit`, publishes
  guardian-healthy checkpoints on a cadence with a data-shard watermark
  and fences rollback/divergence windows out of the registry;
* `LoopController` (controller.py) — serving-side watcher: every new
  version is canaried on ONE replica against a pinned holdout before
  the rolling swap promotes it; failed canaries are swapped back,
  stamped rejected, and surfaced as `CanaryRejectedError`.

Freshness is measured end-to-end as ``loop.freshness_lag_s`` (data-seen
watermark → serving-live), a gauge of the ``loop`` namespace in
`obs.metrics`; on the card, `chip_smoke.py` phase 22c drives the whole
loop (a trainer thread, the registry, a router of replicas) with a
poisoned version and a torn publish.
"""
from __future__ import annotations

from .registry import (ModelRegistry, RegistryUnavailableError,
                       REGISTRY_FORMAT)
from .publisher import CheckpointPublisher
from .controller import CanaryRejectedError, LoopController

__all__ = ["ModelRegistry", "RegistryUnavailableError", "REGISTRY_FORMAT",
           "CheckpointPublisher", "LoopController", "CanaryRejectedError"]
