"""Inference serving: dynamic batching over a ladder of batch buckets,
and the replica fleet around it.

PyTorch port of `incubator_mxnet_tpu/serving/`:

* `ServedModel` (model.py), `MicroBatcher` (batcher.py), `ModelServer`
  (server.py) and `ServingMetrics` (metrics.py): the request path;
* `ReplicaRouter` (router.py) over `Replica` handles (replica.py): the
  availability layer — least-loaded, breaker-aware dispatch over
  in-process `LocalReplica`s and `RemoteReplica` worker processes
  (worker.py), idempotent failover off a dead replica, rolling weight
  swaps with no dropped request, and priority classes that shed
  best_effort first;
* `FleetManager` (fleet.py) over `FleetHost` handles and `serving.hostd`
  host daemons: anti-affinity placement, host liveness through
  `dist.membership`, backfill after a host's death, and the SLO-driven
  `Autoscaler`;
* `DecodeEngine` / `DecodeReplica` (decode.py): continuous-batching LM
  decode, whose `Replica` face plugs into the router unchanged.

Minimal server::

    import incubator_mxnet_tpu_torch as mx
    srv = mx.serving.ModelServer(max_queue_latency_ms=2.0)
    srv.load_model("vgg16", prefix="vgg16", epoch=0,
                   data_shapes=[("data", (1, 3, 224, 224))],
                   buckets=(1, 2, 4, 8, 16, 32))
    out = srv.predict("vgg16", {"data": x})[0]
    srv.shutdown(drain=True)

A router over an in-process replica and a worker process, both on the
card::

    spec = dict(data_shapes=[("data", (1, 3, 224, 224))],
                buckets=(1, 2, 4, 8))
    local = mx.serving.LocalReplica(
        mx.serving.ServedModel.load("vgg16", 0, **spec), replica_id="r0")
    remote = mx.serving.RemoteReplica.spawn(prefix="vgg16", epoch=0,
                                            replica_id="w0", **spec)
    router = mx.serving.ReplicaRouter([local, remote])
    out = router.predict({"data": x}, priority="interactive")[0]
    router.shutdown()

Serving the LM from a `.params` file of its parameters::

    eng = mx.serving.DecodeEngine(cfg, mx.nd.load("lm.params"))
    out = eng.submit([1, 5, 9], max_new_tokens=16).result()["tokens"]
    eng.close()
"""
from __future__ import annotations

from .model import ServedModel, DEFAULT_BUCKETS
from .batcher import MicroBatcher
from .server import ModelServer
from .metrics import ServingMetrics, LatencyReservoir
from .replica import (Replica, LocalReplica, RemoteReplica,
                      ReplicaLostError)
from .router import ReplicaRouter, SwapInProgressError, PRIORITIES
from .fleet import (FleetManager, Autoscaler, ReplicaSpec, FleetHost,
                    InProcessHost, AgentHost)
from .decode import DecodeEngine, DecodeReplica, DEFAULT_PROMPT_BUCKETS

__all__ = ["ServedModel", "MicroBatcher", "ModelServer", "ServingMetrics",
           "LatencyReservoir", "DEFAULT_BUCKETS", "Replica", "LocalReplica",
           "RemoteReplica", "ReplicaLostError", "ReplicaRouter",
           "SwapInProgressError", "PRIORITIES", "FleetManager", "Autoscaler",
           "ReplicaSpec", "FleetHost", "InProcessHost", "AgentHost",
           "DecodeEngine", "DecodeReplica", "DEFAULT_PROMPT_BUCKETS"]
