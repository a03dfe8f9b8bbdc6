"""Inference serving: dynamic batching over a ladder of batch buckets.

PyTorch port of the request path of `incubator_mxnet_tpu/serving/`:
`ServedModel` (model.py), `MicroBatcher` (batcher.py), `ModelServer`
(server.py) and `ServingMetrics` (metrics.py).  Minimal server::

    import incubator_mxnet_tpu_torch as mx
    srv = mx.serving.ModelServer(max_queue_latency_ms=2.0)
    srv.load_model("vgg16", prefix="vgg16", epoch=0,
                   data_shapes=[("data", (1, 3, 224, 224))],
                   buckets=(1, 2, 4, 8, 16, 32))
    out = srv.predict("vgg16", {"data": x})[0]
    srv.shutdown(drain=True)
"""
from __future__ import annotations

from .model import ServedModel, DEFAULT_BUCKETS
from .batcher import MicroBatcher
from .server import ModelServer
from .metrics import ServingMetrics, LatencyReservoir

__all__ = ["ServedModel", "MicroBatcher", "ModelServer", "ServingMetrics",
           "LatencyReservoir", "DEFAULT_BUCKETS"]
