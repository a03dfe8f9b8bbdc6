"""Multi-process distributed training on the parameter server.

PyTorch port of `incubator_mxnet_tpu/dist/` (reference ps-lite stack:
`src/kvstore/kvstore_dist.h` worker, `kvstore_dist_server.h` server,
`tools/launch.py` launcher), on its socket data plane:

* `transport`  — framed request/response channels over TCP, the JAX
  package's wire;
* `compression` — the 2-bit wire codec, the JAX package's bytes;
* `membership` — the root server's membership table;
* `server`     — `ParameterServer`: sync rounds, async pushes, the
  server-side optimizer, the sharded embedding table's row shards;
  ``python -m incubator_mxnet_tpu_torch.dist.server``;
* `collective` — the workers' `torch.distributed` process group (gloo,
  or NCCL with a card a rank), torn down and re-formed at a smaller
  world by shrink-and-resume;
* `kvstore_dist` — `KVStoreDist`, the worker side, with the collective
  data plane (the default for ``dist_sync``) and the socket plane;
* `launch`     — a local launcher: servers and workers with the dmlc
  tracker's environment;
* `pod_worker` — one elastic pod worker (``python -m
  incubator_mxnet_tpu_torch.dist.pod_worker``), the repo's
  `tools/pod_worker.py` for the port.
"""
from . import compression, transport
from .kvstore_dist import KVStoreDist

__all__ = ["compression", "transport", "KVStoreDist", "ParameterServer"]


def __getattr__(name):
    # lazy: `python -m ...dist.server` would import server twice
    if name == "ParameterServer":
        from .server import ParameterServer
        return ParameterServer
    raise AttributeError(name)
