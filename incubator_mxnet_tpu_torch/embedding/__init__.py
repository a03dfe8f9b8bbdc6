"""Sharded sparse embeddings for recommender workloads.

PyTorch port of `incubator_mxnet_tpu/embedding/`: embedding tables too
big for one device, range- or hash-partitioned into row shards hosted on
the parameter servers (`dist.server`), trained with lazy row-sparse
updates applied shard-side, and looked up through a hot-row cache on the
card.

- `ShardedEmbedding`  — the sharded table client (pull, push, breakers,
  `ServerLostError` diagnosis, checkpoint capture and restore)
- `HotRowCache`       — the device-resident LRU row cache
- `EmbeddingFitAdapter` — trains a table through `Module.fit`
- `EmbeddingServingPath` — fans a request's ids out to the shards, then
  submits the dense tower through a `ReplicaRouter`
"""
from .cache import HotRowCache
from .sharded import ShardedEmbedding, shard_of_ids
from .fit import EmbeddingFitAdapter
from .serving import EmbeddingServingPath

__all__ = ["HotRowCache", "ShardedEmbedding", "shard_of_ids",
           "EmbeddingFitAdapter", "EmbeddingServingPath"]
