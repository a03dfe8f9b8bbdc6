"""`mx.parallel`: SPMD parallelism over a mesh of ranks (port of
`incubator_mxnet_tpu/parallel/`).

* `mesh.py` — meshes over the ranks of a `torch.distributed` group (a
  `DeviceMesh` with named dp/tp/pp/sp axes) or over a grid of contexts,
  the spec grammar, `initialize_distributed`
* `collectives.py` — named-axis collective verbs (the NCCL verbs)
* `data_parallel.py` — the data-parallel train step
* `tensor_parallel.py` — parameter-sharding rules as DTensor layouts
* `gluon_bridge.py` — gluon blocks, batches and optimizer state on a
  mesh (K1 on each rank's shards)
* `zero.py` — ZeRO-sharded optimizer state
* `pipeline.py` — the pipeline-parallel microbatch schedule over `pp`
* `ring_attention.py` — ring attention over a sequence-parallel group
"""
from .mesh import (make_mesh, mesh_axes, local_mesh, rebuild, mesh_from_spec,
                   parse_spec, dp_axis_of, initialize_distributed, Mesh, P,
                   PartitionSpec, NamedSharding)
from .gluon_bridge import (shard_block, block_shardings,
                           shard_state_for_zero, put)
from .collectives import (all_reduce, all_gather, reduce_scatter, ppermute,
                          broadcast, supervised)
from .data_parallel import data_parallel_step, replicate, unreplicate
from .tensor_parallel import shard_params, ShardingRules
from .ring_attention import ring_attention, blockwise_attention
from .pipeline import pipeline_step, pipeline_train_step
from .zero import zero_train_step, zero_update, zero_init_state

__all__ = ["make_mesh", "mesh_axes", "local_mesh", "rebuild",
           "mesh_from_spec", "parse_spec", "dp_axis_of",
           "initialize_distributed", "Mesh", "P", "PartitionSpec",
           "NamedSharding", "shard_block", "block_shardings",
           "shard_state_for_zero", "put", "all_reduce", "all_gather",
           "reduce_scatter", "ppermute", "broadcast", "supervised",
           "data_parallel_step", "replicate", "unreplicate", "shard_params",
           "ShardingRules", "ring_attention", "blockwise_attention",
           "pipeline_step", "pipeline_train_step", "zero_train_step",
           "zero_update", "zero_init_state"]
