"""Subgraph partition framework (reference `src/operator/subgraph/`).

PyTorch port of `incubator_mxnet_tpu/subgraph/`.  A backend marks chains
of a Symbol graph and replaces each with one fused op; ``TPU_PALLAS``
(`fused_ops.py`) fuses FullyConnected+bias+ReLU into kernel K1.

Usage, before saving the graph a server will load:
    partitioned = subgraph.partition_graph(sym, "TPU_PALLAS")
"""
from .subgraph_property import (SubgraphProperty, register_subgraph_property,
                                get_subgraph_property, list_backends)
from .partition import partition_graph
from . import fused_ops  # registers the TPU_PALLAS backend

__all__ = ["SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_backends", "partition_graph"]
