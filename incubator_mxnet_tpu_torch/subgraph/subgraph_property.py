"""SubgraphProperty: what to match and what to replace it with
(reference `src/operator/subgraph/subgraph_property.h`).  PyTorch-port
copy of `incubator_mxnet_tpu/subgraph/subgraph_property.py`."""
from __future__ import annotations

from ..base import MXNetError

_BACKENDS = {}


class SubgraphProperty:
    """A pluggable partition backend.

    Subclasses override:
    * `match_chain(node, get_input)` — given a candidate END node of a
      chain (and a callback returning the producer of its i-th input),
      return the list of chain nodes [first..last] to fuse, or None.
      Chain fusion covers the practically useful cases (conv+bn+relu,
      fc+relu, quantize chains) without the full convex-cut machinery of
      `partition_graph.cc`; properties needing richer selection can
      override `select` wholesale.
    * `create_fused_op(nodes)` — return (registered OpDef, params dict,
      external inputs) computing the fused chain; the fn sees the chain's
      ORIGINAL external inputs in first-occurrence order.
    """

    name = "base"

    def match_chain(self, node, get_input):
        return None

    def create_fused_op(self, nodes):
        raise NotImplementedError


def register_subgraph_property(prop):
    """Register a backend instance (reference
    `MXNET_REGISTER_SUBGRAPH_PROPERTY`)."""
    _BACKENDS[prop.name] = prop
    return prop


def get_subgraph_property(name):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise MXNetError(
            f"subgraph backend {name!r} is not registered; available: "
            f"{sorted(_BACKENDS)}") from None


def list_backends():
    return sorted(_BACKENDS)
