"""Graph partitioning (reference `src/operator/subgraph/partition_graph.cc`).

Walks the Symbol DAG, asks the property for fusable chains, and rebuilds
the graph with each chain contracted into one fused-op node.  A chain is
only contracted when its interior nodes have no consumers outside the
chain (the convexity condition `partition_graph.cc` enforces generally).

PyTorch-port copy of `incubator_mxnet_tpu/subgraph/partition.py`: the
same chains and fused node names, so a partitioned graph's JSON is the
same in both packages.
"""
from __future__ import annotations

from ..base import MXNetError
from ..symbol.symbol import Symbol, _Node
from .subgraph_property import get_subgraph_property


def partition_graph(symbol, prop_or_name):
    prop = (get_subgraph_property(prop_or_name)
            if isinstance(prop_or_name, str) else prop_or_name)
    topo = symbol._topo()

    # consumer counts for the convexity check
    n_consumers = {}
    for node in topo:
        for src, _ in node.inputs:
            n_consumers[id(src)] = n_consumers.get(id(src), 0) + 1
    for node, _ in symbol._entries:
        n_consumers[id(node)] = n_consumers.get(id(node), 0) + 1

    def get_input(node, i=0):
        return node.inputs[i][0] if node.inputs else None

    # choose chains greedily in topo order; a node joins at most one chain
    in_chain = {}
    chains = []
    for node in reversed(topo):          # prefer chains ending latest
        if node.is_variable or id(node) in in_chain:
            continue
        chain = prop.match_chain(node, get_input)
        if not chain:
            continue
        if any(id(c) in in_chain for c in chain):
            continue
        # interior nodes must feed only the next chain node
        ok = all(n_consumers.get(id(c), 0) == 1 for c in chain[:-1])
        if not ok:
            continue
        for c in chain:
            in_chain[id(c)] = len(chains)
        chains.append(chain)

    if not chains:
        return symbol

    # rebuild bottom-up
    memo = {}

    def build(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.is_variable:
            memo[id(node)] = node
            return node
        cidx = in_chain.get(id(node))
        if cidx is not None and node is chains[cidx][-1]:
            chain = chains[cidx]
            op, params, ext_inputs = prop.create_fused_op(chain)
            new_inputs = [(build(src), oi) for src, oi in ext_inputs]
            fused = _Node(op, f"{chain[-1].name}_{prop.name.lower()}",
                          dict(params), new_inputs)
            memo[id(node)] = fused
            return fused
        if cidx is not None:
            raise MXNetError("internal: interior chain node reached "
                             "directly — chain not convex")
        new = _Node(node.op, node.name, dict(node.attrs),
                    [(build(src), oi) for src, oi in node.inputs])
        new._extra_attrs = dict(node._extra_attrs)
        memo[id(node)] = new
        return new

    entries = [(build(n), i) for n, i in symbol._entries]
    return Symbol(entries)


def external_inputs(chain):
    """The fused node's inputs: every (producer, out_idx) feeding the chain
    from outside, first occurrence order."""
    member = {id(c) for c in chain}
    out = []
    seen = set()
    for node in chain:
        for src, oi in node.inputs:
            if id(src) in member:
                continue
            key = (id(src), oi)
            if key not in seen:
                seen.add(key)
                out.append((src, oi))
    return out
