"""Mesh parallelism through the Gluon front-end.

PyTorch port of `incubator_mxnet_tpu/parallel/gluon_bridge.py`.  The
reference's model parallelism pins layers to devices by hand
(`ctx_group` attrs + `group2ctx`, `symbol.py:1336-1439`); its data
parallelism copies parameters per device.  Here both become layouts on
a mesh of ranks: every parameter (and its gradient buffer) is ONE
global DTensor laid out over the mesh, the batch is a DTensor sharded
over ``dp``, and eager and hybridized compute propagate the placements
(DTensor's rules, where GSPMD's serve the JAX package), inserting the
all-gathers and reductions the reference's `_CrossDeviceCopy` op and
NCCL reduce did by hand.  Kernel K1 (`_sg_pallas_fc_relu`) runs on each
rank's local shards (`subgraph.fused_ops`).

Usage, in every rank::

    mx.parallel.initialize_distributed(...)
    mesh = mx.parallel.make_mesh({"dp": 2, "tp": 2})
    net.initialize(ctx=mx.cpu())           # one global copy
    mx.parallel.shard_block(net, mesh, ShardingRules.megatron("tp"))
    mx.parallel.put(x, mesh, P("dp"))      # the batch over dp
    trainer = gluon.Trainer(net.collect_params(), "adam", ...,
                            zero=mesh)     # ZeRO: optimizer state sharded

Training then proceeds with the ordinary autograd/Trainer loop.
"""
from __future__ import annotations

import torch

from .mesh import NamedSharding, P
from .tensor_parallel import (ShardingRules, clean_spec, distribute,
                              local_chunk)

__all__ = ["shard_block", "block_shardings", "shard_state_for_zero", "put",
           "is_sharded", "place_state_like", "update_on_shards"]


def is_sharded(t):
    """Whether the tensor `t` is a DTensor laid out on a mesh."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _ctx_of_mesh(mesh):
    from ..context import cpu, gpu
    import torch
    if mesh.device_type == "cuda":
        return gpu(torch.cuda.current_device())
    return cpu()


def put(x, mesh, spec=P()):
    """Place an NDArray (or a tensor holding the same values on every
    rank) on the mesh with `spec` — e.g. ``put(batch, mesh, P("dp"))``
    shards the batch dim for data parallelism, the input-side counterpart
    of `shard_block`."""
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        x._data = distribute(x._data, mesh, spec)
        x._ctx = _ctx_of_mesh(mesh)
        return x
    return distribute(x, mesh, spec)


def block_shardings(block, mesh, rules=None):
    """{param name: NamedSharding} for every parameter of `block`."""
    rules = rules or ShardingRules()
    return {p.name: NamedSharding(mesh, clean_spec(
                p.shape, rules.spec_for(p.name), mesh))
            for p in block.collect_params().values()}


def shard_block(block, mesh, rules=None):
    """Lay every initialized parameter (and its gradient buffer) of
    `block` out over the mesh of ranks per `rules`.

    Parameters must be initialized on a SINGLE context (one global copy,
    the same values on every rank); after this call each parameter's
    array is a DTensor on the mesh's device and the forward, backward and
    update follow the layout.  Returns the {name: NamedSharding} map
    applied.
    """
    shardings = block_shardings(block, mesh, rules)
    ctx = _ctx_of_mesh(mesh)
    for p in block.collect_params().values():
        datas = p._data
        if datas is None:
            raise ValueError(
                f"Parameter {p.name} is not initialized; call "
                "initialize(ctx=<one ctx>) before shard_block")
        if len(datas) != 1:
            raise ValueError(
                f"Parameter {p.name} is replicated over {len(datas)} "
                "contexts; mesh sharding needs a single global copy "
                "(initialize with one ctx)")
        spec = shardings[p.name].spec
        d = datas[0]
        d._data = distribute(d._data, mesh, spec)
        d._ctx = ctx
        for g in p._grad or ():
            g._data = distribute(g._data, mesh, spec, requires_grad=False)
            g._ctx = ctx
        p._ctx_list = [ctx]
    return shardings


def shard_state_for_zero(state, mesh, axis):
    """Shard optimizer-state NDArrays over `axis` (ZeRO: each rank of the
    axis holds 1/N of every state tensor, replicated over the other axes;
    a DTensor update redistributes the gradient to the state's layout and
    the fresh weights back to theirs — the mesh reading of the reference's
    range-sharded parameter servers, `kvstore_dist_server.h`).  Leaves
    whose leading dim does not divide the axis stay replicated."""
    from ..ndarray.ndarray import NDArray
    n = mesh.shape[axis]

    def place(leaf):
        if not isinstance(leaf, NDArray):
            return
        spec = P(axis) if leaf.ndim and leaf.shape[0] % n == 0 else P()
        leaf._data = distribute(leaf._data, mesh, spec, requires_grad=False)

    _each_leaf(state, place)


def place_state_like(state, like):
    """Lay optimizer-state NDArrays out as the DTensor `like` is (a
    sharded weight's state without ZeRO)."""
    from torch.distributed.tensor import DTensor
    from ..ndarray.ndarray import NDArray

    def place(leaf):
        if isinstance(leaf, NDArray) and not isinstance(leaf._data, DTensor):
            local = local_chunk(leaf._data.detach(), like.device_mesh,
                                like.placements)
            leaf._data = DTensor.from_local(
                local.to(like.to_local().device).contiguous().clone(),
                like.device_mesh, like.placements, run_check=False,
                shape=like.shape, stride=like.stride())

    _each_leaf(state, place)


def _each_leaf(state, fn):
    if isinstance(state, (list, tuple)):
        for s in state:
            _each_leaf(s, fn)
    elif state is not None:
        fn(state)


def update_on_shards(optimizer, index, weight, grad, state):
    """One optimizer update of a mesh-sharded weight, on each rank's local
    shards: the gradient and the weight are laid out as the state is (as
    the weight is for a stateless optimizer), the optimizer updates the
    local tensors in place (the state's own), and a weight laid out
    otherwise takes the updated shards back (with ZeRO: the all-gather
    over dp).  Elementwise updates need all operands in one layout;
    DTensor's in-place rules do not promise that on every torch the port
    runs on."""
    from torch.distributed.tensor import DTensor
    from ..ndarray.ndarray import NDArray
    leaves = []
    _each_leaf(state, lambda leaf: leaves.append(leaf))
    w = weight.data
    mesh = w.device_mesh
    layout = next((tuple(leaf._data.placements) for leaf in leaves
                   if isinstance(leaf, NDArray) and
                   isinstance(leaf._data, DTensor)), tuple(w.placements))

    def local(t):
        t = t.redistribute(mesh, layout) if isinstance(t, DTensor) else t
        return t.to_local() if isinstance(t, DTensor) else t

    def local_state(s):
        if isinstance(s, (list, tuple)):
            return type(s)(local_state(x) for x in s)
        if isinstance(s, NDArray) and isinstance(s._data, DTensor):
            return NDArray(s._data.to_local(), ctx=s.context)
        return s
    wl = NDArray(local(w.detach()), ctx=weight.context)
    gl = NDArray(local(grad.data), ctx=grad.context)
    optimizer.update_multi_precision(index, wl, gl, local_state(state))
    if layout != tuple(w.placements):
        whole = DTensor.from_local(wl.data, mesh, layout, run_check=False,
                                   shape=w.shape, stride=w.stride())
        with torch.no_grad():
            w.to_local().copy_(whole.redistribute(
                mesh, w.placements).to_local())
