"""Named-axis collectives over a mesh of ranks (the NCCL verbs,
reference `src/kvstore/kvstore_nccl.h:285-402` and `comm.h`).

PyTorch port of `incubator_mxnet_tpu/parallel/collectives.py`.  Where
the JAX verbs run inside a `shard_map` region and name a bound axis,
each verb here runs eagerly over the subgroup of one axis of a mesh of
ranks: the mesh passed as ``mesh=``, else the innermost one bound by
``with mesh:``.  Values are torch tensors or NDArrays (an NDArray comes
back as an NDArray on its context).  The card's tensors stay on the
card; only `ppermute` on a gloo group stages them through pinned host
memory, because gloo's point-to-point verbs cannot read the card
(`verbs`).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import verbs as _hs

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "ppermute",
           "broadcast", "axis_index", "axis_size", "supervised"]


def _mesh(axis_name, mesh):
    if mesh is None:
        for m in _bound_meshes():
            if axis_name in m.shape:
                mesh = m
                break
    if mesh is None:
        raise MXNetError(f"collective over axis {axis_name!r}: no mesh "
                         "with that axis is bound (pass mesh= or use "
                         "'with mesh:')")
    mesh._check_axis(axis_name)
    return mesh


def _bound_meshes():
    from .mesh import _bound
    return list(reversed(_bound()))


def _unwrap(x):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data, (lambda t: NDArray(t, ctx=x.context))
    return x, (lambda t: t)


def all_reduce(x, axis_name, op="sum", mesh=None):
    """ncclAllReduce equivalent: sum, mean, max or min over the axis."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown op {op}")
    t, wrap = _unwrap(x)
    return wrap(_hs.all_reduce(t, op, _mesh(axis_name, mesh).group(
        axis_name)))


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None):
    """ncclAllGather equivalent: the axis's values concatenated along
    `axis` (``tiled``) or stacked in a new leading `axis`."""
    t, wrap = _unwrap(x)
    g = _mesh(axis_name, mesh).group(axis_name)
    n = torch.distributed.get_world_size(g)
    moved = t.movedim(axis, 0) if tiled else t.unsqueeze(0)
    out = _hs.all_gather(moved, g)
    if tiled:
        return wrap(out.movedim(0, axis))
    return wrap(out.reshape((n,) + tuple(t.shape)).movedim(0, axis))


def reduce_scatter(x, axis_name, scatter_axis=0, mesh=None):
    """ncclReduceScatter equivalent (ZeRO-style sharded grads): the sum
    over the axis, each rank keeping its chunk of `scatter_axis`."""
    t, wrap = _unwrap(x)
    g = _mesh(axis_name, mesh).group(axis_name)
    out = _hs.reduce_scatter(t.movedim(scatter_axis, 0), "sum", g)
    return wrap(out.movedim(0, scatter_axis))


def ppermute(x, axis_name, perm, mesh=None):
    """Ring/neighbour exchange: for each (src, dst) in `perm` (indices
    along the axis) dst receives src's value; a rank no pair sends to
    gets zeros, as in JAX."""
    t, wrap = _unwrap(x)
    m = _mesh(axis_name, mesh)
    g = m.group(axis_name)
    me = m.axis_index(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise MXNetError(f"ppermute: {perm} sends or receives twice at "
                         f"index {me}")
    return wrap(_p2p(t, g, dst[0] if dst else None,
                     src[0] if src else None))


def _p2p(t, g, dst, src):
    """Send `t` to group rank `dst` and receive from `src` (either may be
    None); what was received, or zeros."""
    import torch.distributed as dist
    if dst is not None and src is not None:
        return _hs.send_recv(t, dst, src, g)
    staged = _hs._staged(g, t)
    out = torch.zeros_like(t)
    if dst is not None:
        buf = _hs._host(t) if staged else t.contiguous()
        dist.send(buf, dist.get_global_rank(g, dst), group=g)
    if src is not None:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged) \
            if staged else out
        dist.recv(buf, dist.get_global_rank(g, src), group=g)
        out = buf.to(t.device) if staged else buf
    return out


def broadcast(x, axis_name, src=0, mesh=None):
    """ncclBcast equivalent: everyone takes src's value."""
    t, wrap = _unwrap(x)
    return wrap(_hs.broadcast(t, src, _mesh(axis_name, mesh).group(
        axis_name)))


def axis_index(axis_name, mesh=None):
    return _mesh(axis_name, mesh).axis_index(axis_name)


def axis_size(axis_name, mesh=None):
    return _mesh(axis_name, mesh).shape[axis_name]


def supervised(name, fn, axis_name=None, timeout=None):
    """Run a blocking host-level collective under the active
    `JobSupervisor`'s hung-collective watchdog (a plain call when none is
    active); on expiry `CollectiveTimeoutError` names the collective,
    the axis and the hosts that did not arrive."""
    from ..resilience.supervisor import supervised as _supervised
    return _supervised(name, fn, axis=axis_name, timeout=timeout)
