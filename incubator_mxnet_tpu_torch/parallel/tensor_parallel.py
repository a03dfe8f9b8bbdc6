"""Tensor-parallel sharding rules.

PyTorch port of `incubator_mxnet_tpu/parallel/tensor_parallel.py`: the
declarative successor to the reference's manual model parallelism
(`ctx_group` attrs + `group2ctx` bind arg, `symbol.py:1336-1439`).
Parameters get `PartitionSpec`s by name pattern; on a mesh of ranks
each becomes a DTensor whose placements follow the spec, and DTensor
inserts the all-gathers and reductions that the reference's
`_CrossDeviceCopy` op did by hand (GSPMD does it in the JAX package).
Megatron-style rules: column-parallel then row-parallel pairs.
"""
from __future__ import annotations

import re

import torch

from .mesh import NamedSharding, P, placements_of

__all__ = ["ShardingRules", "shard_params", "group2ctx_shardings",
           "distribute", "clean_spec", "local_chunk", "on_local_shards",
           "on_local_rows"]


class ShardingRules:
    """Ordered (regex, PartitionSpec) rules applied to parameter names."""

    def __init__(self, rules=(), default=P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, name):
        for prog, spec in self.rules:
            if prog.search(name):
                return spec
        return self.default

    @staticmethod
    def megatron(tp_axis="tp"):
        """Column-parallel qkv/ffn-in, row-parallel proj/ffn-out."""
        return ShardingRules([
            (r"(qkv|query|key|value|gate|up|fc1|ffn_in).*weight",
             P(tp_axis, None)),
            (r"(out_proj|down|fc2|ffn_out|proj).*weight", P(None, tp_axis)),
            (r"embed.*weight", P(tp_axis, None)),
            (r"bias", P()),
        ])


def clean_spec(shape, spec, mesh):
    """`spec` with every axis that does not divide its dimension dropped
    (the JAX rule)."""
    ext = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    clean = []
    for dim, ax in zip(shape, ext):
        if ax is None:
            clean.append(None)
        else:
            size = mesh.shape[ax] if isinstance(ax, str) else 1
            clean.append(ax if size and dim % size == 0 else None)
    return P(*clean)


def distribute(t, mesh, spec, requires_grad=None):
    """A DTensor of the whole tensor `t` (the same values on every rank)
    laid out by `spec` on the mesh of ranks: each rank keeps its chunk,
    with no communication.  The chunk goes to the mesh's device type.
    ``requires_grad`` (default: `t`'s) makes it a leaf that takes a
    gradient."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    dm = mesh.device_mesh
    placements = placements_of(mesh, spec)
    dev = torch.device(dm.device_type, torch.cuda.current_device()) \
        if dm.device_type == "cuda" else torch.device(dm.device_type)
    local = local_chunk(t.detach(), dm, placements).to(dev).contiguous() \
        .clone()
    out = DTensor.from_local(local, dm, placements, run_check=False,
                             shape=t.shape, stride=t.contiguous().stride())
    grad = t.requires_grad if requires_grad is None else requires_grad
    if grad and out.is_floating_point():
        out.requires_grad_()
    return out


def local_chunk(t, device_mesh, placements):
    """This rank's chunk of the whole tensor `t` laid out by `placements`
    on `device_mesh` (even chunks, in mesh-dimension order)."""
    coord = device_mesh.get_coordinate()
    for k, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(device_mesh.size(k), dim=pl.dim)[coord[k]]
    return t


def shard_params(params, mesh, rules, name_fn=None):
    """{name: DTensor} of a dict of params (NDArrays or tensors) laid out
    per the rules, an axis that does not divide its dimension dropped."""
    out = {}
    for name, arr in params.items():
        data = arr._data if hasattr(arr, "_data") else torch.as_tensor(arr)
        spec = clean_spec(data.shape, rules.spec_for(
            name if name_fn is None else name_fn(name)), mesh)
        out[name] = distribute(data, mesh, spec, requires_grad=False)
    return out


def group2ctx_shardings(symbol, group2axis, mesh):
    """Bridge legacy `group2ctx` model parallelism to mesh shardings:
    {var_name: NamedSharding} for every ``__ctx_group__``-annotated
    variable of `symbol` whose group `group2axis` maps to a
    PartitionSpec (or an axis name, sharding dim 0); its
    ``placements`` are the DTensor layout."""
    out = {}
    for node in symbol._topo():
        if not node.is_variable:
            continue
        g = node._extra_attrs.get("__ctx_group__")
        if g is None or g not in group2axis:
            continue
        spec = group2axis[g]
        if isinstance(spec, str):
            spec = P(spec)
        out[node.name] = NamedSharding(mesh, spec)
    return out


def on_local_shards(fn, x, w, b=None):
    """``fn(x, w, b)`` of a layer whose output features are dim 1 (a
    fully-connected layer, K1, a convolution) on each rank's local
    shards of DTensors on one mesh, as `local_map` would.  On each mesh
    dimension where w's rows are sharded (the layer column-parallel), x
    is replicated and w, b and the output shard by features (Shard(1));
    elsewhere w and b are replicated and a split of x's rows (dim 0: the
    batch) carries through to the output.  The inputs are redistributed
    to those layouts first (a row-split w is gathered).  The local
    gradients are partial sums where the layout splits their reduction:
    x's over the column-sharded dimensions, w's and b's over the
    dimensions that split x's rows.  A plain tensor among the inputs
    counts as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh if isinstance(w, DTensor) else x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def as_dt(t):
        return t if t is None or isinstance(t, DTensor) else \
            DTensor.from_local(t, mesh, rep, run_check=False)
    x, w, b = as_dt(x), as_dt(w), as_dt(b)
    xp, wp, op, xg, wg = [], [], [], [], []
    for xk, wk in zip(x.placements, w.placements):
        if wk.is_shard(0):
            xp.append(Replicate())
            wp.append(Shard(0))
            op.append(Shard(1))
            xg.append(Partial())
            wg.append(Shard(0))
        else:
            keep = xk if xk.is_shard(0) else Replicate()
            xp.append(keep)
            wp.append(Replicate())
            op.append(keep)
            xg.append(keep)
            wg.append(Partial() if keep.is_shard(0) else Replicate())
    y = fn(x.redistribute(mesh, xp).to_local(grad_placements=xg),
           w.redistribute(mesh, wp).to_local(grad_placements=wg),
           None if b is None else
           b.redistribute(mesh, wp).to_local(grad_placements=wg))
    return _wrap(y, mesh, op)


def on_local_rows(fn, x):
    """``fn(x)`` of an op that treats each row (dim 0) and each channel
    (dim 1) on its own (pooling) on each rank's local shard of the
    DTensor `x`: a split of rows or channels carries through, any other
    layout is replicated first, and the gradient keeps the layout
    (DTensor has no sharding rule for max pooling on every torch the
    port runs on)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    keep = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
            for p in x.placements]
    return _wrap(fn(x.redistribute(mesh, keep).to_local(
        grad_placements=keep)), mesh, keep)


def _wrap(y, mesh, placements):
    """The local `y` as a DTensor of `placements` (even shards)."""
    from torch.distributed.tensor import DTensor
    shape = list(y.shape)
    for k, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] *= mesh.size(k)
    return DTensor.from_local(y, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())
