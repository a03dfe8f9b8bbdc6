"""Reductions and broadcasting ops.

PyTorch port of `incubator_mxnet_tpu/ops/reduce.py` (reference
`src/operator/tensor/broadcast_reduce_op_{value,index}.cc`).  MXNet's
reduce semantics: ``axis`` may be None, an int or a tuple,
``exclude=True`` reduces over the other axes, ``keepdims`` keeps the
reduced axes; reducing over no axis returns the input unchanged.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

_REDUCE_PARAMS = {"axis": None, "keepdims": False, "exclude": False}


def _norm_axis(params, ndim):
    axis = params.get("axis", None)
    if axis is None or axis == () or axis == []:
        return () if params.get("exclude", False) else tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    axes = tuple(a % ndim for a in axis)
    if params.get("exclude", False):
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


_REDUCERS = {
    "sum": (lambda x, a, k: torch.sum(x, dim=a, keepdim=k), ("sum_axis",)),
    "mean": (lambda x, a, k: torch.mean(x, dim=a, keepdim=k), ()),
    "prod": (lambda x, a, k: _prod(x, a, k), ()),
    "nansum": (lambda x, a, k: torch.nansum(x, dim=a, keepdim=k), ()),
    "nanprod": (lambda x, a, k: _prod(torch.nan_to_num(x, nan=1.0), a, k),
                ()),
    "max": (lambda x, a, k: torch.amax(x, dim=a, keepdim=k), ("max_axis",)),
    "min": (lambda x, a, k: torch.amin(x, dim=a, keepdim=k), ("min_axis",)),
}


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _reduce(name, f):
    def fn(params, x):
        axes = _norm_axis(params, x.dim())
        if axes == ():
            return torch.nan_to_num(x, nan=0.0) \
                if name in ("nansum", "nanprod") else x.clone()
        return f(x, axes, bool(params.get("keepdims", False)))
    return fn


for _name, (_f, _aliases) in _REDUCERS.items():
    register(_name, params=dict(_REDUCE_PARAMS),
             aliases=_aliases)(_reduce(_name, _f))


@register("norm", params={"ord": 2, "axis": None, "keepdims": False,
                          "out_dtype": None})
def _norm(params, x):
    """L1 or L2 norm (reference `broadcast_reduce_op_value.cc` norm)."""
    ordv = int(params["ord"])
    axis = params["axis"]
    dims = tuple(range(x.dim())) if axis is None else \
        ((axis,) if isinstance(axis, int) else tuple(axis))
    keep = bool(params["keepdims"])
    if ordv == 1:
        out = x.abs().sum(dim=dims, keepdim=keep)
    elif ordv == 2:
        out = x.square().sum(dim=dims, keepdim=keep).sqrt()
    else:
        raise MXNetError("norm only supports ord=1 or 2 (as the reference)")
    if params["out_dtype"]:
        from ..base import torch_dtype
        out = out.to(torch_dtype(params["out_dtype"]))
    return out


def _arg(f):
    def fn(params, x):
        axis = params.get("axis", None)
        keep = bool(params.get("keepdims", False))
        if axis is None:
            out = f(x.reshape(-1), dim=0).float()
            return out.reshape((1,) * x.dim()) if keep else out
        return f(x, dim=int(axis), keepdim=keep).float()
    return fn


# MXNet's argmax/argmin return a float dtype
register("argmax", params={"axis": None, "keepdims": False})(
    _arg(torch.argmax))
register("argmin", params={"axis": None, "keepdims": False})(
    _arg(torch.argmin))


@register("argmax_channel")
def _argmax_channel(params, x):
    return torch.argmax(x, dim=1).float()


@register("broadcast_to", params={"shape": ()})
def _broadcast_to(params, x):
    tgt = tuple(params["shape"])
    # 0 keeps the input's size
    tgt = tuple(x.shape[i] if t == 0 else t for i, t in enumerate(tgt))
    return x.expand(tgt)


@register("broadcast_axis", params={"axis": (), "size": ()},
          aliases=("broadcast_axes",))
def _broadcast_axis(params, x):
    axes, sizes = params["axis"], params["size"]
    axes = (axes,) if isinstance(axes, int) else axes
    sizes = (sizes,) if isinstance(sizes, int) else sizes
    shape = list(x.shape)
    for a, s in zip(axes, sizes):
        shape[a % x.dim()] = s
    return x.expand(tuple(shape))


@register("broadcast_like", nin=2)
def _broadcast_like(params, x, like):
    return x.expand(like.shape)
