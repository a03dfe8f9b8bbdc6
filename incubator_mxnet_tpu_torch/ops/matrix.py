"""Shape, indexing and product ops.

PyTorch port of part of `incubator_mxnet_tpu/ops/matrix.py` (reference
`src/operator/tensor/matrix_op.cc`, `dot.cc`, `slice_channel.cc`,
`broadcast_reduce_op_index.cc`, `indexing_op.cc`): Reshape with MXNet's
special codes, Flatten, transpose, expand_dims, squeeze, swapaxes,
slice_axis, split, Concat, stack, add_n, dot, batch_dot, the indexing
ops NDArray's ``[]`` records (``_index``, ``_index_nd``), reshape_like,
pick, Embedding, where and Cast.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, torch_dtype
from .registry import register, REQUIRED


def infer_reshape(target, src_shape, reverse=False):
    """Resolve an MXNet target shape spec (0/-1/-2/-3/-4 codes) to a
    concrete shape (reference matrix_op-inl.h InferReshapeShape)."""
    target = list(target)
    src = list(src_shape)
    if reverse:
        target = target[::-1]
        src = src[::-1]
    out = []
    i = 0  # index into target
    j = 0  # index into src
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[j]); j += 1
        elif t == -1:
            out.append(-1); j += 1
        elif t == -2:
            out.extend(src[j:]); j = len(src)
        elif t == -3:
            out.append(src[j] * src[j + 1]); j += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            i += 2
            if d1 == -1 and d2 == -1:
                raise MXNetError("Split dims cannot both be -1.")
            if d1 == -1:
                d1 = src[j] // d2
            if d2 == -1:
                d2 = src[j] // d1
            out.extend([d1, d2]); j += 1
        else:
            out.append(int(t)); j += 1
        i += 1
    if reverse:
        out = out[::-1]
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = math.prod(src_shape) // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=("reshape",),
          params={"shape": (), "reverse": False, "target_shape": None,
                  "keep_highest": False})
def _reshape(params, x):
    shape = params["shape"]
    if not shape and params["target_shape"]:
        shape = params["target_shape"]  # legacy param
    return x.reshape(infer_reshape(shape, x.shape, bool(params["reverse"])))


@register("Flatten", aliases=("flatten",))
def _flatten(params, x):
    """Collapse all but the first axis (reference matrix_op.cc Flatten)."""
    return x.reshape(x.shape[0], -1)


@register("transpose", params={"axes": ()})
def _transpose(params, x):
    axes = params["axes"] or tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*axes)


@register("expand_dims", params={"axis": REQUIRED})
def _expand_dims(params, x):
    return x.unsqueeze(int(params["axis"]))


@register("squeeze", params={"axis": None})
def _squeeze(params, x):
    axis = params["axis"]
    if axis is None:
        return x.squeeze()
    return x.squeeze((axis,) if isinstance(axis, int) else tuple(axis))


@register("SwapAxis", aliases=("swapaxes",), params={"dim1": 0, "dim2": 0})
def _swapaxes(params, x):
    return x.transpose(int(params["dim1"]), int(params["dim2"]))


@register("slice_axis", params={"axis": REQUIRED, "begin": REQUIRED,
                               "end": None})
def _slice_axis(params, x):
    """``x[begin:end]`` along `axis` (reference `matrix_op.cc`
    slice_axis); ``end=None`` runs to the end."""
    axis = int(params["axis"]) % x.dim()
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(params["begin"], params["end"])
    return x[tuple(sl)]


def _split_nout(params):
    return int(params["num_outputs"])


@register("SliceChannel", aliases=("split",), nout=_split_nout,
          params={"num_outputs": REQUIRED, "axis": 1, "squeeze_axis": False})
def _split(params, x):
    """`num_outputs` equal parts along `axis` (reference
    `slice_channel.cc`)."""
    n = int(params["num_outputs"])
    axis = int(params["axis"]) % x.dim()
    parts = torch.chunk(x, n, dim=axis)
    if params["squeeze_axis"]:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("Concat", aliases=("concat",), nin=-1, variadic_param="num_args",
          params={"num_args": 0, "dim": 1})
def _concat(params, *xs):
    return torch.cat(xs, dim=int(params["dim"]))


@register("stack", nin=-1, variadic_param="num_args",
          params={"num_args": 0, "axis": 0})
def _stack(params, *xs):
    return torch.stack(xs, dim=int(params["axis"]))


@register("add_n", aliases=("ElementWiseSum", "_sum"), nin=-1,
          variadic_param="num_args", params={"num_args": 0})
def _add_n(params, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register("dot", nin=2, params={"transpose_a": False, "transpose_b": False,
                                "forward_stype": None})
def _dot(params, a, b):
    """The last axis of a against the first of b, after the optional
    transposes (reference `dot.cc`)."""
    if params["transpose_a"]:
        a = a.permute(*range(a.dim() - 1, -1, -1))
    if params["transpose_b"]:
        b = b.permute(*range(b.dim() - 1, -1, -1))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", nin=2, params={"transpose_a": False,
                                      "transpose_b": False,
                                      "forward_stype": None})
def _batch_dot(params, a, b):
    if params["transpose_a"]:
        a = a.transpose(-1, -2)
    if params["transpose_b"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("_index", params={"key": REQUIRED})
def _index(params, x):
    """Basic indexing as a differentiable op (what NDArray's ``[]``
    records)."""
    return x[params["key"]]


@register("_index_nd", nin=2)
def _index_nd(params, x, idx):
    """Integer-array indexing along axis 0, differentiable."""
    return x[idx.long()]


@register("reshape_like", nin=2, params={"lhs_begin": None, "lhs_end": None,
                                         "rhs_begin": None, "rhs_end": None})
def _reshape_like(params, lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("pick", nin=2, params={"axis": -1, "keepdims": False,
                                 "mode": "clip"})
def _pick(params, data, index):
    """One element along `axis` per position of `index` (reference
    `broadcast_reduce_op_index.cc` pick); out-of-range indices clip, or
    wrap with ``mode="wrap"``."""
    axis = int(params["axis"]) % data.dim()
    n = data.shape[axis]
    idx = index.long()
    idx = torch.remainder(idx, n) if params["mode"] == "wrap" else \
        idx.clamp(0, n - 1)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if params["keepdims"] else out.squeeze(axis)


@register("Embedding", nin=2,
          params={"input_dim": REQUIRED, "output_dim": REQUIRED,
                  "dtype": "float32", "sparse_grad": False},
          input_names=["data", "weight"])
def _embedding(params, data, weight):
    """``weight[data]`` in the weight's dtype (reference `indexing_op.cc`
    Embedding).  Indices clip into ``[0, input_dim - 1]`` first, as the
    JAX op's clip before `jnp.take`: on the card an index out of range
    would be a device-side assert that ends the process's CUDA context.
    Float indices (an `NDArrayIter` gives float32 tokens) truncate to
    integers after the clip."""
    idx = data.clamp(0, int(params["input_dim"]) - 1).long()
    return torch.nn.functional.embedding(idx, weight)


@register("where", nin=3)
def _where(params, cond, x, y):
    return torch.where(cond != 0, x, y)


@register("Cast", aliases=("cast",), params={"dtype": REQUIRED})
def _cast(params, x):
    return x.to(torch_dtype(params["dtype"]), copy=True)
