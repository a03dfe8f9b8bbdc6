"""Shape, indexing and product ops.

PyTorch port of `incubator_mxnet_tpu/ops/matrix.py` (reference
`src/operator/tensor/matrix_op.cc`, `dot.cc`, `slice_channel.cc`,
`broadcast_reduce_op_index.cc`, `indexing_op.cc`, `ordering_op.cc`,
`pad.cc`, `diag_op.cc`, `sequence_{last,mask,reverse}.cc`): Reshape with
MXNet's special codes, Flatten, transpose, expand_dims, squeeze,
swapaxes, slice/crop, slice_axis, slice_like, reverse/flip, tile,
repeat, Pad, split, Concat, stack, add_n, dot, batch_dot, take,
batch_take, one_hot, gather_nd, scatter_nd, the indexing ops NDArray's
``[]`` records (``_index``, ``_index_nd``), reshape_like, pick,
Embedding, where, topk, sort, argsort, Cast, shape_array, size_array,
diag, depth_to_space, space_to_depth and the Sequence ops.

Indices are made safe as the JAX gathers make them: negative ones wrap
once, then a gather clips into range and a scatter drops what is still
out of it (on the card an index out of range would be a device-side
assert).  The ordering ops sort stably: `jax.lax.top_k` ranks equal
values by position, lower first, and `jnp.argsort` is stable, while
`torch.topk` promises no order among ties on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    integers after the clip.  A weight sharded by rows over a mesh of
    ranks (`parallel.shard_block`) looks each row up on the rank that
    holds it; the partial rows are summed over the mesh at once, so the
    result is replicated like a lookup of the whole table."""
    idx = data.clamp(0, int(params["input_dim"]) - 1).long()
    out = torch.nn.functional.embedding(idx, weight)
    if any(p.is_partial() for p in getattr(out, "placements", ())):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


@register("where", nin=3)
def _where(params, cond, x, y):
    return torch.where(cond != 0, x, y)


@register("Cast", aliases=("cast",), params={"dtype": REQUIRED})
def _cast(params, x):
    return x.to(torch_dtype(params["dtype"]), copy=True)


def _axis_slice(x, axis, begin, end, step):
    """``x[begin:end:step]`` along `axis`; a negative step (which torch
    slicing lacks) gathers the positions Python's slice gives."""
    if step is None or step > 0:
        sl = [slice(None)] * x.dim()
        sl[axis] = slice(begin, end, step)
        return x[tuple(sl)]
    idx = range(*slice(begin, end, step).indices(x.shape[axis]))
    return x.index_select(axis, torch.tensor(list(idx), dtype=torch.long,
                                             device=x.device))


@register("slice", params={"begin": REQUIRED, "end": REQUIRED, "step": None},
          aliases=("crop",))
def _slice(params, x):
    """Reference matrix_op.cc slice: begin/end/step per leading axis,
    None-able entries."""
    begin, end = list(params["begin"]), list(params["end"])
    step = list(params["step"] or [])
    for axis in range(x.dim()):
        b = begin[axis] if axis < len(begin) else None
        e = end[axis] if axis < len(end) else None
        s = step[axis] if axis < len(step) else None
        if (b, e, s) != (None, None, None):
            x = _axis_slice(x, axis, b, e, s)
    return x


@register("slice_like", nin=2, params={"axes": ()})
def _slice_like(params, x, like):
    axes = params["axes"] or tuple(range(x.dim()))
    sl = [slice(None)] * x.dim()
    for a in axes:
        a = a % x.dim()
        sl[a] = slice(0, like.shape[a])
    return x[tuple(sl)]


@register("reverse", aliases=("flip",), params={"axis": REQUIRED})
def _reverse(params, x):
    axis = params["axis"]
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("tile", params={"reps": REQUIRED})
def _tile(params, x):
    return x.tile(tuple(params["reps"]))


@register("repeat", params={"repeats": REQUIRED, "axis": None})
def _repeat(params, x):
    axis = params["axis"]
    if axis is None:
        x, axis = x.reshape(-1), 0
    return x.repeat_interleave(int(params["repeats"]), dim=int(axis))


_PAD_MODE = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=("pad",),
          params={"mode": "constant", "pad_width": REQUIRED,
                  "constant_value": 0.0})
def _pad(params, x):
    """Reference `pad.cc`: ``pad_width`` holds (before, after) for every
    axis; "constant", "edge" (numpy's) or "reflect" (numpy's, the edge
    not repeated)."""
    pw = params["pad_width"]
    pairs = [(int(pw[2 * i]), int(pw[2 * i + 1]))
             for i in range(len(pw) // 2)]
    pairs += [(0, 0)] * (x.dim() - len(pairs))
    mode = params["mode"]
    if mode == "constant":
        flat = [v for pair in reversed(pairs) for v in pair]
        return F.pad(x, flat, value=float(params["constant_value"]))
    if mode not in _PAD_MODE:
        raise MXNetError(f"Pad: unknown mode {mode}")
    # torch pads the last 1-3 axes of a batch: fold the leading ones
    padded = [i for i, p in enumerate(pairs) if p != (0, 0)]
    first = padded[0] if padded else x.dim()
    k = x.dim() - first
    if k == 0:
        return x.clone()
    if k > 3:
        raise MXNetError(f"Pad: mode {mode} pads at most the last 3 axes")
    lead = x.shape[:first]
    xb = x.reshape((-1,) + tuple(x.shape[first:]))
    flat = [v for pair in reversed(pairs[first:]) for v in pair]
    out = F.pad(xb, flat, mode=_PAD_MODE[mode])
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def _wrap_negative(idx, n):
    return torch.where(idx < 0, idx + n, idx)


@register("take", nin=2, params={"axis": 0, "mode": "clip"})
def _take(params, a, indices):
    """Slices of `a` along `axis` at `indices` (reference `indexing_op.cc`
    take); indices out of range clip, or wrap with ``mode="wrap"``."""
    axis = int(params["axis"]) % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if params["mode"] == "wrap" else \
        idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("batch_take", nin=2)
def _batch_take(params, a, indices):
    """``a[i, indices[i]]`` for every row i, indices clipped."""
    idx = indices.to(torch.int64).clamp(0, a.shape[1] - 1)
    return torch.take_along_dim(a, idx[:, None], dim=1)[:, 0]


@register("one_hot", params={"depth": REQUIRED, "on_value": 1.0,
                             "off_value": 0.0, "dtype": "float32"})
def _one_hot(params, indices):
    """``on_value`` where the last axis equals the index, ``off_value``
    elsewhere; an index outside [0, depth) gives a row of off_value."""
    depth = int(params["depth"])
    on, off = params["on_value"], params["off_value"]
    cls = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int64).unsqueeze(-1) == cls).to(
        torch_dtype(params["dtype"]))
    return oh * (on - off) + off


def _nd_index(indices, shape):
    """The index tuple of `gather_nd`/`scatter_nd`: row i of `indices`
    indexes axis i, negative values wrapped."""
    return tuple(_wrap_negative(indices[i].to(torch.int64), shape[i])
                 for i in range(indices.shape[0]))


@register("gather_nd", nin=2)
def _gather_nd(params, data, indices):
    """Reference indexing_op.cc gather_nd: indices (M, Y...) selects
    data[idx_0, ..., idx_{M-1}] -> (Y..., data.shape[M:]); out-of-range
    indices clip."""
    idx = tuple(i.clamp(0, data.shape[d] - 1) for d, i in
                enumerate(_nd_index(indices, data.shape)))
    return data[idx]


@register("scatter_nd", nin=2, params={"shape": REQUIRED})
def _scatter_nd(params, data, indices):
    """Zeros of `shape` with ``out[idx] = data`` (the inverse of
    gather_nd); an index out of range is dropped."""
    shape = tuple(params["shape"])
    idx = _nd_index(indices, shape)
    keep = torch.ones(idx[0].shape, dtype=torch.bool, device=data.device)
    for d, i in enumerate(idx):
        keep &= (i >= 0) & (i < shape[d])
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    m = len(idx)
    vals = data.reshape(tuple(idx[0].shape) + shape[m:])
    return out.index_put(tuple(i[keep] for i in idx), vals[keep])


def _topk_nout(params):
    return 2 if params.get("ret_typ") == "both" else 1


def _stable_order(x, axis, descending):
    """(values, indices) of `x` sorted along `axis`, equal values in
    their order of position."""
    return torch.sort(x, dim=axis, descending=descending, stable=True)


_INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _total_order(x):
    """Integers that order like IEEE total order of float `x` (-0 below
    +0, NaNs at the ends), the order XLA's TopK ranks by; `x` itself
    when it is not a float."""
    it = _INT_OF.get(x.dtype)
    if it is None:
        return x
    bits = x.contiguous().view(it)
    mask = torch.iinfo(it).max
    return bits ^ ((bits >> (torch.iinfo(it).bits - 1)) & mask)


@register("topk", nout=_topk_nout,
          params={"axis": -1, "k": 1, "ret_typ": "indices",
                  "is_ascend": False, "dtype": "float32"})
def _topk(params, x):
    """The k largest (smallest with ``is_ascend``) along `axis` in IEEE
    total order, equal values ranked by position (`jax.lax.top_k`, which
    puts +0 above -0 where `sort` takes them as equal); indices in
    ``dtype``."""
    axis = int(params["axis"]) % x.dim()
    k = int(params["k"])
    ret = params["ret_typ"]
    idxs = _stable_order(_total_order(x), axis,
                         not params["is_ascend"])[1].narrow(axis, 0, k)
    vals = torch.take_along_dim(x, idxs, dim=axis)
    if ret == "value":
        return vals
    if ret == "indices":
        return idxs.to(torch_dtype(params["dtype"]))
    if ret == "both":
        return vals, idxs.to(torch_dtype(params["dtype"]))
    if ret == "mask":
        return torch.zeros_like(x).scatter(axis, idxs, 1)
    raise MXNetError(f"topk: bad ret_typ {ret}")


@register("sort", params={"axis": -1, "is_ascend": True})
def _sort(params, x):
    axis = int(params["axis"])
    out = _stable_order(x, axis, False)[0]
    return out if params["is_ascend"] else torch.flip(out, (axis,))


@register("argsort", params={"axis": -1, "is_ascend": True,
                             "dtype": "float32"})
def _argsort(params, x):
    """The stable ascending order, reversed whole for descending (as
    the JAX op: equal values then come last position first)."""
    axis = int(params["axis"])
    idx = _stable_order(x, axis, False)[1]
    if not params["is_ascend"]:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(params["dtype"]))


@register("shape_array")
def _shape_array(params, x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register("size_array")
def _size_array(params, x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("diag", params={"k": 0, "axis1": 0, "axis2": 1})
def _diag(params, x):
    k = int(params["k"])
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=int(params["axis1"]),
                          dim2=int(params["axis2"]))


@register("depth_to_space", params={"block_size": REQUIRED})
def _depth_to_space(params, x):
    b = int(params["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", params={"block_size": REQUIRED})
def _space_to_depth(params, x):
    b = int(params["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 5, 3, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# -- Sequence ops: data is (seq_len, batch, ...) along `axis` 0 (or
# (batch, seq_len, ...) with axis 1), with an optional per-batch
# sequence_length input

def _steps_first(data, axis):
    return data.movedim(axis, 0) if axis else data


@register("SequenceLast", nin=-1,
          params={"use_sequence_length": False, "axis": 0})
def _sequence_last(params, data, *rest):
    axis = int(params["axis"])
    if params["use_sequence_length"] and rest:
        idx = (rest[0].to(torch.int64) - 1).clamp_min(0)
        dm = _steps_first(data, axis)
        return dm[idx.clamp_max(dm.shape[0] - 1),
                  torch.arange(dm.shape[1], device=data.device)]
    return data.select(axis, -1)


@register("SequenceMask", nin=-1,
          params={"use_sequence_length": False, "value": 0.0, "axis": 0})
def _sequence_mask(params, data, *rest):
    if not params["use_sequence_length"] or not rest:
        return data + 0
    axis = int(params["axis"])
    seqlen = rest[0].to(torch.int64)
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < seqlen[None, :]            # (T, B)
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(tuple(data.shape[:2]) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(params["value"],
                                                dtype=data.dtype,
                                                device=data.device))


@register("SequenceReverse", nin=-1,
          params={"use_sequence_length": False, "axis": 0})
def _sequence_reverse(params, data, *rest):
    axis = int(params["axis"])
    if not params["use_sequence_length"] or not rest:
        return torch.flip(data, (axis,))
    seqlen = rest[0].to(torch.int64)
    dm = _steps_first(data, axis)
    steps = torch.arange(dm.shape[0], device=data.device)[:, None]
    idx = torch.where(steps < seqlen[None, :], seqlen[None, :] - 1 - steps,
                      steps)                           # (T, B)
    out = dm[idx, torch.arange(dm.shape[1], device=data.device)[None, :]]
    return out.movedim(0, axis) if axis else out
