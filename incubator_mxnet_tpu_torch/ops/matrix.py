"""Shape ops: Reshape (with MXNet's special codes) and Flatten.

PyTorch port of the serving slice of `incubator_mxnet_tpu/ops/matrix.py`.
"""
from __future__ import annotations

import math

from ..base import MXNetError
from .registry import register


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
