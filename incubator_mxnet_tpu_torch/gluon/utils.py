"""Gluon utilities (reference `python/mxnet/gluon/utils.py`).

PyTorch port of `split_data`, `split_and_load` and `clip_global_norm`
from `incubator_mxnet_tpu/gluon/utils.py`.  `clip_global_norm` sums the
squares on the arrays' device in float64 and reads the norm back once;
the JAX package sums them in numpy on the host.  `download` and
`check_sha1` are not ported: the port fetches nothing.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis`; the last takes the
    remainder unless ``even_split`` asks for equal slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's a multiple of {num_slice} or set even_split=False.")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        end = (i + 1) * step if i < num_slice - 1 else size
        key = [slice(None)] * data.ndim
        key[batch_axis] = slice(i * step, end)
        slices.append(data[tuple(key)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """`data` split along `batch_axis`, one slice on each context of
    `ctx_list` (the whole batch when there is one context)."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so that their joint L2 norm is at most
    `max_norm`; returns the norm before scaling."""
    if not arrays:
        raise ValueError("clip_global_norm: no arrays")
    dev = arrays[0].data.device
    with torch.no_grad():
        total = sum(a.data.detach().to(dev, torch.float64).square().sum()
                    for a in arrays)
        total_norm = math.sqrt(float(total))
        if check_isfinite and not math.isfinite(total_norm):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a.data.mul_(scale)
    return total_norm
