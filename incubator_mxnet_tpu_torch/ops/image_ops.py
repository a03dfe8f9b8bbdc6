"""On-device input preprocessing ops.

PyTorch port of `incubator_mxnet_tpu/ops/image_ops.py`.  `ImageNormalize`
is the graph-side half of `ImageRecordIter(device_augment=True)`: the
iterator ships uint8 HWC pixels (a quarter of the fp32 bytes) and this op
subtracts the mean, multiplies by the fp32 reciprocal of std, moves the
layout and casts, on the device.  The iterator's `normalize_symbol(data)`
composes the two with its own mean and std.
"""
from __future__ import annotations

import ast

import torch

from ..base import MXNetError, torch_dtype
from .registry import register


def _floats(v, n):
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),) * n
    out = tuple(float(x) for x in v)
    if len(out) == 1:
        return out * n
    return out


@register("ImageNormalize", nin=1,
          params={"mean": 0.0, "std": 1.0, "input_layout": "NHWC",
                  "output_layout": "NCHW", "dtype": "float32"})
def _image_normalize(params, x):
    """``(x - mean) * (1 / std)`` with a layout move and a cast to
    `dtype` (reference `src/io/iter_normalize.h` mean_r/g/b, std_r/g/b,
    moved onto the device).  The subtraction and the product are separate
    fp32 ops (no fused multiply-add), so a uint8 batch normalized here
    equals the native library's host finish bit for bit."""
    ilay = str(params.get("input_layout", "NHWC")).upper()
    olay = str(params.get("output_layout", "NCHW")).upper()
    if ilay not in ("NHWC", "NCHW") or olay not in ("NHWC", "NCHW"):
        raise MXNetError("ImageNormalize: layouts must be NHWC or NCHW")
    c = x.shape[-1] if ilay == "NHWC" else x.shape[1]
    # the reciprocal is taken on the host in fp32, as the iterator's
    # `_stdinv` is, and moved to the device with the mean
    mean = torch.tensor(_floats(params.get("mean", 0.0), c),
                        dtype=torch.float32)
    stdinv = 1.0 / torch.tensor(_floats(params.get("std", 1.0), c),
                                dtype=torch.float32)
    shape = (1, 1, 1, c) if ilay == "NHWC" else (1, c, 1, 1)
    mean = mean.reshape(shape).to(x.device, non_blocking=True)
    stdinv = stdinv.reshape(shape).to(x.device, non_blocking=True)
    out = (x.to(torch.float32) - mean) * stdinv
    if ilay != olay:
        out = out.permute((0, 3, 1, 2) if olay == "NCHW" else (0, 2, 3, 1))
    return out.to(torch_dtype(params.get("dtype", "float32"))).contiguous()
