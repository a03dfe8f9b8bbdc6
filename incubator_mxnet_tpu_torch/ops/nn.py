"""Core neural-network operators.

PyTorch port of part of `incubator_mxnet_tpu/ops/nn.py`:
FullyConnected, Convolution, Pooling, Activation, softmax and Dropout.
Data layouts follow the reference (NCHW); the op bodies are
`torch.nn.functional` calls, as the JAX package leaves these ops to XLA,
and their backward is autograd's through them (the JAX package's is
`jax.vjp` of its forward).

Mixed operand dtypes (bf16 activations against fp32 parameters, as a
bf16 server feeds them) compute in the promoted dtype and return the
data's dtype.  The JAX ops cast the parameters to the data's dtype
first, so in 16-bit the two differ by that rounding of the parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register, REQUIRED


def _with_bias(p):
    return ["data", "weight"] + ([] if p.get("no_bias") else ["bias"])


@register("FullyConnected", nin=-1,
          params={"num_hidden": REQUIRED, "no_bias": False, "flatten": True},
          input_names=_with_bias)
def _fully_connected(params, x, weight, *rest):
    bias = None if params["no_bias"] else rest[0]
    dt = _promoted(x, weight, bias)
    if params["flatten"]:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt)).to(x.dtype)


def _promoted(*tensors):
    """The dtype the operands promote to (torch.promote_types)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def _tup(v, n, default):
    if not v:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


_CONV_PARAMS = {
    "kernel": REQUIRED, "stride": (), "dilate": (), "pad": (),
    "num_filter": REQUIRED, "num_group": 1, "no_bias": False,
    "workspace": 1024, "cudnn_tune": None, "cudnn_off": False, "layout": None,
}
_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", nin=-1, params=dict(_CONV_PARAMS),
          input_names=_with_bias)
def _convolution(params, x, weight, *rest):
    kernel = tuple(params["kernel"])
    nd = len(kernel)
    if nd not in _CONV_FN:
        raise MXNetError("Convolution supports 1D/2D/3D kernels")
    bias = None if params["no_bias"] else rest[0]
    dt = _promoted(x, weight, bias)
    return _CONV_FN[nd](
        x.to(dt), weight.to(dt), None if bias is None else bias.to(dt),
        stride=_tup(params["stride"], nd, 1),
        padding=_tup(params["pad"], nd, 0),
        dilation=_tup(params["dilate"], nd, 1),
        groups=int(params["num_group"])).to(x.dtype)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", aliases=("Pooling_v1",),
          params={"kernel": (), "pool_type": "max", "global_pool": False,
                  "cudnn_off": False, "pooling_convention": "valid",
                  "stride": (), "pad": (), "count_include_pad": True})
def _pooling(params, x):
    nd = x.ndim - 2
    ptype = params["pool_type"]
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: unknown pool_type {ptype}")
    axes = tuple(range(2, 2 + nd))
    if params["global_pool"]:
        if ptype == "max":
            return x.amax(dim=axes, keepdim=True)
        if ptype == "sum":
            return x.sum(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    kernel = _tup(params["kernel"], nd, 1)
    stride = _tup(params["stride"], nd, 1)
    pad = _tup(params["pad"], nd, 0)
    # explicit padding, as the JAX op's reduce_window does: (lo, hi) per
    # spatial dim, hi grown so "full" (ceil) windows cover the edge
    pads = []
    for i in range(nd):
        hi = pad[i]
        if params["pooling_convention"] == "full":
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi += stride[i] - rem
        pads.append((pad[i], hi))
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]   # F.pad order
    if ptype == "max":
        xp = F.pad(x, flat, value=-math.inf) if any(flat) else x
        return _MAX_POOL[nd](xp, kernel, stride)
    window = math.prod(kernel)
    s = _AVG_POOL[nd](F.pad(x, flat) if any(flat) else x, kernel,
                      stride) * window
    if ptype == "sum":
        return s
    if params["count_include_pad"]:
        return s / window
    ones = torch.ones_like(x[:1, :1])
    cnt = _AVG_POOL[nd](F.pad(ones, flat) if any(flat) else ones, kernel,
                        stride) * window
    return s / cnt.clamp(min=1)


@register("Activation", params={"act_type": REQUIRED})
def _activation(params, x):
    t = params["act_type"]
    if t == "relu":
        return torch.relu(x)
    if t == "sigmoid":
        return torch.sigmoid(x)
    if t == "tanh":
        return torch.tanh(x)
    if t == "softrelu":
        return F.softplus(x)
    if t == "softsign":
        return F.softsign(x)
    raise MXNetError(f"Activation: unknown act_type {t}")


@register("softmax", params={"axis": -1, "temperature": None, "dtype": None})
def _softmax(params, x):
    t = params["temperature"]
    if t:
        x = x / t
    out = torch.softmax(x, dim=int(params["axis"]))
    if params["dtype"]:
        from ..base import torch_dtype
        out = out.to(torch_dtype(params["dtype"]))
    return out


@register("Dropout", needs_rng=True, mode_dependent=True,
          params={"p": 0.5, "mode": "training", "axes": ()})
def _dropout(params, x, generator):
    """Reference `src/operator/nn/dropout.cc`: inverted dropout; the
    identity outside training."""
    p = float(params["p"])
    train = params.get("_train", False) or params["mode"] == "always"
    if not train or p <= 0:
        return x
    shape = list(x.shape)
    for i in range(len(shape)):
        if params["axes"] and i not in params["axes"]:
            shape[i] = 1
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
