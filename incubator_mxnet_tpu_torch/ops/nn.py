"""Core neural-network operators.

PyTorch port of part of `incubator_mxnet_tpu/ops/nn.py`:
FullyConnected, Convolution, Pooling, Activation, softmax, LeakyReLU,
Dropout, BatchNorm and LayerNorm.
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


@register("log_softmax", params={"axis": -1, "temperature": None,
                                 "dtype": None})
def _log_softmax(params, x):
    t = params["temperature"]
    if t:
        x = x / t
    out = torch.log_softmax(x, dim=int(params["axis"]))
    if params["dtype"]:
        from ..base import torch_dtype
        out = out.to(torch_dtype(params["dtype"]))
    return out


@register("softmin", params={"axis": -1, "temperature": None, "dtype": None})
def _softmin(params, x):
    t = params["temperature"]
    if t:
        x = x / t
    return torch.softmax(-x, dim=int(params["axis"]))


_SELU = (1.6732632423543772, 1.0507009873554805)


@register("LeakyReLU", nin=-1,
          params={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                  "upper_bound": 0.334},
          input_names=lambda p: ["data"] + (
              ["gamma"] if p.get("act_type") == "prelu" else []))
def _leaky_relu(params, x, *rest):
    """Reference `src/operator/leaky_relu.cc`: leaky, prelu, elu, selu,
    gelu (exact, erf), rrelu (its inference slope, the bounds' mean, as
    the JAX op)."""
    t = params["act_type"]
    if t == "leaky":
        return torch.where(x > 0, x, x * params["slope"])
    if t == "prelu":
        gamma = rest[0]
        if gamma.dim() == 1 and x.dim() > 1:
            shape = [1] * x.dim()
            shape[1] = gamma.shape[0] if gamma.shape[0] > 1 else 1
            gamma = gamma.reshape(shape)
        return torch.where(x > 0, x, x * gamma)
    if t == "elu":
        return torch.where(x > 0, x, params["slope"] * torch.expm1(x))
    if t == "selu":
        alpha, scale = _SELU
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if t == "gelu":
        return F.gelu(x, approximate="none")
    if t == "rrelu":
        slope = (params["lower_bound"] + params["upper_bound"]) / 2
        return torch.where(x > 0, x, x * slope)
    raise MXNetError(f"LeakyReLU: unknown act_type {t}")


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


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _bn_nout(params):
    return 3 if params.get("output_mean_var") else 1


@register("BatchNorm", nin=3, naux=2, nout=_bn_nout, mode_dependent=True,
          params={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                  "use_global_stats": False, "output_mean_var": False,
                  "axis": 1, "cudnn_off": False, "sync": False,
                  "sync_axis": "dp"},
          aliases=("BatchNorm_v1",),
          input_names=["data", "gamma", "beta", "moving_mean", "moving_var"])
def _batch_norm(params, x, gamma, beta, moving_mean, moving_var):
    """Reference `src/operator/nn/batch_norm.cc`, with the JAX op's math:
    statistics in float32 whatever x's dtype (float64 for float64 data;
    the output cast back to x's dtype), the *biased* batch variance, and
    in training the moving update ``moving * momentum + batch * (1 -
    momentum)`` returned after the outputs (the reverse of torch's
    ``momentum``).  ``fix_gamma`` uses ones for gamma, so gamma's
    gradient is 0.  ``output_mean_var`` adds the mean and ``rsqrt(var +
    eps)`` as outputs 2 and 3.

    The normalisation is `torch.native_batch_norm` (one fused kernel each
    way on the card) without running buffers: torch would update them
    with the unbiased variance and its own momentum.  The biased variance
    comes back from the kernel's saved inverse deviation.  With
    ``output_mean_var`` the statistics are outputs that gradients may
    reach, so that case runs as plain torch ops.  ``sync`` asks for
    statistics over every data-parallel replica; the port trains on one
    device, where those are the batch's own."""
    axis = int(params["axis"]) % x.ndim
    eps = float(params["eps"])
    momentum = float(params["momentum"])
    train = params.get("_train", False) and not params["use_global_stats"]
    if params["fix_gamma"]:
        gamma = torch.ones_like(gamma)
    xc = x.movedim(axis, 1) if axis != 1 else x
    # float32 statistics (float64 for float64 data)
    sdt = torch.promote_types(x.dtype, torch.float32)
    g, b = gamma.to(sdt), beta.to(sdt)
    if params.get("_train", False) and params["use_global_stats"]:
        # autograd and the outputs keep the moving statistics, and the
        # executor overwrites the aux arrays in place after the forward
        moving_mean, moving_var = moving_mean.clone(), moving_var.clone()
    if params["output_mean_var"]:
        out, mean, var, inv = _bn_plain(xc, g, b, moving_mean, moving_var,
                                        train, eps, sdt)
    elif train:
        out, mean, inv = torch.native_batch_norm(xc, g, b, None, None, True,
                                                 0.0, eps)
        with torch.no_grad():   # >= 0 where var << eps cancels
            var = (inv.pow(-2) - eps).clamp_min_(0)
    else:
        mean, var = moving_mean, moving_var
        out = torch.native_batch_norm(xc, g, b, moving_mean.to(sdt),
                                      moving_var.to(sdt), False, 0.0,
                                      eps)[0]
    out = out.to(x.dtype)
    if axis != 1:
        out = out.movedim(1, axis)
    outs = (out,)
    if params["output_mean_var"]:
        outs = (out, mean, inv)
    if params.get("_train", False):
        with torch.no_grad():
            new_mean = moving_mean * momentum + mean * (1 - momentum)
            new_var = moving_var * momentum + var * (1 - momentum)
        return outs + (new_mean, new_var)
    return outs if len(outs) > 1 else out


def _bn_plain(x, gamma, beta, moving_mean, moving_var, train, eps, sdt):
    """BatchNorm over channel axis 1 as differentiable torch ops in
    `sdt`: (out, mean, biased var, rsqrt(var + eps))."""
    red = tuple(i for i in range(x.ndim) if i != 1)
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    xs = x.to(sdt)
    if train:
        mean = xs.mean(dim=red)
        var = (xs - mean.reshape(shape)).square().mean(dim=red)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (xs - mean.reshape(shape)) * inv.reshape(shape) \
        * gamma.reshape(shape) + beta.reshape(shape)
    return out, mean, var, inv


def _ln_nout(params):
    return 3 if params.get("output_mean_var") else 1


@register("LayerNorm", nin=3, nout=_ln_nout,
          params={"axis": -1, "eps": 1e-5, "output_mean_var": False},
          input_names=["data", "gamma", "beta"])
def _layer_norm(params, x, gamma, beta):
    """Reference `src/operator/nn/layer_norm.cc`, with the JAX op's math:
    over `axis`, ``(x - mean) * rsqrt(var + eps) * gamma + beta`` with
    the biased variance.  ``output_mean_var`` adds the mean and
    ``rsqrt(var + eps)``, `axis` squeezed, as outputs 2 and 3; that case
    runs as plain torch ops so gradients reach them, the other as
    `F.layer_norm` (one kernel each way on the card) over the last axis.
    Mixed operand dtypes compute in the promoted dtype and return the
    data's."""
    axis = int(params["axis"]) % x.dim()
    eps = float(params["eps"])
    dt = _promoted(x, gamma, beta)
    xs, g, b = x.to(dt), gamma.to(dt), beta.to(dt)
    if params["output_mean_var"]:
        mean = xs.mean(dim=axis, keepdim=True)
        var = (xs - mean).square().mean(dim=axis, keepdim=True)
        inv = torch.rsqrt(var + eps)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        out = (xs - mean) * inv * g.reshape(shape) + b.reshape(shape)
        return (out.to(x.dtype), mean.squeeze(axis).to(x.dtype),
                inv.squeeze(axis).to(x.dtype))
    xs = xs.movedim(axis, -1)
    out = F.layer_norm(xs, (xs.shape[-1],), g, b, eps)
    return out.movedim(-1, axis).to(x.dtype)
