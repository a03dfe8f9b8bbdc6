"""Quantization ops (reference `src/operator/quantization/`: quantize,
dequantize, requantize, quantized conv/fc/pooling).

PyTorch port of `incubator_mxnet_tpu/ops/quantization.py`, with its
math: values quantized symmetric into int8 with their (min, max) range
carried beside them (the reference's 3-tensor convention); scales are
``max(|min|, |max|)``; int8 data dequantizes at range/127 and int32
accumulators at range/127²; rounding is half to even (`torch.round`, as
`jnp.round`).  `contrib.quantization.quantize_model` writes the graphs
that use them.

Two routes keep the JAX package's integers on the card:

* `_contrib_quantized_fully_connected` multiplies in float64 (`_int_dot`):
  int8 products and their sums stay exact there for any K below 2⁵³/127²,
  where fp32 holds only below K = 1040 (2²⁴/127²); torch has no int32
  matmul on CUDA, and `torch._int_mm` takes neither M below 17 nor every
  K and N.
* `_contrib_quantized_conv` convolves in float32 and rounds, as the JAX
  op does (`ops/quantization.py:123-161`); TF32 must stay off for it.

A division by a Python number goes through `true_div` (CUDA turns one
into a product with the reciprocal, an ulp off the CPU's quotient).
Like the JAX package's, these ops compute in float32 (its `cost_meta`
declares ``compute_dtype="float32"``), so an int8 graph is slower than
its fp32 one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .detection import true_div
from .registry import register, REQUIRED

__all__ = []


def _range_scale(lo, hi):
    return torch.maximum(lo.abs(), hi.abs())


def _to_int8(real, scale):
    """clip(round(real / scale * 127), -127, 127) as int8."""
    return torch.clamp(torch.round(real / scale * 127.0), -127, 127) \
        .to(torch.int8)


def _calib(params, like):
    return (torch.tensor(params["min_calib_range"], dtype=torch.float32,
                         device=like.device),
            torch.tensor(params["max_calib_range"], dtype=torch.float32,
                         device=like.device))


@register("_contrib_quantize", nin=3, nout=3, params={"out_type": "int8"},
          aliases=("quantize",))
def _quantize(params, data, min_range, max_range):
    """Reference quantize.cc: float -> int8 with the given range."""
    scale = torch.clamp_min(_range_scale(min_range, max_range), 1e-8)
    return _to_int8(data, scale), -scale, scale


@register("_contrib_quantize_v2", nin=1, nout=3,
          params={"out_type": "int8", "min_calib_range": None,
                  "max_calib_range": None})
def _quantize_v2(params, data):
    """float -> int8 over the calibrated range, or the data's own."""
    if params["min_calib_range"] is not None:
        mn, mx = _calib(params, data)
    else:
        mn, mx = data.min().float(), data.max().float()
    scale = torch.clamp_min(_range_scale(mn, mx), 1e-8)
    return _to_int8(data, scale), -scale, scale


@register("_contrib_dequantize", nin=3, params={"out_type": "float32"},
          aliases=("dequantize",))
def _dequantize(params, data, min_range, max_range):
    """int8 carries real = q * range/127; int32 accumulators from the
    quantized matmul and conv carry real = q * range/127²."""
    q_max = 127.0 if data.dtype == torch.int8 else 127.0 * 127.0
    return true_div(data.float() * _range_scale(min_range, max_range),
                    q_max)


@register("_contrib_requantize", nin=3, nout=3,
          params={"out_type": "int8", "min_calib_range": None,
                  "max_calib_range": None})
def _requantize(params, data, min_range, max_range):
    """int32 accumulators -> int8 (reference requantize.cc)."""
    real = true_div(data.float() * _range_scale(min_range, max_range),
                    127.0 * 127.0)
    if params["min_calib_range"] is not None:
        mn, mx = _calib(params, real)
    else:
        mn, mx = real.min(), real.max()
    scale = torch.clamp_min(_range_scale(mn, mx), 1e-8)
    return _to_int8(real, scale), -scale, scale


def _int_dot(x, w):
    """x (M, K) . w (N, K)^T over integer values, exactly, as int32: the
    operands truncated to integers (the JAX op's ``astype(int32)``), then
    one float64 GEMM."""
    x, w = x.to(torch.int32), w.to(torch.int32)
    return (x.double() @ w.double().t()).to(torch.int32)


def _unpack(params, args):
    if bool(params["no_bias"]):
        data, weight, dmin, dmax, wmin, wmax = args
        return data, weight, None, dmin, dmax, wmin, wmax, None, None
    return args


def _accumulate_bias(bias, bmin, bmax, d_scale, w_scale):
    """The int8 bias, rescaled from its own scale into accumulator units
    (reference quantized_fully_connected float_for_one_quant_of_bias)."""
    b_scale = true_div(_range_scale(bmin, bmax), 127.0)
    acc = torch.round(bias.float() * b_scale / (d_scale * w_scale))
    return acc.to(torch.int32)


@register("_contrib_quantized_fully_connected", nin=-1, nout=3,
          params={"num_hidden": REQUIRED, "no_bias": False, "flatten": True})
def _quantized_fc(params, *args):
    """int8 x int8 -> int32 matmul (reference quantized_fully_connected.cc).
    Inputs: data, weight, [bias], then min and max of each."""
    data, weight, bias, dmin, dmax, wmin, wmax, bmin, bmax = \
        _unpack(params, args)
    x = data
    if params["flatten"]:
        x = x.reshape(x.shape[0], -1)
    out = _int_dot(x, weight)
    d_scale = true_div(_range_scale(dmin, dmax), 127.0)
    w_scale = true_div(_range_scale(wmin, wmax), 127.0)
    if bias is not None:
        out = out + _accumulate_bias(bias, bmin, bmax, d_scale, w_scale)
    out_range = d_scale * w_scale * 127.0 * 127.0
    return out, -out_range, out_range


def _pair(v, default=None):
    t = (v, v) if isinstance(v, int) else tuple(v)
    return t if t else (default or (1, 1))


@register("_contrib_quantized_conv", nin=-1, nout=3,
          params={"kernel": REQUIRED, "stride": (1, 1), "pad": (0, 0),
                  "dilate": (1, 1), "num_filter": REQUIRED, "num_group": 1,
                  "no_bias": False, "layout": "NCHW"})
def _quantized_conv(params, *args):
    """int8 conv -> int32 accumulators (reference quantized_conv.cc),
    computed in float32 and rounded, as the JAX op does."""
    data, weight, bias, dmin, dmax, wmin, wmax, bmin, bmax = \
        _unpack(params, args)
    out = F.conv2d(data.float(), weight.float(),
                   stride=_pair(params["stride"]),
                   padding=_pair(params["pad"], (0, 0)),
                   dilation=_pair(params["dilate"]),
                   groups=int(params["num_group"]))
    out = torch.round(out).to(torch.int32)
    d_scale = true_div(_range_scale(dmin, dmax), 127.0)
    w_scale = true_div(_range_scale(wmin, wmax), 127.0)
    if bias is not None:
        out = out + _accumulate_bias(bias, bmin, bmax, d_scale,
                                     w_scale).reshape(1, -1, 1, 1)
    out_range = d_scale * w_scale * 127.0 * 127.0
    return out, -out_range, out_range


@register("_contrib_quantized_pooling", nin=3, nout=3,
          params={"kernel": REQUIRED, "pool_type": "max", "stride": (1, 1),
                  "pad": (0, 0), "global_pool": False,
                  "pooling_convention": "valid"})
def _quantized_pooling(params, data, min_range, max_range):
    """Pooling on int8 values, the ranges passed through (reference
    quantized_pooling.cc: pooling preserves the range)."""
    ptype = params["pool_type"]
    if params["global_pool"]:
        kernel, stride, pad = tuple(data.shape[2:]), (1, 1), (0, 0)
    else:
        kernel = _pair(params["kernel"])
        stride = _pair(params["stride"])
        pad = _pair(params["pad"], (0, 0))
    x = data.float()
    if ptype == "max":
        out = F.max_pool2d(x, kernel, stride, pad)
    elif ptype == "avg":
        # the window's sum (padding counts as 0), then its mean
        s = F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True,
                         divisor_override=1)
        out = true_div(s, float(kernel[0] * kernel[1]))
    else:
        raise ValueError(f"quantized_pooling: pool_type {ptype}")
    out = torch.clamp(torch.round(out), -127, 127).to(data.dtype)
    return out, min_range, max_range
