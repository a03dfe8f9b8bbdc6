"""General-purpose contrib ops (reference `src/operator/contrib/`).

PyTorch port of `incubator_mxnet_tpu/ops/contrib_ops.py`: quadratic,
arange_like, AdaptiveAvgPooling2D, BilinearResize2D, div_sqrt_dim, the
interleaved self-attention matmuls of `transformer-inl.h`,
boolean_mask_supported, index_copy, index_array and getnnz.  The
resizes are the JAX ops' `jax.image.resize` ("linear", antialiased when
shrinking): `nn.resize_linear`.
"""
from __future__ import annotations

import math

import torch

from .nn import resize_linear
from .registry import register, REQUIRED


@register("_contrib_quadratic", aliases=("quadratic",),
          params={"a": 0.0, "b": 0.0, "c": 0.0})
def _quadratic(params, x):
    """a * x^2 + b * x + c (reference `contrib/quadratic_op.cc`)."""
    return params["a"] * torch.square(x) + params["b"] * x + params["c"]


@register("_contrib_arange_like", params={"start": 0.0, "step": 1.0,
                                          "repeat": 1, "axis": None})
def _arange_like(params, x):
    """start + step * i over x's elements (or along `axis`), each value
    `repeat` times."""
    axis = params["axis"]
    repeat = max(int(params["repeat"]), 1)
    n = x.numel() if axis is None else x.shape[int(axis)]
    out = params["start"] + params["step"] * torch.arange(
        -(-n // repeat), dtype=x.dtype, device=x.device)
    if repeat > 1:
        out = out.repeat_interleave(repeat)[:n]
    return out.reshape(x.shape) if axis is None else out


@register("_contrib_AdaptiveAvgPooling2D", params={"output_size": ()})
def _adaptive_avg_pool(params, x):
    """Block means where the output divides the input; else the JAX
    op's linear resize (reference `contrib/adaptive_avg_pooling.cc`)."""
    os_ = params["output_size"]
    if not os_:
        oh = ow = 1
    elif isinstance(os_, int):
        oh = ow = int(os_)
    else:
        oh, ow = int(os_[0]), int(os_[1])
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return resize_linear(x, (oh, ow))


@register("_contrib_BilinearResize2D",
          params={"height": 1, "width": 1, "scale_height": None,
                  "scale_width": None, "mode": "size"})
def _bilinear_resize(params, x):
    h, w = x.shape[2:]
    if params["scale_height"] is not None:
        oh = int(round(h * float(params["scale_height"])))
        ow = int(round(w * float(params["scale_width"] or
                                 params["scale_height"])))
    else:
        oh, ow = int(params["height"]), int(params["width"])
    return resize_linear(x, (oh, ow))


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(params, x):
    return x / torch.sqrt(torch.tensor(x.shape[-1], dtype=x.dtype,
                                       device=x.device))


def _heads(qkv, heads, which):
    """Part `which` (0 q, 1 k, 2 v) of interleaved (L, B, H*3*D) as
    (B*H, L, D)."""
    L, B, E = qkv.shape
    D = E // heads // 3
    x = qkv.reshape(L, B, heads, 3, D)[:, :, :, which, :]
    return x.permute(1, 2, 0, 3).reshape(B * heads, L, D)


@register("_contrib_interleaved_matmul_selfatt_qk", nin=1,
          params={"heads": REQUIRED})
def _interleaved_qk(params, qkv):
    """qkv (L, B, H*3*D) interleaved per head; (B*H, L, L) scores q·kᵀ /
    sqrt(D)."""
    heads = int(params["heads"])
    d = qkv.shape[2] // heads // 3
    q, k = _heads(qkv, heads, 0), _heads(qkv, heads, 1)
    return torch.matmul(q, k.transpose(1, 2)) / math.sqrt(d)


@register("_contrib_interleaved_matmul_selfatt_valatt", nin=2,
          params={"heads": REQUIRED})
def _interleaved_valatt(params, qkv, att):
    """att (B*H, L, L) against the interleaved values: (L, B, H*D)."""
    heads = int(params["heads"])
    L, B, E = qkv.shape
    D = E // heads // 3
    out = torch.matmul(att, _heads(qkv, heads, 2))       # (B*H, L, D)
    return out.reshape(B, heads, L, D).permute(2, 0, 1, 3).reshape(
        L, B, heads * D)


@register("_contrib_boolean_mask_supported", nin=0, params={})
def _boolean_mask_supported(params, device=None):
    """The JAX package's stub (a dynamic-shape boolean_mask does not
    compile): zeros of shape (1,)."""
    return torch.zeros((1,), device=device)


@register("_contrib_index_copy", nin=3)
def _index_copy(params, old, idx, new):
    """old with rows idx replaced by new."""
    return old.index_copy(0, idx.to(torch.int64), new)


@register("_contrib_index_array", nin=1, params={"axes": None})
def _index_array(params, x):
    """The index of every element along `axes` (all by default),
    stacked on a new last axis, int64."""
    axes = params["axes"]
    if axes is None:
        axes = tuple(range(x.dim()))
    elif isinstance(axes, int):
        axes = (axes,)
    grids = torch.meshgrid(*[torch.arange(x.shape[a], device=x.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int64)


@register("_contrib_getnnz", nin=1, params={"axis": None})
def _getnnz(params, x):
    nz = (x != 0).to(torch.int64)
    axis = params["axis"]
    return nz.sum() if axis is None else nz.sum(dim=int(axis))
