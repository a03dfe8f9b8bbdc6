"""Spatial-warp operators.

PyTorch port of `incubator_mxnet_tpu/ops/spatial.py` (reference
`src/operator/bilinear_sampler.cc`, `grid_generator.cc`,
`spatial_transformer.cc`, `correlation.cc`, `crop.cc`): the same names,
params and sampling arithmetic, gradients by autograd.
"""
from __future__ import annotations

import torch

from .detection import true_div
from .registry import register, REQUIRED
from ..base import MXNetError


def _bilinear_sample(img, gy, gx):
    """img (B, C, H, W); gy, gx (B, Ho, Wo) in [-1, 1]; zero outside the
    image.  Returns (B, C, Ho, Wo)."""
    b, c, hgt, wid = img.shape
    y = (gy + 1) * (hgt - 1) / 2
    x = (gx + 1) * (wid - 1) / 2
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    flat = img.reshape(b, c, hgt * wid)

    def at(yi, xi):
        inb = (yi >= 0) & (yi < hgt) & (xi >= 0) & (xi < wid)
        yc = torch.clamp(yi, 0, hgt - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, wid - 1).to(torch.int64)
        idx = (yc * wid + xc).reshape(b, 1, -1).expand(-1, c, -1)
        v = torch.gather(flat, 2, idx).reshape((b, c) + tuple(yi.shape[1:]))
        return torch.where(inb[:, None], v, 0.0)

    return (at(y0, x0) * (1 - wy) * (1 - wx) +
            at(y0 + 1, x0) * wy * (1 - wx) +
            at(y0, x0 + 1) * (1 - wy) * wx +
            at(y0 + 1, x0 + 1) * wy * wx)


@register("BilinearSampler", nin=2, params={"cudnn_off": False})
def _bilinear_sampler(params, data, grid):
    """Reference bilinear_sampler.cc: grid (B, 2, Ho, Wo) of (x, y) in
    [-1, 1]."""
    return _bilinear_sample(data, grid[:, 1], grid[:, 0])


def _affine_grid(theta, th, tw):
    """(B, 6) affine matrices -> (B, 2, th, tw) sampling grids."""
    ys = torch.linspace(-1, 1, th, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1, 1, tw, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])       # (3, th*tw)
    out = theta.reshape(-1, 2, 3) @ base
    return out.reshape(-1, 2, th, tw)


@register("GridGenerator",
          params={"transform_type": REQUIRED, "target_shape": (0, 0)})
def _grid_generator(params, data):
    """Reference grid_generator.cc: an affine (B, 6) or a warp flow (B,
    2, H, W) to a sampling grid of normalized (x, y)."""
    tt = params["transform_type"]
    if tt == "affine":
        th, tw = tuple(params["target_shape"])
        return _affine_grid(data, th, tw)
    if tt == "warp":
        _, _, hgt, wid = data.shape
        ys = torch.arange(hgt, dtype=data.dtype, device=data.device)
        xs = torch.arange(wid, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        x = true_div((data[:, 0] + gx[None]) * 2, max(wid - 1, 1)) - 1
        y = true_div((data[:, 1] + gy[None]) * 2, max(hgt - 1, 1)) - 1
        return torch.stack([x, y], dim=1)
    raise MXNetError(f"GridGenerator: bad transform_type {tt}")


@register("SpatialTransformer", nin=2,
          params={"target_shape": (0, 0), "transform_type": "affine",
                  "sampler_type": "bilinear", "cudnn_off": False})
def _spatial_transformer(params, data, loc):
    """Reference spatial_transformer.cc: an affine theta (B, 6), then
    bilinear sampling."""
    th, tw = tuple(params["target_shape"])
    grid = _affine_grid(loc, th, tw)
    return _bilinear_sample(data, grid[:, 1], grid[:, 0])


@register("Correlation", nin=2,
          params={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                  "stride2": 1, "pad_size": 0, "is_multiply": True})
def _correlation(params, data1, data2):
    """Reference correlation.cc (FlowNet's cost volume), as the JAX op:
    for each displacement (dy, dx) in steps of stride2 up to
    max_displacement, the channel mean of data1 * shifted data2 (or of
    |data1 - shifted data2|), subsampled by stride1."""
    md = int(params["max_displacement"])
    s1 = int(params["stride1"])
    s2 = int(params["stride2"])
    pad = int(params["pad_size"])
    _, _, hgt, wid = data1.shape
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    hp, wp = hgt + 2 * pad, wid + 2 * pad
    a = p1[:, :, md:hp - md, md:wp - md]
    outs = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            b = p2[:, :, md + dy:hp - md + dy, md + dx:wp - md + dx]
            if params["is_multiply"]:
                corr = torch.mean(a * b, dim=1)
            else:
                corr = torch.mean(torch.abs(a - b), dim=1)
            outs.append(corr[:, ::s1, ::s1])
    return torch.stack(outs, dim=1)


@register("Crop", nin=-1, variadic_param="num_args",
          params={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                  "center_crop": False})
def _crop_op(params, *args):
    """Reference crop.cc: crop the first input to the second's spatial
    size (or to ``h_w``), at ``offset`` or centred."""
    data = args[0]
    if len(args) > 1:
        h, w = args[1].shape[2], args[1].shape[3]
    else:
        h, w = tuple(params["h_w"])
    if params["center_crop"]:
        oy = (data.shape[2] - h) // 2
        ox = (data.shape[3] - w) // 2
    else:
        oy, ox = tuple(params["offset"])
    return data[:, :, oy:oy + h, ox:ox + w]
