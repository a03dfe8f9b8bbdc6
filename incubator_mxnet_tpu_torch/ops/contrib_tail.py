"""The deformable detection ops of the contrib tail.

PyTorch port of `_contrib_DeformableConvolution` and
`_contrib_DeformablePSROIPooling` in `incubator_mxnet_tpu/ops/
contrib_tail.py` (reference `contrib/deformable_convolution-inl.h`,
`contrib/deformable_psroi_pooling-inl.h`: Deformable ConvNets v1 and the
R-FCN head).  Both are a bilinear gather and a contraction, with the JAX
ops' sampling grids and gradients by autograd.  The file's other ops
(fft, count_sketch, histogram, SyncBatchNorm, ...) are not ported yet.
"""
from __future__ import annotations

import torch

from .detection import true_div
from .registry import register, REQUIRED


def _pair(v, default):
    if not v:
        return (default, default)
    if isinstance(v, int):
        return (int(v), int(v))
    return tuple(int(x) for x in v)


def _bilinear_gather(img, py, px):
    """img (G, C, H, W); py, px (G, ...) sample positions.  Zero outside
    [0, H-1] x [0, W-1] (the reference's dmcn_im2col_bilinear).  Returns
    (G, C, ...)."""
    g, c, hgt, wid = img.shape
    flat = img.reshape(g, c, hgt * wid)
    rest = tuple(py.shape[1:])
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi = y0 + dy
            xi = x0 + dx
            w = (1 - torch.abs(py - yi)) * (1 - torch.abs(px - xi))
            valid = (yi >= 0) & (yi <= hgt - 1) & (xi >= 0) & (xi <= wid - 1)
            yc = torch.clamp(yi, 0, hgt - 1).to(torch.int64)
            xc = torch.clamp(xi, 0, wid - 1).to(torch.int64)
            idx = (yc * wid + xc).reshape(g, 1, -1).expand(-1, c, -1)
            v = torch.gather(flat, 2, idx).reshape((g, c) + rest)
            out = out + v * (w * valid)[:, None]
    return out


@register("_contrib_DeformableConvolution", nin=-1,
          aliases=("DeformableConvolution",),
          params={"kernel": REQUIRED, "stride": (), "dilate": (), "pad": (),
                  "num_filter": REQUIRED, "num_group": 1,
                  "num_deformable_group": 1, "workspace": 1024,
                  "no_bias": False, "layout": None},
          input_names=lambda p: ["data", "offset", "weight"] +
          ([] if p.get("no_bias") else ["bias"]))
def _deformable_convolution(params, data, offset, weight, *rest):
    """Deformable convolution v1: each kernel tap samples at its base
    position + dilation + a learned offset (bilinear), then a grouped
    contraction with the weights.  offset (N, DG*2*K, Ho, Wo), per
    deformable group a block of (y_k, x_k) pairs."""
    kh, kw = _pair(params["kernel"], 1)
    sh, sw = _pair(params["stride"], 1)
    dh, dw = _pair(params["dilate"], 1)
    ph, pw = _pair(params["pad"], 0)
    nf = int(params["num_filter"])
    grp = int(params["num_group"])
    dg = int(params["num_deformable_group"])
    n, c, hgt, wid = data.shape
    ho = (hgt + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wid + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    k = kh * kw
    off = offset.reshape(n, dg, k, 2, ho, wo)
    dev = dict(device=data.device)
    ky, kx = torch.meshgrid(torch.arange(kh, **dev) * dh,
                            torch.arange(kw, **dev) * dw, indexing="ij")
    ky, kx = ky.reshape(k).to(off.dtype), kx.reshape(k).to(off.dtype)
    base_y = (torch.arange(ho, **dev) * sh - ph).to(off.dtype)
    base_x = (torch.arange(wo, **dev) * sw - pw).to(off.dtype)
    py = off[:, :, :, 0] + base_y[None, None, None, :, None] + \
        ky[None, None, :, None, None]
    px = off[:, :, :, 1] + base_x[None, None, None, None, :] + \
        kx[None, None, :, None, None]
    cg = c // dg
    cols = _bilinear_gather(data.reshape(n * dg, cg, hgt, wid),
                            py.reshape(n * dg, k, ho, wo),
                            px.reshape(n * dg, k, ho, wo))
    cols = cols.reshape(n, grp, c // grp, k, ho, wo)
    w_g = weight.reshape(grp, nf // grp, c // grp, k)
    acc = torch.promote_types(data.dtype, torch.float32)
    out = torch.einsum("ngckhw,gfck->ngfhw", cols.to(acc), w_g.to(acc))
    out = out.reshape(n, nf, ho, wo).to(data.dtype)
    if rest and not params.get("no_bias"):
        out = out + rest[0][None, :, None, None]
    return out


@register("_contrib_DeformablePSROIPooling", nin=-1, nout=2,
          aliases=("DeformablePSROIPooling",),
          params={"spatial_scale": REQUIRED, "output_dim": REQUIRED,
                  "group_size": REQUIRED, "pooled_size": REQUIRED,
                  "part_size": 0, "sample_per_part": 1, "trans_std": 0.0,
                  "no_trans": False},
          input_names=lambda p: ["data", "rois"] +
          ([] if p.get("no_trans") else ["trans"]))
def _deformable_psroi_pooling(params, data, rois, *rest):
    """Position-sensitive ROI pooling whose bins shift by learned,
    roi-normalized offsets (the R-FCN deformable head).  The JAX op's
    sampling grid: spp x spp samples a bin at hstart + i * sub_bin (no
    half-bin offset), counted where -0.5 <= h <= H - 0.5 (inclusive).
    Returns (output, top_count), each (R, output_dim, ps, ps)."""
    scale = float(params["spatial_scale"])
    od = int(params["output_dim"])
    gs = int(params["group_size"])
    ps = int(params["pooled_size"])
    part = int(params["part_size"]) or ps
    spp = int(params["sample_per_part"])
    tstd = float(params["trans_std"])
    trans = None if (params["no_trans"] or not rest) else rest[0]
    _, _, hgt, wid = data.shape
    dt, dev = data.dtype, data.device
    rois = rois.detach()
    nr = rois.shape[0]

    phs = torch.arange(ps, device=dev)
    # floor(p * gs / ps) of non-negative ints, in integers
    gh = torch.clamp(torch.div(phs * gs, ps, rounding_mode="floor"), 0,
                     gs - 1)
    c_idx = (torch.arange(od, device=dev)[:, None, None] * gs +
             gh[None, :, None]) * gs + gh[None, None, :]      # (od, ps, ps)
    part_h = torch.clamp(torch.div(phs * part, ps, rounding_mode="floor"),
                         0, part - 1)

    b = rois[:, 0].to(torch.int64)
    start_w = torch.round(rois[:, 1]) * scale - 0.5
    start_h = torch.round(rois[:, 2]) * scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    roi_w = torch.clamp(end_w - start_w, min=0.1)
    roi_h = torch.clamp(end_h - start_h, min=0.1)
    bin_h, bin_w = true_div(roi_h, ps), true_div(roi_w, ps)
    sub_h, sub_w = true_div(bin_h, spp), true_div(bin_w, spp)
    r4 = (nr, 1, 1, 1)
    if trans is not None:
        ncls = trans.shape[1] // 2
        cls_of = torch.div(torch.arange(od, device=dev), max(od // ncls, 1),
                           rounding_mode="floor")
        t = trans[:, :, part_h][:, :, :, part_h]            # (R, 2C, ps, ps)
        tx = t[:, cls_of * 2] * tstd                         # (R, od, ps, ps)
        ty = t[:, cls_of * 2 + 1] * tstd
    else:
        tx = ty = torch.zeros((nr, od, ps, ps), dtype=dt, device=dev)
    phf = phs.to(dt)
    hstart = start_h.reshape(r4) + phf[None, None, :, None] * \
        bin_h.reshape(r4) + ty * roi_h.reshape(r4)
    wstart = start_w.reshape(r4) + phf[None, None, None, :] * \
        bin_w.reshape(r4) + tx * roi_w.reshape(r4)
    sp = torch.arange(spp, device=dev)
    iy = sp[None] * sub_h[:, None]                           # (R, spp)
    ix = sp[None] * sub_w[:, None]
    hh = hstart[..., None, None] + iy.reshape(nr, 1, 1, 1, spp, 1)
    ww = wstart[..., None, None] + ix.reshape(nr, 1, 1, 1, 1, spp)
    hh, ww = torch.broadcast_tensors(hh, ww)          # (R, od, ps, ps, s, s)
    valid = (hh >= -0.5) & (hh <= hgt - 0.5) & (ww >= -0.5) & \
        (ww <= wid - 0.5)
    hc = torch.clamp(hh, 0, hgt - 1)
    wc = torch.clamp(ww, 0, wid - 1)
    y0 = torch.floor(hc)
    x0 = torch.floor(wc)
    bb = b.reshape(nr, 1, 1, 1, 1, 1)
    cc = c_idx[None, :, :, :, None, None]
    acc = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi = torch.clamp(y0 + dy, 0, hgt - 1).to(torch.int64)
            xi = torch.clamp(x0 + dx, 0, wid - 1).to(torch.int64)
            wgt = (1 - torch.abs(hc - (y0 + dy))) * \
                (1 - torch.abs(wc - (x0 + dx)))
            acc = acc + data[bb, cc, yi, xi] * wgt
    acc = torch.where(valid, acc, 0.0)
    count = valid.sum((-1, -2)).to(dt)
    total = acc.sum((-1, -2))
    out = torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)
    return out.to(dt), count
