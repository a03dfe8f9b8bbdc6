"""The contrib/tensor op tail (reference `src/operator/contrib/`,
`src/operator/tensor/`).

PyTorch port of `incubator_mxnet_tpu/ops/contrib_tail.py`: fft/ifft
(`torch.fft`, cuFFT on the card), count_sketch, khatri_rao, histogram,
ravel_multi_index/unravel_index, _square_sum, cast_storage,
sparse_retain, SyncBatchNorm, DeformableConvolution and
DeformablePSROIPooling (Deformable ConvNets v1 and the R-FCN head: a
bilinear gather and a contraction, with the JAX ops' sampling grids).
Gradients are autograd's.  As in the JAX package, cast_storage and
sparse_retain are their dense semantics (the sparse NDArrays of
`ndarray/sparse.py` convert with `tostype`), and SyncBatchNorm is
BatchNorm over the batch it sees: one device's.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
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


# ---------------------------------------------------------------------------
# FFT family (reference `contrib/fft-inl.h`, `ifft-inl.h`)
# ---------------------------------------------------------------------------

@register("_contrib_fft", aliases=("fft",), params={"compute_size": 128})
def _fft(params, x):
    """The FFT over the last axis of a real input; the output's last
    axis is 2d with (re, im) interleaved (cuFFT's complex layout).
    ``compute_size`` (a sub-batching knob) is accepted and ignored."""
    c = torch.fft.fft(x.to(torch.float32))
    out = torch.stack([c.real, c.imag], dim=-1)
    return out.reshape(tuple(x.shape[:-1]) + (2 * x.shape[-1],)).to(x.dtype)


@register("_contrib_ifft", aliases=("ifft",), params={"compute_size": 128})
def _ifft(params, x):
    """The unnormalised inverse FFT (cuFFT's CUFFT_INVERSE: never divided
    by d) of an interleaved-complex input (..., 2d); the real part,
    (..., d)."""
    d = x.shape[-1] // 2
    pairs = x.reshape(tuple(x.shape[:-1]) + (d, 2)).to(torch.float32)
    c = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(c).real * d).to(x.dtype)


# ---------------------------------------------------------------------------
# count_sketch / khatri_rao (reference `contrib/count_sketch-inl.h`,
# `contrib/krprod.cc`)
# ---------------------------------------------------------------------------

@register("_contrib_count_sketch", nin=3,
          params={"out_dim": REQUIRED, "processing_batch_size": 32})
def _count_sketch(params, data, h, s):
    """out[:, h[i]] += s[i] * x[:, i], the Count Sketch projection of
    compact bilinear pooling (an atomic add on the card, so the order of
    a bucket's sum is not fixed)."""
    idx = h.reshape(-1).to(torch.int64)
    vals = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(params["out_dim"])),
                      dtype=data.dtype, device=data.device)
    return out.index_add(1, idx, vals)


@register("khatri_rao", nin=-1, variadic_param="num_args",
          params={"num_args": REQUIRED})
def _khatri_rao(params, *mats):
    """The column-wise Khatri-Rao product: inputs (M_i, N) -> (prod M_i,
    N), column k the Kronecker product of the inputs' k-th columns."""
    if not mats:
        raise MXNetError("khatri_rao needs at least one matrix")
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


# ---------------------------------------------------------------------------
# histogram / ravel / unravel / square_sum (reference `tensor/histogram.cc`,
# `tensor/ravel.cc`, `tensor/square_sum-inl.h`)
# ---------------------------------------------------------------------------

def histogram_counts(data, edges):
    """`jnp.histogram`'s counts of float32 `data` in bins with `edges`:
    bin i holds edges[i] <= x < edges[i + 1], the last bin closed;
    values outside the edges are not counted.  Float32 counts."""
    idx = torch.searchsorted(edges, data, right=True)
    nb = edges.shape[0]
    idx = torch.where(data == edges[-1], nb - 1, idx)
    return torch.bincount(idx, minlength=nb + 1)[1:nb].to(torch.float32)


@register("_histogram", nin=-1, variadic_param="num_args", nout=2,
          aliases=("histogram",),
          params={"num_args": 1, "bin_cnt": None, "range": None})
def _histogram(params, *arrays):
    """(counts, bin edges): ``bin_cnt`` equal bins over ``range``, or
    the edges given as a second input."""
    data = arrays[0].reshape(-1).to(torch.float32)
    bin_cnt = params.get("bin_cnt")
    if bin_cnt is not None:
        lo, hi = (float(v) for v in params["range"])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, int(bin_cnt) + 1,
                               dtype=torch.float64,
                               device=data.device).to(torch.float32)
        out_dt = torch.float32
    else:
        if len(arrays) < 2:
            raise MXNetError("_histogram: provide bins input or bin_cnt")
        edges = arrays[1].to(torch.float32)
        out_dt = arrays[-1].dtype
    if data.device.type == "meta":
        return (torch.empty((edges.shape[0] - 1,), device="meta"),
                edges.to(out_dt))
    return histogram_counts(data, edges), edges.to(out_dt)


@register("_ravel_multi_index", aliases=("ravel_multi_index",),
          params={"shape": REQUIRED})
def _ravel_multi_index(params, idx):
    """(ndim, n) index columns -> (n,) flat positions in `shape`."""
    flat = torch.zeros(tuple(idx.shape[1:]), dtype=torch.int64,
                       device=idx.device)
    for d, s in enumerate(int(v) for v in params["shape"]):
        flat = flat * s + idx[d].to(torch.int64)
    return flat.to(idx.dtype)


@register("_unravel_index", aliases=("unravel_index",),
          params={"shape": REQUIRED})
def _unravel_index(params, flat):
    """(n,) flat positions -> (ndim, n) index columns in `shape`."""
    rows = []
    rem = flat.to(torch.int64)
    for s in reversed([int(v) for v in params["shape"]]):
        rows.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(rows[::-1], dim=0).to(flat.dtype)


@register("_square_sum", params={"axis": None, "keepdims": False,
                                 "exclude": False})
def _square_sum(params, x):
    """sum(x * x) over `axis` (every axis but those with ``exclude``)."""
    axis = params["axis"]
    if axis is not None and not isinstance(axis, (tuple, list)):
        axis = (int(axis),)
    if axis is not None and params.get("exclude"):
        axis = tuple(i for i in range(x.dim())
                     if i not in tuple(a % x.dim() for a in axis))
    sq = x.square()
    if axis is None:
        return sq.sum().reshape((1,) * x.dim()) if params["keepdims"] \
            else sq.sum()
    return sq.sum(dim=tuple(axis), keepdim=bool(params["keepdims"]))


@register("cast_storage", params={"stype": REQUIRED})
def _cast_storage(params, x):
    """The identity on a dense tensor, for every target stype."""
    if params["stype"] not in ("default", "row_sparse", "csr"):
        raise MXNetError(f"cast_storage: unknown stype {params['stype']}")
    return x


@register("sparse_retain", nin=2)
def _sparse_retain(params, data, indices):
    """The rows listed in `indices` kept, the others zero."""
    idx = indices.reshape(-1).to(torch.int64)
    return torch.zeros_like(data).index_copy(0, idx,
                                             data.index_select(0, idx))


# ---------------------------------------------------------------------------
# SyncBatchNorm (reference `contrib/sync_batch_norm-inl.h`)
# ---------------------------------------------------------------------------

def _sbn_nout(params):
    return 3 if params.get("output_mean_var") else 1


@register("_contrib_SyncBatchNorm", nin=3, naux=2, nout=_sbn_nout,
          mode_dependent=True, aliases=("SyncBatchNorm",),
          params={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                  "use_global_stats": False, "output_mean_var": False,
                  "ndev": 1, "key": ""},
          input_names=["data", "gamma", "beta", "moving_mean", "moving_var"])
def _sync_batch_norm(params, x, gamma, beta, moving_mean, moving_var):
    """BatchNorm (`nn._batch_norm`) with ``sync`` set over the ``dp``
    axis: in training under a bound mesh of ranks with that axis, the
    statistics of the whole batch, summed over the axis's group; else
    the batch's own.  ``ndev`` and ``key`` are accepted (the group
    decides who takes part)."""
    from .nn import _batch_norm
    sub = {k: params[k] for k in ("eps", "momentum", "fix_gamma",
                                  "use_global_stats", "output_mean_var")}
    sub.update(axis=1, cudnn_off=False, sync=True, sync_axis="dp",
               _train=params.get("_train", False))
    return _batch_norm(sub, x, gamma, beta, moving_mean, moving_var)
