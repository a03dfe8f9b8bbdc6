"""INT8 model quantization (reference `python/mxnet/contrib/quantization.py`
`quantize_model:412` and the C++ `quantize_graph_pass.cc`).

PyTorch port of `incubator_mxnet_tpu/contrib/quantization.py`, with its
graph rewrite and thresholds: every FullyConnected, Convolution and
Pooling node not in ``excluded_sym_names`` (and of a configuration the
int8 ops implement, `_supported`) becomes quantize -> int8 op ->
dequantize, its weight quantized into the returned parameters beside its
``_min``/``_max`` range; the bias stays fp32 and is added after the
dequantize.  Calibration: ``none`` (each batch's own range, at run time),
``naive`` (min/max of every internal output over the calibration
batches) or ``entropy`` (the minimum-KL threshold of an 8001-bin
histogram a layer, `_kl_threshold_from_hist`).

Divergences from the JAX package: a Convolution whose ``layout`` is
unset (None, NCHW) is rewritten, where the JAX package's `_supported`
leaves every such node fp32 (ROADMAP Queue 3); ``ctx`` defaults to the
card, where the quantized weights land and the calibration forward runs
(the JAX package's default is the CPU); the weights are quantized on
their context, and calibration reduces each internal output to its
min/max or histogram on the device, reading back a few numbers a batch
instead of every activation.  `_histogram` gives `np.histogram`'s counts
(its bin edges, left-closed bins, the last one closed).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import sparse as _sparse
from ..ops.detection import true_div

QUANTIZABLE = {"FullyConnected", "Convolution", "Pooling"}

__all__ = ["quantize_model"]


def _smooth_distribution(d, eps=0.0001):
    """Move epsilon mass onto zero bins so KL stays finite (the reference's
    `_smooth_distribution`, itself the TensorRT calibration recipe)."""
    is_zero = d == 0
    n_zero = int(is_zero.sum())
    n_nonzero = d.size - n_zero
    if n_nonzero == 0:
        return None
    d = d.astype(np.float64)
    if n_zero:
        d[is_zero] = eps
        d[~is_zero] -= eps * n_zero / n_nonzero
        if (d[~is_zero] <= 0).any():
            return None
    return d / d.sum()


_NUM_BINS = 8001


def _merge_histograms(parts):
    """Rebin per-batch histograms (each over its own symmetric range) onto
    the widest range, bin centers reassigned by linear index scaling."""
    absmax = max(a for _, a in parts)
    total = np.zeros(_NUM_BINS, np.int64)
    for hist, a in parts:
        if a == absmax:
            total += hist
            continue
        centers = (np.arange(_NUM_BINS) + 0.5) / _NUM_BINS * 2 * a - a
        idx = np.clip(((centers + absmax) / (2 * absmax)
                       * _NUM_BINS).astype(int), 0, _NUM_BINS - 1)
        np.add.at(total, idx, hist)
    return total, absmax


def _histogram(t, absmax, num_bins=_NUM_BINS):
    """``np.histogram(t, num_bins, range=(-absmax, absmax))[0]`` of a
    tensor, counted on its device: numpy's own bin edges, each value in
    the bin whose left edge it reaches, the last bin closed."""
    edges = np.histogram_bin_edges(
        np.empty(0, np.dtype(str(t.dtype).replace("torch.", ""))),
        bins=num_bins, range=(-absmax, absmax))
    flat = t.reshape(-1)
    idx = torch.searchsorted(torch.from_numpy(edges).to(t.device), flat,
                             right=True) - 1
    return torch.bincount(idx.clamp_(0, num_bins - 1), minlength=num_bins)


def _kl_optimal_threshold(arr, num_bins=_NUM_BINS, num_quantized_bins=255):
    """Minimum-KL clipping threshold for one layer's activations."""
    arr = np.asarray(arr).ravel()
    absmax = float(np.abs(arr).max()) or 1e-8
    hist, _ = np.histogram(arr, bins=num_bins, range=(-absmax, absmax))
    return _kl_threshold_from_hist(hist, absmax, num_quantized_bins)


def _kl_threshold_from_hist(hist, absmax, num_quantized_bins=255):
    """Minimum-KL clipping threshold from a symmetric histogram (the
    reference's entropy calibration, `_get_optimal_threshold`, after
    TensorRT's KL recipe): for each candidate symmetric threshold, the KL
    divergence between the clipped fp32 histogram P and its
    int8-requantized reconstruction Q; the threshold that loses the least
    wins."""
    num_bins = len(hist)
    edges = np.linspace(-absmax, absmax, num_bins + 1)
    zero = num_bins // 2
    best_kl, best_thr = None, absmax
    for i in range(num_quantized_bins // 2, zero + 1,
                   max(1, zero // 128)):
        lo, hi = zero - i, zero + i + 1
        sliced = hist[lo:hi].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:lo].sum()            # outliers clamp to the edges
        p[-1] += hist[hi:].sum()
        # requantize the slice into the int8 bin count, then expand back
        factor = len(sliced) / num_quantized_bins
        q = np.zeros_like(p)
        for j in range(num_quantized_bins):
            a = int(np.floor(j * factor))
            b = int(np.ceil((j + 1) * factor))
            chunk = sliced[a:b]
            count = (chunk != 0).sum()
            if count:
                q[a:b][chunk != 0] = chunk[chunk != 0].sum() / count
        p = _smooth_distribution(p)
        q = _smooth_distribution(q)
        if p is None or q is None:
            continue
        kl = float(np.sum(p * np.log(p / q)))
        if best_kl is None or kl < best_kl:
            best_kl = kl
            best_thr = float(edges[hi]) if hi < len(edges) else absmax
    return best_thr


def _collect_calib_ranges(sym, arg_params, aux_params, calib_data,
                          num_batches, ctx, mode="naive"):
    """The fp32 forward of every internal output over the calibration
    batches, on `ctx`.  'naive': each output's running min/max (reference
    _LayerOutputMinMax collector); 'entropy': each batch folded into an
    8001-bin histogram, merged and cut at the minimum-KL threshold
    (reference _LayerHistogramCollector + _get_optimal_threshold)."""
    internals = sym.get_internals()
    names = internals.list_outputs()
    ranges = {}
    samples = {}
    exe = None
    for i, batch in enumerate(calib_data):
        if i >= num_batches:
            break
        data = batch.data[0]
        if exe is None:
            exe = internals.simple_bind(ctx=ctx, grad_req="null",
                                        data=data.shape)
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=True)
        outs = [o.data for o in exe.forward(is_train=False, data=data)]
        if mode == "entropy":
            absmax = torch.stack([o.abs().max().float() for o in outs])
            absmax = [float(a) or 1e-8 for a in absmax.cpu()]
            hists = torch.stack([_histogram(o, a)
                                 for o, a in zip(outs, absmax)]).cpu()
            for name, hist, a in zip(names, hists.numpy(), absmax):
                samples.setdefault(name, []).append((hist, a))
            continue
        lims = torch.stack([torch.stack([o.min(), o.max()]).float()
                            for o in outs]).cpu().tolist()
        for name, (mn, mx) in zip(names, lims):
            if name in ranges:
                omn, omx = ranges[name]
                ranges[name] = (min(mn, omn), max(mx, omx))
            else:
                ranges[name] = (mn, mx)
    if mode == "entropy":
        for name, parts in samples.items():
            hist, absmax = _merge_histograms(parts)
            thr = _kl_threshold_from_hist(hist, absmax)
            ranges[name] = (-thr, thr)
    return ranges


def _quantize_weight(w, ctx):
    """(int8 weight on `ctx`, its absmax): clip(round(w / absmax * 127))."""
    t = _sparse.dense_tensor(w, ctx.torch_device)
    wmax = float(t.abs().max()) or 1e-8
    q = torch.clamp(torch.round(true_div(t, wmax) * 127), -127, 127)
    return q.to(torch.int8), wmax


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=logging):
    """Reference `quantization.py:412 quantize_model` -> (quantized
    symbol, new arg_params, aux_params); ``ctx`` defaults to the card."""
    from ..context import current_context
    from ..ndarray.ndarray import NDArray
    from ..symbol import Variable
    from ..symbol.symbol import Symbol, _Node, _sym_apply

    excluded = set(excluded_sym_names or [])
    ctx = ctx if ctx is not None else current_context()

    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError("calib_mode must be 'none', 'naive' or 'entropy'")
    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_data required for calib_mode="
                             f"'{calib_mode}'")
        nb = max(1, (num_calib_examples or 32) // calib_data.batch_size)
        calib_ranges = _collect_calib_ranges(sym, arg_params, aux_params,
                                             calib_data, nb, ctx,
                                             mode=calib_mode)

    new_args = dict(arg_params)
    memo = {}

    def transform(node):
        """Rebuild the graph bottom-up, returning a Symbol per node."""
        if id(node) in memo:
            return memo[id(node)]
        if node.is_variable:
            out = Symbol([(node, 0)])
            memo[id(node)] = out
            return out
        in_syms = []
        for src, idx in node.inputs:
            s = transform(src)
            in_syms.append(s[idx] if len(s._entries) > 1 else s)

        if node.op.name in QUANTIZABLE and node.name not in excluded \
                and _supported(node):
            qdata = _sym_apply("_contrib_quantize_v2", [in_syms[0]],
                               {"out_type": quantized_dtype,
                                **_calib_kwargs(calib_ranges, node)})

            if node.op.name == "Pooling":
                qp = _sym_apply("_contrib_quantized_pooling",
                                [qdata[0], qdata[1], qdata[2]],
                                {k: node.attrs[k] for k in
                                 ("kernel", "pool_type", "stride", "pad",
                                  "global_pool", "pooling_convention")
                                 if k in node.attrs})
                out = _sym_apply("_contrib_dequantize",
                                 [qp[0], qp[1], qp[2]], {})
                memo[id(node)] = out
                return out

            weight_s = in_syms[1]
            bias_s = in_syms[2] if len(in_syms) > 2 else None
            if bias_s is not None:
                # the rewritten graph feeds the bias into a plain Reshape,
                # which has no weight-shape rule: pin the known shape on a
                # fresh variable node of the same name, so the caller's
                # fp32 graph is not mutated
                bnode = node.inputs[2][0]
                if bnode.is_variable and bnode.name in arg_params:
                    nb = _Node(None, bnode.name, {}, [])
                    nb._extra_attrs.update(bnode._extra_attrs)
                    nb._extra_attrs["__shape__"] = tuple(
                        arg_params[bnode.name].shape)
                    bias_s = Symbol([(nb, 0)])
            wname = node.inputs[1][0].name
            qw, wmax = _quantize_weight(arg_params[wname], ctx)
            new_args[wname] = NDArray(qw, ctx=ctx)
            dev = ctx.torch_device
            new_args[wname + "_min"] = NDArray(
                torch.tensor([-wmax], dtype=torch.float32, device=dev),
                ctx=ctx)
            new_args[wname + "_max"] = NDArray(
                torch.tensor([wmax], dtype=torch.float32, device=dev),
                ctx=ctx)

            if node.op.name == "Convolution":
                qc = _sym_apply(
                    "_contrib_quantized_conv",
                    [qdata[0], weight_s, qdata[1], qdata[2],
                     Variable(wname + "_min"), Variable(wname + "_max")],
                    {**{k: node.attrs[k] for k in
                        ("kernel", "stride", "pad", "dilate", "num_filter",
                         "num_group", "layout") if k in node.attrs},
                     "no_bias": True})
                out = _sym_apply("_contrib_dequantize",
                                 [qc[0], qc[1], qc[2]], {})
                if bias_s is not None:
                    out = _sym_apply("broadcast_add", [
                        out, _sym_apply("Reshape", [bias_s],
                                        {"shape": (1, -1, 1, 1)})], {})
            else:  # FullyConnected
                qfc = _sym_apply(
                    "_contrib_quantized_fully_connected",
                    [qdata[0], weight_s, qdata[1], qdata[2],
                     Variable(wname + "_min"), Variable(wname + "_max")],
                    {"num_hidden": node.attrs["num_hidden"], "no_bias": True,
                     "flatten": node.attrs.get("flatten", True)})
                out = _sym_apply("_contrib_dequantize",
                                 [qfc[0], qfc[1], qfc[2]], {})
                if bias_s is not None:
                    out = out + _sym_apply("Reshape", [bias_s],
                                           {"shape": (1, -1)})
            memo[id(node)] = out
            return out

        new_node = _Node(node.op, node.name, node.attrs,
                         [s._entries[0] for s in in_syms])
        new_node._extra_attrs = dict(node._extra_attrs)
        nout = new_node.num_outputs()
        out = Symbol([(new_node, i) for i in range(nout)])
        memo[id(node)] = out
        return out

    out_entries = []
    for node, idx in sym._entries:
        s = transform(node)
        out_entries.append(s._entries[min(idx, len(s._entries) - 1)])
    qsym = Symbol(out_entries)
    return qsym, new_args, dict(aux_params)


def _supported(node):
    """Only configurations the int8 ops implement are rewritten; anything
    else stays fp32 (the reference's quantize_graph_pass likewise skips
    unsupported nodes)."""
    p = node.attrs
    if node.op.name == "Pooling":
        if p.get("pool_type", "max") not in ("max", "avg"):
            return False
        if p.get("pooling_convention", "valid") != "valid":
            return False
        kernel = tuple(p.get("kernel") or ())
        if not p.get("global_pool") and len(kernel) != 2:
            return False
        if p.get("count_include_pad") is False:
            return False
        return True
    if node.op.name == "Convolution":
        kernel = tuple(p.get("kernel") or ())
        # an unset layout (None) is NCHW; the JAX package reads it as
        # another layout and so never rewrites a Convolution
        return len(kernel) == 2 and (p.get("layout") or "NCHW") == "NCHW"
    return True


def _calib_kwargs(ranges, node):
    src = node.inputs[0][0]
    key = f"{src.name}_output"
    if key in ranges:
        mn, mx = ranges[key]
        return {"min_calib_range": mn, "max_calib_range": mx}
    return {}
