"""Core neural-network operators.

PyTorch port of `incubator_mxnet_tpu/ops/nn.py`: FullyConnected,
Convolution, Deconvolution, Pooling, Activation, softmax,
SoftmaxActivation, LeakyReLU, Dropout, BatchNorm, LayerNorm,
InstanceNorm, L2Normalization, LRN, RNN and UpSampling.
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

import numpy as np
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

    def conv(x, weight, bias):
        return _CONV_FN[nd](
            x.to(dt), weight.to(dt), None if bias is None else bias.to(dt),
            stride=_tup(params["stride"], nd, 1),
            padding=_tup(params["pad"], nd, 0),
            dilation=_tup(params["dilate"], nd, 1),
            groups=int(params["num_group"])).to(x.dtype)
    if type(weight) is not torch.Tensor and hasattr(weight, "placements") \
            and int(params["num_group"]) == 1:
        # a mesh of ranks: on each rank's local shards (DTensor's own
        # convolution splits images, not the batch)
        from ..parallel.tensor_parallel import on_local_shards
        return on_local_shards(conv, x, weight, bias)
    return conv(x, weight, bias)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", aliases=("Pooling_v1",),
          params={"kernel": (), "pool_type": "max", "global_pool": False,
                  "cudnn_off": False, "pooling_convention": "valid",
                  "stride": (), "pad": (), "count_include_pad": True})
def _pooling(params, x):
    if type(x) is not torch.Tensor and hasattr(x, "placements"):
        # a mesh of ranks: on each rank's local shard
        from ..parallel.tensor_parallel import on_local_rows
        return on_local_rows(lambda xl: _pooling(params, xl), x)
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


@register("Dropout", needs_rng=True, rate_param="p", mode_dependent=True,
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
    statistics over every data-parallel replica: in training, with a mesh
    of ranks bound (``with mesh:``, `parallel.data_parallel_step`) that
    has the ``sync_axis`` axis, the sums of x and of its squared
    deviations and the element count are all-reduced over that axis's
    group, in plain torch ops, so every rank normalises with the whole
    batch's statistics and gradients flow through the sums (the JAX op's
    pmean of the moments); without one, the statistics are the batch's
    own."""
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
    group = None
    if train and params.get("sync"):
        from ..parallel.mesh import bound_group
        group = bound_group(str(params.get("sync_axis", "dp")))
    if params["output_mean_var"] or group is not None:
        out, mean, var, inv = _bn_plain(xc, g, b, moving_mean, moving_var,
                                        train, eps, sdt, group)
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


def _bn_plain(x, gamma, beta, moving_mean, moving_var, train, eps, sdt,
              group=None):
    """BatchNorm over channel axis 1 as differentiable torch ops in
    `sdt`: (out, mean, biased var, rsqrt(var + eps)); in training with a
    process `group`, the statistics of the batch summed over it."""
    red = tuple(i for i in range(x.ndim) if i != 1)
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    xs = x.to(sdt)
    if train and group is not None:
        from ..parallel.verbs import all_reduce_sum
        sums = all_reduce_sum(torch.cat([
            xs.sum(dim=red), xs.new_full((1,), x.numel() // x.shape[1])]),
            group)
        mean = sums[:-1] / sums[-1]
        var = all_reduce_sum((xs - mean.reshape(shape)).square().sum(
            dim=red), group) / sums[-1]
    elif train:
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


# ---------------------------------------------------------------------------
# Fused RNN (reference src/operator/rnn.cc, cudnn_rnn-inl.h): multi-layer,
# optionally bidirectional vanilla/LSTM/GRU over (T, B, I) inputs with the
# cuDNN flat parameter packing.  PyTorch port of `RNN` in
# `incubator_mxnet_tpu/ops/nn.py`.
# ---------------------------------------------------------------------------

def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total flat parameter count (the cuDNN packing; reference
    rnn-inl.h GetParamSize)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size)  # Wx + Wh
    size += num_layers * d * g * state_size * 2  # bx + bh
    return size


def _unpack_rnn_params(flat, mode, input_size, state_size, num_layers,
                       bidir):
    """Views of the flat cuDNN-layout vector: ``[layer][direction]`` lists
    of (Wx, Wh) and of (bx, bh).  Layout (reference cudnn GetParams): all
    weight matrices, layer-major and direction-minor, Wx then Wh; then
    all biases in the same order, bx then bh."""
    g = _gates(mode)
    d = 2 if bidir else 1
    gh = g * state_size
    off = 0

    def take(n, *shape):
        nonlocal off
        v = flat[off:off + n].view(*shape)
        off += n
        return v

    ws = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        ws.append([(take(gh * in_sz, gh, in_sz),
                    take(gh * state_size, gh, state_size))
                   for _ in range(d)])
    bs = [[(take(gh, gh), take(gh, gh)) for _ in range(d)]
          for _ in range(num_layers)]
    return ws, bs


def _cell_step(mode):
    """``step(carry, xw_t, wh, bh) -> (carry, h)``: one time step given
    the input's projection ``xw_t = x_t Wx^T + bx``."""
    if mode == "lstm":
        def step(carry, xw, wh, bh):
            h, c = carry
            i, f, g, o = (xw + h @ wh.t() + bh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return (h, c), h
    elif mode == "gru":
        def step(carry, xw, wh, bh):
            (h,) = carry
            xr, xz, xn = xw.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.t() + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            return (h,), h
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, xw, wh, bh):
            h = act(xw + carry[0] @ wh.t() + bh)
            return (h,), h
    return step


def rnn_plain(params, data, flat, state, state_cell=None, generator=None):
    """The `RNN` op's plain path: the JAX op's math in torch, one input
    GEMM per layer and direction, then the step loop; returns
    ``(out, h_n, c_n or None)``.  The CPU's route and the card's oracle."""
    mode = params["mode"]
    L, H = int(params["num_layers"]), int(params["state_size"])
    bidir = bool(params["bidirectional"])
    d = 2 if bidir else 1
    p = float(params["p"])
    train = params.get("_train", False)
    ws, bs = _unpack_rnn_params(flat, mode, data.shape[2], H, L, bidir)
    step = _cell_step(mode)
    x = data
    hs, cs = [], []
    for layer in range(L):
        outs = []
        for dr in range(d):
            (wx, wh), (bx, bh) = ws[layer][dr], bs[layer][dr]
            k = layer * d + dr
            carry = (state[k], state_cell[k]) if mode == "lstm" \
                else (state[k],)
            xw = (x if dr == 0 else x.flip(0)) @ wx.t() + bx
            seq = []
            for t in range(xw.shape[0]):
                carry, h = step(carry, xw[t], wh, bh)
                seq.append(h)
            seq = torch.stack(seq)
            outs.append(seq if dr == 0 else seq.flip(0))
            hs.append(carry[0])
            if mode == "lstm":
                cs.append(carry[1])
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if train and p > 0 and layer < L - 1:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= p
            x = torch.where(keep, x / (1 - p), torch.zeros_like(x))
    return x, torch.stack(hs), torch.stack(cs) if cs else None


def rnn_cudnn(params, data, flat, state, state_cell=None):
    """The `RNN` op on the card: cuDNN's fused RNN through `torch.lstm`,
    `torch.gru`, `torch.rnn_tanh` or `torch.rnn_relu`, as the
    reference's GPU backend runs it (`cudnn_rnn-inl.h`); the flat vector
    sliced into torch's per-layer (w_ih, w_hh, b_ih, b_hh) list.  The
    gate orders agree (LSTM i,f,g,o; GRU r,z,n with n = tanh(xn + r (W_hn
    h + b_hn))).  Dropout between layers draws from torch's own stream."""
    mode = params["mode"]
    L, H = int(params["num_layers"]), int(params["state_size"])
    bidir = bool(params["bidirectional"])
    train = bool(params.get("_train", False))
    p = float(params["p"]) if train else 0.0
    ws, bs = _unpack_rnn_params(flat, mode, data.shape[2], H, L, bidir)
    weights = [t for layer in range(L) for dr in range(len(ws[layer]))
               for t in ws[layer][dr] + bs[layer][dr]]
    args = (weights, True, L, p, train, bidir, False)
    if mode == "lstm":
        return torch.lstm(data, (state, state_cell), *args)
    fn = {"gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
          "rnn_relu": torch.rnn_relu}[mode]
    out, h_n = fn(data, state, *args)
    return out, h_n, None


# launches of the op by route, over the process (phase 11 reads them)
rnn_routes = {"cudnn": 0, "plain": 0}


def _rnn_nout(params):
    if not params.get("state_outputs"):
        return 1
    return 3 if params.get("mode") == "lstm" else 2


@register("RNN", nin=-1, nout=_rnn_nout, mode_dependent=True, needs_rng=True,
          rate_param="p",
          input_names=lambda p: ["data", "parameters", "state"] + (
              ["state_cell"] if p.get("mode") == "lstm" else []),
          params={"state_size": REQUIRED, "num_layers": REQUIRED,
                  "bidirectional": False, "mode": REQUIRED, "p": 0.0,
                  "state_outputs": False, "projection_size": None,
                  "lstm_state_clip_min": None, "lstm_state_clip_max": None,
                  "lstm_state_clip_nan": False})
def _rnn(params, *args):
    """Fused multi-layer RNN.  Inputs: data (T, B, I), the flat parameter
    vector, state (L*D, B, H) [, state_cell for lstm], the generator.
    A CUDA tensor takes cuDNN's RNN (`rnn_cudnn`), any other the plain
    loop (`rnn_plain`).  As in the JAX op, the projection and state-clip
    params are accepted and not applied."""
    mode = params["mode"]
    generator = args[-1]
    data, flat, state = args[0], args[1], args[2]
    cell = args[3] if mode == "lstm" else None
    dt = _promoted(data, flat)
    ins = [t.to(dt) for t in (data, flat, state)] + \
        ([cell.to(dt)] if cell is not None else [])
    L, H = int(params["num_layers"]), int(params["state_size"])
    d = 2 if params["bidirectional"] else 1
    if data.device.type == "meta":
        T, B = data.shape[:2]
        h = torch.empty((L * d, B, H), dtype=dt, device="meta")
        out, h_n, c_n = torch.empty((T, B, d * H), dtype=dt,
                                    device="meta"), h, h
    elif data.is_cuda:
        rnn_routes["cudnn"] += 1
        out, h_n, c_n = rnn_cudnn(params, *ins)
    else:
        rnn_routes["plain"] += 1
        out, h_n, c_n = rnn_plain(params, *ins, generator=generator)
    out = out.to(data.dtype)
    if not params["state_outputs"]:
        return out
    if mode == "lstm":
        return out, h_n.to(data.dtype), c_n.to(data.dtype)
    return out, h_n.to(data.dtype)



# ---------------------------------------------------------------------------
# Deconvolution (reference deconvolution-inl.h)
# ---------------------------------------------------------------------------

_DECONV_PARAMS = dict(_CONV_PARAMS)
_DECONV_PARAMS.update({"adj": (), "target_shape": ()})
_DECONV_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
              3: F.conv_transpose3d}


def _deconv_geometry(params, x):
    """(stride, dilate, pad, adj, groups) of a Deconvolution on `x`;
    ``target_shape`` sets adj so the output has that spatial shape."""
    kernel = tuple(params["kernel"])
    nd = len(kernel)
    stride = _tup(params["stride"], nd, 1)
    dilate = _tup(params["dilate"], nd, 1)
    pad = _tup(params["pad"], nd, 0)
    adj = _tup(params["adj"], nd, 0)
    if params["target_shape"]:
        tgt = _tup(params["target_shape"], nd, 0)
        adj = tuple(tgt[i] - ((x.shape[2 + i] - 1) * stride[i] + (
            (kernel[i] - 1) * dilate[i] + 1) - 2 * pad[i]) for i in range(nd))
    return stride, dilate, pad, adj, int(params["num_group"])


def deconv_plain(params, x, weight, bias=None):
    """The transposed convolution as the JAX op computes it: the input
    dilated by the stride (zeros between its elements), padded by
    ``dilate * (k - 1) - pad`` (plus adj after), convolved with the
    kernel flipped and its in/out axes swapped per group.  The plain
    version the library route (`F.conv_transpose*d`) is held to."""
    kernel = tuple(params["kernel"])
    nd = len(kernel)
    stride, dilate, pad, adj, groups = _deconv_geometry(params, x)
    w = torch.flip(weight, tuple(range(2, 2 + nd)))
    cin, cog = w.shape[0], w.shape[1]
    w = w.reshape((groups, cin // groups, cog) + kernel).transpose(1, 2)
    w = w.reshape((groups * cog, cin // groups) + kernel)
    n, c = x.shape[:2]
    size = [(x.shape[2 + i] - 1) * stride[i] + 1 for i in range(nd)]
    xd = x.new_zeros((n, c) + tuple(size))
    xd[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                          for s in stride)] = x
    flat = []
    for i in reversed(range(nd)):
        lo = dilate[i] * (kernel[i] - 1) - pad[i]
        flat += [lo, lo + adj[i]]
    xd = F.pad(xd, flat)   # a negative pad crops, as lax's padding does
    out = _CONV_FN[nd](xd, w, bias, dilation=dilate, groups=groups)
    return out


@register("Deconvolution", nin=-1, params=_DECONV_PARAMS,
          input_names=_with_bias)
def _deconvolution(params, x, weight, *rest):
    """Transposed convolution, the gradient of Convolution with respect
    to its input (reference `deconvolution-inl.h`); weight (Cin,
    Cout/groups, *kernel).  `F.conv_transpose*d` (cuDNN on the card),
    whose plain version is `deconv_plain`."""
    kernel = tuple(params["kernel"])
    nd = len(kernel)
    if nd not in _DECONV_FN:
        raise MXNetError("Deconvolution supports 1D/2D/3D kernels")
    bias = None if params["no_bias"] else rest[0]
    dt = _promoted(x, weight, bias)
    stride, dilate, pad, adj, groups = _deconv_geometry(params, x)
    return _DECONV_FN[nd](
        x.to(dt), weight.to(dt), None if bias is None else bias.to(dt),
        stride=stride, padding=pad, output_padding=adj, groups=groups,
        dilation=dilate).to(x.dtype)


# ---------------------------------------------------------------------------
# Normalisations (reference instance_norm.cc, l2_normalization.cc, lrn.cc)
# ---------------------------------------------------------------------------

@register("InstanceNorm", nin=3, params={"eps": 1e-3},
          input_names=["data", "gamma", "beta"])
def _instance_norm(params, x, gamma, beta):
    """Normalised over the spatial axes per (n, c), biased variance."""
    eps = float(params["eps"])
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register("L2Normalization", params={"eps": 1e-10, "mode": "instance"})
def _l2_normalization(params, x):
    """x / sqrt(sum(x^2) + eps) over every axis but the batch
    ("instance"), the channel axis ("channel") or the spatial axes
    ("spatial")."""
    eps = float(params["eps"])
    axes = {"instance": tuple(range(1, x.dim())), "channel": (1,),
            "spatial": tuple(range(2, x.dim()))}.get(params["mode"])
    if axes is None:
        raise MXNetError("bad L2Normalization mode")
    return x / torch.sqrt(x.square().sum(dim=axes, keepdim=True) + eps)


@register("LRN", params={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                         "nsize": REQUIRED})
def _lrn(params, x):
    """Local response normalisation across channels: x * (knorm + alpha
    / nsize * the sum of x^2 over the nsize channels around)^-beta."""
    n = int(params["nsize"])
    alpha, beta = float(params["alpha"]), float(params["beta"])
    k = float(params["knorm"])
    half = n // 2
    sq = x.square()
    flat = [0, 0] * (x.dim() - 2) + [half, half]
    sq_p = F.pad(sq, flat)
    acc = torch.zeros_like(x)
    for i in range(n):
        acc = acc + sq_p.narrow(1, i, x.shape[1])
    return x * torch.pow(k + (alpha / n) * acc, -beta)


@register("SoftmaxActivation", params={"mode": "instance"})
def _softmax_activation(params, x):
    if params["mode"] == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# UpSampling (reference upsampling.cc)
# ---------------------------------------------------------------------------

def _linear_weights(n_in, n_out):
    """`jax.image.resize`'s weights for one axis ("linear", antialiased),
    as an (n_in, n_out) float32 array: the triangle kernel at the output
    pixel centres, stretched by the scale when shrinking, each column
    normalised to sum 1 and zeroed where its centre falls outside the
    input (computed in float64, then rounded once)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale,
                                                                 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(x, out_hw):
    """`jax.image.resize(x, (n, c, *out_hw), "linear")` on an NCHW tensor:
    one contraction per axis whose size changes.  `F.interpolate`'s
    bilinear mode clamps its source coordinate at the edges and does not
    low-pass when shrinking, so it differs from this at the borders and
    on every downsample."""
    out = x
    for axis, n_out in ((2, int(out_hw[0])), (3, int(out_hw[1]))):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = torch.from_numpy(_linear_weights(n_in, n_out)).to(
            device=out.device, dtype=out.dtype)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out


@register("UpSampling", nin=-1, variadic_param="num_args",
          params={"scale": REQUIRED, "num_filter": 0, "sample_type": REQUIRED,
                  "multi_input_mode": "concat", "num_args": 1,
                  "workspace": 512})
def _upsampling(params, *xs):
    """Each input scaled up `scale` times: "nearest" repeats pixels,
    "bilinear" is `resize_linear` of the input, as the JAX op, which
    takes no weight (upstream MXNet runs a Deconvolution with a weight
    input instead).  Several inputs are concatenated on the channels or
    summed (``multi_input_mode``)."""
    scale = int(params["scale"])
    stype = params["sample_type"]
    outs = []
    for x in xs:
        if stype == "nearest":
            out = x.repeat_interleave(scale, dim=2).repeat_interleave(
                scale, dim=3)
        elif stype == "bilinear":
            out = resize_linear(x, (x.shape[2] * scale, x.shape[3] * scale))
        else:
            raise MXNetError("UpSampling: bad sample_type")
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    if params["multi_input_mode"] == "sum":
        o = outs[0]
        for t in outs[1:]:
            o = o + t
        return o
    return torch.cat(outs, dim=1)
