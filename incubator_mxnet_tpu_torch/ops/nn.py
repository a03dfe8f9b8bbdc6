"""Core neural-network operators.

PyTorch port of part of `incubator_mxnet_tpu/ops/nn.py`:
FullyConnected, Convolution, Pooling, Activation, softmax, LeakyReLU,
Dropout, BatchNorm, LayerNorm and RNN.
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
