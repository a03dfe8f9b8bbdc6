"""Loss-head output ops with implicit gradients.

PyTorch port of `SoftmaxOutput` (alias ``Softmax``) in
`incubator_mxnet_tpu/ops/loss_output.py` (reference
`src/operator/softmax_output.cc`): the classic classification head whose
backward *ignores the incoming gradient* (unless ``out_grad``) and emits
softmax minus one-hot, scaled by ``grad_scale`` and the normalization.
The JAX op is a custom VJP; here it is a `torch.autograd.Function`.
Softmax and its gradient run in fp32 and are cast to the input's dtype;
the label gets a zero gradient.  The same for the rest of the file:
the regression outputs, `MakeLoss` (the SSD's box loss head), `SVMOutput`
and `IdentityAttachKLSparseReg`.
"""
from __future__ import annotations

import torch

from .registry import register

_SOFTMAX_OUT_PARAMS = {
    "grad_scale": 1.0, "ignore_label": -1.0, "multi_output": False,
    "use_ignore": False, "preserve_shape": False, "normalization": "null",
    "out_grad": False, "smooth_alpha": 0.0,
}


def _one_hot(label, k, axis, dtype):
    """One-hot of the int labels along `axis` (1 or -1) of the output;
    labels outside [0, k) give a zero row, as jax.nn.one_hot does."""
    classes = torch.arange(k, device=label.device)
    if axis == 1:
        classes = classes.view((1, k) + (1,) * (label.dim() - 1))
        return (label.unsqueeze(1) == classes).to(dtype)
    return (label.unsqueeze(-1) == classes).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, params):
        axis = 1 if params["multi_output"] else -1
        out = torch.softmax(data.float(), dim=axis)
        ctx.save_for_backward(out, label)
        ctx.params = params
        ctx.axis = axis
        ctx.in_dtype = data.dtype
        return out.to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        p, axis = ctx.params, ctx.axis
        k = out.shape[axis]
        onehot = _one_hot(label.to(torch.int32), k, axis, out.dtype)
        smooth = float(p["smooth_alpha"])
        if smooth > 0:
            onehot = onehot * (1 - smooth) + smooth / (k - 1) * (1 - onehot)
        grad = out - onehot
        ignore = float(p["ignore_label"])
        if p["use_ignore"]:
            keep = (label != ignore).unsqueeze(axis)
            grad = grad * keep.to(out.dtype)
        if p["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif p["normalization"] == "valid":
            if p["use_ignore"]:
                valid = torch.clamp((label != ignore).to(out.dtype).sum(),
                                    min=1.0)
            else:
                valid = float(label.numel())
            grad = grad / valid
        grad = grad * float(p["grad_scale"])
        if p["out_grad"]:
            grad = grad * g.to(out.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(ctx.in_dtype), dlabel, None


@register("SoftmaxOutput", nin=2, params=dict(_SOFTMAX_OUT_PARAMS),
          aliases=("Softmax",), input_names=["data", "label"])
def _softmax_output(params, data, label):
    """Forward = softmax; backward = (softmax - onehot(label)) *
    grad_scale, with ignore-label masking and normalization (reference
    `softmax_output-inl.h` SoftmaxOutputBackward).  Without
    ``multi_output`` or ``preserve_shape`` an N-D input is read as
    (batch, prod(rest)) classes."""
    orig_shape = data.shape
    flattened = False
    if not params["multi_output"] and not params["preserve_shape"] \
            and data.dim() > 2:
        data = data.reshape(orig_shape[0], -1)
        label = label.reshape(orig_shape[0])
        flattened = True
    out = _SoftmaxOutput.apply(data, label, params)
    return out.reshape(orig_shape) if flattened else out


class _Regression(torch.autograd.Function):
    """Forward = link(data); backward = grad_fn(out, label) *
    grad_scale / num_output, the incoming gradient ignored (reference
    `regression_output-inl.h`)."""

    @staticmethod
    def forward(ctx, data, label, link, grad_fn, grad_scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn = grad_fn
        ctx.grad_scale = grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_out = max(out.numel() // out.shape[0], 1)
        grad = ctx.grad_fn(out, label.reshape(out.shape)) * \
            (ctx.grad_scale / num_out)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(out.dtype), dlabel, None, None, None


def _regression(link, grad_fn):
    def fn(params, data, label):
        return _Regression.apply(data, label, link, grad_fn,
                                 float(params["grad_scale"]))
    return fn


# grad = (pred - label) for linear and logistic, sign(pred - label) for
# MAE; scaled by grad_scale / num_output
for _name, _link, _grad in (
        ("LinearRegressionOutput", lambda d: d, lambda o, l: o - l),
        ("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l),
        ("MAERegressionOutput", lambda d: d,
         lambda o, l: torch.sign(o - l))):
    register(_name, nin=2, params={"grad_scale": 1.0},
             input_names=["data", "label"])(_regression(_link, _grad))


class _MakeLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, params):
        ctx.save_for_backward(data)
        ctx.params = params
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        p = ctx.params
        grad = torch.full_like(d, float(p["grad_scale"]))
        if p["normalization"] == "batch":
            grad = grad / d.shape[0]
        elif p["normalization"] == "valid":
            valid = torch.clamp(
                (d > float(p["valid_thresh"])).to(d.dtype).sum(), min=1.0)
            grad = grad / valid
        return grad, None


@register("MakeLoss",
          params={"grad_scale": 1.0, "valid_thresh": 0.0,
                  "normalization": "null"})
def _make_loss_op(params, data):
    """Reference `make_loss.cc`: forward the identity; backward
    ``grad_scale``, divided by the batch size (``batch``) or by the
    count of elements above ``valid_thresh`` (``valid``, at least 1);
    the incoming gradient is ignored."""
    return _MakeLoss.apply(data, params)


class _SVMOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, params):
        ctx.save_for_backward(data, label)
        ctx.params = params
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        p = ctx.params
        margin = float(p["margin"])
        reg = float(p["regularization_coefficient"])
        target = 2 * _one_hot(label.to(torch.int64), d.shape[1], -1,
                              d.dtype) - 1
        gap = margin - target * d
        viol = gap > 0
        if p["use_linear"]:
            grad = torch.where(viol, -target * reg, 0.0)
        else:
            grad = torch.where(viol, -2 * gap * target * reg, 0.0)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(d.dtype), dlabel, None


@register("SVMOutput", nin=2,
          params={"margin": 1.0, "regularization_coefficient": 1.0,
                  "use_linear": False}, input_names=["data", "label"])
def _svm_output(params, data, label):
    """Reference `svm_output.cc`: forward the identity; backward the
    hinge loss's gradient (squared, or linear with ``use_linear``) for
    the one-vs-rest targets +1 (the label's class) and -1."""
    return _SVMOutput.apply(data, label, params)


@register("IdentityAttachKLSparseReg",
          params={"sparseness_target": 0.1, "penalty": 0.001,
                  "momentum": 0.9})
def _identity_kl(params, data):
    """The identity, as in the JAX package (which attaches no KL
    penalty to the gradient)."""
    return data + 0
