"""Optimizer update ops (reference `src/operator/optimizer_op.cc`).

PyTorch port of `incubator_mxnet_tpu/ops/optimizer_ops.py`: sgd_update,
sgd_mom_update, mp_sgd_update, mp_sgd_mom_update, adam_update,
rmsprop_update, rmspropalex_update, ftrl_update, signsgd_update and
signum_update.  The gradient is rescaled, then clipped when
``clip_gradient > 0`` (`_prep_grad`).

Each formula is written once, as an in-place tensor function (the
``*_`` names) under `torch.no_grad()` that overwrites the weight and its
state tensors (momentum, means, the fp32 master weight).  The optimizers
(`optimizer.py`) call those.  The registry ops wrap them with the JAX
ops' face: ``fn(params, weight, grad, *states)`` returns the new weight,
computed on a copy, and the updated states, which are the state tensors
themselves, updated in place (the aux outputs the frontends write back),
so ``nd.sgd_mom_update(weight, grad, mom, momentum=0.9, lr=..,
out=weight)`` writes ``out`` and ``mom`` as the reference's does.

`multi_sgd_update_` updates a list of parameters at once with the
`torch._foreach_*` ops (a few launches for all of them on the card; the
reference's ``multi_sgd_*`` ops), each with its own lr and wd.  It does
the per-parameter functions' arithmetic in the same order, so the
results are bitwise equal.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update_", "sgd_mom_update_", "mp_sgd_update_",
           "mp_sgd_mom_update_", "multi_sgd_update_", "adam_update_",
           "rmsprop_update_", "rmspropalex_update_", "ftrl_update_",
           "signsgd_update_", "signum_update_"]

_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0,
           "lazy_update": True}


def _prep_grad(grad, rescale, clip):
    g = grad * rescale
    if clip > 0:
        g = g.clamp(-abs(clip), abs(clip))
    return g


@torch.no_grad()
def sgd_update_(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """weight -= lr * (g + wd * weight)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient).to(weight.dtype)
    weight.sub_(lr * (g + wd * weight))


@torch.no_grad()
def sgd_mom_update_(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (g + wd * weight); weight += mom."""
    g = _prep_grad(grad, rescale_grad, clip_gradient).to(weight.dtype)
    mom.mul_(momentum).sub_(lr * (g + wd * weight))
    weight.add_(mom)


@torch.no_grad()
def mp_sgd_update_(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """SGD on the fp32 master copy, the weight refreshed from it
    (reference optimizer_op-inl.h MP_SGDKernel)."""
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient)
    weight32.sub_(lr * (g + wd * weight32))
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update_(weight, grad, mom, weight32, lr, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)


@torch.no_grad()
def multi_sgd_update_(weights, grads, lrs, wds, moms=None, weights32=None,
                      momentum=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """The update of `sgd_update_` (`moms` None) or `sgd_mom_update_` over
    lists of tensors, parameter i at ``lrs[i]``, ``wds[i]``; with
    `weights32` (fp32 master copies) that of `mp_sgd_update_` or
    `mp_sgd_mom_update_`, the weights refreshed from the masters."""
    if weights32 is not None:
        gs = [g.float() for g in grads]
        torch._foreach_mul_(gs, rescale_grad)
        target = weights32
    else:
        gs = torch._foreach_mul(grads, rescale_grad)
        target = weights
    if clip_gradient > 0:
        torch._foreach_clamp_min_(gs, -abs(clip_gradient))
        torch._foreach_clamp_max_(gs, abs(clip_gradient))
    # step = lr * (g + wd * w); g + 0 * w is g for finite weights
    if any(wds):
        step = torch._foreach_mul(target, list(wds))
        torch._foreach_add_(step, gs)
    else:
        step = gs
    torch._foreach_mul_(step, list(lrs))
    if moms is not None:
        torch._foreach_mul_(moms, momentum)
        torch._foreach_sub_(moms, step)
        torch._foreach_add_(target, moms)
    else:
        torch._foreach_sub_(target, step)
    if weights32 is not None:
        torch._foreach_copy_(weights, weights32)


@torch.no_grad()
def adam_update_(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """g = grad + wd * weight; mean = beta1 * mean + (1 - beta1) * g;
    var = beta2 * var + (1 - beta2) * g^2; weight -= lr * mean /
    (sqrt(var) + epsilon) (the caller folds the bias correction into
    `lr`, as `optimizer.Adam` does)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient).to(weight.dtype) + \
        wd * weight
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * g.square())
    weight.sub_(lr * mean / (var.sqrt() + epsilon))


@torch.no_grad()
def rmsprop_update_(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """g = grad + wd * weight; n = (1 - gamma1) * g^2 + gamma1 * n;
    weight -= lr * g / sqrt(n + epsilon) (Tieleman and Hinton)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    weight.sub_(lr * g / (n + epsilon).sqrt())


@torch.no_grad()
def rmspropalex_update_(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0):
    """The centered RMSProp of Graves (2013): n and g_avg the running
    means of g^2 and g, delta = gamma2 * delta - lr * g / sqrt(n - g_avg^2
    + epsilon), weight += delta."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    g_avg.mul_(gamma1).add_((1 - gamma1) * g)
    delta.mul_(gamma2).sub_(lr * g / (n - g_avg.square() + epsilon).sqrt())
    weight.add_(delta)


@torch.no_grad()
def ftrl_update_(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-Proximal (McMahan et al. 2013): n += g^2, z += g - (sqrt(n) -
    sqrt(n_old)) / lr * weight, and the weight the closed-form solution,
    0 where |z| <= lamda1."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    sqrt_old = n.sqrt()
    n.add_(g.square())
    sqrt_new = n.sqrt()
    z.add_(g - (sqrt_new - sqrt_old) / lr * weight)
    solved = -(z - torch.sign(z) * lamda1) / ((beta + sqrt_new) / lr + wd)
    weight.copy_(torch.where(z.abs() > lamda1, solved,
                             torch.zeros_like(weight)))


@torch.no_grad()
def signsgd_update_(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """weight -= lr * (sign(g) + wd * weight)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * weight))


@torch.no_grad()
def signum_update_(weight, grad, mom, lr, momentum=0.0, wd=0.0, wd_lh=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - (1 - momentum) * (g + wd * weight); weight =
    (1 - lr * wd_lh) * weight + lr * sign(mom) (Bernstein et al. 2018)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_((1 - momentum) * (g + wd * weight))
    weight.mul_(1 - lr * wd_lh).add_(lr * torch.sign(mom))


# -- registry ops --------------------------------------------------------------

def _kw(params, *names):
    """The update function's keywords from the op's params."""
    return {k: params[k] for k in ("wd", "rescale_grad", "clip_gradient")
            + names}


@register("sgd_update", nin=2, params=dict(_COMMON))
def _sgd_update(params, weight, grad):
    w = weight.clone()
    sgd_update_(w, grad, params["lr"], **_kw(params))
    return w


@register("sgd_mom_update", nin=3, naux=1,
          params={**_COMMON, "momentum": 0.0})
def _sgd_mom_update(params, weight, grad, mom):
    w = weight.clone()
    sgd_mom_update_(w, grad, mom, params["lr"], **_kw(params, "momentum"))
    return w, mom


@register("mp_sgd_update", nin=3, naux=1, params=dict(_COMMON))
def _mp_sgd_update(params, weight, grad, weight32):
    w = weight.clone()
    mp_sgd_update_(w, grad, weight32, params["lr"], **_kw(params))
    return w, weight32


@register("mp_sgd_mom_update", nin=4, naux=2,
          params={**_COMMON, "momentum": 0.0})
def _mp_sgd_mom_update(params, weight, grad, mom, weight32):
    w = weight.clone()
    mp_sgd_mom_update_(w, grad, mom, weight32, params["lr"],
                       **_kw(params, "momentum"))
    return w, mom, weight32


@register("adam_update", nin=4, naux=2,
          params={**_COMMON, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
def _adam_update(params, weight, grad, mean, var):
    w = weight.clone()
    adam_update_(w, grad, mean, var, params["lr"],
                 **_kw(params, "beta1", "beta2", "epsilon"))
    return w, mean, var


@register("rmsprop_update", nin=3, naux=1,
          params={**_COMMON, "gamma1": 0.95, "epsilon": 1e-8})
def _rmsprop_update(params, weight, grad, n):
    w = weight.clone()
    rmsprop_update_(w, grad, n, params["lr"],
                    **_kw(params, "gamma1", "epsilon"))
    return w, n


@register("rmspropalex_update", nin=5, naux=3,
          params={**_COMMON, "gamma1": 0.95, "gamma2": 0.9,
                  "epsilon": 1e-8})
def _rmspropalex_update(params, weight, grad, n, g_avg, delta):
    w = weight.clone()
    rmspropalex_update_(w, grad, n, g_avg, delta, params["lr"],
                        **_kw(params, "gamma1", "gamma2", "epsilon"))
    return w, n, g_avg, delta


@register("ftrl_update", nin=4, naux=2,
          params={**_COMMON, "lamda1": 0.01, "beta": 1.0})
def _ftrl_update(params, weight, grad, z, n):
    w = weight.clone()
    ftrl_update_(w, grad, z, n, params["lr"], **_kw(params, "lamda1",
                                                     "beta"))
    return w, z, n


@register("signsgd_update", nin=2, params=dict(_COMMON))
def _signsgd_update(params, weight, grad):
    w = weight.clone()
    signsgd_update_(w, grad, params["lr"], **_kw(params))
    return w


@register("signum_update", nin=3, naux=1,
          params={**_COMMON, "momentum": 0.0, "wd_lh": 0.0})
def _signum_update(params, weight, grad, mom):
    w = weight.clone()
    signum_update_(w, grad, mom, params["lr"],
                   **_kw(params, "momentum", "wd_lh"))
    return w, mom
