"""Optimizer update ops (reference `src/operator/optimizer_op.cc`).

PyTorch port of `sgd_update`, `sgd_mom_update`, `mp_sgd_update` and
`mp_sgd_mom_update` in `incubator_mxnet_tpu/ops/optimizer_ops.py`.  The
JAX ops return new arrays that the caller writes back; here each runs in
place under `torch.no_grad()`: the weight and the state tensors
(momentum, the fp32 master weight) are overwritten.  The gradient is
rescaled, then clipped when ``clip_gradient > 0`` (`_prep_grad`).

Two faces: the tensor functions (``*_`` names) and the `nd` frontends
with the reference's signatures, ``nd.sgd_mom_update(weight, grad, mom,
momentum=0.9, lr=..., out=weight)``, which write ``out`` (the weight when
``out`` is None or is the weight).

`multi_sgd_update_` updates a list of parameters at once with the
`torch._foreach_*` ops (a few launches for all of them on the card; the
reference's ``multi_sgd_*`` ops), each with its own lr and wd.  It does
the per-parameter functions' arithmetic in the same order, so the
results are bitwise equal.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update_", "sgd_mom_update_", "mp_sgd_update_",
           "mp_sgd_mom_update_", "multi_sgd_update_", "sgd_update", "sgd_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update"]


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


# -- nd frontends ------------------------------------------------------------

def _out(weight, out):
    """The NDArray the new weight goes to, holding the weight's values."""
    if out is None or out is weight:
        return weight
    out._set_data(weight.data)
    return out


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, out=None):
    out = _out(weight, out)
    sgd_update_(out.data, grad.data, lr, wd, rescale_grad, clip_gradient)
    return out


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None):
    out = _out(weight, out)
    sgd_mom_update_(out.data, grad.data, mom.data, lr, momentum, wd,
                    rescale_grad, clip_gradient)
    return out


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, out=None):
    out = _out(weight, out)
    mp_sgd_update_(out.data, grad.data, weight32.data, lr, wd, rescale_grad,
                   clip_gradient)
    return out


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True, out=None):
    out = _out(weight, out)
    mp_sgd_mom_update_(out.data, grad.data, mom.data, weight32.data, lr,
                       momentum, wd, rescale_grad, clip_gradient)
    return out
