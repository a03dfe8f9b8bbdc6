"""Optimizers (reference `python/mxnet/optimizer.py`).

PyTorch port of `incubator_mxnet_tpu/optimizer.py`: the `Optimizer` base
and registry, `SGD` (with momentum and ``multi_precision``: fp32 master
weights for fp16/bf16 parameters), `Signum`, `FTML`, `DCASGD`, `NAG`,
`SGLD`, `Adam`, `AdaGrad`, `AdaDelta`, `RMSProp` (``centered``), `Ftrl`,
`Adamax`, `Nadam`, `LBSGD`, `Test`, `Updater`, `get_updater` and
`create`.  Where the JAX classes call an update op (SGD, Signum, Adam,
RMSProp, Ftrl) these run its in-place tensor function
(`ops/optimizer_ops.py`); the others write the JAX classes' formulas as
in-place torch arithmetic.  As in the JAX package only the optimizers
with a ``momentum`` argument (SGD, NAG, Signum, DCASGD, LBSGD) take one:
the others raise the base class's TypeError for it.  `SGLD` draws its
noise on the weight's device (`nd.random.normal`, the device stream), so
the fused train step declines it (``draws_rng``), as the JAX fused step
declines an optimizer that draws randomness while it traces.

Given a `ndarray.sparse.RowSparseNDArray` gradient (an embedding
table's), `SGD` and `Adam` run the JAX package's lazy update
(`optimizer.py:204-270`): duplicate row ids are summed on the host
(`aggregate_row_sparse`), then only the touched rows of the weight and
the state are gathered, updated and written back with `index_copy_` on
unique rows; an empty gradient changes nothing.  With
``lazy_update=False`` the gradient densifies and every row updates.
`state_dict` / `load_state_dict` carry the scalar position (update
counts, the learning-rate schedule) a checkpoint's manifest records;
`Updater.get_states` pickles the states as host arrays that load on a
machine without the card (`NDArray.__reduce__`), and `dumps_states` /
`loads_states` write and read them with the arrays out of band (the
elastic checkpoint's optimizer blob); an optimizer's own scalars
(`Nadam`'s ``m_schedule``) travel with the pickled optimizer.
`update_multi` updates many parameters in one call (what the fused
train step runs); `SGD`'s is the multi-tensor update, which gives the
per-parameter results.
"""
from __future__ import annotations

import pickle
import struct

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import ndarray as nd
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl", "Adamax",
           "Nadam", "LBSGD", "Test", "Updater", "get_updater", "create",
           "register"]


def _low_precision(arr):
    return arr.data.dtype in (torch.float16, torch.bfloat16)


class Optimizer:
    """Base optimizer (reference `optimizer.py:Optimizer`)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        # {index: gluon Parameter}: a Trainer's parameters, whose own
        # lr_mult / wd_mult take precedence
        self.param_dict = dict(param_dict or {})
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """(fp32 master copy, state of the copy) for a low-precision
        weight under ``multi_precision``, else `create_state`."""
        if self.multi_precision and _low_precision(weight):
            w32 = weight.astype("float32")
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and isinstance(state, tuple) \
                and isinstance(state[0], NDArray) \
                and state[0].data.dtype == torch.float32 \
                and weight.data.dtype != torch.float32:
            w32, base_state = state
            self.update(index, w32, grad.astype("float32"), base_state)
            w32.copyto(weight)
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        """`update_multi_precision` of every (index, weight, grad, state),
        in order."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
        self.lr = lr

    def _sym_mult(self, key):
        out = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if key in attr.get(name, {}):
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mult("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # no weight decay on biases and other non-weight parameters
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_mult("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, table):
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            return lr * self.param_dict[index].lr_mult
        return lr * self._mult(index, self.lr_mult)

    def _get_wd(self, index):
        if index in self.param_dict:
            return self.wd * self.param_dict[index].wd_mult
        return self.wd * self._mult(index, self.wd_mult)

    def state_dict(self):
        """The optimizer's scalar state: update counts and the schedule's
        position (the tensors live in `Updater.states`)."""
        d = {"num_update": int(self.num_update),
             "begin_num_update": int(self.begin_num_update),
             "index_update_count": {str(k): int(v) for k, v in
                                    self._index_update_count.items()}}
        if self.lr_scheduler is not None:
            d["lr_scheduler"] = self.lr_scheduler.state_dict()
        return d

    def load_state_dict(self, d):
        self.num_update = int(d.get("num_update", self.num_update))
        self.begin_num_update = int(d.get("begin_num_update",
                                          self.begin_num_update))
        counts = d.get("index_update_count")
        if counts is not None:
            self._index_update_count = {
                (int(k) if str(k).lstrip("-").isdigit() else k): int(v)
                for k, v in counts.items()}
        if self.lr_scheduler is not None and d.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(d["lr_scheduler"])

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("param_dict", None)   # the Parameters stay with the caller
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}


register = Optimizer.register


def _clip(og):
    return og if og is not None and og > 0 else -1.0


_EMPTY_ROWS = object()


def _row_sparse_grad(grad, weight):
    """(unique row ids as a tensor on the weight's device, their summed
    rows in the weight's dtype there) of a row-sparse gradient,
    `_EMPTY_ROWS` when it touches no row, or None for a dense one."""
    from .ndarray.sparse import RowSparseNDArray, aggregate_row_sparse
    if not isinstance(grad, RowSparseNDArray):
        return None
    if len(grad._np_indices) == 0:
        return _EMPTY_ROWS
    idx, vals = aggregate_row_sparse(grad._np_indices, grad._np_data)
    dev = weight.data.device
    # copies: the rows may be a read-only wire buffer
    return (torch.from_numpy(_np.array(idx)).to(dev),
            torch.from_numpy(_np.array(vals)).to(dev, weight.data.dtype))


def _dense_grad(grad, weight):
    """A row-sparse gradient densified on the weight's context (the
    ``lazy_update=False`` route); a dense one as it is."""
    from .ndarray.sparse import RowSparseNDArray
    if isinstance(grad, RowSparseNDArray):
        return grad.tostype("default").as_in_context(weight.context)
    return grad


def _lazy_grad_rows(w_rows, vals, lr_dtype, wd, rescale, clip):
    """The rows' gradient as the dense update sees it: rescaled,
    clipped, plus weight decay (the JAX package's lazy kernels)."""
    g = vals * rescale
    if clip > 0:
        g = torch.clamp(g, -clip, clip)
    return (g + wd * w_rows).to(lr_dtype)


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision (reference
    `optimizer.py SGD`)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return nd.zeros(weight.shape, ctx=weight.context,
                            dtype=weight.data.dtype)
        return None

    def create_state_multi_precision(self, index, weight):
        """(momentum or None, fp32 master weight) for a low-precision
        weight under ``multi_precision``."""
        if self.multi_precision and _low_precision(weight):
            mom = nd.zeros(weight.shape, ctx=weight.context,
                           dtype="float32") if self.momentum != 0.0 else None
            return (mom, weight.astype("float32"))
        return self.create_state(index, weight)

    def _kwargs(self, index):
        self._update_count(index)
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=_clip(self.clip_gradient))

    def update(self, index, weight, grad, state):
        kw = self._kwargs(index)
        rs = _row_sparse_grad(grad, weight) if self.lazy_update else None
        if rs is _EMPTY_ROWS:
            return                     # no touched row: the lazy no-op
        if rs is not None:
            self._lazy_update(weight, state, rs, kw)
            return
        grad = _dense_grad(grad, weight).data
        lr = kw.pop("lr")
        if state is not None:
            _ops.sgd_mom_update_(weight.data, grad, state.data, lr,
                                 momentum=self.momentum, **kw)
        else:
            _ops.sgd_update_(weight.data, grad, lr, **kw)

    def _lazy_update(self, weight, state, rows, kw):
        """SGD on the touched rows only (unique ids: `index_copy_`)."""
        idx, vals = rows
        w = weight.data
        with torch.no_grad():
            w_rows = w.index_select(0, idx)
            g = _lazy_grad_rows(w_rows, vals, w.dtype, kw["wd"],
                                kw["rescale_grad"], kw["clip_gradient"])
            if state is not None:
                m = state.data
                new_m = self.momentum * m.index_select(0, idx) - \
                    kw["lr"] * g
                w.index_copy_(0, idx, w_rows + new_m)
                m.index_copy_(0, idx, new_m)
            else:
                w.index_copy_(0, idx, w_rows + -kw["lr"] * g)

    @staticmethod
    def _has_master(weight, state):
        """Whether `state` is ``(momentum or None, fp32 master)`` of a
        low-precision weight."""
        return isinstance(state, tuple) and len(state) == 2 and \
            isinstance(state[1], NDArray) and \
            state[1].data.dtype == torch.float32 and \
            weight.data.dtype != torch.float32

    def update_multi(self, indices, weights, grads, states):
        """One multi-tensor update (`ops.optimizer_ops.multi_sgd_update_`)
        per kind of state (momentum or not, fp32 master or not), each
        index counted and given its lr and wd as `update` would; a
        row-sparse gradient takes `update`."""
        from .ndarray.sparse import RowSparseNDArray
        if any(isinstance(g, RowSparseNDArray) for g in grads):
            return super().update_multi(indices, weights, grads, states)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            kw = self._kwargs(i)
            mom, w32 = s if self._has_master(w, s) else (s, None)
            rows = groups.setdefault((mom is not None, w32 is not None), [])
            rows.append((w.data, g.data, None if mom is None else mom.data,
                         None if w32 is None else w32.data, kw["lr"],
                         kw["wd"]))
        for (has_mom, has_master), rows in groups.items():
            ws, gs, moms, w32s, lrs, wds = (list(c) for c in zip(*rows))
            _ops.multi_sgd_update_(ws, gs, lrs, wds,
                                   moms=moms if has_mom else None,
                                   weights32=w32s if has_master else None,
                                   momentum=self.momentum,
                                   rescale_grad=self.rescale_grad,
                                   clip_gradient=_clip(self.clip_gradient))

    def update_multi_precision(self, index, weight, grad, state):
        if self._has_master(weight, state):
            grad = _dense_grad(grad, weight).data
            kw = self._kwargs(index)
            lr = kw.pop("lr")
            mom, w32 = state
            if mom is not None:
                _ops.mp_sgd_mom_update_(weight.data, grad, mom.data,
                                        w32.data, lr,
                                        momentum=self.momentum, **kw)
            else:
                _ops.mp_sgd_update_(weight.data, grad, w32.data, lr, **kw)
        else:
            self.update(index, weight, grad, state)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate
    (reference `optimizer.py Adam`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context,
                         dtype=weight.data.dtype),
                nd.zeros(weight.shape, ctx=weight.context,
                         dtype=weight.data.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        rs = _row_sparse_grad(grad, weight) if self.lazy_update else None
        if rs is _EMPTY_ROWS:
            return                     # no touched row: the lazy no-op
        if rs is not None:
            idx, vals = rs
            w, m, v = weight.data, mean.data, var.data
            with torch.no_grad():
                w_rows = w.index_select(0, idx)
                g = _lazy_grad_rows(w_rows, vals, w.dtype, wd,
                                    self.rescale_grad,
                                    _clip(self.clip_gradient))
                new_m = self.beta1 * m.index_select(0, idx) + \
                    (1 - self.beta1) * g
                new_v = self.beta2 * v.index_select(0, idx) + \
                    (1 - self.beta2) * torch.square(g)
                upd = lr * new_m / (torch.sqrt(new_v) + self.epsilon)
                w.index_copy_(0, idx, w_rows + -upd)
                m.index_copy_(0, idx, new_m)
                v.index_copy_(0, idx, new_v)
            return
        grad = _dense_grad(grad, weight)
        _ops.adam_update_(weight.data, grad.data, mean.data, var.data, lr,
                          beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.epsilon, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=_clip(self.clip_gradient))


def _zeros_like(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=dtype or weight.data.dtype)


def _scaled(opt, grad, weight=None, wd=0.0):
    """grad * rescale_grad (+ wd * weight when `weight` is given, the
    order of the JAX class), clipped to +-clip_gradient when that is
    set: the gradient most of the optimizers below start from."""
    g = grad.data * opt.rescale_grad
    if weight is not None:
        g = g + wd * weight.data
    if opt.clip_gradient:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


@register
class Signum(Optimizer):
    """signSGD with momentum (reference `optimizer.py Signum`): the
    `signum_update` op, or `signsgd_update` without momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        lr = self._get_lr(index)
        if state is not None:
            _ops.signum_update_(weight.data, grad.data, state.data, lr,
                                momentum=self.momentum, wd_lh=self.wd_lh,
                                **kw)
        else:
            _ops.signsgd_update_(weight.data, grad.data, lr, **kw)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (Zheng and Kwok 2017; reference
    `optimizer.py FTML`): states (d, v, z)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = (s.data for s in state)
        w = weight.data
        g = _scaled(self, grad, weight, wd)
        v_new = self.beta2 * v + (1 - self.beta2) * g * g
        d_new = (1 - pow(self.beta1, t)) / lr * (
            (v_new / (1 - pow(self.beta2, t))).sqrt() + self.epsilon)
        sigma = d_new - self.beta1 * d
        z_new = self.beta1 * z + (1 - self.beta1) * g - sigma * w
        d.copy_(d_new)
        v.copy_(v_new)
        z.copy_(z_new)
        w.copy_(-z_new / d_new)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (Zheng et al. 2017; reference `optimizer.py
    DCASGD`): states (momentum or None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _scaled(self, grad)
        mom, previous = state
        w, prev = weight.data, previous.data
        d = g + wd * w + self.lamda * g * g * (w - prev)
        if mom is not None:
            mom.data.mul_(self.momentum).sub_(lr * d)
            delta = mom.data
        else:
            delta = -lr * d
        w.add_(delta)
        prev.copy_(w)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference `optimizer.py NAG`)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _scaled(self, grad)
        w = weight.data
        if state is not None:
            mom = state.data
            mom.mul_(self.momentum).add_(g + wd * w)
            w.sub_(lr * (g + self.momentum * mom + wd * w))
        else:
            w.sub_(lr * (g + wd * w))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (Welling and Teh 2011;
    reference `optimizer.py SGLD`): half an SGD step plus N(0, lr) noise
    drawn on the weight's device."""

    draws_rng = True

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _scaled(self, grad)
        noise = nd.random.normal(0, lr ** 0.5, shape=weight.shape,
                                 dtype="float32", ctx=weight.context).data
        w = weight.data
        w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class AdaGrad(Optimizer):
    """AdaGrad (Duchi et al. 2011; reference `optimizer.py AdaGrad`)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        g = _scaled(self, grad) + wd * w
        hist = state.data
        hist.add_(g * g)
        w.sub_(lr * g / (hist + self.float_stable_eps).sqrt())


@register
class AdaDelta(Optimizer):
    """AdaDelta (Zeiler 2012; reference `optimizer.py AdaDelta`): no
    learning rate; states (E[g^2], E[delta^2])."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = _scaled(self, grad)
        acc_g, acc_delta = (s.data for s in state)
        acc_g.mul_(self.rho).add_((1 - self.rho) * g * g)
        delta = ((acc_delta + self.epsilon).sqrt() /
                 (acc_g + self.epsilon).sqrt()) * g
        acc_delta.mul_(self.rho).add_((1 - self.rho) * delta * delta)
        w = weight.data
        w.copy_(w - wd * w - delta)


@register
class RMSProp(Optimizer):
    """RMSProp (reference `optimizer.py RMSProp`): the `rmsprop_update`
    op, or `rmspropalex_update` with ``centered``.  ``clip_weights`` is
    accepted and, as in the JAX class, not applied."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight, torch.float32) for _ in range(n))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(wd=self._get_wd(index), rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient),
                  gamma1=self.gamma1, epsilon=self.epsilon)
        lr = self._get_lr(index)
        if not self.centered:
            _ops.rmsprop_update_(weight.data, grad.data, state[0].data, lr,
                                 **kw)
        else:
            n, g, delta = (s.data for s in state)
            _ops.rmspropalex_update_(weight.data, grad.data, n, g, delta, lr,
                                     gamma2=self.gamma2, **kw)


@register
class Ftrl(Optimizer):
    """FTRL-Proximal (reference `optimizer.py Ftrl`): the `ftrl_update`
    op; states (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _ops.ftrl_update_(weight.data, grad.data, z.data, n.data,
                          self._get_lr(index), lamda1=self.lamda1,
                          beta=self.beta, wd=self._get_wd(index),
                          rescale_grad=self.rescale_grad,
                          clip_gradient=_clip(self.clip_gradient))


@register
class Adamax(Optimizer):
    """Adamax, Adam under the infinity norm (Kingma and Ba 2015;
    reference `optimizer.py Adamax`)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        g = _scaled(self, grad, weight, wd)
        m_t, u_t = (s.data for s in state)
        m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
        u_t.copy_(torch.maximum(self.beta2 * u_t, g.abs()))
        w = weight.data
        w.sub_(lr * m_t / u_t)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (Dozat 2016; reference `optimizer.py
    Nadam`).  ``m_schedule`` is the optimizer's, multiplied at every
    update of every parameter, as in the JAX class."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = _scaled(self, grad, weight, wd)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = (s.data for s in state)
        m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
        v_t.mul_(self.beta2).add_((1.0 - self.beta2) * g * g)
        grad_prime = g / (1.0 - self.m_schedule)
        m_t_prime = m_t / (1.0 - m_schedule_next)
        v_t_prime = v_t / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        w = weight.data
        w.sub_(lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD (reference `optimizer.py LBSGD`): as in the JAX
    class, the warmup arguments are accepted and the update is SGD's
    (the warmup belongs to the learning-rate scheduler)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)


@register
class Test(Optimizer):
    """The reference's test optimizer: weight += rescaled grad; the
    state holds the new weight."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.data.add_(grad.data * self.rescale_grad)
        state.data.copy_(weight.data)


create = Optimizer.create_optimizer


class Updater:
    """Applies the optimizer to (index, grad, weight), creating each
    index's state on first sight (reference `optimizer.py:Updater`)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def update_multi(self, indices, grads, weights):
        """The optimizer's `update_multi` over many indices at once."""
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])

    def set_states(self, states):
        states = loads_states(states) if isinstance(
            states, (bytes, bytearray, memoryview)) else states
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


_OOB_MAGIC = b"MXOOB1\n"
_OOB_HDR = struct.Struct("<Q")


def dumps_states(obj, payload=None):
    """`obj` (an updater's (states, optimizer)) as blob parts: a pickle
    whose arrays go out of band, ``MAGIC | u64 n | pickle((lengths,
    stream)) of n bytes | the arrays' bytes``.  `payload`, when it holds
    exactly those bytes back to back (`checkpoint.snapshot.Staged`), is
    the last part itself; else each array's buffer is.  `loads_states`
    reads it, and plain pickles."""
    bufs = []
    stream = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    lengths = [len(r) for r in raws]
    head = pickle.dumps((lengths, stream), protocol=5)
    if payload is not None and _back_to_back(raws, payload):
        raws = [payload]
    return [_OOB_MAGIC, _OOB_HDR.pack(len(head)), head] + raws


def _back_to_back(views, payload):
    """Whether the non-empty `views` lie in `payload` one after another,
    filling it."""
    def addr(v):
        return _np.frombuffer(v, _np.uint8).ctypes.data
    at, end = addr(payload), addr(payload) + len(payload)
    for v in views:
        if len(v):
            if addr(v) != at:
                return False
            at += len(v)
    return at == end


def loads_states(blob):
    """Read a `dumps_states` blob or a plain pickle."""
    if bytes(blob[:len(_OOB_MAGIC)]) != _OOB_MAGIC:
        return pickle.loads(blob)
    view = memoryview(blob)
    at = len(_OOB_MAGIC)
    n = _OOB_HDR.unpack(view[at:at + _OOB_HDR.size])[0]
    at += _OOB_HDR.size
    lengths, stream = pickle.loads(view[at:at + n])
    at += n
    bufs = []
    for length in lengths:
        bufs.append(view[at:at + length])
        at += length
    return pickle.loads(stream, buffers=bufs)


def states_on_ctx(state, ctx):
    """An optimizer state (an NDArray, a tuple of them and Nones, or
    None) on `ctx`."""
    if isinstance(state, (tuple, list)):
        return type(state)(states_on_ctx(s, ctx) for s in state)
    return state.as_in_context(ctx) if state is not None else None


def get_updater(optimizer):
    if not isinstance(optimizer, Optimizer):
        raise MXNetError(f"get_updater: expects an Optimizer, got "
                         f"{type(optimizer).__name__}")
    return Updater(optimizer)
