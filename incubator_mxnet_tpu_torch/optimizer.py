"""Optimizers (reference `python/mxnet/optimizer.py`).

PyTorch port of the `Optimizer` base and registry, `SGD` (with momentum
and ``multi_precision``: fp32 master weights for fp16/bf16 parameters),
`Adam`, `Updater`, `get_updater` and `create` from
`incubator_mxnet_tpu/optimizer.py`.  Given a `ndarray.sparse.
RowSparseNDArray` gradient (an embedding table's), `SGD` and `Adam` run
the JAX package's lazy update (`optimizer.py:204-270`): duplicate row ids
are summed on the host (`aggregate_row_sparse`), then only the touched
rows of the weight and the state are gathered, updated and written back
with `index_copy_` on unique rows; an empty gradient changes nothing.
With ``lazy_update=False`` the gradient densifies and every row updates.  `SGD.update` and
`Adam.update` run the in-place update ops of `ops/optimizer_ops.py`.
`state_dict` / `load_state_dict` carry the scalar position (update
counts, the learning-rate schedule) a checkpoint's manifest records;
`Updater.get_states` pickles the states as host arrays that load on a
machine without the card (`NDArray.__reduce__`), and `dumps_states` /
`loads_states` write and read them with the arrays out of band (the
elastic checkpoint's optimizer blob).  `update_multi` updates many
parameters in one call (what the fused train step runs); `SGD`'s is the
multi-tensor update, which gives the per-parameter results.  The other
optimizers of the JAX package are not ported yet.
"""
from __future__ import annotations

import pickle
import struct

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import ndarray as nd
from .ops.optimizer_ops import multi_sgd_update_

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
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
        grad = _dense_grad(grad, weight)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                              out=weight, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, **kw)

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
            multi_sgd_update_(ws, gs, lrs, wds,
                              moms=moms if has_mom else None,
                              weights32=w32s if has_master else None,
                              momentum=self.momentum,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=_clip(self.clip_gradient))

    def update_multi_precision(self, index, weight, grad, state):
        if self._has_master(weight, state):
            grad = _dense_grad(grad, weight)
            kw = self._kwargs(index)
            mom, w32 = state
            if mom is not None:
                nd.mp_sgd_mom_update(weight, grad, mom, w32,
                                     momentum=self.momentum, out=weight,
                                     **kw)
            else:
                nd.mp_sgd_update(weight, grad, w32, out=weight, **kw)
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
        nd.adam_update(weight, grad, mean, var, lr=lr, wd=wd,
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                       clip_gradient=_clip(self.clip_gradient), out=weight)


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
