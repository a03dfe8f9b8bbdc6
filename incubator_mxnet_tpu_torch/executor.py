"""Executor: a bound Symbol run eagerly on one device.

PyTorch port of `incubator_mxnet_tpu/executor.py` (reference
`src/executor/graph_executor.cc`: Bind/SimpleBind, Forward, Backward).
The JAX executor compiles the graph into XLA programs and keeps the vjp
residuals between `forward` and `backward`; here `forward` runs the
graph interpreter (`symbol.graph_eval_fn`) on the bound tensors:

* ``forward(is_train=True)`` with any ``grad_req`` other than ``"null"``
  records the autograd graph from detached leaves of the arguments that
  take a gradient; `backward` consumes it (a ones cotangent for every
  output unless ``out_grads`` says otherwise, as the JAX package's does)
  and releases it.  Ops draw their randomness from one
  `random.generator` per training forward.
* ``forward(is_train=False)`` runs under `torch.no_grad`.

Gradients are written to the bound gradient arrays by ``grad_req``:
``"write"`` overwrites, ``"add"`` accumulates, ``"null"`` skips; aux
updates of a training forward are written back.  Every write copies into
the bound arrays (see `ndarray.ndarray`).
"""
from __future__ import annotations

import torch

from .base import MXNetError, torch_dtype
from .ndarray import sparse as _sparse
from .ndarray.ndarray import NDArray
from .symbol.symbol import check_unique_names, graph_eval_fn

__all__ = ["Executor"]


def _req_dict(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return {n: grad_req.get(n, "null") for n in arg_names}


def _tensor(v):
    if isinstance(v, NDArray):
        return v.data
    if isinstance(v, torch.Tensor):
        return v
    import numpy as np
    return torch.from_numpy(np.ascontiguousarray(v))


class Executor:
    def __init__(self, symbol, ctx, arg_arrays, grad_arrays, grad_req,
                 aux_arrays):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device
        arg_names = symbol.list_arguments()
        self._arg_names = arg_names
        self.arg_arrays = list(arg_arrays)
        self.grad_arrays = list(grad_arrays)
        self.aux_arrays = list(aux_arrays)
        self.arg_dict = dict(zip(arg_names, self.arg_arrays))
        self.grad_dict = dict(zip(arg_names, self.grad_arrays))
        self.aux_dict = dict(zip(symbol.list_auxiliary_states(),
                                 self.aux_arrays))
        self._grad_req = _req_dict(grad_req, arg_names)
        self._wrt = [i for i, n in enumerate(arg_names)
                     if self._grad_req.get(n, "null") != "null"]
        self.outputs = []
        self._fns = {}          # is_train -> graph function
        self._needs_rng = any(not n.is_variable and n.op.draws(n.attrs)
                              for n in symbol._topo())
        self._rng = None        # the generator of the last training forward
        self._recorded = None   # (leaves, outputs) awaiting backward
        self._monitor_callback = None

    def _graph_fn(self, is_train):
        if is_train not in self._fns:
            fn, _, _ = graph_eval_fn(self._symbol, is_train)
            self._fns[is_train] = fn
        return self._fns[is_train]

    # -- API -----------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference `executor.py forward`); ``kwargs``
        name arguments to overwrite first (cast to the bound array's
        dtype and moved to its device; an input of another shape replaces
        the bound one, as in the JAX package)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"Unknown argument {k}")
            tgt = self.arg_dict[k]
            # a sparse input (a LibSVM batch) crosses as its parts and is
            # densified on the device
            t = _sparse.dense_tensor(v, self._device, tgt.data.dtype) \
                if isinstance(v, _sparse.BaseSparseNDArray) else _tensor(v)
            if tuple(t.shape) == tgt.shape:
                tgt._set_data(t)
            else:   # another batch size: the argument takes the new shape
                tgt._data = t.to(self._device, tgt.data.dtype, copy=True)
        self._recorded = None
        if is_train:
            from . import random as _random
            self._rng = _random.generator(self._device) \
                if self._needs_rng else None
        self._run(bool(is_train))
        if self._monitor_callback is not None:
            for name, arr in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, arr)
        return self.outputs

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, array)`` on each output after every
        forward (reference `MXExecutorSetMonitorCallback`)."""
        self._monitor_callback = callback

    def _run(self, is_train):
        fn = self._graph_fn(is_train)
        args = [a.data for a in self.arg_arrays]
        aux = [a.data for a in self.aux_arrays]
        rng = self._rng if is_train else None
        if is_train and self._wrt:
            leaves = []
            for i in self._wrt:
                args[i] = args[i].detach().requires_grad_()
                leaves.append(args[i])
            with torch.enable_grad():
                outs, new_aux = fn(args, aux, rng)
            self._recorded = (leaves, outs)
        else:
            with torch.no_grad():
                outs, new_aux = fn(args, aux, rng)
        if is_train:     # the new aux values, in one multi-tensor copy
            changed = [(a.data, v.detach()) for a, v in
                       zip(self.aux_arrays, new_aux) if v is not a.data]
            if changed:
                with torch.no_grad():
                    torch._foreach_copy_(*(list(c) for c in zip(*changed)))
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (with ``out_grads`` as cotangents, a
        ones tensor for each output left None) into the bound gradient
        arrays; returns them.  Without a recorded training forward, runs
        one first with the last forward's generator (reference
        `graph_executor.cc Backward`)."""
        if not self._wrt:
            return []
        out = []
        for i, g in zip(self._wrt, self._grads(out_grads)):
            tgt = self.grad_arrays[i]
            if tgt is not None:
                if self._grad_req[self._arg_names[i]] == "add":
                    g = tgt.data + g.to(tgt.data.device, tgt.data.dtype)
                tgt._set_data(g)
            out.append(NDArray(g.detach(), ctx=self._ctx))
        return out

    def _grads(self, out_grads=None):
        """The gradients of the arguments that take one (ordered like
        ``_wrt``) from the recorded training forward, which is released;
        a zero tensor for an argument the outputs do not reach."""
        if self._recorded is None:
            self._run(True)
        leaves, outs = self._recorded
        self._recorded = None          # release the graph
        if out_grads is None:
            out_grads = [None] * len(outs)
        elif isinstance(out_grads, NDArray):
            out_grads = [out_grads] + [None] * (len(outs) - 1)
        pairs = [(o, torch.ones_like(o) if g is None
                  else _tensor(g).to(o.device, o.dtype))
                 for o, g in zip(outs, out_grads) if o.requires_grad]
        grads = [None] * len(leaves)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        leaves, [g for _, g in pairs],
                                        allow_unused=True)
        return [torch.zeros_like(leaf) if g is None else g
                for leaf, g in zip(leaves, grads)]

    def forward_backward(self, out_grads=None, **kwargs):
        """One training forward and its backward (the Module step)."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays (reference `executor.py
        copy_params_from`)."""
        for params, table, what in ((arg_params, self.arg_dict, "arguments"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux states")):
            for k, v in params.items():
                if k in table:
                    table[k]._set_data(_tensor(v))
                elif not allow_extra_params:
                    raise MXNetError(f"Found name {k} not in {what}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor over arrays of the shapes ``kwargs`` imply;
        arrays whose shape is unchanged are shared (reference
        `executor.py reshape`)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def fit(old, shape):
            if old is None or tuple(shape) == old.shape:
                return old
            return NDArray(torch.zeros(shape, dtype=old.data.dtype,
                                       device=old.data.device), ctx=old.ctx)

        return Executor(self._symbol, self._ctx,
                        [fit(a, s) for a, s in zip(self.arg_arrays,
                                                   arg_shapes)],
                        [fit(g, s) for g, s in zip(self.grad_arrays,
                                                   arg_shapes)],
                        self._grad_req,
                        [fit(a, s) for a, s in zip(self.aux_arrays,
                                                   aux_shapes)])

    # -- construction --------------------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     shared_exec=None, shared_arg_names=None):
        check_unique_names(symbol)
        arg_names = symbol.list_arguments()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = type_dict or {}
        device = ctx.torch_device
        reqs = _req_dict(grad_req, arg_names)
        shared = set(shared_arg_names or ())

        def make(shape, name, table=None):
            if table is not None and name in table:
                arr = table[name]
                if arr is not None and arr.shape != tuple(shape):
                    raise MXNetError(
                        f"simple_bind: shared array {name} is "
                        f"{arr.shape}, this graph needs {tuple(shape)}")
                return arr
            dt = torch_dtype(type_dict.get(name, "float32"))
            return NDArray(torch.zeros(shape, dtype=dt, device=device),
                           ctx=ctx)

        arg_table = grad_table = aux_table = None
        if shared_exec is not None:
            arg_table = {n: a for n, a in shared_exec.arg_dict.items()
                         if n in shared}
            grad_table = {n: a for n, a in shared_exec.grad_dict.items()
                          if n in shared}
            aux_table = shared_exec.aux_dict
        args = [make(s, n, arg_table) for n, s in zip(arg_names, arg_shapes)]
        grads = [make(s, n, grad_table) if reqs.get(n, "null") != "null"
                 else None for n, s in zip(arg_names, arg_shapes)]
        auxs = [make(s, n, aux_table) for n, s in
                zip(symbol.list_auxiliary_states(), aux_shapes)]
        return Executor(symbol, ctx, args, grads, reqs, auxs)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states):
        check_unique_names(symbol)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def to_list(d, names, what):
            if d is None:
                return [None] * len(names)
            if isinstance(d, dict):
                return [d.get(n) for n in names]
            if len(d) != len(names):
                raise MXNetError(f"Length of {what} does not match number "
                                 f"of {what} names")
            return list(d)

        arg_arrays = to_list(args, arg_names, "arguments")
        missing = [n for n, a in zip(arg_names, arg_arrays) if a is None]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        if args_grad is None:
            grad_req = "null"
        grad_arrays = to_list(args_grad, arg_names, "gradients")
        aux_arrays = to_list(aux_states, aux_names, "aux states")
        if any(a is None for a in aux_arrays):
            raise MXNetError(f"bind: missing aux states {aux_names}")
        return Executor(symbol, ctx, arg_arrays, grad_arrays, grad_req,
                        aux_arrays)
