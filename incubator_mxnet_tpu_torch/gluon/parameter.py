"""Gluon Parameter and ParameterDict (reference
`python/mxnet/gluon/parameter.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/parameter.py`.  A `Parameter`
holds one NDArray per context and, unless ``grad_req`` is ``"null"``, a
gradient array beside each; a shape with a 0 in it is not known yet and
waits for the first forward (deferred initialisation).  `var()` gives
the Variable a Block's symbolic trace uses, carrying the shape, dtype,
``lr_mult`` and ``wd_mult``.

Each data array of a parameter that takes a gradient is an autograd
leaf (``requires_grad``), marked with its gradient array as
`NDArray.attach_grad` marks one: `autograd.backward` writes or adds the
gradient there by ``grad_req``, and `grad()`, `list_grad()` and
`zero_grad()` act on those arrays.  Setting ``grad_req`` re-makes the
leaves; `cast` makes new ones, with gradients, in the new dtype;
`set_data` and the optimizer write into the leaves in place, so a later
`autograd.record()` sees the new values through the same leaves.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, cpu, current_context
from .. import initializer as init_mod
from ..initializer import InitDesc
from ..ndarray.ndarray import NDArray
from .. import ndarray as nd

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A Parameter whose shape is not known yet was read."""


class Parameter:
    """A Block parameter (reference `parameter.py:Parameter`)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None       # list[NDArray], one per context
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        if not differentiable:
            grad_req = "null"
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"Parameter {self.name}: grad_req must be "
                             f"write, add or null, got {req!r}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or not all(
                s1 in (0, s2) for s1, s2 in zip(self._shape, new_shape)):
            raise MXNetError(f"Parameter {self.name}: expected shape "
                             f"{new_shape} is incompatible with given "
                             f"shape {self._shape}")
        self._shape = new_shape

    def _check_initialized(self, ctx=None):
        if self._data is not None:
            if ctx is not None and ctx not in self._ctx_list:
                raise MXNetError(
                    f"Parameter '{self.name}' was not initialized on "
                    f"context {ctx}. It was only initialized on "
                    f"{self._ctx_list}.")
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual "
                "initialization happens during the first forward pass.")
        raise MXNetError(
            f"Parameter '{self.name}' has not been initialized. Initialize "
            "through Block.collect_params(), which includes the "
            "Parameters of nested child Blocks.")

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the parameter on each context of `ctx` (default
        `current_context()`): with `init`, else the parameter's own
        ``init``, else `default_init`.  An unknown shape defers it to
        the first forward when ``allow_deferred_init``."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = self.init
        self._deferred_init = (init, ctx, default_init, None)
        if self._shape is None or any(s == 0 for s in self._shape):
            if self.allow_deferred_init:
                return
            self._deferred_init = ()
            raise MXNetError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self._shape}.")
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        if self._shape is None or not all(s > 0 for s in self._shape):
            raise MXNetError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self._shape}.")
        self._deferred_init = ()
        if data is None:
            data = nd.zeros(self._shape, dtype=self.dtype, ctx=cpu())
            # an initializer given to the parameter (or by name) fills it
            # through `_init_weight`, whatever its name's suffix, as the
            # JAX package's does
            if isinstance(init, init_mod.Initializer):
                init._init_weight(InitDesc(self.name), data)
            elif isinstance(init, str):
                init_mod.create(init)._init_weight(InitDesc(self.name), data)
            elif callable(init):
                init(InitDesc(self.name), data)
            else:
                d = init_mod.create(default_init)
                if isinstance(d, init_mod.Initializer):
                    d._init_weight(InitDesc(self.name), data)
                else:
                    d(InitDesc(self.name), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx_list = list(ctx_list)
        self._data = [NDArray(_tensor_of(data, self.dtype).to(
            c.torch_device, copy=True), ctx=c) for c in self._ctx_list]
        self._init_grad()

    def _init_grad(self):
        """Fresh zero gradient arrays, and each data array re-made as a
        leaf marked with its gradient (no gradient for ``"null"``)."""
        if self.grad_req == "null":
            self._grad = None
            for d in self._data:
                d._mark_variable(None, "null")
            return
        self._grad = [nd.zeros(d.shape, dtype=d.data.dtype, ctx=d.context)
                      for d in self._data]
        for d, g in zip(self._data, self._grad):
            d._mark_variable(g, self.grad_req)

    def _reduce(self):
        """The value averaged over contexts, on the first one's."""
        if len(self._data) == 1:
            return self._data[0]
        acc = sum(d.data.to("cpu", copy=True) for d in self._data)
        return NDArray(acc / len(self._data), ctx=cpu())

    def set_data(self, data):
        """Write `data` (NDArray, tensor or numpy) into every context's
        copy, cast to the parameter's dtype; before a deferred init it
        becomes the initial value."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError(f"Parameter '{self.name}' has not been "
                                 "initialized")
            init, ctx, default_init, _ = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
            return
        src = _tensor_of(data, self._data[0].data.dtype)
        with torch.no_grad():
            for d in self._data:
                d.data.copy_(src)

    def data(self, ctx=None):
        """The NDArray on `ctx` (default: the first context)."""
        self._check_initialized(ctx)
        if ctx is None:
            return self._data[0]
        return self._data[self._ctx_list.index(ctx)]

    def list_data(self):
        """The data array on every context."""
        self._check_initialized()
        return list(self._data)

    def list_ctx(self):
        """The contexts the parameter lives on (those it will, while its
        initialisation is deferred)."""
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise MXNetError(f"Parameter '{self.name}' has not been "
                             "initialized")
        return self._ctx_list

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"'{self.name}' because grad_req='null'")
        self._check_initialized(ctx)
        if ctx is None:
            return self._grad[0]
        return self._grad[self._ctx_list.index(ctx)]

    def list_grad(self):
        """The gradient array on every context."""
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(f"grad_req='null' for Parameter '{self.name}'")
        return list(self._grad)

    def zero_grad(self):
        with torch.no_grad():
            for g in self._grad or ():
                g.data.zero_()

    def var(self):
        """The Variable that stands for this parameter in a trace."""
        from ..symbol import Variable
        if self._var is None:
            self._var = Variable(self.name, shape=self._shape,
                                 dtype=self.dtype, lr_mult=self.lr_mult,
                                 wd_mult=self.wd_mult)
        return self._var

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is None:
            return
        self._data = [d.astype(dtype) for d in self._data]
        self._init_grad()


def _tensor_of(data, dtype):
    """`data` (NDArray, tensor or numpy) as a CPU-or-device tensor of
    `dtype`."""
    import numpy as np
    import torch
    from ..base import torch_dtype
    if isinstance(data, NDArray):
        t = data.data.detach()
    elif isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        t = torch.from_numpy(np.array(data))
    return t.to(torch_dtype(dtype))


class Constant(Parameter):
    """A parameter that is not learned (reference `parameter.py
    Constant`)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value

        class _InitC(init_mod.Initializer):
            def _init_weight(self, _, arr):
                arr._set_data(value)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.data.dtype, init=_InitC())


class ParameterDict:
    """Parameters by full name, with the prefix of the Block that owns
    them (reference `parameter.py ParameterDict`)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        s = "\n".join(repr(v) for v in self.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with `kwargs` if it
        does not exist; an existing one takes the attributes it lacks and
        has its unknown (0) dims filled from ``shape``."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None and len(v) == len(existing):
                param._shape = tuple(a if a != 0 else b
                                     for a, b in zip(existing, v))
        return param

    def get_constant(self, name, value=None):
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'.")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"Cannot update self with other because "
                                 f"they have different Parameters with the "
                                 f"same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter with `init` as the default
        initializer (default `Uniform()`)."""
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def save(self, filename, strip_prefix=""):
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError(f"Prefix '{strip_prefix}' is to be "
                                 f"stripped before saving, but Parameter's "
                                 f"name '{param.name}' does not start "
                                 "with it")
            arg_dict[param.name[len(strip_prefix):]] = param._reduce()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        loaded = {restore_prefix + k: v
                  for k, v in nd.load(filename).items()}
        _load_into(self._params, loaded, f"file '{filename}'", ctx,
                   allow_missing, ignore_extra)


def _load_into(params, loaded, source, ctx, allow_missing, ignore_extra):
    """Write `loaded` ({key: NDArray or array}) into `params` ({key:
    Parameter}), initializing deferred or uninitialized parameters from
    the values on `ctx` (default: their own, else the CPU); `source`
    names where the values came from in errors."""
    if not allow_missing:
        missing = [n for n in params if n not in loaded]
        if missing:
            raise MXNetError(f"Parameter '{missing[0]}' is missing in "
                             f"{source}")
    for name, value in loaded.items():
        if name not in params:
            if not ignore_extra:
                raise MXNetError(f"Parameter '{name}' loaded from {source} "
                                 "is not present in this Block")
            continue
        param = params[name]
        if param._data is None:
            param.shape = value.shape
            if isinstance(ctx, Context):
                ctx = [ctx]
            if param._deferred_init:
                init, pctx, default_init, _ = param._deferred_init
                param._deferred_init = (init, ctx or pctx, default_init,
                                        value)
                param._finish_deferred_init()
            else:
                param._deferred_init = (None, ctx or [cpu()], None, value)
                param._finish_deferred_init()
        else:
            param.set_data(value)
