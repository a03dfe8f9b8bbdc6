"""Central operator registry.

PyTorch port of `incubator_mxnet_tpu/ops/registry.py`.  One registry
entry per operator, each a plain function on torch tensors
``fn(params, *tensors) -> tensor | tuple``.  The symbolic interpreter
(`symbol.graph_eval_fn`) calls it eagerly on the bound device; shape
inference calls the same function on ``meta`` tensors.  Op names, param
tables and input names match the JAX package, so symbol JSON written by
either package loads in the other.
"""
from __future__ import annotations

from typing import Optional

from ..base import MXNetError, py_literal

__all__ = ["OpDef", "register", "register_opdef", "get", "maybe_get",
           "list_ops", "REQUIRED"]


class _Required:
    def __repr__(self):
        return "REQUIRED"


REQUIRED = _Required()

_REGISTRY: dict[str, "OpDef"] = {}

# keyword arguments every op accepts besides its param table
_FRONTEND_KEYS = {"name", "out", "ctx", "attr", "__layout__", "lr_mult",
                  "wd_mult"}


class OpDef:
    """A registered operator.

    name : canonical op name (kept from MXNet so symbol JSON interchanges).
    fn : ``fn(params: dict, *tensors) -> tensor | tuple``.
    nin : number of tensor inputs; -1 = variadic.
    variadic_param : the param a variadic op's symbolic and NDArray
        frontends set to the number of inputs (``num_args``), as the
        JAX package's frontends do.
    nout : number of outputs, or callable ``(params) -> int``.
    naux : trailing inputs that are auxiliary states.
    params : dict name -> default (REQUIRED for mandatory params).
    needs_rng : op consumes randomness; the interpreter appends a
        `torch.Generator` (or None) input.
    rate_param : for such an op, the name of a rate parameter: a call
        whose rate is 0 draws nothing (`draws`) and gets None.
    stop_grad : the imperative frontend does not record the op for
        backward (BlockGrad and friends).
    mode_dependent : op behaves differently in train vs predict mode; the
        interpreter injects boolean param ``_train``.
    input_names : static list or callable(params)->list of input slot
        names; the symbolic frontend auto-creates Variables for trailing
        missing inputs (``fc1_weight``, ``fc1_bias``).
    param_types : dict name -> converter applied to a param's value
        after `py_literal` (a control-flow subgraph's JSON stays a
        string even when `py_literal` parsed it).
    """

    __slots__ = ("name", "fn", "nin", "nout", "naux", "params", "needs_rng",
                 "rate_param", "mode_dependent", "stop_grad", "aliases",
                 "input_names", "param_types", "variadic_param", "doc")

    def __init__(self, name, fn, nin=1, nout=1, naux=0, params=None,
                 needs_rng=False, mode_dependent=False, stop_grad=False,
                 aliases=(), input_names=None, param_types=None,
                 variadic_param=None, doc=None, rate_param=None):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.nout = nout
        self.naux = naux
        self.params = dict(params or {})
        self.needs_rng = needs_rng
        self.rate_param = rate_param
        self.mode_dependent = mode_dependent
        self.stop_grad = stop_grad
        self.aliases = tuple(aliases)
        self.input_names = input_names
        self.param_types = dict(param_types or {})
        self.variadic_param = variadic_param
        self.doc = doc or (fn.__doc__ if fn else None)

    def draws(self, params):
        """Whether a call with `params` draws random numbers."""
        if self.rate_param is None:
            return self.needs_rng
        return float(params.get(self.rate_param,
                                self.params.get(self.rate_param))) > 0

    def canonicalize_params(self, kwargs):
        """Coerce/validate kwargs against the param table; returns plain dict."""
        out = {}
        for k, default in self.params.items():
            if k in kwargs and kwargs[k] is not None:
                v = py_literal(kwargs[k])
                conv = self.param_types.get(k)
                out[k] = _hashable(v if conv is None else conv(v))
            elif default is REQUIRED:
                raise MXNetError(
                    f"Operator {self.name}: required parameter '{k}' missing")
            else:
                out[k] = _hashable(default)
        unknown = set(kwargs) - set(self.params) - _FRONTEND_KEYS
        if unknown:
            raise MXNetError(
                f"Operator {self.name}: unknown parameters {sorted(unknown)}")
        return out

    def num_outputs(self, params):
        return self.nout(params) if callable(self.nout) else self.nout

    def num_aux(self, params):
        return self.naux(params) if callable(self.naux) else self.naux

    def list_input_names(self, params):
        if self.input_names is None:
            return None
        if callable(self.input_names):
            return list(self.input_names(params))
        return list(self.input_names)

    def __repr__(self):
        return f"OpDef({self.name})"


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


def register(name, **kwargs):
    """Decorator registering a compute function as operator ``name``."""
    def deco(fn):
        register_opdef(OpDef(name, fn, **kwargs))
        return fn
    return deco


def register_opdef(op):
    """Register an OpDef under its name and aliases; a name may be taken once."""
    for key in (op.name,) + op.aliases:
        if key in _REGISTRY:
            raise MXNetError(f"Operator {key} registered twice")
        _REGISTRY[key] = op
    return op


def get(name) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"Operator {name} is not registered") from None


def maybe_get(name) -> Optional[OpDef]:
    return _REGISTRY.get(name)


def list_ops():
    return sorted(_REGISTRY)
