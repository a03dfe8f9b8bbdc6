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
    nout : number of outputs, or callable ``(params) -> int``.
    naux : trailing inputs that are auxiliary states.
    params : dict name -> default (REQUIRED for mandatory params).
    needs_rng : op consumes randomness; the interpreter appends a
        `torch.Generator` (or None) input.
    mode_dependent : op behaves differently in train vs predict mode; the
        interpreter injects boolean param ``_train``.
    input_names : static list or callable(params)->list of input slot
        names; the symbolic frontend auto-creates Variables for trailing
        missing inputs (``fc1_weight``, ``fc1_bias``).
    """

    __slots__ = ("name", "fn", "nin", "nout", "naux", "params", "needs_rng",
                 "mode_dependent", "aliases", "input_names", "doc")

    def __init__(self, name, fn, nin=1, nout=1, naux=0, params=None,
                 needs_rng=False, mode_dependent=False, aliases=(),
                 input_names=None, doc=None):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.nout = nout
        self.naux = naux
        self.params = dict(params or {})
        self.needs_rng = needs_rng
        self.mode_dependent = mode_dependent
        self.aliases = tuple(aliases)
        self.input_names = input_names
        self.doc = doc or (fn.__doc__ if fn else None)

    def canonicalize_params(self, kwargs):
        """Coerce/validate kwargs against the param table; returns plain dict."""
        out = {}
        for k, default in self.params.items():
            if k in kwargs and kwargs[k] is not None:
                out[k] = _hashable(py_literal(kwargs[k]))
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
