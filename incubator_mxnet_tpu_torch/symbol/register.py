"""Generate `sym.<Op>` functions from the registry (reference
`python/mxnet/symbol/register.py`)."""
from __future__ import annotations

import types

from ..ops import registry as _reg
from .symbol import Symbol, _sym_apply

# positional order for symbols passed by keyword (sym.op(data=x, weight=w))
_SLOT_ORDER = ["data", "lhs", "rhs", "weight", "bias"]


def _make_function(op, public_name):
    def fn(*args, **kwargs):
        data = []
        for a in args:
            if isinstance(a, Symbol):
                data.append(a)
            elif isinstance(a, (list, tuple)) and all(
                    isinstance(x, Symbol) for x in a):
                data.extend(a)
            else:
                raise TypeError(
                    f"Operator {op.name}: symbolic inputs must be Symbol, "
                    f"got {type(a).__name__}")
        sym_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if isinstance(kwargs[k], Symbol)}
        if sym_kwargs and not data:
            for k in _SLOT_ORDER:
                if k in sym_kwargs:
                    data.append(sym_kwargs.pop(k))
        data.extend(sym_kwargs.values())
        return _sym_apply(op.name, data, kwargs)

    fn.__name__ = public_name
    fn.__doc__ = op.doc or f"Symbolic operator `{op.name}`."
    return fn


def populate(target_module):
    """Attach one frontend per registered op: public names on
    `target_module`, every name on its ``_internal`` namespace."""
    internal = types.ModuleType(target_module.__name__ + "._internal")
    for name in _reg.list_ops():
        f = _make_function(_reg.get(name), name)
        setattr(internal, name, f)
        if not name.startswith("_") and not hasattr(target_module, name):
            setattr(target_module, name, f)
    target_module._internal = internal
