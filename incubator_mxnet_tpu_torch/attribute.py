"""AttrScope (reference `python/mxnet/attribute.py`).

PyTorch port of `incubator_mxnet_tpu/attribute.py`: a context manager
that stamps attributes (``ctx_group``, ``lr_mult``, ``wd_mult``, ...) as
``__name__`` onto every Symbol node made inside it, the op nodes, their
auto-created parameter variables and explicit Variables; the innermost
scope wins.  A parameter's ``__lr_mult__`` and ``__wd_mult__`` reach the
optimizer through the symbol's `attr_dict` (`Optimizer._sym_mult`).

    with mx.AttrScope(lr_mult=0.5):
        fc1 = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class AttrScope:
    def __init__(self, **attrs):
        self._attrs = {f"__{k}__" if not k.startswith("__") else k: str(v)
                       for k, v in attrs.items()}

    def get(self, user_attrs=None):
        """The scope's attributes updated by `user_attrs`."""
        merged = dict(self._attrs)
        if user_attrs:
            merged.update(user_attrs)
        return merged

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def current_attrs():
    """The merged attributes of the active scopes (innermost wins)."""
    out = {}
    for scope in _stack():
        out.update(scope._attrs)
    return out
