"""Symbolic API (`mx.sym`)."""
import sys as _sys

from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     graph_eval_fn)
from . import register as _register

_register.populate(_sys.modules[__name__])

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "graph_eval_fn"]
