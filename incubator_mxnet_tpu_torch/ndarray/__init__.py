"""NDArray, the imperative ``nd.<Op>`` frontends of every registered op,
the creation functions, the optimizer updates and the `.params`
save/load (`mx.nd`)."""
import sys as _sys

from .ndarray import (NDArray, invoke, imperative_invoke, array, zeros, ones,
                      full, empty, arange, concatenate, waitall)
from .utils import save, load
from ..ops.optimizer_ops import (sgd_update, sgd_mom_update, mp_sgd_update,
                                 mp_sgd_mom_update, adam_update)
from . import register as _register

_register.populate(_sys.modules[__name__])
from . import contrib  # noqa: E402

__all__ = ["NDArray", "invoke", "imperative_invoke", "array", "zeros",
           "ones", "full", "empty", "arange", "concatenate", "waitall",
           "save", "load", "sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update"]
