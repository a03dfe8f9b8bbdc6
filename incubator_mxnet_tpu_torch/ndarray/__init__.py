"""NDArray, its creation functions, the optimizer updates and the
`.params` save/load (`mx.nd`)."""
from .ndarray import NDArray, array, zeros, ones, full, concatenate
from .utils import save, load
from ..ops.optimizer_ops import (sgd_update, sgd_mom_update, mp_sgd_update,
                                 mp_sgd_mom_update)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "concatenate",
           "save", "load", "sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update"]
