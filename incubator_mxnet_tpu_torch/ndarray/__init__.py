"""NDArray, the imperative ``nd.<Op>`` frontends of every registered op,
the creation functions, the optimizer updates, the `.params`
save/load, the image ops of `nd.image` and the sparse arrays of
`nd.sparse` (`mx.nd`)."""
import sys as _sys

from .ndarray import (NDArray, invoke, imperative_invoke, array, zeros, ones,
                      full, empty, arange, eye, linspace, concatenate,
                      moveaxis, waitall, maximum, minimum, add, subtract,
                      multiply, divide, modulo, power)
from .utils import save, load
from . import register as _register

_register.populate(_sys.modules[__name__])
from . import contrib  # noqa: E402
from . import image, linalg, random, sparse  # noqa: E402

__all__ = ["NDArray", "invoke", "imperative_invoke", "array", "zeros",
           "ones", "full", "empty", "arange", "eye", "linspace",
           "concatenate", "moveaxis", "waitall", "maximum", "minimum", "add",
           "subtract", "multiply", "divide", "modulo", "power", "image",
           "linalg", "random", "sparse",
           "save", "load", "sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update"]
