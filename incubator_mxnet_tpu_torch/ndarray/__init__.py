"""NDArray and the `.params` save/load (`mx.nd`)."""
from .ndarray import NDArray, array
from .utils import save, load

__all__ = ["NDArray", "array", "save", "load"]
