"""`mx.nd.linalg` (reference `python/mxnet/ndarray/linalg.py`): the
``linalg_*`` ops of `ops/linalg_ops.py` by their short names."""
from __future__ import annotations

from .ndarray import invoke
from ..ops import registry as _reg

_NAMES = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "extracttrian",
          "makediag", "inverse", "det", "slogdet")
__all__ = list(_NAMES)


def _wrap(opname):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        return invoke(_reg.get(opname), list(args), kwargs, out=out)
    fn.__name__ = opname[len("linalg_"):]
    return fn


for _name in _NAMES:
    globals()[_name] = _wrap("linalg_" + _name)
