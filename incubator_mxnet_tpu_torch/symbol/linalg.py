"""`mx.sym.linalg` (reference `python/mxnet/symbol/linalg.py`): the
``linalg_*`` ops of `ops/linalg_ops.py` by their short names."""
from __future__ import annotations

from .symbol import _sym_apply

_NAMES = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "extracttrian",
          "makediag", "inverse", "det", "slogdet")
__all__ = list(_NAMES)


def _wrap(opname):
    def fn(*args, **kwargs):
        return _sym_apply(opname, list(args), kwargs)
    fn.__name__ = opname[len("linalg_"):]
    return fn


for _name in _NAMES:
    globals()[_name] = _wrap("linalg_" + _name)
