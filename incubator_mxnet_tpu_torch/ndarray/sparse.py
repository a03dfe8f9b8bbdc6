"""Compressed sparse row arrays (reference `python/mxnet/ndarray/sparse.py`).

The part of `incubator_mxnet_tpu/ndarray/sparse.py` that `io.LibSVMIter`
yields: `CSRNDArray`, a host-resident (data, indices, indptr) triple that
densifies explicitly (`tostype("default")`, `asnumpy`).  The port has no
sparse compute; `data`, `indices` and `indptr` are CPU NDArrays, as the
JAX class's are arrays of its context.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .ndarray import array

__all__ = ["CSRNDArray"]


class CSRNDArray:
    """csr: (data, indices, indptr) 2-D sparse (reference
    `sparse.py:CSRNDArray`)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self._np_data = np.asarray(data)
        self._np_indices = np.asarray(indices, dtype=np.int64)
        self._np_indptr = np.asarray(indptr, dtype=np.int64)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self._np_data.dtype

    @property
    def data(self):
        return array(self._np_data, ctx=cpu(), dtype=self._np_data.dtype)

    @property
    def indices(self):
        return array(self._np_indices, ctx=cpu(), dtype=np.int64)

    @property
    def indptr(self):
        return array(self._np_indptr, ctx=cpu(), dtype=np.int64)

    def asnumpy(self):
        m, n = self.shape
        out = np.zeros((m, n), dtype=self._np_data.dtype)
        rows = np.repeat(np.arange(m), np.diff(self._np_indptr))
        out[rows, self._np_indices] = self._np_data
        return out

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return array(self.asnumpy(), ctx=cpu(), dtype=self.dtype)
        raise MXNetError(f"cannot cast csr to {stype}")

    def __repr__(self):
        return f"<CSRNDArray {self.shape} @cpu(0)>"
