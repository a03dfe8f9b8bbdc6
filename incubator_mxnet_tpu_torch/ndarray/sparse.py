"""Sparse arrays (reference `python/mxnet/ndarray/sparse.py`).

PyTorch port of `incubator_mxnet_tpu/ndarray/sparse.py`: `CSRNDArray`
(what `io.LibSVMIter` yields) and `RowSparseNDArray` (the gradient of an
embedding table: row ids and their rows), both host-resident numpy
structures that densify explicitly (`tostype("default")`, `asnumpy`), as
the JAX package's are.  `aggregate_row_sparse` sums duplicate row ids in
a stable order, so the lazy optimizer updates (`optimizer.SGD`,
`optimizer.Adam`) scatter unique rows with `index_copy_`, whose result
under duplicates CUDA leaves undefined.  `row_sparse_array`,
`zeros("row_sparse", ...)` and `cast_storage` build them.  The port has
no sparse compute; `data`, `indices` and `indptr` are CPU NDArrays.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .ndarray import array

__all__ = ["CSRNDArray", "RowSparseNDArray", "aggregate_row_sparse",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros"]


def aggregate_row_sparse(indices, values):
    """Sum duplicate row ids: -> (sorted unique ids, summed rows).  The
    sum over each id's rows runs in their order in `values` (the JAX
    package's `np.add.at`), so both packages give the same bits."""
    indices = np.asarray(indices, dtype=np.int64)
    values = np.asarray(values)
    if len(indices) <= 1:
        return indices, values
    uniq, inv = np.unique(indices, return_inverse=True)
    if len(uniq) == len(indices) and np.array_equal(uniq, indices):
        return indices, values
    out = np.zeros((len(uniq),) + values.shape[1:], dtype=values.dtype)
    np.add.at(out, inv, values)
    return uniq, out


class RowSparseNDArray:
    """row_sparse: (indices, rows) over axis 0 of a `shape` array
    (reference `sparse.py:RowSparseNDArray`)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        self._np_data = np.asarray(data)
        self._np_indices = np.asarray(indices, dtype=np.int64)
        self.shape = tuple(shape)
        self._ctx = ctx if ctx is not None else cpu()

    @property
    def context(self):
        return self._ctx

    @property
    def dtype(self):
        return self._np_data.dtype

    @property
    def data(self):
        return array(self._np_data, ctx=cpu(), dtype=self._np_data.dtype)

    @property
    def indices(self):
        return array(self._np_indices, ctx=cpu(), dtype=np.int64)

    def asnumpy(self):
        out = np.zeros(self.shape, dtype=self._np_data.dtype)
        if len(self._np_indices):
            out[self._np_indices] = self._np_data
        return out

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return array(self.asnumpy(), ctx=self._ctx, dtype=self.dtype)
        raise MXNetError(f"cannot cast row_sparse to {stype}")

    def wait_to_read(self):
        pass

    def __repr__(self):
        return f"<RowSparseNDArray {self.shape} @{self._ctx}>"


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


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A `RowSparseNDArray` from ``(data, indices)`` and `shape`, or from
    a dense array (its nonzero rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = (_host(x) for x in arg1)
        return RowSparseNDArray(np.asarray(data, dtype=dtype), indices,
                                shape, ctx)
    dense = np.asarray(_host(arg1), dtype=dtype)
    nz = np.where(np.any(dense.reshape(dense.shape[0], -1) != 0,
                         axis=1))[0]
    return RowSparseNDArray(dense[nz], nz, dense.shape, ctx)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A `CSRNDArray` from ``(data, indices, indptr)`` and `shape`, or
    from a dense 2-D array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = (_host(x) for x in arg1)
        return CSRNDArray(data.astype(dtype) if dtype else data, indices,
                          indptr, shape)
    dense = np.asarray(_host(arg1), dtype=dtype)
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=dense.shape[0]))])
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def cast_storage(arr, stype):
    """Reference `cast_storage.cc`: to "default", "row_sparse" or "csr"."""
    if stype == "default":
        return arr.tostype("default") if isinstance(
            arr, (RowSparseNDArray, CSRNDArray)) else arr
    if stype == "row_sparse":
        return row_sparse_array(arr.asnumpy())
    if stype == "csr":
        return csr_matrix(arr.asnumpy())
    raise MXNetError(f"unknown stype {stype}")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type `stype`."""
    dtype = dtype or "float32"
    if stype == "row_sparse":
        return RowSparseNDArray(np.zeros((0,) + tuple(shape[1:]), dtype),
                                np.zeros((0,), np.int64), shape, ctx)
    if stype == "csr":
        return CSRNDArray(np.zeros((0,), dtype), [], [0] * (shape[0] + 1),
                          shape)
    from .ndarray import zeros as _dense_zeros
    return _dense_zeros(shape, ctx=ctx, dtype=dtype)
