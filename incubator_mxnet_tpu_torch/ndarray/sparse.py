"""Sparse arrays (reference `python/mxnet/ndarray/sparse.py`).

PyTorch port of `incubator_mxnet_tpu/ndarray/sparse.py`.
`BaseSparseNDArray` is an `NDArray`, as in the JAX package; its two
storage types keep their parts as torch tensors on their context:

* `CSRNDArray` (``stype`` "csr", what `io.LibSVMIter` yields): ``data``,
  ``indices`` (columns) and ``indptr`` (row offsets) of a 2-D array;
* `RowSparseNDArray` (``stype`` "row_sparse", the gradient of an
  embedding table): ``data`` (rows) and ``indices`` (their row ids).

``data``, ``indices`` and ``indptr`` return NDArrays of the parts, as the
reference's do.  An operator given a sparse array computes on its dense
form, as the JAX package's `_apply_op` does: a sparse array's backing
tensor (``_data``, what `ndarray.invoke` reads) is built on its device
from the parts, so a dense input pays nothing for the check.
`dense_tensor` builds that form on another device: the parts cross
(nnz-sized traffic) and the array is densified there (`Executor.forward`,
the fused step and the staging ring feed a CSR batch so).

`dot` multiplies a CSR array and a dense one through torch's sparse CSR
product (cuSPARSE on the card) without densifying; any other sparse
operand densifies first, as the JAX package's `dot` does for all of
them.  `aggregate_row_sparse` sums duplicate row ids in a stable order,
so the lazy optimizer updates (`optimizer.SGD`, `optimizer.Adam`)
scatter unique rows with `index_copy_`, whose result under duplicates
CUDA leaves undefined.

The constructors, `row_sparse_array`, `csr_matrix` and `zeros` build on
the CPU unless given a context (or tensors on a device), as the port's
readers and iterators hand out host arrays.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, cpu
from .ndarray import NDArray, _ctx_of

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "aggregate_row_sparse", "row_sparse_array", "csr_matrix",
           "cast_storage", "zeros", "dot", "dense_tensor"]


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


def _part(x, device, dtype=None):
    """One part (numpy array, tensor or NDArray) as a tensor on
    `device`."""
    if isinstance(x, NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device, dtype) if dtype is not None else x.to(device)


def _host_np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _resolve_ctx(ctx, first):
    if ctx is not None:
        return ctx
    if isinstance(first, NDArray):
        return first.context
    if isinstance(first, torch.Tensor):
        return _ctx_of(first)
    return cpu()


class BaseSparseNDArray(NDArray):
    """An NDArray stored as parts (reference `sparse.py:BaseSparseNDArray`).
    Subclasses set ``_parts`` (name -> tensor on ``_ctx``) and
    ``_shape``, and build the dense form with `_dense_on`."""

    stype = "default"

    @property
    def _data(self):
        # what an operator reads: the dense form, built on the device
        return self._dense_on(self._ctx.torch_device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        t = self._parts["data"]
        if t.dtype == torch.bfloat16:
            return torch.bfloat16
        return np.dtype(str(t.dtype).replace("torch.", ""))

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def data(self):
        """The stored values, a new NDArray on the array's context."""
        return NDArray(self._parts["data"].clone(), ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._parts["indices"].clone(), ctx=self._ctx)

    @property
    def _np_data(self):
        return _host_np(self._parts["data"])

    @property
    def _np_indices(self):
        return _host_np(self._parts["indices"])

    def _dense_on(self, device, dtype=None, non_blocking=False):
        """The dense form, built on `device` (the parts copied there)."""
        raise NotImplementedError

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return NDArray(self._data, ctx=self._ctx)
        raise MXNetError(f"cannot cast {self.stype} to {stype}")

    def asnumpy(self):
        return _host_np(self._dense_on(torch.device("cpu")))

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return self._with_parts(
            {k: v.to(ctx.torch_device) for k, v in self._parts.items()},
            ctx)

    as_in_ctx = as_in_context

    def copy(self):
        return self._with_parts(
            {k: v.clone() for k, v in self._parts.items()}, self._ctx)

    def copyto(self, other):
        if isinstance(other, Context):
            return self.copy().as_in_context(other)
        return super().copyto(other)

    def _set_data(self, value):
        raise MXNetError(f"cannot write into a {self.stype} array in "
                         "place")

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError(f"a {self.stype} array cannot take a gradient")

    def detach(self):
        return self

    def wait_to_read(self):
        pass

    def __reduce__(self):
        parts = {k: _host_np(v) for k, v in self._parts.items()}
        return _unpickle_sparse, (type(self).__name__, parts, self._shape,
                                  self._ctx.device_type, self._ctx.device_id)

    def __repr__(self):
        return f"<{type(self).__name__} " \
               f"{'x'.join(map(str, self._shape))} @{self._ctx}>"


def _unpickle_sparse(cls_name, parts, shape, device_type, device_id):
    ctx = Context(device_type, device_id)
    if device_type == "gpu" and not (torch.cuda.is_available() and
                                     device_id < torch.cuda.device_count()):
        ctx = cpu()
    cls = {"CSRNDArray": CSRNDArray,
           "RowSparseNDArray": RowSparseNDArray}[cls_name]
    return cls._from_parts(parts, shape, ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: (indices, rows) over axis 0 of a `shape` array
    (reference `sparse.py:RowSparseNDArray`)."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        ctx = _resolve_ctx(ctx, data)
        dev = ctx.torch_device
        self._ctx = ctx
        self._grad = None
        self._grad_req = None
        self._shape = tuple(int(d) for d in shape)
        self._parts = {"data": _part(data, dev),
                       "indices": _part(indices, dev, torch.int64)}

    @classmethod
    def _from_parts(cls, parts, shape, ctx):
        return cls(parts["data"], parts["indices"], shape, ctx)

    def _with_parts(self, parts, ctx):
        return RowSparseNDArray(parts["data"], parts["indices"],
                                self._shape, ctx)

    def _set_rows(self, rows, ids):
        """Hold `rows` at row ids `ids` (`KVStore.row_sparse_pull`)."""
        dev = self._ctx.torch_device
        self._parts = {"data": _part(rows, dev),
                       "indices": _part(ids, dev, torch.int64)}

    def _dense_on(self, device, dtype=None, non_blocking=False):
        data = self._parts["data"].to(device, non_blocking=non_blocking)
        out = torch.zeros(self._shape, dtype=dtype or data.dtype,
                          device=device)
        if data.shape[0]:
            out[self._parts["indices"].to(
                device, non_blocking=non_blocking)] = data.to(out.dtype)
        return out


class CSRNDArray(BaseSparseNDArray):
    """csr: (data, indices, indptr) 2-D sparse (reference
    `sparse.py:CSRNDArray`)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx = _resolve_ctx(ctx, data)
        dev = ctx.torch_device
        self._ctx = ctx
        self._grad = None
        self._grad_req = None
        self._shape = tuple(int(d) for d in shape)
        if len(self._shape) != 2:
            raise MXNetError(f"csr arrays are 2-D, got shape {self._shape}")
        self._parts = {"data": _part(data, dev),
                       "indices": _part(indices, dev, torch.int64),
                       "indptr": _part(indptr, dev, torch.int64)}

    @classmethod
    def _from_parts(cls, parts, shape, ctx):
        return cls(parts["data"], parts["indices"], parts["indptr"], shape,
                   ctx)

    def _with_parts(self, parts, ctx):
        return CSRNDArray(parts["data"], parts["indices"], parts["indptr"],
                          self._shape, ctx)

    @property
    def indptr(self):
        return NDArray(self._parts["indptr"].clone(), ctx=self._ctx)

    @property
    def _np_indptr(self):
        return _host_np(self._parts["indptr"])

    @property
    def nnz(self):
        return int(self._parts["data"].shape[0])

    def _rows_of(self, device, non_blocking=False):
        """The row of every stored value, on `device`."""
        indptr = self._parts["indptr"].to(device, non_blocking=non_blocking)
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=device), indptr.diff(),
            output_size=self.nnz)

    def _dense_on(self, device, dtype=None, non_blocking=False):
        data = self._parts["data"].to(device, non_blocking=non_blocking)
        out = torch.zeros(self._shape, dtype=dtype or data.dtype,
                          device=device)
        if self.nnz:
            out[self._rows_of(device, non_blocking),
                self._parts["indices"].to(device, non_blocking=non_blocking)
                ] = data.to(out.dtype)
        return out

    def _slice_rows(self, start, stop):
        """Rows [start, stop) as a CSRNDArray on the same context."""
        ptr = self._parts["indptr"]
        lo, hi = int(ptr[start]), int(ptr[stop])
        return CSRNDArray(self._parts["data"][lo:hi],
                          self._parts["indices"][lo:hi],
                          ptr[start:stop + 1] - lo,
                          (stop - start, self._shape[1]), self._ctx)

    def _torch_csr(self, device, transpose=False):
        """The array (or its transpose) as a torch sparse CSR tensor on
        `device`."""
        data = self._parts["data"].to(device)
        cols = self._parts["indices"].to(device)
        m, n = self._shape
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta" notices
            if not transpose:
                return torch.sparse_csr_tensor(
                    self._parts["indptr"].to(device), cols, data, (m, n),
                    check_invariants=False)
            coo = torch.sparse_coo_tensor(
                torch.stack([cols, self._rows_of(device)]), data, (n, m),
                check_invariants=False)
            return coo.coalesce().to_sparse_csr()


def dense_tensor(value, device, dtype=None):
    """`value` (a sparse array, an NDArray, a tensor or a numpy array) as
    a dense tensor on `device`, in `dtype` when given; a sparse array
    crosses as its parts and is densified on `device`."""
    if isinstance(value, BaseSparseNDArray):
        return value._dense_on(device, dtype)
    if isinstance(value, NDArray):
        value = value.data
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device, dtype) if dtype is not None else \
        value.to(device)


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
                          indptr, shape, ctx)
    dense = np.asarray(_host(arg1), dtype=dtype)
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=dense.shape[0]))])
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape, ctx)


def cast_storage(arr, stype):
    """Reference `cast_storage.cc`: to "default", "row_sparse" or "csr"."""
    if stype == "default":
        return arr.tostype("default") if isinstance(
            arr, BaseSparseNDArray) else arr
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
        return CSRNDArray(np.zeros((0,), dtype), np.zeros((0,), np.int64),
                          np.zeros(shape[0] + 1, np.int64), shape, ctx)
    from .ndarray import zeros as _dense_zeros
    return _dense_zeros(shape, ctx=ctx, dtype=dtype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``op(lhs) . op(rhs)`` (reference `sparse.py:dot`), op a transpose
    where asked.  A CSR operand beside a dense one stays sparse: its
    parts move to the dense operand's device and the product is torch's
    sparse CSR one; otherwise both densify, as in the JAX package.  The
    result is on the dense operand's context (the lhs's when neither or
    both are dense)."""
    from .ndarray import _apply
    lcsr, rcsr = isinstance(lhs, CSRNDArray), isinstance(rhs, CSRNDArray)
    if lcsr != rcsr and not isinstance(lhs if rcsr else rhs,
                                       BaseSparseNDArray):
        dense = rhs if lcsr else lhs
        ctx = dense.context
        dev = ctx.torch_device
        b = dense.data
        if lcsr:
            # op(A) @ op(B), A sparse
            b = b.t() if transpose_b else b
            out = lhs._torch_csr(dev, transpose_a) @ b.contiguous()
        else:
            # op(A) @ op(B) = (op(B)^T @ op(A)^T)^T, B sparse
            a = lhs.data
            a = a if transpose_a else a.t()
            out = (rhs._torch_csr(dev, not transpose_b)
                   @ a.contiguous()).t().contiguous()
        return NDArray(out, ctx=ctx)
    return _apply("dot", [lhs.tostype("default") if isinstance(
        lhs, BaseSparseNDArray) else lhs, rhs.tostype("default")
        if isinstance(rhs, BaseSparseNDArray) else rhs],
        {"transpose_a": transpose_a, "transpose_b": transpose_b})
