"""Reference `.params` binary container — reader and writer.

PyTorch-port copy of `incubator_mxnet_tpu/compat/mxnet_params.py`: the
same bytes in both directions, for dense arrays of every reference type
flag (int8, flag 5, is what quantized parameters hold) and for the two
sparse storage types, `row_sparse` (its rows and row ids) and `csr`
(its values, indptr and column indices).  Arrays read land on the CPU.

Byte layout (from `src/ndarray/ndarray.cc`):

file      := u64 0x112 (kMXAPINDArrayListMagic) . u64 reserved=0
           . u64 n . ndarray*n                  (dmlc vector<NDArray>)
           . u64 m . (u64 len . bytes)*m        (dmlc vector<string> names)
ndarray   := u32 0xF993fac9 (NDARRAY_V2_MAGIC, `ndarray.cc:1535`)
           . i32 stype                          (0 dense, 1 row_sparse, 2 csr)
           . [shape storage_shape]              (iff stype sparse)
           . shape                              (logical shape)
           . i32 dev_type . i32 dev_id          (Context::Save, base.h:188)
           . i32 type_flag                      (mshadow TypeFlag)
           . (i32 aux_type . shape aux_shape)*nad
           . raw data bytes                     (storage_shape for sparse)
           . raw aux bytes * nad
shape     := u32 ndim . i64*ndim                (nnvm::Tuple::Save, int64
                                                 since NDARRAY_V1_MAGIC)

Legacy pre-V2 arrays (`ndarray.cc:1603-1648`): the leading u32 is either
NDARRAY_V1_MAGIC (0xF993fac8, shape as above) or the raw ndim itself with
u32 dims (pre-V1); no stype/aux sections.  All little-endian.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9

# mshadow::TypeFlag (mshadow/base.h)
_TYPE_TO_NP = {0: "<f4", 1: "<f8", 2: "<f2", 3: "|u1", 4: "<i4", 5: "|i1",
               6: "<i8"}
_NP_TO_TYPE = {np.dtype(v): k for k, v in _TYPE_TO_NP.items()}

_STYPE_DENSE, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DENSE: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("Invalid NDArray file format (truncated)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def shape(self):
        ndim = self.u32()
        return tuple(struct.unpack(f"<{ndim}q", self.read(8 * ndim)))


def _read_ndarray(r: _Reader):
    magic = r.u32()
    if magic != V2_MAGIC:
        return _read_legacy(r, magic)
    stype = r.i32()
    nad = _NUM_AUX.get(stype)
    if nad is None:
        raise MXNetError(f"Unknown storage type {stype} in .params file")
    sshape = r.shape() if nad > 0 else None
    shape = r.shape()
    if len(shape) == 0:
        return None
    r.i32(); r.i32()                      # context (dev_type, dev_id): unused
    type_flag = r.i32()
    dt = _TYPE_TO_NP.get(type_flag)
    if dt is None:
        raise MXNetError(f"Unsupported dtype flag {type_flag}")
    aux = []
    for _ in range(nad):
        at = r.i32()
        aux.append((_TYPE_TO_NP[at], r.shape()))
    data_shape = sshape if nad else shape
    n = int(np.prod(data_shape)) if data_shape else 1
    data = np.frombuffer(r.read(n * np.dtype(dt).itemsize),
                         dtype=dt).reshape(data_shape)
    aux_arrays = []
    for at, ashape in aux:
        an = int(np.prod(ashape)) if ashape else 1
        aux_arrays.append(np.frombuffer(
            r.read(an * np.dtype(at).itemsize), dtype=at).reshape(ashape))
    if stype == _STYPE_DENSE:
        return data
    return _to_sparse(stype, shape, data, aux_arrays)


def _read_legacy(r: _Reader, magic):
    if magic == V1_MAGIC:
        shape = r.shape()
    else:
        ndim = magic                      # pre-V1: the word IS the ndim
        shape = tuple(struct.unpack(f"<{ndim}I", r.read(4 * ndim)))
    if len(shape) == 0:
        return None
    r.i32(); r.i32()                      # context
    type_flag = r.i32()
    dt = _TYPE_TO_NP.get(type_flag)
    if dt is None:
        raise MXNetError(f"Unsupported dtype flag {type_flag}")
    n = int(np.prod(shape))
    return np.frombuffer(r.read(n * np.dtype(dt).itemsize),
                         dtype=dt).reshape(shape)


def _to_sparse(stype, shape, data, aux_arrays):
    from ..context import cpu
    from ..ndarray import sparse as sp
    data = np.array(data)                 # a writable copy of the buffer
    if stype == _STYPE_ROW_SPARSE:
        return sp.RowSparseNDArray(data, aux_arrays[0].astype("int64"),
                                   shape, ctx=cpu())
    # csr aux order in the container: indptr then indices (`ndarray.cc`
    # kIndPtr=0, kIdx=1 for CSR)
    return sp.CSRNDArray(data, aux_arrays[1].astype("int64"),
                         aux_arrays[0].astype("int64"), shape, ctx=cpu())


def load_params(fname_or_bytes):
    """Read a reference `.params`/`.nd` container -> dict name->NDArray
    (or list when the file carries no names, as `mx.nd.load` does)."""
    if isinstance(fname_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(fname_or_bytes)
    else:
        with open(fname_or_bytes, "rb") as f:
            buf = f.read()
    r = _Reader(buf)
    if r.u64() != LIST_MAGIC:
        raise MXNetError("Invalid NDArray file format (bad list magic)")
    r.u64()                               # reserved
    n = r.u64()
    arrays = [_read_ndarray(r) for _ in range(n)]
    m = r.u64()
    names = [r.read(r.u64()).decode() for _ in range(m)]
    if names and len(names) != len(arrays):
        raise MXNetError("Invalid NDArray file format (name/array mismatch)")

    from ..context import cpu
    from ..ndarray.ndarray import NDArray, array
    # a file's arrays land in host memory; callers move them
    wrapped = [a if a is None or isinstance(a, NDArray) else
               array(a, ctx=cpu(), dtype=a.dtype) for a in arrays]
    if not names:
        return wrapped
    return dict(zip(names, wrapped))


def _shape_bytes(shape):
    return struct.pack("<I", len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape)


def _write_ndarray(out, arr):
    from ..ndarray import sparse as sp
    from ..ndarray.ndarray import NDArray
    if isinstance(arr, sp.RowSparseNDArray):
        data, aux = arr._np_data, [arr._np_indices.astype("<i8")]
        stype, shape = _STYPE_ROW_SPARSE, arr.shape
    elif isinstance(arr, sp.CSRNDArray):
        data = arr._np_data
        aux = [arr._np_indptr.astype("<i8"), arr._np_indices.astype("<i8")]
        stype, shape = _STYPE_CSR, arr.shape
    else:
        data = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
        aux, stype, shape = [], _STYPE_DENSE, data.shape
    dt = np.dtype(data.dtype)
    if dt not in _NP_TO_TYPE:
        # bf16 & friends have no reference type flag: save as f4
        data = data.astype("<f4")
        dt = np.dtype("<f4")
    out.append(struct.pack("<I", V2_MAGIC))
    out.append(struct.pack("<i", stype))
    if stype != _STYPE_DENSE:
        out.append(_shape_bytes(data.shape))
    out.append(_shape_bytes(shape))
    out.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
    out.append(struct.pack("<i", _NP_TO_TYPE[dt]))
    for a in aux:
        out.append(struct.pack("<i", _NP_TO_TYPE[np.dtype(a.dtype)]))
        out.append(_shape_bytes(a.shape))
    out.append(np.ascontiguousarray(data).tobytes())
    for a in aux:
        out.append(np.ascontiguousarray(a).tobytes())


def save_params(fname, data, names=None):
    """Write the reference container.  data: dict name->array or list."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        arrays = list(data)
        names = list(names) if names is not None else []
    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_ndarray(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    blob = b"".join(out)
    if fname is None:
        return blob
    with open(fname, "wb") as f:
        f.write(blob)
    return None
