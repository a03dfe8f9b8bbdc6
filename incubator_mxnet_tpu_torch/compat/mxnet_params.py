"""Reference `.params` binary container — reader and writer.

PyTorch-port copy of `incubator_mxnet_tpu/compat/mxnet_params.py`: the
same bytes in both directions.  Dense arrays only: a sparse array in a
file raises until the port carries sparse arrays.

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

_STYPE_DENSE = 0


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
    if stype != _STYPE_DENSE:
        raise MXNetError(f"storage type {stype} in .params file: the port "
                         "reads dense arrays only")
    shape = r.shape()
    if len(shape) == 0:
        return None
    r.i32(); r.i32()                      # context (dev_type, dev_id): unused
    type_flag = r.i32()
    dt = _TYPE_TO_NP.get(type_flag)
    if dt is None:
        raise MXNetError(f"Unsupported dtype flag {type_flag}")
    n = int(np.prod(shape))
    return np.frombuffer(r.read(n * np.dtype(dt).itemsize),
                         dtype=dt).reshape(shape)


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
    from ..ndarray.ndarray import array
    # a file's arrays land in host memory; callers move them
    wrapped = [None if a is None else array(a, ctx=cpu(), dtype=a.dtype)
               for a in arrays]
    if not names:
        return wrapped
    return dict(zip(names, wrapped))


def _shape_bytes(shape):
    return struct.pack("<I", len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape)


def _write_ndarray(out, arr):
    from ..ndarray.ndarray import NDArray
    data = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
    dt = np.dtype(data.dtype)
    if dt not in _NP_TO_TYPE:
        # bf16 & friends have no reference type flag: save as f4
        data = data.astype("<f4")
        dt = np.dtype("<f4")
    out.append(struct.pack("<I", V2_MAGIC))
    out.append(struct.pack("<i", _STYPE_DENSE))
    out.append(_shape_bytes(data.shape))
    out.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
    out.append(struct.pack("<i", _NP_TO_TYPE[dt]))
    out.append(np.ascontiguousarray(data).tobytes())


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
