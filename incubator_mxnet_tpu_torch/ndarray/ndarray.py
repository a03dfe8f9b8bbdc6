"""NDArray: an n-dim array bound to a device context.

Minimal PyTorch port of `incubator_mxnet_tpu/ndarray/ndarray.py`: an
`NDArray` wraps one torch tensor on its context's device.  The serving
path returns these; the training path binds them as an executor's
argument, gradient and aux arrays, which the optimizer and initializers
write in place (`_set_data`, `copyto`).  The imperative operator
frontends (`nd.<Op>`) and the autograd tape come with a later slice.

Writes copy: an NDArray never takes over another's tensor, because the
optimizer updates its tensor in place and an alias would carry the
update to a second array (the JAX package's arrays are immutable, so it
may share them).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context, cpu

__all__ = ["NDArray", "array", "zeros", "ones", "full", "concatenate"]


def _ctx_of(tensor):
    if tensor.device.type == "cuda":
        return Context("gpu", tensor.device.index or 0)
    return cpu()


class NDArray:
    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data
        self._ctx = ctx if ctx is not None else _ctx_of(data)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype of the elements; bfloat16, which numpy lacks, is
        reported as the torch dtype."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return _np.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def data(self):
        """The backing torch tensor."""
        return self._data

    def asnumpy(self):
        """Copy to a host numpy array (bfloat16 widens to float32); the
        copy never shares memory with the array, which may be written in
        place later."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out = t.cpu().numpy()
        return out.copy() if t.device.type == "cpu" else out

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device), ctx=ctx)

    def astype(self, dtype):
        """A copy in `dtype` (a copy even when the dtype is the same)."""
        return NDArray(self._data.to(torch_dtype(dtype), copy=True),
                       ctx=self._ctx)

    def copy(self):
        """A new NDArray holding a copy of this one."""
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def copyto(self, other):
        """Copy into `other` (an NDArray of the same shape, written in
        place and keeping its dtype and device) or onto a Context."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), ctx=other)
        if not isinstance(other, NDArray):
            raise MXNetError(f"copyto: target must be NDArray or Context, "
                             f"got {type(other).__name__}")
        other._set_data(self._data)
        return other

    def _set_data(self, value):
        """Overwrite the elements in place with `value` (a tensor, NDArray
        or numpy array of this shape), cast to this array's dtype."""
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(_np.ascontiguousarray(value))
        if tuple(value.shape) != self.shape:
            raise MXNetError(f"cannot write shape {tuple(value.shape)} into "
                             f"an NDArray of shape {self.shape}")
        with torch.no_grad():
            self._data.copy_(value)

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def __getitem__(self, key):
        return NDArray(self._data[key], ctx=self._ctx)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))} @{self._ctx}>"


def array(source, ctx=None, dtype=None):
    """An NDArray holding a copy of `source` (numpy array, NDArray or
    tensor) on `ctx` (default `current_context()`).  As in the reference,
    a source that is not already an array of the framework defaults to
    float32."""
    ctx = ctx if ctx is not None else current_context()
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach().clone()
    else:
        if dtype is None:
            dtype = "float32"
        t = torch.from_numpy(_np.array(source, copy=True))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to(ctx.torch_device), ctx=ctx)


def _filled(shape, ctx, dtype, value):
    from ..ops import registry as _reg
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, int):
        shape = (shape,)
    params = {"shape": tuple(shape), "dtype": dtype or "float32"}
    name = "_zeros" if value == 0 else "_ones" if value == 1 else "_full"
    if name == "_full":
        params["value"] = value
    return NDArray(_reg.get(name).fn(params, device=ctx.torch_device),
                   ctx=ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    """Zeros of `shape` on `ctx` (default `current_context()`), float32
    unless `dtype` says otherwise (reference `nd.zeros`)."""
    return _filled(shape, ctx, dtype, 0)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(shape, ctx, dtype, 1)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return _filled(shape, ctx, dtype, val)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along `axis` on the first one's context."""
    if not arrays:
        raise MXNetError("concatenate: no arrays")
    ctx = arrays[0].context
    return NDArray(torch.cat([a.data.to(ctx.torch_device) for a in arrays],
                             dim=axis), ctx=ctx)
