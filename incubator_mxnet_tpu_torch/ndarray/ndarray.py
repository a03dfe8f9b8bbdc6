"""NDArray: an n-dim array bound to a device context.

Minimal PyTorch port of `incubator_mxnet_tpu/ndarray/ndarray.py`: an
`NDArray` wraps one torch tensor on its context's device.  The serving
path returns these; the imperative operator frontends (`nd.<Op>`) and the
autograd tape come with a later slice.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context, cpu

__all__ = ["NDArray", "array"]


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
        """Copy to a host numpy array (bfloat16 widens to float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device), ctx=ctx)

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype)), ctx=self._ctx)

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
