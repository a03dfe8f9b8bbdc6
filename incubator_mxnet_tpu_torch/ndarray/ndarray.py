"""NDArray: an n-dim array bound to a device context, and `invoke`, the
imperative op dispatch.

PyTorch port of `incubator_mxnet_tpu/ndarray/ndarray.py`: an `NDArray`
wraps one torch tensor on its context's device.  Every operator applied
to NDArrays, the ``nd.<Op>`` frontends (`ndarray.register`) and the
arithmetic operators alike, goes through `invoke` (reference
`Imperative::Invoke`): the op's params are canonicalised once per
distinct call (a dict lookup after that), a mode-dependent op is told
`autograd.is_training()`, the op runs with grad mode on under
`autograd.record()` and under `torch.no_grad` elsewhere, aux outputs
(BatchNorm's moving statistics) are written into the aux input arrays
in place, outside the graph, and the call goes on the autograd tape when
it is recorded.  Nothing in `invoke` infers shapes, builds a symbol or
waits for the device.

`attach_grad` makes the array a leaf that `autograd.backward` writes a
gradient for (`autograd`).

Writes copy: an NDArray never takes over another's tensor, because the
optimizer updates its tensor in place and an alias would carry the
update to a second array (the JAX package's arrays are immutable, so it
may share them).  Basic indexing returns a recorded copy (the JAX
package's functional views).
"""
from __future__ import annotations

import time

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context, cpu
from .. import autograd as _autograd
from .. import engine as _engine
from .. import profiler as _profiler

__all__ = ["NDArray", "invoke", "imperative_invoke", "array", "zeros",
           "ones", "full", "empty", "arange", "concatenate", "waitall"]


def _ctx_of(tensor):
    if tensor.device.type == "cuda":
        return Context("gpu", tensor.device.index or 0)
    return cpu()


def _whole(t):
    """The whole tensor of a DTensor laid out on a mesh of ranks
    (`parallel`), gathered to every rank; any other tensor as it is."""
    if type(t) is not torch.Tensor and hasattr(t, "full_tensor"):
        return t.full_tensor()
    return t


def _unpickle(data, device_type, device_id):
    """An unpickled NDArray (`data`: a numpy array or a CPU tensor) on its
    recorded context, or on the CPU when this machine lacks that card."""
    ctx = Context(device_type, device_id)
    if device_type == "gpu" and not (
            torch.cuda.is_available() and
            device_id < torch.cuda.device_count()):
        ctx = cpu()
    if isinstance(data, _np.ndarray):
        # an out-of-band buffer may be a read-only view of the blob
        data = torch.from_numpy(data if data.flags.writeable
                                else data.copy())
    return NDArray(data.to(ctx.torch_device), ctx=ctx)


class NDArray:
    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data
        self._ctx = ctx if ctx is not None else _ctx_of(data)
        self._grad = None
        self._grad_req = None

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

    @property
    def grad(self):
        """The gradient array `attach_grad` attached, or None."""
        return self._grad

    def asnumpy(self):
        """Copy to a host numpy array (bfloat16 widens to float32); the
        copy never shares memory with the array, which may be written in
        place later."""
        t = _whole(self._data.detach())
        if t.dtype == torch.bfloat16:
            t = t.float()
        out = t.cpu().numpy()
        return out.copy() if t.device.type == "cpu" else out

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asnumpy().item()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    def __reduce__(self):
        # the elements on the host and the context's name: a pickle
        # written on the card (optimizer states, checkpoints) loads where
        # there is no card, on the CPU (`_unpickle`).  A numpy array
        # pickles its elements in one copy; bfloat16, which numpy lacks,
        # goes as a compact CPU tensor
        t = _whole(self._data.detach()).cpu()
        data = t.clone() if t.dtype == torch.bfloat16 else t.numpy()
        return _unpickle, (data, self._ctx.device_type, self._ctx.device_id)

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return _on(self._data.detach(), ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        """The array in `dtype` (a copy even when the dtype is the same,
        unless ``copy=False``)."""
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _apply("Cast", [self], {"dtype": str(dt)[6:]}) \
            if _autograd.is_recording() and self._data.requires_grad \
            else NDArray(self._data.detach().to(dt, copy=True),
                         ctx=self._ctx)

    def copy(self):
        """A new NDArray holding a copy of this one."""
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def copyto(self, other):
        """Copy into `other` (an NDArray of the same shape, written in
        place and keeping its dtype and device) or onto a Context."""
        if isinstance(other, Context):
            return _on(self._data.detach(), other, copy=True)
        if not isinstance(other, NDArray):
            raise MXNetError(f"copyto: target must be NDArray or Context, "
                             f"got {type(other).__name__}")
        other._set_data(self._data)
        return other

    def _set_data(self, value):
        """Overwrite the elements in place with `value` (a tensor, NDArray
        or numpy array of this shape), cast to this array's dtype."""
        if _autograd.is_recording() and self._data.requires_grad:
            raise MXNetError("In-place write to an array that requires grad "
                             "while recording (reference raises the same)")
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
        _engine.wait_to_read(self._data)

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Attach a zero gradient array and make the array a leaf whose
        gradient `autograd.backward` writes there (``"write"``) or adds
        to (``"add"``)."""
        grad = NDArray(torch.zeros_like(self._data, requires_grad=False),
                       ctx=self._ctx)
        self._mark_variable(grad, grad_req)

    def _mark_variable(self, grad, grad_req):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        self._grad = grad if grad_req != "null" else None
        self._grad_req = grad_req
        leaf = self._data.detach()
        if grad_req != "null" and leaf.is_floating_point():
            leaf.requires_grad_()
        self._data = leaf

    def detach(self):
        """The same values outside the graph."""
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """`autograd.backward` of this array (ones as the head gradient
        unless `out_grad`)."""
        _autograd.backward([self], [out_grad], retain_graph=retain_graph,
                           train_mode=train_mode)

    # -- shape ---------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _apply("Reshape", [self], {"shape": tuple(shape),
                                          "reverse": kwargs.get("reverse",
                                                                False)})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    @property
    def T(self):
        return _apply("transpose", [self], {"axes": ()})

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            return _apply("_index_nd", [self, key], {})
        if isinstance(key, list):
            key = _np.asarray(key)
        if isinstance(key, _np.ndarray):
            if key.dtype == _np.bool_:
                raise MXNetError("boolean-mask indexing produces dynamic "
                                 "shapes and is not supported")
            return _apply("_index_nd", [self, array(key, ctx=self._ctx,
                                                    dtype="int64")], {})
        return _apply("_index", [self], {"key": key})

    def __setitem__(self, key, value):
        if _autograd.is_recording() and self._data.requires_grad:
            raise MXNetError("In-place write to an array that requires grad "
                             "while recording (reference raises the same)")
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            self._data[key] = torch.as_tensor(value, dtype=self._data.dtype,
                                              device=self._data.device)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray " \
               f"{'x'.join(map(str, self.shape))} @{self._ctx}>"

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        return _binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binary(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binary(self, other, None, "_rdiv_scalar")

    def __mod__(self, other):
        return _binary(self, other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return _binary(self, other, None, "_rmod_scalar")

    def __pow__(self, other):
        return _binary(self, other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _binary(self, other, None, "_rpower_scalar")

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    def _inplace(self, out):
        self._set_data(out._data)
        return self

    def __neg__(self):
        return _apply("negative", [self], {})

    def __abs__(self):
        return _apply("abs", [self], {})

    def __eq__(self, other):
        return _binary(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return _binary(self, other, "broadcast_not_equal",
                       "_not_equal_scalar")

    def __gt__(self, other):
        return _binary(self, other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return _binary(self, other, "broadcast_greater_equal",
                       "_greater_equal_scalar")

    def __lt__(self, other):
        return _binary(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _binary(self, other, "broadcast_lesser_equal",
                       "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __matmul__(self, other):
        return _apply("dot", [self, other], {})


def _binary(lhs, rhs, tensor_op, scalar_op):
    if isinstance(rhs, NDArray):
        if tensor_op is None:
            return NotImplemented
        return _apply(tensor_op, [lhs, rhs], {})
    if isinstance(rhs, (int, float, bool, _np.generic)):
        return _apply(scalar_op, [lhs], {"scalar": float(rhs)})
    if isinstance(rhs, _np.ndarray) and tensor_op is not None:
        return _apply(tensor_op, [lhs, array(rhs, ctx=lhs.context,
                                             dtype=rhs.dtype)], {})
    return NotImplemented


# ---------------------------------------------------------------------------
# Imperative dispatch
# ---------------------------------------------------------------------------

_PARAMS = {}          # (op, call kwargs) -> (params, ctx keyword)
_PARAMS_MAX = 4096    # bounds calls whose scalars change every time


def _canonical(op, kwargs):
    """(canonical params, ``ctx=`` keyword) of one call, cached by the
    call's keywords."""
    try:
        key = (op, tuple(kwargs.items()))
        hit = _PARAMS.get(key)
    except TypeError:       # an unhashable keyword value: no cache
        key, hit = None, None
    if hit is not None:
        return hit
    kw = dict(kwargs)
    kw.pop("name", None)
    kw.pop("attr", None)
    ctx = kw.pop("ctx", None) if "ctx" not in op.params else kw.get("ctx")
    params = op.canonicalize_params(kw)
    ctx = params.pop("ctx", None) or ctx
    hit = (params, ctx)
    if key is not None:
        if len(_PARAMS) >= _PARAMS_MAX:
            _PARAMS.clear()
        _PARAMS[key] = hit
    return hit


def _apply(op_name, data, kwargs, out=None):
    from ..ops import registry as _reg
    return invoke(_reg.get(op_name), data, kwargs, out=out)


def invoke(op, data, kwargs, out=None):
    """Run the registered op `op` on NDArrays `data` with keyword params
    `kwargs`; one NDArray, or a list for several outputs, on the first
    input's context (the ``ctx`` keyword's, or `current_context()`, for
    an op without inputs).  ``out`` takes the result in place."""
    params, ctx = _canonical(op, kwargs)
    st = _autograd._st()
    if op.mode_dependent:
        params = dict(params)
        params["_train"] = st.training
    tensors = [d._data for d in data]
    if data:
        out_ctx = data[0]._ctx
    else:
        out_ctx = ctx if isinstance(ctx, Context) else current_context()
    if op.needs_rng:
        from .. import random as _random
        tensors.append(_random.generator(out_ctx.torch_device)
                       if op.draws(params) else None)
    graph = st.recording and not op.stop_grad
    record = graph and any(t.requires_grad for t in tensors
                           if isinstance(t, torch.Tensor))
    with torch.set_grad_enabled(graph):
        if _profiler._imperative_active():
            res = _timed_call(op, params, tensors, out_ctx)
        elif _engine.naive():
            res = _engine.run_naive(op.name, lambda: op.fn(
                params, *tensors) if op.nin else op.fn(
                    params, *tensors, device=out_ctx.torch_device),
                {out_ctx.torch_device} | {t.device for t in tensors
                                          if isinstance(t, torch.Tensor)})
        else:
            res = op.fn(params, *tensors) if op.nin else \
                op.fn(params, *tensors, device=out_ctx.torch_device)
    if not isinstance(res, (tuple, list)):
        res = (res,)
    nout = op.num_outputs(params)
    if len(res) > nout:         # aux updates: written in place, unrecorded
        naux = op.num_aux(params)
        with torch.no_grad():
            for a, upd in zip(data[len(data) - naux:], res[nout:]):
                a._data.copy_(upd)
    outputs = [NDArray(t, ctx=out_ctx) for t in res[:nout]]
    if record:
        _autograd._record(data, outputs)
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        if len(outs) != len(outputs):
            raise MXNetError(f"Operator {op.name}: out= expects "
                             f"{len(outputs)} arrays, got {len(outs)}")
        if record:
            raise MXNetError("Assigning to out= arrays is not supported when "
                             "recording with autograd")
        for tgt, o in zip(outs, outputs):
            tgt._set_data(o._data)
        return out
    return outputs[0] if len(outputs) == 1 else outputs


def _timed_call(op, params, tensors, out_ctx):
    """One op call timed for the profiler's per-op table: the card is
    synchronized before the clock is read (launches return before the
    work is done).  Paid only while a profile runs with
    ``profile_imperative``."""
    dev = out_ctx.torch_device
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    if sync is not None:
        sync(dev)
    t0 = time.perf_counter()
    res = op.fn(params, *tensors) if op.nin else \
        op.fn(params, *tensors, device=dev)
    if sync is not None:
        sync(dev)
    _profiler.record_op(op.name, (time.perf_counter() - t0) * 1e6)
    return res


def imperative_invoke(op_name, *data, **kwargs):
    """Invoke by the op's name."""
    out = kwargs.pop("out", None)
    return _apply(op_name, list(data), kwargs, out=out)


# ---------------------------------------------------------------------------
# Creation functions
# ---------------------------------------------------------------------------

def _on(t, ctx, copy=False):
    """An NDArray of tensor `t` on `ctx`; inside `engine.bulk`, a host
    copy that the scope's exit moves in one batched copy."""
    if _engine.bulk_active():
        out = NDArray(t.to("cpu", copy=True), ctx=ctx)
        _engine.stage(out)
        return out
    return NDArray(t.to(ctx.torch_device, copy=copy), ctx=ctx)


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
    return _on(t, ctx)


def _filled(shape, ctx, dtype, value):
    from ..ops import registry as _reg
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, int):
        shape = (shape,)
    params = {"shape": tuple(shape), "dtype": dtype or "float32"}
    name = "_zeros" if value == 0 else "_ones" if value == 1 else "_full"
    if name == "_full":
        params["value"] = value
    if _engine.bulk_active():
        return _on(_reg.get(name).fn(params, device=torch.device("cpu")),
                   ctx)
    return NDArray(_reg.get(name).fn(params, device=ctx.torch_device),
                   ctx=ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    """Zeros of `shape` on `ctx` (default `current_context()`), float32
    unless `dtype` says otherwise (reference `nd.zeros`)."""
    return _filled(shape, ctx, dtype, 0)


empty = zeros


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(shape, ctx, dtype, 1)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return _filled(shape, ctx, dtype, val)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """Evenly spaced values in [start, stop), each repeated `repeat`
    times, float32 unless `dtype` says otherwise (reference
    `nd.arange`)."""
    ctx = ctx if ctx is not None else current_context()
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch.float64)
    if repeat > 1:
        t = t.repeat_interleave(int(repeat))
    return NDArray(t.to(ctx.torch_device, torch_dtype(dtype or "float32")),
                   ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    """An N x M (M = N when 0) array with ones on diagonal `k`."""
    return _apply("_eye", [], {"N": N, "M": M, "k": k,
                               "dtype": dtype or "float32",
                               "ctx": ctx or current_context()})


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    """`num` evenly spaced values from `start` to `stop`."""
    return _apply("_linspace", [], {"start": start, "stop": stop,
                                    "num": num, "endpoint": endpoint,
                                    "dtype": dtype or "float32",
                                    "ctx": ctx or current_context()})


def moveaxis(tensor, source, destination):
    """`tensor` with axis `source` moved to `destination`."""
    axes = list(range(tensor.ndim))
    axes.remove(source % tensor.ndim)
    axes.insert(destination % tensor.ndim, source % tensor.ndim)
    return _apply("transpose", [tensor], {"axes": tuple(axes)})


def _scalar_or_tensor(lhs, rhs, tensor_op, lscalar_op, rscalar_op):
    """The broadcast op of two NDArrays, or the scalar op of one and a
    number on either side (reference `nd.maximum` and friends)."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return _apply(tensor_op, [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return _apply(lscalar_op, [lhs], {"scalar": float(rhs)})
    if isinstance(rhs, NDArray):
        return _apply(rscalar_op, [rhs], {"scalar": float(lhs)})
    raise TypeError("at least one argument must be NDArray")


def maximum(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_maximum",
                             "_maximum_scalar", "_maximum_scalar")


def minimum(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_minimum",
                             "_minimum_scalar", "_minimum_scalar")


def add(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_add", "_plus_scalar",
                             "_plus_scalar")


def subtract(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_sub", "_minus_scalar",
                             "_rminus_scalar")


def multiply(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_mul", "_mul_scalar",
                             "_mul_scalar")


def divide(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_div", "_div_scalar",
                             "_rdiv_scalar")


def modulo(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_mod", "_mod_scalar",
                             "_rmod_scalar")


def power(lhs, rhs):
    return _scalar_or_tensor(lhs, rhs, "broadcast_power", "_power_scalar",
                             "_rpower_scalar")


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along `axis` on the first one's context."""
    if not arrays:
        raise MXNetError("concatenate: no arrays")
    ctx = arrays[0].context
    return NDArray(torch.cat([a.data.to(ctx.torch_device) for a in arrays],
                             dim=axis), ctx=ctx)


waitall = _engine.waitall
