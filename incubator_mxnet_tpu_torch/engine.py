"""Execution-engine semantics over CUDA streams.

PyTorch port of `incubator_mxnet_tpu/engine.py`.  The reference's
dependency engine (`src/engine/threaded_engine.cc`,
`include/mxnet/engine.h:116-315`) provides: (1) async op execution with
sequential consistency per variable, (2) `WaitForVar` / `WaitForAll`
sync points, (3) a serializing `NaiveEngine` debug mode, (4)
bulk-execution fusion.

On the card, CUDA streams give (1): kernels launch asynchronously and a
stream runs them in order.  What remains host-side:

* `waitall()` (reference `MXNDArrayWaitAll`, `mx.nd.waitall`) waits for
  every queued kernel on every card; `wait_to_read` for the queue of the
  array's device;
* ``MXNET_ENGINE_TYPE=NaiveEngine`` synchronizes after every eagerly
  dispatched op (`ndarray.invoke`) and turns its failure into an
  `MXNetError` naming the op (`src/engine/naive_engine.cc:50`), so an
  error surfaces at the op that caused it;
* `bulk(size)` implements the reference's bulk-execution fusion
  (`include/mxnet/engine.h:308-313`) for the host-to-device direction:
  inside a bulk scope, creation ops (`nd.zeros`/`ones`/`full`/`array`
  and copies onto a context, so a `Parameter`'s initial values and
  gradient buffers and an optimizer's fresh states) keep their values
  in host memory, and the outermost scope's exit moves them in ONE
  pinned host-to-device copy per device, then splits that copy into the
  arrays (each array a view of its own bytes of the one device buffer,
  aligned to 256 bytes; on the CPU the copy is a host copy).
  `h2d_copies` counts those copies and `staged_total` the arrays they
  carried.

Plain `threading.Lock`s stand in for the JAX package's `analysis.locks`
(14-analysis).
"""
from __future__ import annotations

import threading
import weakref

import torch

from . import config as _config

__all__ = ["waitall", "wait_to_read", "bulk", "set_bulk_size", "engine_type",
           "bulk_active", "stage", "flush_staged", "naive", "run_naive"]

_lock = threading.Lock()
_ALIGN = 256


def engine_type():
    return _config.get("MXNET_ENGINE_TYPE")


def naive():
    """Whether ``MXNET_ENGINE_TYPE=NaiveEngine`` serializes every op."""
    return engine_type() == "NaiveEngine"


def run_naive(op, fn, devices):
    """NaiveEngine's dispatch of one op: `fn()`, then every card of
    `devices` synchronized; any failure becomes an `MXNetError` naming
    the op."""
    from .base import MXNetError
    try:
        out = fn()
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    except Exception as e:
        raise MXNetError(
            f"NaiveEngine: operator '{op or '<unknown>'}' failed during "
            f"synchronous execution: {e}") from e
    return out


def wait_to_read(tensor):
    """Block until an array's value is ready (reference
    `NDArray::WaitToRead`): the queue of its card."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def waitall():
    """Block until all outstanding work completes on every card
    (reference `Engine::WaitForAll`, `mx.nd.waitall`)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


_bulk_size = 0
_staging_depth = 0  # nesting depth of active bulk() scopes
_staged = []        # weak references to NDArrays whose values wait on the host
h2d_copies = 0      # batched host-to-device copies made by flushes
staged_total = 0    # arrays those copies carried


def set_bulk_size(size):
    """Reference `Engine::set_bulk_size` (`include/mxnet/engine.h:308-313`).
    Host staging is active only inside the `bulk()` context manager (which
    flushes on exit).  Returns the previous value."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, size
    return prev


def bulk_active():
    """True while inside a bulk scope (creation ops should host-stage)."""
    return _staging_depth > 0 and _bulk_size != 0


def stage(nd_obj):
    """Register a host-staged NDArray (its ``_data`` a host tensor, its
    context where it goes) for the next `flush_staged()`."""
    with _lock:
        if not any(r() is nd_obj for r in _staged):
            _staged.append(weakref.ref(nd_obj))


def flush_staged():
    """Move every staged array still alive to its device: per device,
    the arrays' bytes packed into one host buffer (pinned for a card),
    one copy to the device, and each array a view of its bytes there
    (keeping its ``requires_grad``)."""
    global h2d_copies, staged_total
    with _lock:
        arrs = [r() for r in _staged]
        del _staged[:]
    by_dev = {}
    for a in arrs:
        if a is not None:
            by_dev.setdefault(a.context.torch_device, []).append(a)
    for dev, group in by_dev.items():
        offsets, total = [], 0
        for a in group:
            offsets.append(total)
            nbytes = a._data.numel() * a._data.element_size()
            total += -(-nbytes // _ALIGN) * _ALIGN
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        for a, off in zip(group, offsets):
            t = a._data.detach().contiguous()
            n = t.numel() * t.element_size()
            host[off:off + n].copy_(t.reshape(-1).view(torch.uint8))
        on_dev = host.to(dev)
        for a, off in zip(group, offsets):
            t = a._data
            n = t.numel() * t.element_size()
            new = on_dev[off:off + n].view(t.dtype).view(t.shape)
            if t.requires_grad:
                new.requires_grad_()
            a._data = new
        h2d_copies += 1
        staged_total += len(group)


class bulk:
    """Context manager `mx.engine.bulk(size)` (reference
    `python/mxnet/engine.py`): on exit of the outermost scope the staged
    host buffers are flushed to their devices, one copy a device."""

    def __init__(self, size):
        self.size = size
        self._prev = None

    def __enter__(self):
        global _staging_depth
        self._prev = set_bulk_size(self.size)
        _staging_depth += 1

    def __exit__(self, *args):
        global _staging_depth
        set_bulk_size(self._prev)
        _staging_depth -= 1
        if _staging_depth == 0:
            flush_staged()
