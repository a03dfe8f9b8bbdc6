"""Host staging buffers (reference `src/storage/pooled_storage_manager.h`).

PyTorch port of `HostStagingPool` in `incubator_mxnet_tpu/storage.py`.
The card's memory is PyTorch's caching allocator's; what the framework
pools is host memory a device tensor is copied into, here the
checkpoint plane's snapshots (`checkpoint/snapshot.py`).  Buffers are
torch ``uint8`` tensors, pinned (page-locked) when a card is present so
a device-to-host copy into them can run asynchronously on the stream
that produced the data.  Sizes round up to the next power of two (the
reference's bucket rounding, the JAX pool's size classes), so a few
classes serve every shape.  The default pool registers its `stats()` as
the ``storage`` telemetry producer, as in the JAX package; its
lock-order instrumentation (`analysis.locks`) is not ported.

`memory_stats` and `device_memory_info` are the counterparts of the JAX
package's PJRT counters: the card's from `torch.cuda.memory_stats` and
`torch.cuda.mem_get_info`, ``{}`` and ``(0, 0)`` for a CPU context.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import torch_dtype

__all__ = ["HostStagingPool", "default_pool", "memory_stats",
           "device_memory_info"]


class HostStagingPool:
    """Size-class pool of host buffers.

    ``acquire(shape, dtype)`` -> ``(tensor, raw)``: a tensor of that shape
    and dtype backed by the pooled buffer `raw`; ``release(raw)`` hands
    the buffer back.  Thread-safe; holds at most `max_bytes` of free
    buffers (a release beyond that lets the buffer go).  ``pin=None``
    pins when a card is present.
    """

    def __init__(self, max_bytes=4 << 30, pin=None):
        self._free = {}                 # rounded nbytes -> [raw tensors]
        self._lock = threading.Lock()
        self._max_bytes = int(max_bytes)
        self._pin = pin
        self._held = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _round(nbytes):
        return 1 << max(12, int(np.ceil(np.log2(max(1, nbytes)))))

    @property
    def pinned(self):
        if self._pin is None:
            self._pin = torch.cuda.is_available()
        return self._pin

    def acquire(self, shape, dtype=torch.float32):
        dtype = torch_dtype(dtype)
        shape = tuple(int(s) for s in shape)
        need = int(np.prod(shape, dtype=np.int64)) * \
            torch.empty((), dtype=dtype).element_size()
        size = self._round(need)
        with self._lock:
            bucket = self._free.get(size)
            raw = bucket.pop() if bucket else None
            if raw is not None:
                self._held -= size
                self.hits += 1
            else:
                self.misses += 1
        if raw is None:
            raw = torch.empty(size, dtype=torch.uint8,
                              pin_memory=self.pinned)
        return raw[:need].view(dtype).view(shape), raw

    def release(self, raw):
        size = raw.numel()
        with self._lock:
            if self._held + size > self._max_bytes:
                return False            # pool full: let it go
            bucket = self._free.setdefault(size, [])
            if any(r is raw for r in bucket):
                return False            # double release: keep one
            bucket.append(raw)
            self._held += size
        return True

    def stats(self):
        with self._lock:
            return {"held_bytes": self._held, "hits": self.hits,
                    "misses": self.misses,
                    "buckets": {k: len(v) for k, v in self._free.items()}}


_default = None
_default_lock = threading.Lock()


def default_pool():
    global _default
    with _default_lock:
        if _default is None:
            _default = HostStagingPool()
            # the staging pool's hit economy under the 'storage' namespace
            from .obs import metrics as _obs_metrics
            _obs_metrics.register_producer("storage", _default.stats)
    return _default


def memory_stats(ctx=None):
    """The device's memory counters (the `gpu_memory_info` role):
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved`` and
    ``bytes_limit`` of a card context (PyTorch's caching allocator and the
    device's capacity); ``{}`` for a CPU context, and where no card is
    present, as the JAX package's CPU backend reports none."""
    from .context import current_context
    ctx = ctx or current_context()
    if ctx.device_type != "gpu" or not torch.cuda.is_available():
        return {}
    dev = ctx.torch_device
    st = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total)}


def device_memory_info(ctx=None):
    """(free, total) bytes, reference `mx.context.gpu_memory_info`; (0, 0)
    when the device reports no capacity figure (a CPU context)."""
    stats = memory_stats(ctx)
    total = stats.get("bytes_limit", 0)
    used = stats.get("bytes_in_use", 0)
    if not total:
        return (0, 0)
    return (max(0, total - used), total)
