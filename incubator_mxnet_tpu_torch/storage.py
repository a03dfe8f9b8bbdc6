"""Host staging buffers (reference `src/storage/pooled_storage_manager.h`).

PyTorch port of `HostStagingPool` in `incubator_mxnet_tpu/storage.py`.
The card's memory is PyTorch's caching allocator's; what the framework
pools is host memory a device tensor is copied into, here the
checkpoint plane's snapshots (`checkpoint/snapshot.py`).  Buffers are
torch ``uint8`` tensors, pinned (page-locked) when a card is present so
a device-to-host copy into them can run asynchronously on the stream
that produced the data.  Sizes round up to the next power of two (the
reference's bucket rounding, the JAX pool's size classes), so a few
classes serve every shape.  The JAX pool's lock-order instrumentation
(`analysis.locks`) and its telemetry registration are not ported.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import torch_dtype

__all__ = ["HostStagingPool", "default_pool"]


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
    return _default
