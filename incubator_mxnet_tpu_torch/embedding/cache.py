"""Device-resident hot-row cache for sharded embedding tables.

PyTorch port of `incubator_mxnet_tpu/embedding/cache.py`.  A
recommender's id traffic is power-law: a small hot set covers most
lookups.  The cache pins up to `capacity` rows in ONE ``(capacity, dim)``
buffer on its device and serves hits with one `index_select`: the
steady-state lookup of hot ids never leaves the card and never reaches
the parameter servers.  Misses are pulled from their shards in one batch,
written into LRU-evicted slots with `index_copy_`, then the whole request
gathers.

`index_copy_` is only defined for unique slots on CUDA, so every write
takes one row per slot: an id written twice in one call keeps its last
row, and resident and fresh ids never share a slot.  The JAX cache pads
its id axis to the next power of two so that XLA compiles O(log
capacity) programs; eager torch compiles nothing, so the port drops the
pad (README, "Declared divergences").
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import config as _config
from ..base import torch_dtype
from ..context import current_context

__all__ = ["HotRowCache"]


class HotRowCache:
    """LRU over row ids; one device buffer, batched gather and scatter."""

    def __init__(self, dim, capacity=None, dtype="float32", name="embed",
                 ctx=None):
        if capacity is None:
            capacity = int(_config.get("MXNET_EMBED_CACHE_ROWS"))
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.ctx = ctx if ctx is not None else current_context()
        self._device = self.ctx.torch_device
        self._lock = threading.Lock()
        # id -> slot, most recently used last
        self._slot = OrderedDict()
        self._free = list(range(self.capacity))
        self._buf = None           # (capacity, dim) on the device, lazily
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def stats(self):
        with self._lock:
            total = self.hits + self.misses
            return {"capacity": self.capacity, "rows": len(self._slot),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_rate": self.hits / total if total else 0.0}

    # -- internals ------------------------------------------------------------
    def _ensure_buf(self):
        # under the lock: two first lookups must not each install a
        # buffer, or the rows one writes vanish with the buffer replaced
        with self._lock:
            if self._buf is None:
                self._buf = torch.zeros((self.capacity, self.dim),
                                        dtype=torch_dtype(self.dtype.name),
                                        device=self._device)

    def _take_slots(self, n):
        """n slots, evicting LRU rows as needed (lock held)."""
        slots = []
        while len(slots) < n:
            if self._free:
                slots.append(self._free.pop())
            else:
                _evicted, slot = self._slot.popitem(last=False)
                self.evictions += 1
                slots.append(slot)
        return slots

    def _slots_tensor(self, slots):
        return torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(
            self._device)

    # -- API ------------------------------------------------------------------
    def lookup(self, ids, pull_fn):
        """Rows for ``ids`` (np int array) as ONE device tensor [len, dim]:
        hits gather from the buffer; the unique missing ids go through
        ``pull_fn(miss_ids) -> np [k, dim]``, are written into LRU slots,
        and the whole request gathers.  -> (rows, n_hits, n_misses).
        Under eviction churn from other threads the retry is bounded: the
        batch is then served uncached, straight from ``pull_fn``."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        id_list = ids.tolist()
        uniq = list(dict.fromkeys(id_list))
        # guard on the batch's distinct ids: if they cannot all fit, the
        # insert would evict the batch's own rows and never converge
        if len(uniq) > self.capacity:
            raise ValueError(
                f"hot-row cache capacity {self.capacity} cannot "
                f"hold the {len(uniq)} distinct rows of one "
                "lookup — raise MXNET_EMBED_CACHE_ROWS past the "
                "per-batch distinct id count")
        self._ensure_buf()
        for _attempt in range(8):
            with self._lock:
                miss_occ = [i for i in id_list if i not in self._slot]
                miss = list(dict.fromkeys(miss_occ))
                n_miss = len(miss_occ)
                n_hit = len(ids) - n_miss
                # the batch's resident rows go to the MRU end first, so
                # the miss insert evicts only rows outside the batch
                for i in id_list:
                    if i in self._slot:
                        self._slot.move_to_end(i)
            if miss:
                rows = np.asarray(
                    pull_fn(np.asarray(miss, dtype=np.int64)),
                    dtype=self.dtype)
                self.insert(miss, rows)
            with self._lock:
                if any(i not in self._slot for i in id_list):
                    continue   # another lookup evicted ours: re-pull
                self.hits += n_hit
                self.misses += n_miss
                slots = [self._slot[i] for i in id_list]
                for i in id_list:
                    self._slot.move_to_end(i)
                # gather under the lock: the slots were validated against
                # this buffer state
                return (self._buf.index_select(
                    0, self._slots_tensor(slots)), n_hit, n_miss)
        rows = np.asarray(pull_fn(np.asarray(uniq, dtype=np.int64)),
                          dtype=self.dtype).reshape(len(uniq), self.dim)
        pos = {i: j for j, i in enumerate(uniq)}
        with self._lock:
            self.hits += n_hit
            self.misses += n_miss
        return (torch.from_numpy(rows[[pos[i] for i in id_list]]).to(
            self._device), n_hit, n_miss)

    def insert(self, ids, rows):
        """Pin rows (np [k, dim]) for ids, evicting LRU entries to fit; a
        resident id's row is overwritten in place."""
        ids = [int(i) for i in np.asarray(ids).ravel()]
        rows = np.asarray(rows, dtype=self.dtype).reshape(len(ids),
                                                          self.dim)
        last = {i: j for j, i in enumerate(ids)}     # one row per id
        self._ensure_buf()
        with self._lock:
            fresh = [i for i in last if i not in self._slot]
            resident = [i for i in last if i in self._slot]
            for i, s in zip(fresh, self._take_slots(len(fresh))):
                self._slot[i] = s
            # a resident id the fresh ones evicted gave up its slot
            order = fresh + [i for i in resident if i in self._slot]
            if not order:
                return
            slots = self._slots_tensor([self._slot[i] for i in order])
            src = torch.from_numpy(np.ascontiguousarray(
                rows[[last[i] for i in order]])).to(self._device)
            self._buf.index_copy_(0, slots, src)

    def refresh(self, ids, rows):
        """Overwrite the cached copies of whichever ``ids`` are resident (a
        push's updated rows); other ids are not pinned."""
        ids = np.asarray(ids).ravel()
        rows = np.asarray(rows, dtype=self.dtype).reshape(len(ids),
                                                          self.dim)
        with self._lock:
            at = [j for j, i in enumerate(ids.tolist())
                  if int(i) in self._slot]
        if at:
            self.insert(ids[at], rows[at])

    def invalidate(self, ids):
        """Drop rows whose cached copies are stale."""
        with self._lock:
            for i in np.asarray(ids).ravel().tolist():
                slot = self._slot.pop(int(i), None)
                if slot is not None:
                    self._free.append(slot)
