"""The data plane's host-to-device staging ring.

PyTorch port of `auto_shard`, `RingPlacement`, `H2DRing`,
`DevicePrefetchIter` and `stats` from `incubator_mxnet_tpu/io_plane.py`.
Without the ring, `Module.fit` hands each host batch to the executor,
whose ``copy_`` from pageable memory blocks the training thread.  With
it:

* `H2DRing` -- a feeder thread copies each batch (and its cast to the
  bound dtype) into a pinned buffer from `storage.HostStagingPool`,
  copies that to the card on a dedicated copy stream, records an event
  there and waits for it on the feeder thread; only then does the pinned
  buffer go back to the pool.  The device batch is queued (depth
  ``MXNET_IO_PREFETCH``, floor 2).  The consumer pops it, makes its
  stream wait on the event and marks the tensors as used there
  (`record_stream`), so the caching allocator never hands their memory
  to the copy stream while the step still reads it.  A put blocks while
  the queue is full (backpressure); a get on an empty queue is a counted
  stall.  A tensor already on the target device in the target dtype (a
  resident batch) passes through without a copy.
* `DevicePrefetchIter` -- wraps any `DataIter` with the ring; `Module.fit`
  wraps its training iterator (``MXNET_IO_RING``, default on) with the
  fused train step's placement (`fused.FusedTrainStep.ring_placement`).
  Checkpoint capture, seek, quarantine and record ranges delegate to the
  inner iterator, the feeder paused around each.
* `DevicePrefetchLoader` -- the ring over a gluon ``DataLoader`` (any
  iterable of ``(data, label)`` pairs): iteration yields the pairs on
  the card.  `Estimator.fit` wraps its training loader with it when the
  fused gluon step runs and ``MXNET_IO_RING`` is on.
* `auto_shard` -- this process's ``(part_index, num_parts)`` from
  ``DMLC_RANK``/``DMLC_NUM_WORKER`` or an initialized
  `torch.distributed` group.

On a CPU target a host batch of the target dtype passes through (the JAX
ring adopts it zero-copy); a cast is staged, then copied out of the
staging buffer.  Telemetry, as in the JAX package: `stats()` is the
``io`` producer, each transfer an ``io.h2d`` span, and the registry
carries ``io.h2d.batches``/``io.h2d.bytes``, ``io.ring.stalls`` and the
``io.ring.occupancy``/``io.ring.depth`` gauges.
"""
from __future__ import annotations

import collections
import os
import threading
import time
import weakref

import numpy as _np
import torch

from .base import torch_dtype
from .io import DataBatch, DataIter
from .obs import metrics as _obs_metrics
from .obs import trace as _obs_trace
from .ndarray.ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray

__all__ = ["H2DRing", "RingPlacement", "DevicePrefetchIter",
           "DevicePrefetchLoader", "auto_shard", "stats"]


def auto_shard(part_index=None, num_parts=None):
    """This process's input shard as ``(part_index, num_parts)``:
    explicit values win, then ``DMLC_RANK``/``DMLC_NUM_WORKER``, then an
    initialized `torch.distributed` group; one process reads (0, 1)."""
    if num_parts not in (None, 0, "auto"):
        return int(part_index or 0), int(num_parts)
    nw = os.environ.get("DMLC_NUM_WORKER")
    if nw and int(nw) > 1:
        return int(os.environ.get("DMLC_RANK", 0)), int(nw)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


# process-lifetime totals: a ring's counts outlive the ring (fit releases
# its wrapper when it returns)
_STAT_KEYS = ("stalls", "stall_s", "batches", "bytes", "h2d_s",
              "staging_copies", "resident")
_TOTALS = dict.fromkeys(_STAT_KEYS, 0)
_totals_lock = threading.Lock()
_rings = weakref.WeakSet()


def _totals_add(**kw):
    with _totals_lock:
        for k, v in kw.items():
            _TOTALS[k] += v


_registered = []


def _register_producer():
    """Register the ``io`` producer once (a module-level function: the
    registry holds it strongly, and the module never dies)."""
    if not _registered:
        _registered.append(True)
        _obs_metrics.register_producer("io", stats)


def stats():
    """The ``io`` telemetry producer: process-lifetime totals (stalls, batches, bytes, h2d seconds,
    staging copies, resident pass-throughs) plus the live rings' count,
    depth and occupancy."""
    with _totals_lock:
        out = dict(_TOTALS)
    out.update({"rings": 0, "prefetch_depth": 0, "occupancy": 0})
    for ring in list(_rings):
        s = ring.ring_stats()
        out["rings"] += 1
        out["prefetch_depth"] = max(out["prefetch_depth"], s["depth"])
        out["occupancy"] += s["occupancy"]
    if out["h2d_s"] > 0:
        out["h2d_MBps"] = out["bytes"] / out["h2d_s"] / 1e6
    return out


class RingPlacement:
    """Where the ring's batches land: a context, and per input the dtype
    to cast to (None keeps the input's own: labels, which the executor
    reads as they come)."""

    def __init__(self, ctx=None, dtypes=None):
        if ctx is None:
            from .context import current_context
            ctx = current_context()
        self.ctx = ctx
        self.device = ctx.torch_device
        self.dtypes = list(dtypes) if dtypes is not None else None

    @classmethod
    def for_fused_step(cls, fs):
        """The fused train step's inputs: its executor's context and, per
        input, the bound argument's dtype (labels uncast)."""
        exe = fs._exec
        dtypes = [None if n in fs._label_names else
                  exe.arg_dict[n].data.dtype for n in fs._input_names]
        return cls(ctx=exe._ctx, dtypes=dtypes)

    def target_dtype(self, i, t):
        if self.dtypes is None or i >= len(self.dtypes) or \
                self.dtypes[i] is None:
            return t.dtype
        return torch_dtype(self.dtypes[i])


class _EndOfData:
    """Queue sentinel: the producer exhausted its source (or died with
    `exc`)."""

    __slots__ = ("exc",)

    def __init__(self, exc=None):
        self.exc = exc


def _as_tensor(v):
    if isinstance(v, NDArray):
        return v.data.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(_np.ascontiguousarray(v))


class H2DRing:
    """Pinned staging, one copy stream, a bounded queue of device
    batches.  `put` runs on the feeder thread, `get` on the consumer's;
    see the module docstring."""

    def __init__(self, placement, depth=None, staging=None, name="ring",
                 pool=None):
        from . import config as _config
        from . import storage as _storage
        if depth is None:
            depth = _config.get("MXNET_IO_PREFETCH")
        self.depth = max(2, int(depth))
        if staging is None:
            staging = _config.get("MXNET_IO_STAGING")
        self._staging = bool(staging)
        self._placement = placement
        self._pool = pool if pool is not None else _storage.default_pool()
        self.name = str(name)
        self._cuda = placement.device.type == "cuda"
        self._stream = None           # the copy stream, made on first put
        self._q = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        # one producer at a time; the token (bumped by every reopen)
        # turns a stale feeder's put/put_end into a no-op
        self._put_lock = threading.Lock()
        self._token = 0
        self._ended = None            # _EndOfData once the source dried
        self._stats = dict.fromkeys(_STAT_KEYS, 0)
        self._stats_lock = threading.Lock()
        _rings.add(self)
        _register_producer()

    # -- producer side -------------------------------------------------------
    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._placement.device)
        return self._stream

    def _transfer(self, arrays):
        """Stage and copy one batch; returns (device tensors, event or
        None, bytes copied, staging copies, resident inputs)."""
        device = self._placement.device
        outs, raws, host, sparse = [None] * len(arrays), [], [], []
        nbytes = copies = resident = 0
        for j, a in enumerate(arrays):
            if isinstance(a, BaseSparseNDArray):
                # its parts cross (nnz-sized), and it is densified on the
                # device, in the copy stream
                parts = {}
                for key, t in a._parts.items():
                    if t.device.type == "cpu" and self._staging and \
                            self._cuda:
                        buf, raw = self._pool.acquire(t.shape, t.dtype)
                        buf.copy_(t)
                        raws.append(raw)
                        copies += 1
                        t = buf
                    parts[key] = t
                    nbytes += t.nbytes
                sparse.append((j, a._with_parts(parts, a.context)))
                continue
            t = _as_tensor(a)
            tgt = self._placement.target_dtype(j, t)
            if t.device == device and t.dtype == tgt:
                outs[j] = t               # already there: no copy
                resident += 1
                continue
            if t.device.type != "cpu":    # another device: one copy
                outs[j] = t.to(device, tgt)
                nbytes += outs[j].nbytes
                continue
            if self._staging:
                buf, raw = self._pool.acquire(t.shape, tgt)
                buf.copy_(t)              # the cast happens here, once
                raws.append(raw)
                copies += 1
            else:
                buf = t.to(tgt)
            host.append((j, buf))
            nbytes += buf.nbytes
        event = None
        try:
            if self._cuda and (host or sparse):
                stream = self._copy_stream()
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    for j, buf in host:
                        outs[j] = buf.to(device, non_blocking=True)
                    for j, sp in sparse:
                        outs[j] = sp._dense_on(
                            device, self._placement.target_dtype(
                                j, sp._parts["data"]), non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                # a pinned buffer is refilled only after its copy is done
                event.synchronize()
            else:
                for j, buf in host:
                    outs[j] = buf.clone() if self._staging else buf
                for j, sp in sparse:
                    outs[j] = sp._dense_on(device, self._placement
                                           .target_dtype(j, sp._parts["data"]))
        finally:
            for raw in raws:
                self._pool.release(raw)
        return outs, event, nbytes, copies, resident

    def put(self, arrays, meta=None, token=None):
        """Stage and copy one batch (feeder thread).  Blocks while the
        queue is full.  Returns False when the ring was closed under the
        wait, or when `token` is not the ring's (a stale feeder)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._closed or token not in (None, self._token)
                or len(self._q) < self.depth)
            if self._closed or token not in (None, self._token):
                return False
        with self._put_lock:
            t0 = time.perf_counter()
            with _obs_trace.span("io.h2d", cat="io", ring=self.name) as sp:
                outs, event, nbytes, copies, resident = \
                    self._transfer(arrays)
                sp.note(bytes=nbytes)
            dt = time.perf_counter() - t0
        counts = dict(batches=1, bytes=nbytes, h2d_s=dt,
                      staging_copies=copies, resident=resident)
        with self._stats_lock:
            for k, v in counts.items():
                self._stats[k] += v
        _totals_add(**counts)
        _obs_metrics.counter("io.h2d.batches").inc()
        _obs_metrics.counter("io.h2d.bytes").inc(nbytes)
        with self._cond:
            if self._closed or token not in (None, self._token):
                return False
            self._q.append((outs, event, meta))
            _obs_metrics.gauge("io.ring.occupancy").set(len(self._q))
            self._cond.notify_all()
        return True

    def put_end(self, exc=None, token=None):
        """Mark the source exhausted (or broken): `get` drains the queue,
        then raises StopIteration (or `exc`)."""
        with self._cond:
            if token not in (None, self._token):
                return
            self._q.append(_EndOfData(exc))
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------
    def get(self):
        """The oldest device batch as ``(tensors, meta)``, ordered after
        its copy on the current stream; StopIteration at the end, and on
        every call after it.  A wait on an empty queue is a stall."""
        t0 = None
        with self._cond:
            if not self._q and self._ended is not None:
                if self._ended.exc is not None:
                    raise self._ended.exc
                raise StopIteration
            if not self._q:
                t0 = time.perf_counter()
            self._cond.wait_for(lambda: self._q or self._closed)
            if not self._q and self._closed:
                raise StopIteration
            item = self._q.popleft()
            if isinstance(item, _EndOfData):
                self._ended = item
            _obs_metrics.gauge("io.ring.occupancy").set(len(self._q))
            self._cond.notify_all()
        if isinstance(item, _EndOfData):
            if item.exc is not None:
                raise item.exc
            raise StopIteration
        if t0 is not None:
            dt = time.perf_counter() - t0
            with self._stats_lock:
                self._stats["stalls"] += 1
                self._stats["stall_s"] += dt
            _totals_add(stalls=1, stall_s=dt)
            _obs_metrics.counter("io.ring.stalls").inc()
        outs, event, meta = item
        if event is not None:
            stream = torch.cuda.current_stream(self._placement.device)
            stream.wait_event(event)
            for t in outs:
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return outs, meta

    def reopen(self):
        """A fresh epoch: clear the queue and return the new producer
        token (a previous feeder's token is dead)."""
        with self._cond:
            self._closed = False
            self._ended = None
            self._q.clear()
            self._token += 1
            self._cond.notify_all()
            return self._token

    def close(self):
        with self._cond:
            self._closed = True
            self._q.clear()
            self._cond.notify_all()

    def ring_stats(self):
        with self._stats_lock:
            s = dict(self._stats)
        with self._cond:
            s["occupancy"] = sum(1 for it in self._q
                                 if not isinstance(it, _EndOfData))
        s["depth"] = self.depth
        return s


def _resolve_placement(placement):
    """A RingPlacement, a callable returning one (the fused step may be
    rebuilt before the first batch), or None (the current context, no
    cast)."""
    if callable(placement) and not isinstance(placement, RingPlacement):
        placement = placement()
    return placement if placement is not None else RingPlacement()


class DevicePrefetchIter(DataIter):
    """Wrap a `DataIter` with the staging ring: an ``mx-io-h2d`` feeder
    thread pulls batches from the inner iterator and stages them through
    `H2DRing`; `next()` pops device batches.

    `seek`, `checkpoint_state`, `set_checkpoint_state`, `record_range`,
    `set_quarantine` and `apply_quarantine` go to the inner iterator,
    with the feeder paused around every call that moves it; read-ahead
    never leaks into a checkpoint (resume positions by `seek`)."""

    def __init__(self, data_iter, placement=None, depth=None,
                 staging=None, name="io"):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._inner = data_iter
        self._placement_src = placement
        self._depth = depth
        self._staging_req = staging
        self._ring = None
        self._thread = None
        self._stop = threading.Event()
        self._inner_lock = threading.Lock()
        self._name = name
        self._started = False
        self._cached = None   # iter_next()'s buffered batch

    # -- delegation ----------------------------------------------------------
    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def record_range(self, nbatch):
        return self._inner.record_range(nbatch)

    def checkpoint_state(self):
        with self._inner_lock:
            return self._inner.checkpoint_state()

    def set_checkpoint_state(self, state, nbatch=0):
        self._pause()
        self._inner.set_checkpoint_state(state, nbatch)
        self._start()

    def seek(self, nbatch):
        self._pause()
        self._inner.seek(nbatch)
        self._start()

    def set_quarantine(self, log):
        if hasattr(self._inner, "set_quarantine"):
            self._inner.set_quarantine(log)

    def apply_quarantine(self, entries):
        if hasattr(self._inner, "apply_quarantine"):
            self._pause()
            self._inner.apply_quarantine(entries)
            self._start()

    # -- the feeder thread ---------------------------------------------------
    def _feed(self, ring, stop, token):
        """One epoch's producer.  Every failure (the inner iterator, the
        staging, the copy) lands in the ring as an end event, so the
        consumer raises instead of waiting on a dead feeder."""
        try:
            while not stop.is_set():
                try:
                    with self._inner_lock:
                        batch = self._inner.next()
                except StopIteration:
                    ring.put_end(token=token)
                    return
                arrays = list(batch.data) + list(batch.label or [])
                meta = (len(batch.data), batch.pad, batch.index,
                        batch.bucket_key)
                if not ring.put(arrays, meta, token=token):
                    return               # closed or restarted under us
        except Exception as e:   # noqa: BLE001 - re-raised by get()
            ring.put_end(e, token=token)

    def _start(self):
        if self._ring is None:
            self._ring = H2DRing(_resolve_placement(self._placement_src),
                                 depth=self._depth,
                                 staging=self._staging_req, name=self._name)
            _obs_metrics.gauge("io.ring.depth").set(self._ring.depth)
        token = self._ring.reopen()
        self._stop = threading.Event()   # per start: never shared with a
        self._cached = None              # feeder that outlived its join
        self._thread = threading.Thread(
            target=self._feed, args=(self._ring, self._stop, token),
            daemon=True, name="mx-io-h2d")
        self._thread.start()
        self._started = True

    def _pause(self):
        """Stop the feeder and drop the read-ahead (the inner iterator
        is about to move)."""
        if self._thread is None:
            self._started = False
            return
        self._stop.set()
        self._ring.close()
        self._thread.join(timeout=30)
        self._thread = None
        self._started = False

    # -- DataIter surface ----------------------------------------------------
    def reset(self):
        self._pause()
        self._inner.reset()
        self._start()

    def next(self):
        if self._cached is not None:
            cached, self._cached = self._cached, None
            return cached
        if not self._started:
            self._start()
        outs, meta = self._ring.get()
        n_data, pad, index, bucket_key = meta
        ctx = self._ring._placement.ctx
        nds = [NDArray(t, ctx=ctx) for t in outs]
        return DataBatch(data=nds[:n_data], label=nds[n_data:] or None,
                         pad=pad, index=index, bucket_key=bucket_key,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        """Buffer the fetched batch so the paired `next()` returns it."""
        if self._cached is not None:
            return True
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            return False

    def close(self):
        self._pause()
        if self._ring is not None:
            self._ring.close()
        if hasattr(self._inner, "close"):
            self._inner.close()

    def ring_stats(self):
        return self._ring.ring_stats() if self._ring is not None else {}

    def __del__(self):
        try:
            self._pause()
        except Exception:   # noqa: BLE001 - interpreter shutdown
            pass


class DevicePrefetchLoader:
    """The staging ring over a gluon ``DataLoader`` (or any iterable of
    tuples of arrays): iterating yields each tuple as NDArrays on `ctx`
    (default `current_context()`), staged and copied by an ``mx-io-h2d``
    feeder thread with `depth` batches of read-ahead; dtypes are kept.
    A loader error reaches the consumer at its batch.  Closing the
    iteration (or `close`) stops the feeder, which closes the loader's
    iterator, so a threaded loader's workers leave too."""

    def __init__(self, loader, ctx=None, depth=None, name="io.gluon"):
        self._loader = loader
        self._ctx = ctx
        self._depth = depth
        self._name = name
        self._ring = None
        self._thread = None
        self._stop = threading.Event()

    def __len__(self):
        return len(self._loader)

    @staticmethod
    def _feed(loader, ring, stop, token):
        it = None
        try:
            it = iter(loader)
            while not stop.is_set():
                try:
                    pair = next(it)
                except StopIteration:
                    ring.put_end(token=token)
                    return
                if not ring.put(list(pair), len(pair), token=token):
                    return               # closed or restarted under us
        except Exception as e:   # noqa: BLE001 - re-raised by get()
            ring.put_end(e, token=token)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _stop_feeder(self, thread=None):
        """Stop the running feeder (only `thread`'s, when given) and
        drop its read-ahead."""
        if self._thread is None or thread not in (None, self._thread):
            return
        self._stop.set()
        self._ring.close()
        self._thread.join(timeout=30)
        self._thread = None

    def close(self):
        self._stop_feeder()

    def ring_stats(self):
        return self._ring.ring_stats() if self._ring is not None else {}

    def __iter__(self):
        self._stop_feeder()
        if self._ring is None:
            self._ring = H2DRing(RingPlacement(self._ctx), depth=self._depth,
                                 name=self._name)
        ring = self._ring
        token = ring.reopen()
        self._stop = threading.Event()   # per start, as DevicePrefetchIter
        thread = self._thread = threading.Thread(
            target=self._feed, args=(self._loader, ring, self._stop, token),
            daemon=True, name="mx-io-h2d")
        thread.start()
        return self._batches(ring, thread)

    def _batches(self, ring, thread):
        ctx = ring._placement.ctx
        try:
            while True:
                try:
                    outs, _ = ring.get()
                except StopIteration:
                    return
                yield tuple(NDArray(t, ctx=ctx) for t in outs)
        finally:
            self._stop_feeder(thread)

    def __del__(self):
        try:
            self._stop_feeder()
        except Exception:   # noqa: BLE001 - interpreter shutdown
            pass
