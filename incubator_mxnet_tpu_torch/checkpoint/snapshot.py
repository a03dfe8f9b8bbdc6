"""Async snapshot engine.

PyTorch port of `incubator_mxnet_tpu/checkpoint/snapshot.py`.
``snapshot()`` splits a checkpoint into a cheap synchronous phase and a
background phase so the train step keeps running while bytes hit disk:

* **sync phase** (`gather_to_pool`) — every tensor is copied into a
  pooled host buffer (`storage.HostStagingPool`, pinned when a card is
  present).  A tensor on the card is copied with ``non_blocking=True``
  on the current stream, the stream the train step runs on: the
  optimizer updates parameters in place, and stream order puts the copy
  before the next step's update, where a side stream would race it.  A
  CUDA event recorded after the copies marks them landed.
* **background phase** — a single daemon thread waits on that event,
  then serializes the staged buffers into shard files, hashes them,
  writes the manifest, and commits the checkpoint directory with one
  ``os.replace`` rename.  A blob may be a callable: the thread calls it
  after the event, so a blob built from staged buffers (the optimizer's
  states, `module.Module`) is pickled off the train loop too; it
  returns bytes or a list of bytes-like parts.  The tensors of a
  snapshot are packed back to back in one pooled buffer, so the array
  shard's payload is one `write` and one `crc32` (on a helper thread,
  concurrently): each releases the GIL once, and the train loop's
  thread keeps it the rest of the time.

Double-buffering: at most ONE snapshot is in flight.  Submitting a new
one first waits for the previous write to land, and ``flush()`` blocks
until the in-flight write — if any — has committed.  Background failures
are re-raised on the next ``submit``/``flush``.

The shard format is the JAX package's, byte for byte
(`write_array_shard`): an 8-byte header length, the pickled table of
``(name, dtype string, shape, offset, nbytes)`` tuples of plain Python
values, then the raw bytes.  bfloat16 is written under the dtype string
``"bfloat16"``, as the JAX package writes it, and read back as a torch
tensor (numpy has no bfloat16 without `ml_dtypes`); every other array
reads back as numpy.  The ``checkpoint.commit`` fault site fires before
the manifest is written: a ``torn`` clause commits the directory without
it (a checkpoint never resumed from).  The JAX package's lock-order and
thread-sanitizer hooks (`analysis.locks`, `analysis.tsan`) are not
ported.
"""
from __future__ import annotations

import os
import pickle
import shutil
import struct
import threading
import time
import zlib

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .. import storage
from ..resilience import faults as _faults
from . import manifest as _manifest

ARRAYS_SHARD = "arrays.npk"
_PICKLE_PROTO = 4
_HDR = struct.Struct("<Q")

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.uint8: "uint8", torch.int8: "int8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


def _raw(arr):
    """(dtype string, shape, byte view) of a host numpy array or tensor,
    as the JAX package's writer makes them: its `np.ascontiguousarray`
    gives a 0-d array the shape (1,), and each entry's dtype string is a
    string object of its own (the pickle's memo shares equal objects,
    and would change the header's bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        try:
            name = _DTYPE_NAMES[t.dtype].encode().decode()
        except KeyError:
            raise MXNetError(f"checkpoint: cannot write dtype {t.dtype}") \
                from None
        view = memoryview(t.reshape(-1).view(torch.uint8).numpy())
        return name, tuple(int(s) for s in t.shape) or (1,), view
    a = np.ascontiguousarray(arr)
    return str(a.dtype), tuple(a.shape), memoryview(a).cast("B")


def write_array_shard(path, arrays, payload=None):
    """Stream ``{name: host array}`` (numpy arrays or CPU tensors) to one
    shard file: ``[8-byte header length][pickled (name, dtype, shape,
    offset, nbytes) table][raw array bytes...]``.

    Raw buffers go straight to ``file.write`` and ``zlib.crc32``, both
    of which release the GIL on large buffers.  `payload`, when given,
    is the arrays' bytes back to back (`Staged.payload`), written in one
    call.  Returns (bytes, crc32) for the manifest without re-reading
    the file.
    """
    table = []
    views = []
    offset = 0
    for name, arr in arrays.items():
        dtype, shape, view = _raw(arr)
        table.append((name, dtype, shape, offset, len(view)))
        views.append(view)
        offset += len(view)
    if payload is not None and len(payload) == offset:
        views = [payload]
    header = pickle.dumps(table, protocol=_PICKLE_PROTO)
    return write_parts(path, [_HDR.pack(len(header)), header] + views)


def read_array_shard(path):
    """{name: array} back out of a `write_array_shard` file: numpy
    arrays, and torch tensors for bfloat16."""
    with open(path, "rb") as f:
        hlen = _HDR.unpack(f.read(_HDR.size))[0]
        table = pickle.loads(f.read(hlen))
        payload = f.read()
    out = {}
    for name, dtype, shape, offset, nbytes in table:
        if dtype == "bfloat16":
            bits = np.frombuffer(payload, dtype=np.uint16,
                                 count=nbytes // 2, offset=offset)
            out[name] = torch.from_numpy(bits.copy()).view(
                torch.bfloat16).reshape(shape)
            continue
        dt = np.dtype(dtype)
        arr = np.frombuffer(payload, dtype=dt, count=nbytes // dt.itemsize,
                            offset=offset)
        out[name] = arr.reshape(shape).copy()
    return out


def host_value(arr):
    """A host copy that pickles portably: numpy, or a CPU tensor for
    bfloat16."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    return np.array(arr, copy=True)


class Staged:
    """Host copies of a set of arrays: `arrays` ({name: host tensor or
    numpy array}), `wait()` (blocks until the device copies landed),
    `release()` (hands the pooled buffers back) and `payload`: the
    arrays' bytes back to back in one buffer, in their order, when they
    were staged that way (else None)."""

    def __init__(self, arrays, event, raws, pool, payload=None):
        self.arrays = arrays
        self.payload = payload
        self._event = event
        self._raws = raws
        self._pool = pool

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    def release(self):
        for raw in self._raws:
            self._pool.release(raw)
        self._raws = []
        self.payload = None


def gather_to_pool(named_arrays, pool=None):
    """Stage ``{name: array}`` (NDArrays, tensors or numpy arrays) into
    pooled host buffers; returns a `Staged`.  Tensors are packed back to
    back into one pooled buffer when every element lands aligned (then
    a shard or a pickle of them is written in one call, which holds the
    GIL once); copies from the card are queued on the current stream and
    an event is recorded after them; the caller may go on training at
    once."""
    pool = pool or storage.default_pool()
    srcs = {}
    for name, value in named_arrays.items():
        src = value.data if isinstance(value, NDArray) else value
        srcs[name] = src.detach() if isinstance(src, torch.Tensor) else \
            np.array(src, copy=True)
    offsets, total = [], 0
    for src in srcs.values():
        if not isinstance(src, torch.Tensor) or \
                total % src.element_size():
            offsets = None
            break
        offsets.append(total)
        total += src.numel() * src.element_size()
    staged, raws, payload = {}, [], None
    if offsets is not None and total:
        flat, raw = pool.acquire((total,), torch.uint8)
        raws.append(raw)
        payload = memoryview(flat.numpy())
    device = None
    for k, (name, src) in enumerate(srcs.items()):
        if not isinstance(src, torch.Tensor):
            staged[name] = src
            continue
        if payload is not None:
            n = src.numel() * src.element_size()
            buf = flat[offsets[k]:offsets[k] + n].view(src.dtype).view(
                src.shape)
        else:
            buf, raw = pool.acquire(src.shape, src.dtype)
            raws.append(raw)
        on_card = src.device.type == "cuda"
        buf.copy_(src, non_blocking=on_card and buf.is_pinned())
        if on_card:
            device = src.device
        staged[name] = buf
    event = None
    if device is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return Staged(staged, event, raws, pool, payload)


def _write_hashed(f, view, crc):
    """f.write(view) and crc32 over it, the hash on a helper thread while
    this one writes when the view is large (both release the GIL)."""
    if len(view) < (8 << 20):
        f.write(view)
        return zlib.crc32(view, crc)
    out = {}
    hasher = threading.Thread(
        target=lambda: out.setdefault("crc", zlib.crc32(view, crc)),
        name="mx-ckpt-crc")
    hasher.start()
    f.write(view)
    hasher.join()
    return out["crc"]


def write_parts(path, parts):
    """Write the bytes-like `parts` back to back to `path`; returns
    (bytes, crc32)."""
    crc, size = 0, 0
    with open(path, "wb") as f:
        for part in parts:
            view = memoryview(part).cast("B")
            crc = _write_hashed(f, view, crc)
            size += len(view)
    return size, crc


def _parts(blob):
    """A blob's bytes-like parts: a blob is bytes, or a list of parts
    (what a blob callable may return)."""
    return blob if isinstance(blob, (list, tuple)) else [blob]


class SnapshotJob:
    """One staged checkpoint: everything the background writer needs."""

    def __init__(self, root, step, epoch=0, nbatch=0, arrays=None,
                 blobs=None, rng=None, meta=None, retire=None,
                 rank=0, num_ranks=1, staged=()):
        self.root = root
        self.step = int(step)
        self.epoch = int(epoch)
        self.nbatch = int(nbatch)
        self.arrays = arrays or {}
        self.blobs = dict(blobs or {})
        self.rng = rng
        self.meta = meta or {}
        self.retire = retire    # committed-path -> [stale paths to delete]
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.staged = list(staged)     # snapshot.Staged sets it reads
        self.bytes_written = 0
        self.seconds = {}   # the background phase's parts: wait, blobs, write

    # -- background phase ----------------------------------------------------
    def write(self):
        try:
            t0 = time.perf_counter()
            for st in self.staged:
                st.wait()
            t1 = time.perf_counter()
            self.blobs = {k: (v() if callable(v) else v)
                          for k, v in self.blobs.items()}
            t2 = time.perf_counter()
            if self.rank == 0:
                self._write_primary()
            else:
                self._write_rank_shard()
            self.seconds = {"wait": t1 - t0, "blobs": t2 - t1,
                            "write": time.perf_counter() - t2}
        finally:
            for st in self.staged:
                st.release()

    def _serialize_shards(self, into_dir):
        shards = {}
        if self.arrays:
            path = os.path.join(into_dir, ARRAYS_SHARD)
            payload = self.staged[0].payload if self.staged else None
            size, crc = write_array_shard(path, self.arrays, payload)
            shards[ARRAYS_SHARD] = {"bytes": size, "crc32": crc}
        for name, blob in self.blobs.items():
            fname = f"{name}.bin"
            size, crc = write_parts(os.path.join(into_dir, fname),
                                    _parts(blob))
            shards[fname] = {"bytes": size, "crc32": crc}
        return shards

    def _write_primary(self):
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(
            self.root, "%s%d-%d" % (_manifest._TMP_PREFIX, self.step,
                                    os.getpid()))
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            shards = self._serialize_shards(tmp)
            # per-rank shards (dist layout) live OUTSIDE the renamed dir —
            # other processes wrote them; the manifest records what rank 0
            # expects so validate() still covers them after adoption
            shards.update(self._adopt_rank_shards(tmp))
            try:
                _faults.fire("checkpoint.commit", step=self.step)
            except _faults.TornWrite:
                # the writer "dies" between the directory landing and the
                # manifest: the directory is committed WITHOUT a manifest
                # and the write returns as if it had succeeded, which is
                # what a killed process leaves; validate() rejects it and
                # latest() falls back one commit
                final = os.path.join(self.root,
                                     _manifest.checkpoint_dirname(self.step))
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                return
            _manifest.write_manifest(
                tmp, step=self.step, epoch=self.epoch, nbatch=self.nbatch,
                shards=shards, rng=self.rng, meta=self.meta,
                num_ranks=self.num_ranks)
            final = os.path.join(self.root,
                                 _manifest.checkpoint_dirname(self.step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.bytes_written = sum(int(e["bytes"]) for e in shards.values())
        if self.retire is not None:
            # O(1) retention: the manager tracks its own commit history,
            # so steady-state retirement deletes ONE known directory
            for stale in self.retire(final):
                shutil.rmtree(stale, ignore_errors=True)

    def _adopt_rank_shards(self, tmp):
        """Move this step's per-rank shard files (written by other worker
        processes into ``root/rank-shards/``) inside the checkpoint dir so
        the atomic rename commits them together with rank 0's shards."""
        shards = {}
        pool_dir = os.path.join(self.root, "rank-shards")
        if self.num_ranks <= 1 or not os.path.isdir(pool_dir):
            return shards
        prefix = "step-%d-" % self.step
        for name in sorted(os.listdir(pool_dir)):
            if not name.startswith(prefix):
                continue
            dst = os.path.join(tmp, name)
            os.replace(os.path.join(pool_dir, name), dst)
            shards[name] = _manifest.shard_entry(dst)
        return shards

    def _write_rank_shard(self):
        """Non-primary ranks publish their shards into a shared side pool;
        rank 0's manifest+rename is the only commit point.  Shards for
        steps older than this one are this rank's own superseded
        publications — retire them here so the pool cannot grow without
        bound when commits lag."""
        pool_dir = os.path.join(self.root, "rank-shards")
        os.makedirs(pool_dir, exist_ok=True)
        payload = {"arrays": {k: host_value(v)
                              for k, v in self.arrays.items()},
                   "blobs": {k: b"".join(_parts(v))
                             for k, v in self.blobs.items()},
                   "rng": self.rng}
        fname = "step-%d-rank-%d.bin" % (self.step, self.rank)
        tmp = os.path.join(pool_dir, ".%s.tmp.%d" % (fname, os.getpid()))
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=_PICKLE_PROTO)
        # sized before it is published: rank 0's commit may adopt (move)
        # it the moment it appears in the pool
        self.bytes_written = os.path.getsize(tmp)
        os.replace(tmp, os.path.join(pool_dir, fname))
        suffix = "-rank-%d.bin" % self.rank
        for name in os.listdir(pool_dir):
            if name.startswith("step-") and name.endswith(suffix):
                try:
                    if int(name[5:-len(suffix)]) < self.step:
                        os.remove(os.path.join(pool_dir, name))
                except (ValueError, OSError):
                    continue


class SnapshotWriter:
    """Background serializer with double-buffering (one in-flight write)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._job = None
        self._busy = False
        self._error = None
        self._closed = False
        self._thread = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="mx-ckpt-writer", daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait()
                if self._job is None and self._closed:
                    return
                job, self._job = self._job, None
                self._busy = True
            try:
                job.write()
            except BaseException as e:  # surfaced on next submit/flush
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(f"background checkpoint write failed: {err!r}") \
                from err

    def submit(self, job, sync=False):
        """Queue `job`; waits for any in-flight write first (double-buffer:
        at most one snapshot in flight).  ``sync=True`` additionally waits
        for THIS job to land before returning."""
        self._ensure_thread()
        with self._cond:
            while self._job is not None or self._busy:
                self._cond.wait()
            self._raise_pending()
            self._job = job
            self._cond.notify_all()
        if sync:
            self.flush()

    def flush(self):
        """Block until no snapshot is queued or being written (the
        ``waitall()`` of the checkpoint plane); re-raise deferred errors."""
        with self._cond:
            while self._job is not None or self._busy:
                self._cond.wait()
            self._raise_pending()

    def close(self):
        self.flush()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        self._closed = False
