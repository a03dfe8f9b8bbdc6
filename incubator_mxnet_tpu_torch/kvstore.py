"""KVStore: data-parallel parameter synchronization (reference
`python/mxnet/kvstore.py`, `src/kvstore/`).

PyTorch port of `incubator_mxnet_tpu/kvstore.py`:

* ``local`` — `KVStore`: the values are reduced and stored on the host;
* ``device`` / ``nccl`` / ``tpu`` — `KVStoreDevice`: stored and reduced
  on the card (`gpu(0)`; the CPU on a machine without one);
* ``dist_sync`` / ``dist_async`` (and their aliases) — the parameter
  server's socket data plane (`dist.kvstore_dist.KVStoreDist`) when the
  tracker's environment names a server, else a one-process stand-in
  with the dist bookkeeping, as in the JAX package.

A push of several values for a key (one per context) sums them in push
order on the first value's device, as the JAX store does when the values
share a device (`kvstore.py:516-523`).  A batched multi-key push on
``device`` / ``tpu`` is the JAX store's bucketed reduce (`:505-630`):
the keys, in priority order (the last key first: backward makes the last
layer's gradients first), pack into single-dtype buckets of at most
``MXNET_KVSTORE_BUCKET_MB`` (`plan_buckets`, the JAX rule); each bucket
is one flatten and concatenate per context, one sum in context order and
one split, so a step costs O(buckets) reductions, not one a key, and
its sums are bit for bit the per-key path's.  A batched pull broadcasts
a bucket at a time (`_pull_buckets`); `begin_push` / `push_part` /
`end_push` stream a push bucket by bucket.  The contexts of one card
(``[gpu(0), gpu(0)]``) reduce on that card; values on several cards are
moved to the first one's (the JAX store's all-reduce over a mesh of
cards is not measured).  2-bit gradient compression quantizes the
reduced value with a per-key error-feedback residual (`:267-299`),
after the bucket's split on the bucketed path: ``q = thr where g + r >=
thr, -thr where <= -thr, else 0``, ``r = g + r - q``.  `live_stats` and
`findings` read every live bucketed store's `stats()`.
"""
from __future__ import annotations

import weakref

import numpy as _np
import torch

from .base import MXNetError
from .context import cpu, gpu, num_gpus
from .ndarray.ndarray import NDArray
from . import optimizer as opt

__all__ = ["KVStore", "KVStoreDevice", "create", "plan_buckets",
           "live_stats", "findings"]

# live bucketed stores (weak): `live_stats` reads them without holding
# them alive
_LIVE_STORES = weakref.WeakSet()


def live_stats():
    """`stats()` of every live ``device`` / ``tpu`` store."""
    out = []
    for kv in list(_LIVE_STORES):
        try:
            out.append(kv.stats())
        except Exception:
            pass
    return out


def findings():
    """One summary line a live bucketed store that took batched pushes:
    its dispatch economy (reductions a push must be O(buckets), never
    O(keys)), as dicts with the JAX finding's fields."""
    out = []
    for st in live_stats():
        if not st.get("batched_pushes"):
            continue
        out.append({
            "pass": "kvstore.buckets", "code": "summary",
            "severity": "hint", "location": "kvstore",
            "message": "kvstore='%s': %d batched pushes, %d allreduce "
                       "dispatches (%.2f buckets/push, cap %d MB, avg fill "
                       "%.0f%%), %.1f MB reduced"
                       % (st["type"], st["batched_pushes"],
                          st["allreduce_dispatches"],
                          st["allreduce_dispatches"]
                          / max(1, st["batched_pushes"]),
                          st["bucket_cap_mb"], 100.0 * st["avg_bucket_fill"],
                          st["bytes_reduced"] / (1 << 20))})
    return out


def _key(k):
    return str(k)


def _updater_key(k):
    return int(k) if isinstance(k, int) or (isinstance(k, str) and
                                            k.isdigit()) else k


def plan_buckets(order, sizes, dtypes, cap_bytes):
    """Pack the indices in `order` (already priority-sorted) into
    size-capped single-dtype buckets; an item larger than the cap gets a
    bucket of its own.  A pure function of (order, sizes, dtypes, cap):
    the JAX package's rule (`kvstore.plan_buckets`)."""
    buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
    for i in order:
        nb = sizes[i]
        if cur and (cur_bytes + nb > cap_bytes or dtypes[i] != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = dtypes[i]
    if cur:
        buckets.append(cur)
    return buckets


class KVStore:
    """Single-process key-value store (reference
    `include/mxnet/kvstore.h:59-310`)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}        # key -> NDArray on the store's context
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._residuals = {}
        if kind in ("device", "nccl", "tpu") and num_gpus() > 0:
            self._store_ctx = gpu(0)
        else:
            self._store_ctx = cpu(0)

    # -- identity ------------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- init/push/pull --------------------------------------------------------
    def init(self, key, value):
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            if _key(k) in self._store:
                raise MXNetError(f"Key {k} already initialized")
            self._store[_key(k)] = v.copyto(self._store_ctx)

    def _commit(self, k, merged):
        """Apply a reduced value: the updater when one is installed, else
        overwrite the stored value."""
        sk = _key(k)
        if self._updater is not None:
            self._updater(_updater_key(k), merged, self._store[sk])
        else:
            self._store[sk]._set_data(merged.data.to(
                self._store_ctx.torch_device))

    def push(self, key, value, priority=0):
        """Push values; a list of values for one key is summed first
        (reference `kvstore_local.h:184 PushImpl` -> `comm.h Reduce`)."""
        keys, values = _normalize_push(key, value)
        for k, vals in zip(keys, values):
            sk = _key(k)
            if sk not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
            self._commit(k, self._reduce_compress(sk, vals))

    def _reduce_compress(self, sk, vals):
        merged = self._reduce(vals)
        if self._compression is not None:
            merged = self._compress(sk, merged)
        return merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored value into every out array (reference
        `comm.h:209 Broadcast`)."""
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = _normalize_push(key, out)
        for k, tgt_list in zip(keys, outs):
            sk = _key(k)
            if sk not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
            for tgt in tgt_list:
                self._store[sk].copyto(tgt)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in `row_ids` (reference `PullRowSparse`):
        into a `RowSparseNDArray` its rows and ids, into a dense array the
        rows at their places and zeros elsewhere."""
        from .ndarray.sparse import RowSparseNDArray
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, outs = _normalize_push(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids]
        for k, tgt_list in zip(keys, outs):
            src = self._store[_key(k)].asnumpy()
            for tgt, rids in zip(tgt_list, row_ids * len(tgt_list)):
                rows = rids.asnumpy().astype("int64")
                vals = src[rows]
                if isinstance(tgt, RowSparseNDArray):
                    tgt._set_rows(vals, rows)
                else:
                    full = _np.zeros(src.shape, vals.dtype)
                    full[rows] = vals
                    tgt._set_data(full)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def embedding(self, name, num_rows, dim, **kwargs):
        """A sharded embedding table needs parameter servers: only the
        dist stores host one."""
        raise MXNetError(
            f"kvstore type {self.type!r} has no parameter-server plane "
            "to host a sharded embedding — create the table against a "
            "'dist_async'/'dist_sync' store, or pass explicit server "
            "addresses to embedding.ShardedEmbedding")

    # -- reduction -------------------------------------------------------------
    def _reduce_ctx(self, vals):
        return cpu(0)

    def _reduce(self, vals):
        """Sum in push order on the reducing context."""
        if len(vals) == 1:
            return vals[0]
        ctx = self._reduce_ctx(vals)
        dev = ctx.torch_device
        acc = vals[0].data.to(dev)
        for v in vals[1:]:
            acc = acc + v.data.to(dev)
        return NDArray(acc, ctx=ctx)

    # -- gradient compression ----------------------------------------------------
    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback (reference
        `gradient_compression.h:52-134`); None or empty clears it."""
        if not compression_params:
            self._compression = None
            self._residuals = {}
            return
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError("only 2bit gradient compression is supported "
                             "(as the reference)")
        self._compression = {
            "type": ctype,
            "threshold": float(compression_params.get("threshold", 0.5)),
        }

    def _compress(self, sk, merged):
        thr = self._compression["threshold"]
        g = merged.data
        resid = self._residuals.get(sk)
        if resid is not None:
            g = g + resid.to(g.device)
        t = torch.tensor(thr, dtype=g.dtype, device=g.device)
        q = torch.where(g >= t, t, torch.where(g <= -t, -t,
                                               torch.zeros_like(g)))
        self._residuals[sk] = g - q
        return NDArray(q, ctx=merged.context)

    # -- optimizer integration ----------------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """The updater runs in this process, on the store's device."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def get_optimizer_states(self, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        return self._updater.get_states(dump_optimizer)

    def set_optimizer_states(self, blob):
        """Restore a `get_optimizer_states` blob, each state on the
        store's context."""
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        self._updater.set_states(blob)
        for k, state in self._updater.states.items():
            self._updater.states[k] = opt.states_on_ctx(state,
                                                        self._store_ctx)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        with open(fname, "wb") as f:
            f.write(self.get_optimizer_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self.set_optimizer_states(f.read())

    def _barrier(self):
        """Nothing to synchronize in one process."""


class KVStoreDevice(KVStore):
    """``device`` / ``nccl`` / ``tpu``: the store and the reduction on
    the card.  Values of one key on one device (several contexts on one
    card) sum in push order there; values on several devices are moved
    to the first one's and summed in push order.  A batched multi-key
    push is the bucketed reduce; the counters are the JAX collective
    store's (`stats()`)."""

    def __init__(self, kind="device"):
        super().__init__(kind)
        self.allreduce_dispatches = 0   # one a bucket (tests assert it)
        self._counters = {"pushes": 0, "batched_pushes": 0,
                          "fallback_reduces": 0, "bytes_reduced": 0,
                          "buckets": 0, "fill_sum": 0.0,
                          "pull_broadcasts": 0}
        self._fill_hist = [0, 0, 0, 0]   # fill quartiles (<=25..<=100%)
        self._stream = None              # an open streaming push
        _LIVE_STORES.add(self)
        # telemetry plane: the counters under the 'kvstore' namespace
        # (weakly held; the newest live store answers scrapes)
        from .obs import metrics as _obs_metrics
        _obs_metrics.register_producer("kvstore", self.stats)

    @property
    def _bucket_cap_bytes(self):
        from . import config as _config
        # fractional MB are honored (KB-sized caps force several buckets)
        return max(1, int(float(_config.get("MXNET_KVSTORE_BUCKET_MB"))
                          * (1 << 20)))

    @property
    def prefers_batched_push(self):
        """A multi-key push and pull should come as one call: the key
        list reduces in O(buckets) reductions."""
        return True

    def _reduce_ctx(self, vals):
        return vals[0].context

    def _reduce(self, vals):
        if len(vals) > 1:
            self._counters["bytes_reduced"] += \
                vals[0].data.numel() * vals[0].data.element_size()
        return super()._reduce(vals)

    # -- the bucketed reduce ---------------------------------------------------
    @staticmethod
    def _nbytes(v):
        return v.data.numel() * v.data.element_size()

    def _plan_buckets(self, order, values):
        """The key indices of `order` (already in priority order) packed
        into size-capped single-dtype buckets (`plan_buckets`)."""
        return plan_buckets(order, [self._nbytes(v[0]) for v in values],
                            [v[0].data.dtype for v in values],
                            self._bucket_cap_bytes)

    def _reduce_bucket(self, idxs, keys, values):
        """One bucket: each context's values flattened and concatenated,
        the contexts summed in push order on the first one's device (one
        reduction), the split back into the keys, and each key's 2-bit
        quantize with its own residual (elementwise: the bucket's codes
        and residuals are the per-key path's)."""
        ctx0 = values[idxs[0]][0].context
        dev = ctx0.torch_device
        shapes = [values[i][0].shape for i in idxs]
        sizes = [values[i][0].data.numel() for i in idxs]
        acc = None
        for d in range(len(values[idxs[0]])):
            cat = torch.cat([values[i][d].data.detach().reshape(-1).to(dev)
                             for i in idxs])
            acc = cat if acc is None else acc + cat
        self.allreduce_dispatches += 1
        nbytes = acc.numel() * acc.element_size()
        self._counters["bytes_reduced"] += nbytes
        self._counters["buckets"] += 1
        fill = min(1.0, nbytes / self._bucket_cap_bytes)
        self._counters["fill_sum"] += fill
        self._fill_hist[min(3, max(0, int(_np.ceil(fill * 4)) - 1))] += 1
        out = {}
        for i, p, shape in zip(idxs, torch.split(acc, sizes), shapes):
            out[i] = NDArray(p.view(shape), ctx=ctx0)
            if self._compression is not None:
                out[i] = self._compress(_key(keys[i]), out[i])
        return out

    def _reduce_ordered(self, order, keys, values):
        """The bucketed reduce of `values` in priority order: the merged
        arrays, aligned with `keys`."""
        self._counters["batched_pushes"] += 1
        bytes_before = self._counters["bytes_reduced"]
        plan = self._plan_buckets(order, values)
        merged = {}
        for bucket in plan:
            merged.update(self._reduce_bucket(bucket, keys, values))
        from . import profiler as _profiler
        _profiler.record_kvstore(
            "bucketed_push", keys=len(keys), buckets=len(plan),
            bytes=self._counters["bytes_reduced"] - bytes_before)
        return [merged[i] for i in range(len(values))]

    def _reduce_many(self, values, keys):
        """The batched push's reduce: reversed key order, since backward
        makes the last layer's gradients first."""
        return self._reduce_ordered(list(reversed(range(len(values)))),
                                    list(keys), values)

    def push(self, key, value, priority=0):
        keys, values = _normalize_push(key, value)
        self._counters["pushes"] += 1
        if len(keys) > 1 and all(len(vals) > 1 for vals in values):
            for k in keys:
                if _key(k) not in self._store:
                    raise MXNetError(f"Key {k} has not been initialized")
            from .obs import trace as _obs_trace
            with _obs_trace.span("kvstore.push", cat="kvstore",
                                 keys=len(keys)):
                for k, m in zip(keys, self._reduce_many(values, keys)):
                    self._commit(k, m)
            return
        super().push(keys, values, priority)

    # -- streaming push ----------------------------------------------------------
    def begin_push(self):
        """Open a streaming push: gradients come a key at a time
        (`push_part`) in production order, and a bucket reduces as soon
        as the pending keys reach the cap; `end_push` flushes the tail."""
        if self._stream is not None:
            raise MXNetError("begin_push: a streaming push is already open")
        self._stream = {"keys": [], "values": [], "bytes": 0}

    def push_part(self, key, value, priority=0):
        """Add keys' per-context gradients to the open streaming push."""
        st = self._stream
        if st is None:
            raise MXNetError("push_part outside begin_push/end_push")
        keys, values = _normalize_push(key, value)
        for k, vals in zip(keys, values):
            if _key(k) not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
            st["keys"].append(k)
            st["values"].append(vals)
            st["bytes"] += self._nbytes(vals[0])
        if st["bytes"] >= self._bucket_cap_bytes:
            self._flush_stream()

    def _flush_stream(self):
        st = self._stream
        keys, values = st["keys"], st["values"]
        if not keys:
            return
        st["keys"], st["values"], st["bytes"] = [], [], 0
        if all(len(vals) > 1 for vals in values):
            merged = self._reduce_ordered(list(range(len(keys))), keys,
                                          values)
        else:
            merged = [self._reduce_compress(_key(k), vals)
                      for k, vals in zip(keys, values)]
        for k, m in zip(keys, merged):
            self._commit(k, m)

    def end_push(self):
        """Flush the open streaming push's tail and close it."""
        if self._stream is None:
            raise MXNetError("end_push without begin_push")
        try:
            self._flush_stream()
        finally:
            self._stream = None

    # -- the bucketed pull -------------------------------------------------------
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = _normalize_push(key, out)
        for k in keys:
            if _key(k) not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
        rest = list(range(len(keys)))
        if len(keys) > 1:
            rest = self._pull_buckets(keys, outs)
        if rest:
            super().pull([keys[i] for i in rest],
                         out=[outs[i] for i in rest])

    def _pull_buckets(self, keys, outs):
        """Broadcast the keys pulled into several targets a bucket at a
        time: the stored values concatenated, one copy of the bucket a
        target device, split into the targets.  Returns the indices left
        for the per-key pull."""
        elig = [i for i, t in enumerate(outs) if len(t) > 1]
        if len(elig) < 2:
            return list(range(len(keys)))
        values = [[self._store[_key(keys[i])]] for i in elig]
        for bucket in self._plan_buckets(range(len(elig)), values):
            idxs = [elig[j] for j in bucket]
            srcs = [self._store[_key(keys[i])].data for i in idxs]
            buf = torch.cat([v.reshape(-1) for v in srcs])
            self._counters["pull_broadcasts"] += 1
            sizes = [v.numel() for v in srcs]
            by_dev = {}
            for j, i in enumerate(idxs):
                for tgt in outs[i]:
                    dev = tgt.data.device
                    if dev not in by_dev:
                        by_dev[dev] = torch.split(buf.to(dev), sizes)
                    tgt._set_data(by_dev[dev][j].view(srcs[j].shape))
        chosen = set(elig)
        return [i for i in range(len(keys)) if i not in chosen]

    def stats(self):
        """The store's counters: pushes, batched pushes, reductions
        (``allreduce_dispatches``, one a bucket), bytes reduced, buckets,
        the cap, the fill, pull broadcasts, fallback reduces and the
        compression in force.  The reduce is synchronous on the host's
        stream order, so ``overlap_ratio`` is 0 (not measured)."""
        c = self._counters
        return {
            "type": self._kind,
            "pushes": c["pushes"],
            "batched_pushes": c["batched_pushes"],
            "allreduce_dispatches": self.allreduce_dispatches,
            "bytes_reduced": c["bytes_reduced"],
            "buckets": c["buckets"],
            "bucket_cap_mb": self._bucket_cap_bytes / (1 << 20),
            "bucket_fill_hist": {
                "<=25%": self._fill_hist[0], "<=50%": self._fill_hist[1],
                "<=75%": self._fill_hist[2], "<=100%": self._fill_hist[3]},
            "avg_bucket_fill": c["fill_sum"] / max(1, c["buckets"]),
            "overlap_ratio": 0.0,
            "pull_broadcasts": c["pull_broadcasts"],
            "fallback_reduces": c["fallback_reduces"],
            "compression": None if self._compression is None
            else dict(self._compression),
        }


def _normalize(key, value):
    if isinstance(key, (int, str)):
        return [key], [value]
    return list(key), list(value)


def _normalize_push(key, value):
    """-> keys and a list of lists of arrays."""
    if isinstance(key, (int, str)):
        if isinstance(value, (list, tuple)):
            if value:
                return [key], [list(value)]
            raise MXNetError("invalid push/pull value")
        return [key], [[value]]
    out = []
    for v in value:
        out.append(list(v) if isinstance(v, (list, tuple)) else [v])
    return list(key), out


def create(name="local"):
    """A store by type name (reference `src/kvstore/kvstore.cc:48-64`)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("tpu", "device", "nccl", "local_allreduce_device"):
        return KVStoreDevice("tpu" if name == "tpu" else "device")
    if name in ("local", "local_allreduce_cpu"):
        return KVStore("local")
    if name in ("dist_sync", "dist_async", "dist_device_sync",
                "dist_sync_device", "dist"):
        import os
        role = os.environ.get("DMLC_ROLE")
        if role == "server":
            # the reference runs the user's script on server hosts too:
            # the process serves and never returns to the script
            import sys
            from .dist.server import ParameterServer
            ParameterServer(
                host=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
                port=int(os.environ.get("DMLC_PS_ROOT_PORT", 9091)),
            ).serve_forever()
            sys.exit(0)
        if role == "scheduler":
            import sys
            sys.exit(0)
        if os.environ.get("DMLC_PS_ROOT_URI") or role == "worker":
            from .dist.kvstore_dist import KVStoreDist
            return KVStoreDist(name)
        # no tracker: a one-process stand-in with the dist bookkeeping
        return KVStore(name)
    raise MXNetError(f"Unknown KVStore type {name}")
