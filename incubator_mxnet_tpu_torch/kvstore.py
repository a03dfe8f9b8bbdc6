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
share a device (`kvstore.py:516-523`); the JAX bucketed all-reduce over
distinct devices (`:645-760`, `:909-960`) needs several cards and is not
ported, so a batched multi-key push counts a ``fallback_reduces`` there
as the JAX store does on one device.  `plan_buckets`, the JAX bucket
rule, is kept as the pure function it is.  2-bit gradient compression
quantizes the reduced value with a per-key error-feedback residual
(`:267-299`) on the device it lives on: ``q = thr where g + r >= thr,
-thr where <= -thr, else 0``, ``r = g + r - q``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import cpu, gpu, num_gpus
from .ndarray.ndarray import NDArray
from . import optimizer as opt

__all__ = ["KVStore", "KVStoreDevice", "create", "plan_buckets"]


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
    to the first one's and summed in push order.  The counters are the
    JAX collective store's (`stats()`)."""

    def __init__(self, kind="device"):
        super().__init__(kind)
        self._counters = {"pushes": 0, "batched_pushes": 0,
                          "fallback_reduces": 0, "bytes_reduced": 0}
        # telemetry plane: the counters under the 'kvstore' namespace
        # (weakly held; the newest live store answers scrapes)
        from .obs import metrics as _obs_metrics
        _obs_metrics.register_producer("kvstore", self.stats)

    def _reduce_ctx(self, vals):
        return vals[0].context

    def _reduce(self, vals):
        if len(vals) > 1:
            self._counters["bytes_reduced"] += \
                vals[0].data.numel() * vals[0].data.element_size()
        return super()._reduce(vals)

    def push(self, key, value, priority=0):
        keys, values = _normalize_push(key, value)
        self._counters["pushes"] += 1
        if len(keys) > 1 and all(len(vals) > 1 for vals in values):
            # the JAX store's bucketed reduce needs distinct devices; on
            # one device, and in the port everywhere, it falls back to
            # the per-key reduce
            self._counters["fallback_reduces"] += 1
            bytes_before = self._counters["bytes_reduced"]
            from .obs import trace as _obs_trace
            with _obs_trace.span("kvstore.push", cat="kvstore",
                                 keys=len(keys)):
                super().push(keys, values, priority)
            from . import profiler as _profiler
            _profiler.record_kvstore(
                "fallback_push", keys=len(keys),
                bytes=self._counters["bytes_reduced"] - bytes_before)
            return
        super().push(keys, values, priority)

    def stats(self):
        """The store's counters: pushes, batched pushes (0: the bucketed
        path is not ported), fallback reduces, bytes reduced, and the
        compression in force."""
        return dict(self._counters, type=self._kind,
                    compression=None if self._compression is None
                    else dict(self._compression))


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
