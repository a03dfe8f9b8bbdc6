"""Sharded sparse-embedding table client.

PyTorch port of `incubator_mxnet_tpu/embedding/sharded.py`, on the
port's parameter servers (`dist.server`) and wire (`dist.transport`).
The hot-row cache lives on the table's context (``ctx``, the card by
default); `lookup` returns a tensor there.  `stats()` is the
``embedding.<name>`` telemetry producer and each lookup an
``embedding.lookup`` span, as in the JAX package.

One `ShardedEmbedding` names a logical table of ``num_rows x dim`` that
NEVER materializes densely: its rows are range- or hash-partitioned into
row shards, each hosted by one `dist.server.ParameterServer` process
(the `embed_init`/`embed_push`/`embed_pull` commands over the existing
seq-numbered at-most-once transport).  Training pushes row-sparse grads
to the owning shards, where `optimizer.py`'s lazy SGD/Adam paths update
only the touched rows; lookups ride the device-resident `HotRowCache`
so hot ids gather straight from the device buffer.

Failure semantics mirror the dense dist kvstore (`dist/kvstore_dist.py`):
each shard has its own `CircuitBreaker`; a tripped breaker — or a shard
that answers but forgot a table this client initialized (restarted
empty) — becomes a structured `ServerLostError` naming the shard, its
address, and the row range it owned.  `replace_shard` re-attaches a
respawned server and restores its rows, the chaos-certified recovery.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError
from ..context import current_context
from ..dist.transport import Channel
from ..obs import metrics as _obs_metrics, trace as _trace
from ..resilience import CircuitBreaker, ServerLostError
from .cache import HotRowCache

__all__ = ["ShardedEmbedding", "shard_of_ids"]

# splitmix64 finalizer: a stable, vectorizable integer mix so hash
# partitioning spreads sequential hot ids across shards
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(ids):
    x = np.asarray(ids, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def shard_of_ids(ids, num_rows, num_shards, partition="range"):
    """Owning shard per id (np int array -> np int array).

    'range': shard s owns the contiguous interval
    ``[num_rows*s//n, num_rows*(s+1)//n)`` (ps-lite value ranges —
    locality-preserving, one searchsorted).  'hash': splitmix64 mix
    modulo shards (skew-resistant for power-law id traffic)."""
    ids = np.asarray(ids, dtype=np.int64)
    if partition == "hash":
        return (_mix64(ids) % np.uint64(num_shards)).astype(np.int64)
    bounds = np.array([num_rows * s // num_shards
                       for s in range(1, num_shards)], dtype=np.int64)
    return np.searchsorted(bounds, ids, side="right")


class ShardedEmbedding:
    """A row-sharded embedding table hosted on parameter servers."""

    def __init__(self, name, num_rows, dim, servers, dtype="float32",
                 partition=None, seed=0, scale=0.01, cache_rows=None,
                 optimizer=None, init_values=None, ctx=None):
        self.name = str(name)
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.partition = partition or str(
            _config.get("MXNET_EMBED_PARTITION"))
        if self.partition not in ("range", "hash"):
            raise MXNetError(
                f"ShardedEmbedding({self.name!r}): unknown partition "
                f"{self.partition!r} (one of 'range', 'hash')")
        self._seed, self._scale = int(seed), float(scale)
        self._lock = threading.RLock()
        self._chans = [c if isinstance(c, Channel) else Channel(*c)
                       for c in servers]
        if not self._chans:
            raise MXNetError(
                f"ShardedEmbedding({self.name!r}): at least one shard "
                "server is required")
        self.num_shards = len(self._chans)
        # one request lock per shard: a Channel is a single framed TCP
        # stream — concurrent callers (serving threads) must not
        # interleave frames or steal each other's replies
        self._shard_locks = [threading.Lock() for _ in self._chans]
        self._breakers = [
            CircuitBreaker(
                failure_threshold=int(_config.get(
                    "MXNET_EMBED_BREAKER_THRESHOLD")),
                reset_timeout=float(_config.get(
                    "MXNET_EMBED_BREAKER_RESET_S")))
            for _ in self._chans]
        # guard: a table this tier exists to shard must never densify
        # onto one device — the modeled single-device budget is the gate
        budget = int(_config.get("MXNET_EMBED_HBM_BUDGET_MB")) * (1 << 20)
        self.table_bytes = self.num_rows * self.dim * self.dtype.itemsize
        self.over_hbm_ratio = self.table_bytes / max(budget, 1)
        cache_rows = int(_config.get("MXNET_EMBED_CACHE_ROWS")) \
            if cache_rows is None else int(cache_rows)
        self.ctx = ctx if ctx is not None else current_context()
        self.cache = HotRowCache(self.dim, cache_rows, self.dtype,
                                 name=self.name, ctx=self.ctx) \
            if cache_rows > 0 else None
        self._inited = False
        self._opt_blob = None
        # per-shard wire counters (the `embedding.*` obs namespace)
        self._pushed = [0] * self.num_shards
        self._pulled = [0] * self.num_shards
        self.lookups = 0
        self.lookup_rows = 0
        self.failovers = 0
        self._t0 = time.monotonic()
        _obs_metrics.register_producer(f"embedding.{self.name}",
                                       self.stats)
        self._init_shards(init_values)
        if optimizer is not None:
            self.set_optimizer(optimizer)

    # -- partition ------------------------------------------------------------
    def _range_of(self, shard):
        lo = self.num_rows * shard // self.num_shards
        hi = self.num_rows * (shard + 1) // self.num_shards
        return lo, hi

    def _owned_desc(self, shard):
        """What the shard owns, for ServerLostError evidence."""
        if self.partition == "range":
            lo, hi = self._range_of(shard)
            return [f"{self.name}[{lo}:{hi}]"]
        return [f"{self.name}[hash shard {shard}/{self.num_shards}]"]

    def shard_of(self, ids):
        return shard_of_ids(ids, self.num_rows, self.num_shards,
                            self.partition)

    # -- transport ------------------------------------------------------------
    def _request(self, shard, msg):
        """One shard round trip with the dist failover semantics: the
        channel retries transient failures; exhausted attempts count
        against the shard's breaker; a tripped breaker (or a shard that
        restarted empty) raises `ServerLostError` naming the shard and
        the rows it owned."""
        with self._shard_locks[shard]:
            chan = self._chans[shard]
            breaker = self._breakers[shard]
            addr = f"{chan.host}:{chan.port}"
            if not breaker.allow():
                raise ServerLostError(
                    shard, addr, keys=self._owned_desc(shard),
                    reason=f"circuit breaker is {breaker.state} after "
                           f"{breaker.failure_threshold} consecutive "
                           "failures")
            framed = False
            while True:
                try:
                    reply = chan.resend_last() if framed \
                        else chan.request(msg)
                    break
                except TimeoutError as e:
                    framed = True
                    if breaker.record_failure():
                        raise ServerLostError(
                            shard, addr, keys=self._owned_desc(shard),
                            reason=f"unresponsive during "
                                   f"{msg.get('cmd')!r}: "
                                   f"{breaker.failure_threshold} "
                                   f"consecutive timeouts ({e})") from e
                except (ConnectionError, EOFError, OSError) as e:
                    framed = True
                    if breaker.record_failure():
                        raise ServerLostError(
                            shard, addr, keys=self._owned_desc(shard),
                            reason=f"unreachable during "
                                   f"{msg.get('cmd')!r} after "
                                   f"{breaker.failure_threshold} "
                                   f"consecutive failures "
                                   f"({type(e).__name__}: {e})") from e
        if "error" in reply:
            err = reply["error"]
            if "has not been initialized" in err and self._inited:
                # the shard answered but forgot a table this client DID
                # initialize: it restarted empty — its rows are gone
                breaker.record_failure()
                raise ServerLostError(
                    shard, addr, keys=self._owned_desc(shard),
                    reason=f"server restarted without state ({err})")
            breaker.record_success()
            raise MXNetError(err)
        breaker.record_success()
        return reply

    # -- init / optimizer -----------------------------------------------------
    def _init_shards(self, init_values):
        for s in range(self.num_shards):
            msg = {"cmd": "embed_init", "table": self.name,
                   "dim": self.dim, "dtype": self.dtype.name,
                   "seed": self._seed, "scale": self._scale}
            if self.partition == "range":
                lo, hi = self._range_of(s)
                msg["row_start"], msg["row_end"] = lo, hi
                if init_values is not None:
                    msg["values"] = np.asarray(init_values[lo:hi],
                                               dtype=self.dtype)
            else:
                ids = np.arange(self.num_rows, dtype=np.int64)
                ids = ids[self.shard_of(ids) == s]
                msg["ids"] = ids
                if init_values is not None:
                    msg["values"] = np.asarray(init_values,
                                               dtype=self.dtype)[ids]
            self._request(s, msg)
        self._inited = True

    def set_optimizer(self, optimizer):
        """Ship the (pickled) optimizer to every shard server; pushes then
        apply the lazy row-sparse update shard-side (only touched rows).
        A server unpickles only its own package's optimizers."""
        import pickle
        blob = pickle.dumps(optimizer)
        self._opt_blob = blob    # re-shipped by replace_shard
        for s in range(self.num_shards):
            self._request(s, {"cmd": "set_optimizer", "optimizer": blob})

    # -- data path ------------------------------------------------------------
    def _group_by_shard(self, ids):
        shards = self.shard_of(ids)
        for s in np.unique(shards):
            yield int(s), np.nonzero(shards == s)[0]

    def pull_rows(self, ids):
        """Rows for unique ``ids`` straight from the shards (cache
        bypassed) as np [len(ids), dim]."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        out = np.empty((len(ids), self.dim), dtype=self.dtype)
        for s, at in self._group_by_shard(ids):
            reply = self._request(s, {"cmd": "embed_pull",
                                      "table": self.name,
                                      "ids": ids[at]})
            out[at] = np.asarray(reply["values"], dtype=self.dtype)
            self._pulled[s] += len(at)
        return out

    def lookup(self, ids, out_np=False):
        """Embedding vectors for ``ids`` (any shape) as a tensor of shape
        ``ids.shape + (dim,)`` on the table's device (np array when
        ``out_np``).

        Hot ids gather from the device cache; cold ids pull from their
        shards in one batch per shard and are pinned for next time."""
        ids = np.asarray(ids, dtype=np.int64)
        flat = ids.ravel()
        with _trace.span("embedding.lookup", cat="embedding",
                         table=self.name, rows=int(flat.size)):
            if self.cache is not None:
                rows, _h, _m = self.cache.lookup(flat, self.pull_rows)
            else:                          # no cache: one copy to the device
                rows = torch.from_numpy(self.pull_rows(flat)).to(
                    self.ctx.torch_device)
        with self._lock:
            self.lookups += 1
            self.lookup_rows += int(flat.size)
        rows = rows.reshape(ids.shape + (self.dim,))
        return rows.cpu().numpy() if out_np else rows

    def push_grad(self, ids, grads):
        """Push a row-sparse gradient: duplicate ids pre-sum, each
        shard receives only the rows it owns, the lazy optimizer updates
        them server-side, and the cached copies are invalidated."""
        from ..ndarray.sparse import aggregate_row_sparse
        ids = np.asarray(ids, dtype=np.int64).ravel()
        grads = np.asarray(grads, dtype=self.dtype).reshape(len(ids),
                                                            self.dim)
        uniq, summed = aggregate_row_sparse(ids, grads)
        for s, at in self._group_by_shard(uniq):
            reply = self._request(
                s, {"cmd": "embed_push", "table": self.name,
                    "ids": uniq[at], "values": summed[at]})
            self._pushed[s] += len(at)
            if self.cache is not None:
                # the reply carries the post-update rows: refresh the
                # resident copies in place so hot rows stay hot across
                # training steps (invalidation would force a re-pull)
                self.cache.refresh(uniq[at], reply["values"])

    def assign_rows(self, ids, values):
        """Overwrite rows (checkpoint restore / weight swap)."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=self.dtype).reshape(
            len(ids), self.dim)
        for s, at in self._group_by_shard(ids):
            self._request(s, {"cmd": "embed_push", "table": self.name,
                              "ids": ids[at], "values": values[at],
                              "op": "assign"})
            self._pushed[s] += len(at)
        if self.cache is not None:
            self.cache.invalidate(ids)

    # -- checkpoint / recovery ------------------------------------------------
    def checkpoint_rows(self):
        """The full table streamed back chunk-by-chunk as np
        [num_rows, dim] — host-resident only, for the checkpoint plane
        (one reply never carries a table-sized frame)."""
        chunk = int(_config.get("MXNET_EMBED_PULL_CHUNK"))
        out = np.empty((self.num_rows, self.dim), dtype=self.dtype)
        for lo in range(0, self.num_rows, chunk):
            ids = np.arange(lo, min(lo + chunk, self.num_rows),
                            dtype=np.int64)
            out[lo:lo + len(ids)] = self.pull_rows(ids)
        return out

    def restore_rows(self, table):
        """Push a checkpointed table back out to the shards."""
        table = np.asarray(table, dtype=self.dtype)
        if table.shape != (self.num_rows, self.dim):
            raise MXNetError(
                f"restore_rows({self.name!r}): checkpoint shape "
                f"{table.shape} != table shape "
                f"{(self.num_rows, self.dim)}")
        chunk = int(_config.get("MXNET_EMBED_PULL_CHUNK"))
        for lo in range(0, self.num_rows, chunk):
            ids = np.arange(lo, min(lo + chunk, self.num_rows),
                            dtype=np.int64)
            self.assign_rows(ids, table[lo:lo + len(ids)])

    def replace_shard(self, shard, host, port, restore=None):
        """Re-attach a respawned shard server: reconnect the channel,
        reset its breaker, re-init the shard's rows (from ``restore``, a
        full-table np array, when given — else the seeded init), and
        drop every cached row it owns.  The chaos-certified recovery.
        The swap holds the shard's request lock, so no concurrent lookup
        is mid-request on the channel it closes (the JAX method closes it
        under the table's lock only)."""
        with self._shard_locks[shard], self._lock:
            try:
                self._chans[shard].close()
            except Exception:
                pass
            self._chans[shard] = Channel(host, int(port))
            self._breakers[shard] = CircuitBreaker(
                failure_threshold=int(_config.get(
                    "MXNET_EMBED_BREAKER_THRESHOLD")),
                reset_timeout=float(_config.get(
                    "MXNET_EMBED_BREAKER_RESET_S")))
            self.failovers += 1
        msg = {"cmd": "embed_init", "table": self.name, "dim": self.dim,
               "dtype": self.dtype.name, "seed": self._seed,
               "scale": self._scale}
        if self.partition == "range":
            lo, hi = self._range_of(shard)
            msg["row_start"], msg["row_end"] = lo, hi
            owned = np.arange(lo, hi, dtype=np.int64)
        else:
            owned = np.arange(self.num_rows, dtype=np.int64)
            owned = owned[self.shard_of(owned) == shard]
            msg["ids"] = owned
        if restore is not None:
            msg["values"] = np.asarray(restore, dtype=self.dtype)[owned]
        self._request(shard, msg)
        if getattr(self, "_opt_blob", None) is not None:
            # the respawned server starts without an updater: re-ship
            # the optimizer or the next grad push is a structured error
            self._request(shard, {"cmd": "set_optimizer",
                                  "optimizer": self._opt_blob})
        if self.cache is not None:
            self.cache.invalidate(owned)

    # -- obs ------------------------------------------------------------------
    def stats(self):
        dt = max(time.monotonic() - self._t0, 1e-9)
        out = {
            "table": self.name, "num_rows": self.num_rows,
            "dim": self.dim, "num_shards": self.num_shards,
            "partition": self.partition,
            "table_bytes": self.table_bytes,
            "over_hbm_ratio": round(self.over_hbm_ratio, 3),
            "lookups": self.lookups, "lookup_rows": self.lookup_rows,
            "lookup_qps": round(self.lookups / dt, 3),
            "failovers": self.failovers,
            # dict (not list) so metrics.flatten keeps the per-shard
            # counters in the embedding.* scrape
            "shards": {
                str(s): {"addr": f"{c.host}:{c.port}",
                         "rows_pushed": self._pushed[s],
                         "rows_pulled": self._pulled[s],
                         "breaker": b.state}
                for s, (c, b) in enumerate(zip(self._chans,
                                               self._breakers))},
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self):
        for c in self._chans:
            try:
                c.close()
            except Exception:
                pass
