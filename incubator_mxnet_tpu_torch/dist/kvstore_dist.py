"""Worker-side distributed KVStore (reference `src/kvstore/kvstore_dist.h`).

PyTorch port of `incubator_mxnet_tpu/dist/kvstore_dist.py` on the socket
data plane: the per-context values of a key are summed on the worker
(`kvstore.KVStoreDevice`'s reduce, on the card), then ONE merged array
per key travels to its parameter server (2-bit packed under
compression, `compression`), which aggregates the round (``dist_sync``)
or applies the push at once (``dist_async``).  Keys shard over several
servers as in the JAX package: a key of at most
``MXNET_KVSTORE_BIGARRAY_BOUND`` elements lives whole on one server (by
its number, or a stable hash of its name); a bigger one splits into one
contiguous range per server, each stored under the true key.  Each
server has a circuit breaker; a tripped one, or a server that answers
but forgot a key this worker initialized, raises `ServerLostError`
naming the server and the keys it owned.

The JAX package's collective data plane (``MXNET_KVSTORE_COLLECTIVE``,
gradients all-reduced over `jax.distributed`) is not ported, and NCCL
refuses two ranks on one card: asking for it raises.  The tracker's
environment names the worker: ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT``, ``DMLC_RANK`` (`launch.py` sets them).
"""
from __future__ import annotations

import os
import pickle
import zlib

import numpy as _np

from ..base import MXNetError
from ..kvstore import KVStoreDevice, _normalize, _normalize_push, _key
from ..resilience import CircuitBreaker, ServerLostError
from .transport import Channel, loads_port_blob

__all__ = ["KVStoreDist"]


def _check(reply):
    if "error" in reply:
        raise MXNetError(reply["error"])
    return reply


class KVStoreDist(KVStoreDevice):
    def __init__(self, kind="dist_sync"):
        super().__init__(kind)
        from .. import config as _config
        self._sync = "async" not in kind
        if self._sync and _config.get("MXNET_KVSTORE_COLLECTIVE"):
            raise MXNetError(
                f"kvstore {kind!r} with MXNET_KVSTORE_COLLECTIVE=1 asks for "
                "the collective data plane (the JAX package's all-reduce "
                "over jax.distributed); the port has no such plane yet — "
                "its NCCL counterpart is not ported, and NCCL refuses two "
                "ranks on one card.  Unset it (or set 0) for the "
                "parameter server's socket plane")
        host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", 9091))
        self._chan = Channel(host, port)
        self._chans = [self._chan]
        env_rank = os.environ.get("DMLC_RANK")
        self._epoch = int(_config.get("MXNET_SUPERVISOR_EPOCH"))
        reply = _check(self._chan.request(
            {"cmd": "register", "role": "worker", "epoch": self._epoch,
             "rank": int(env_rank) if env_rank is not None else None}))
        self._rank = reply["rank"]
        self._num_workers = reply["num_workers"]
        self._num_servers = int(reply.get("num_servers", 1))
        if self._num_servers > 1:
            srv = _check(self._chan.request({"cmd": "server_list"}))
            self._chans += [Channel(h, p) for h, p in srv["servers"]]
        self._breakers = [
            CircuitBreaker(
                failure_threshold=int(_config.get(
                    "MXNET_PS_BREAKER_THRESHOLD")),
                reset_timeout=float(_config.get("MXNET_PS_BREAKER_RESET_S")))
            for _ in self._chans]

        def _rehandshake(chan, _rank=self._rank, _epoch=self._epoch):
            # a reconnected root channel re-registers under the same rank
            chan.bare_request({"cmd": "register", "role": "worker",
                               "rank": _rank, "epoch": _epoch})
        self._chan.on_reconnect = _rehandshake
        self._bigarray_bound = int(_config.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND"))
        self._push_count = {}    # (server, key) -> completed sync pushes
        self.wire_bytes = 0      # bytes of gradient payload pushed
        self._closed = False
        # route profiler(profile_process='server') commands through us
        from .. import profiler as _profiler
        _profiler.set_kvstore_handle(self)
        # telemetry plane: the dist retry counters under their own
        # namespace (the base class registers 'kvstore')
        from ..obs import metrics as _obs_metrics
        _obs_metrics.register_producer("kvstore.dist", self.stats)

    # -- identity ------------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    def server_addresses(self):
        """Every server's (host, port), root first."""
        return [(c.host, c.port) for c in self._chans]

    def embedding(self, name, num_rows, dim, **kwargs):
        """A `ShardedEmbedding` row-sharded over this store's servers."""
        from ..embedding import ShardedEmbedding
        return ShardedEmbedding(name, num_rows, dim,
                                self.server_addresses(), **kwargs)

    def stats(self):
        """Resends, stale replies dropped, each server's breaker, and the
        gradient bytes this worker pushed."""
        return {
            "resends": sum(c.resends for c in self._chans),
            "discarded_stale": sum(c.discarded_stale for c in self._chans),
            "wire_bytes": self.wire_bytes,
            "breakers": [
                {"server": i, "addr": f"{c.host}:{c.port}",
                 "state": b.state,
                 "consecutive_failures": b.consecutive_failures}
                for i, (c, b) in enumerate(zip(self._chans,
                                               self._breakers))],
        }

    # -- transport with failover ---------------------------------------------
    def _request(self, srv, msg):
        """One round trip to server `srv`; exhausted channel retries count
        against its breaker, and a tripped breaker (or a server that
        restarted empty) raises `ServerLostError`."""
        chan = self._chans[srv]
        breaker = self._breakers[srv]
        addr = f"{chan.host}:{chan.port}"
        if not breaker.allow():
            raise ServerLostError(
                srv, addr, keys=self._keys_on(srv),
                reason=f"circuit breaker is {breaker.state} after "
                       f"{breaker.failure_threshold} consecutive failures")
        framed = False
        while True:
            try:
                # a retry resends the same frame (same seq): a server
                # that applied it replays its cached reply
                reply = chan.resend_last() if framed else chan.request(msg)
                break
            except TimeoutError as e:
                framed = True
                if breaker.record_failure():
                    raise ServerLostError(
                        srv, addr, keys=self._keys_on(srv),
                        reason=f"unresponsive during {msg.get('cmd')!r}: "
                               f"{breaker.failure_threshold} consecutive "
                               f"timeouts ({e})") from e
            except (ConnectionError, EOFError, OSError) as e:
                framed = True
                if breaker.record_failure():
                    raise ServerLostError(
                        srv, addr, keys=self._keys_on(srv),
                        reason=f"unreachable during {msg.get('cmd')!r} "
                               f"after {breaker.failure_threshold} "
                               f"consecutive failures "
                               f"({type(e).__name__}: {e})") from e
        if "error" in reply:
            err = reply["error"]
            k = msg.get("key")
            if "has not been initialized" in err and k is not None \
                    and k in self._store:
                breaker.record_failure()
                raise ServerLostError(
                    srv, addr, keys=self._keys_on(srv),
                    reason=f"server restarted without state ({err})")
            breaker.record_success()
            raise MXNetError(err)
        breaker.record_success()
        return reply

    def _keys_on(self, srv):
        out = []
        for sk, v in self._store.items():
            if any(s == srv for s, _ in self._shards(sk, v.size)):
                out.append(sk)
        return out

    def _shards(self, sk, size):
        """[(server, slice of the flat value)] of a key: whole on one
        server up to the bound, else one contiguous range per server."""
        n = len(self._chans)
        if n == 1 or size <= self._bigarray_bound:
            srv = int(sk) % n if str(sk).isdigit() else \
                zlib.crc32(str(sk).encode()) % n
            return [(srv, slice(0, size))]
        bounds = [size * i // n for i in range(n + 1)]
        return [(i, slice(bounds[i], bounds[i + 1])) for i in range(n)]

    # -- data plane ----------------------------------------------------------
    def init(self, key, value):
        """Rank 0 ships the initial values to the owning servers; every
        worker barriers, then keeps a local copy (its shape routes pulls)."""
        keys, values = _normalize(key, value)
        if self._rank == 0:
            for k, v in zip(keys, values):
                sk = _key(k)
                flat = v.asnumpy().reshape(-1)
                for srv, sl in self._shards(sk, flat.size):
                    self._request(srv, {"cmd": "init", "keys": [sk],
                                        "values": [flat[sl]]})
        self._barrier()
        for k, v in zip(keys, values):
            self._store[_key(k)] = v.copyto(self._store_ctx)

    def push(self, key, value, priority=0):
        from .compression import pack_2bit
        keys, values = _normalize_push(key, value)
        for k, vals in zip(keys, values):
            sk = _key(k)
            if sk not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
            merged = self._reduce_compress(sk, vals)
            flat = merged.asnumpy().reshape(-1)
            for srv, sl in self._shards(sk, flat.size):
                part = flat[sl]
                if self._compression is not None:
                    # 4 codes a byte: 16x fewer bytes than fp32
                    wire = pack_2bit(part, self._compression["threshold"])
                    self.wire_bytes += wire["packed2bit"].nbytes
                else:
                    wire = part
                    self.wire_bytes += part.nbytes
                self._request(srv, {"cmd": "push", "key": sk,
                                    "value": wire, "sync": self._sync,
                                    "rank": self._rank})
                if self._sync:
                    ck = (srv, sk)
                    self._push_count[ck] = self._push_count.get(ck, 0) + 1

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """The servers' value of each key (a sync pull waits for the
        rounds this worker pushed into), into every out array."""
        if out is None:
            raise MXNetError("pull requires out=")
        keys, outs = _normalize_push(key, out)
        for k, tgt_list in zip(keys, outs):
            sk = _key(k)
            src = self._store.get(sk)
            if src is None:
                raise MXNetError(
                    f"pull({k}): key was never initialized on this worker")
            parts = []
            for srv, _ in self._shards(sk, src.size):
                reply = self._request(
                    srv, {"cmd": "pull", "key": sk,
                          "min_version": self._push_count.get((srv, sk), 0)})
                parts.append(_np.asarray(reply["value"]).reshape(-1))
            value = _np.concatenate(parts) if len(parts) > 1 else parts[0]
            if value.size != src.size:
                raise MXNetError(
                    f"pull({k}): servers returned {value.size} elements, "
                    f"local copy has {src.size} — worker/server shapes "
                    "disagree (inconsistent init?)")
            # a writable copy: the reply's buffer is read-only
            src._set_data(_np.array(value.reshape(src.shape),
                                    dtype=src.dtype))
            for tgt in tgt_list:
                src.copyto(tgt)

    # -- control plane -------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Rank 0 ships the pickled optimizer to every server, which then
        runs the update (reference `kvstore.py:535`); everyone barriers."""
        self._optimizer = optimizer
        if self._rank == 0:
            blob = pickle.dumps(optimizer)
            for srv in range(len(self._chans)):
                self._request(srv, {"cmd": "set_optimizer",
                                    "optimizer": blob})
        self._barrier()

    def get_optimizer_states(self, dump_optimizer=False):
        """Every server's optimizer states, one blob (each server owns
        the states of its key ranges)."""
        blobs = {}
        for srv in range(len(self._chans)):
            reply = self._request(srv, {"cmd": "get_optimizer_states",
                                        "dump_optimizer": dump_optimizer})
            blobs[srv] = reply.get("states")
        if all(b is None for b in blobs.values()):
            raise MXNetError(
                "get_optimizer_states: no optimizer is installed on any "
                "parameter server (call set_optimizer first)")
        return pickle.dumps({"dist_server_states": blobs}, protocol=4)

    def set_optimizer_states(self, blob):
        """Restore a `get_optimizer_states` blob: rank 0 sends each server
        its states, then everyone barriers."""
        payload = loads_port_blob(blob) if isinstance(blob, bytes) \
            else blob
        if not (isinstance(payload, dict) and
                "dist_server_states" in payload):
            raise MXNetError("set_optimizer_states: not a dist store's "
                             "blob (get_optimizer_states of a dist store)")
        if self._rank == 0:
            for srv, states in payload["dist_server_states"].items():
                if states is not None:
                    self._request(int(srv), {"cmd": "set_optimizer_states",
                                             "states": states})
        self._barrier()

    def server_metrics(self):
        """Each server's counters from its ``metrics`` scrape: pushes,
        pulls, rounds, optimizer updates and their ms (the server's
        ``ps.<port>`` producer, the prefix taken off)."""
        out = []
        for srv, chan in enumerate(self._chans):
            values = self._request(srv, {"cmd": "metrics"})["values"]
            pfx = f"ps.{chan.port}."
            out.append({k[len(pfx):]: v for k, v in values.items()
                        if k.startswith(pfx)})
        return out

    def server_profiler_command(self, action, **kw):
        """Drive every parameter server's profiler (reference
        `mx.profiler.set_config/set_state/dump(profile_process='server')`
        forwarded through MXKVStoreSendCommmandToServers).  Every server
        is attempted; the failures are raised together."""
        errors = []
        for i, chan in enumerate(self._chans):
            try:
                _check(chan.request(dict({"cmd": "profiler",
                                          "action": action}, **kw)))
            except Exception as e:
                errors.append(f"server {i}: {e}")
        if errors:
            raise MXNetError("server profiler command failed on: " +
                             "; ".join(errors))

    def _barrier(self):
        _check(self._chan.request({"cmd": "barrier"}))

    def close(self, send_stop=True):
        """Close every server channel; ``send_stop`` counts this worker as
        done on each server (a server stops once every worker is)."""
        if self._closed:
            return
        self._closed = True
        from .. import profiler as _profiler
        if _profiler._kvstore_handle[0] is self:
            _profiler.set_kvstore_handle(None)
        for chan in self._chans:
            if send_stop:
                try:
                    chan.bare_request({"cmd": "stop"})
                except Exception:
                    pass
            try:
                chan.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
