"""Worker-side distributed KVStore (reference `src/kvstore/kvstore_dist.h`).

PyTorch port of `incubator_mxnet_tpu/dist/kvstore_dist.py`, with its two
data planes.

**The collective plane** (``dist_sync`` with more than one worker and
``MXNET_KVSTORE_COLLECTIVE`` on, the default as in the JAX package): the
gradients never reach the parameter server.  Each worker sums its
contexts' values of a key, then the workers all-reduce them over a
`torch.distributed` group (`collective`, gloo where ranks share a card,
NCCL where each has its own): a batched push is ONE collective per dtype
bucket (flatten, concatenate, all-reduce, split; `_CollectivePlane`),
2-bit compressed gradients cross as bfloat16 where that is exact
(`_wire_dtype`), and the optimizer runs on every worker alike on the
all-reduced gradient.  `init` sends rank 0's value out by an all-reduce
to which the others add zeros, so every worker starts from the same
bits.  The server keeps registration, barriers and membership.  Where
the group cannot form, the store warns and uses the server, as the JAX
store does.

**The socket plane** (``MXNET_KVSTORE_COLLECTIVE=0``, ``dist_async``, or
one worker): the per-context values of a key are summed on the worker
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
naming the server and the keys it owned; a request released by a shrink
of the pod (the server's "epoch fenced" reply) raises
`CollectiveTimeoutError`, the signal `Module.fit` shrinks and resumes
on.  Push, pull and the barrier run under the active `JobSupervisor`'s
watchdog (`resilience.supervisor.supervised`).

The tracker's environment names the worker: ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT``, ``DMLC_RANK`` (`launch.py` sets them).
"""
from __future__ import annotations

import os
import pickle
import zlib

import numpy as _np

import torch

from ..base import MXNetError
from ..context import cpu, gpu, num_gpus
from ..kvstore import (KVStore, KVStoreDevice, _normalize, _normalize_push,
                       _key, _updater_key)
from ..ndarray.ndarray import NDArray
from ..resilience import CircuitBreaker, ServerLostError
from ..resilience import faults as _faults
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
        # the collective data plane: sync mode only (async semantics need
        # a mailbox, which is the server)
        self._collective = None
        if self._sync and self._num_workers > 1 and \
                _config.get("MXNET_KVSTORE_COLLECTIVE"):
            try:
                self._collective = _CollectivePlane(self._rank,
                                                    self._num_workers)
            except Exception as e:
                import logging
                logging.getLogger(__name__).warning(
                    "collective data plane unavailable (%s); gradients go "
                    "through the parameter server", str(e)[:200])
            else:
                # the store, the all-reduce and the optimizer on the card
                # the group drives (NCCL: card r for rank r)
                self._store_ctx = gpu(torch.cuda.current_device()) \
                    if num_gpus() > 0 else cpu(0)

    # -- identity ------------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    @property
    def prefers_batched_push(self):
        """A batched push rides one collective per dtype bucket."""
        return self._collective is not None

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
            "collective_dispatches": None if self._collective is None
            else self._collective.dispatch_count,
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
                _faults.note("retry", site="kvstore", server=srv,
                             cmd=msg.get("cmd"), error="timeout")
            except (ConnectionError, EOFError, OSError) as e:
                framed = True
                if breaker.record_failure():
                    raise ServerLostError(
                        srv, addr, keys=self._keys_on(srv),
                        reason=f"unreachable during {msg.get('cmd')!r} "
                               f"after {breaker.failure_threshold} "
                               f"consecutive failures "
                               f"({type(e).__name__}: {e})") from e
                _faults.note("reconnect", site="kvstore", server=srv,
                             cmd=msg.get("cmd"))
        if "error" in reply:
            err = reply["error"]
            if "epoch fenced" in err:
                # a shrink committed while this request waited: the
                # recoverable signal fit's restart loop shrinks on
                from ..resilience.supervisor import CollectiveTimeoutError
                breaker.record_success()   # the server is alive and sane
                raise CollectiveTimeoutError(
                    f"kvstore.{msg.get('cmd')}", axis="workers",
                    detail=err)
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
    def _supervised(self, name, fn):
        """Run a blocking cross-worker exchange under the active
        `JobSupervisor`'s watchdog (a plain call when none is active):
        a round a dead worker never joins becomes a
        `CollectiveTimeoutError` naming it instead of a hang."""
        from ..resilience.supervisor import supervised
        return supervised(name, fn, axis="workers")

    def init(self, key, value):
        """Rank 0 ships the initial values to the owning servers; every
        worker barriers, then keeps a local copy (its shape routes pulls).
        On the collective plane the local copy is rank 0's value, sent
        out by an all-reduce to which the other ranks add zeros."""
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
            if self._collective is not None:
                dev = self._store_ctx.torch_device
                src = v.data.detach().to(dev, copy=True) \
                    if self._rank == 0 else \
                    torch.zeros(v.shape, dtype=v.data.dtype, device=dev)
                self._store[_key(k)] = NDArray(
                    self._collective.allreduce(src), ctx=self._store_ctx)
            else:
                self._store[_key(k)] = v.copyto(self._store_ctx)

    def _wire_dtype(self, merged_dtype):
        """The all-reduce's dtype for compressed gradients.  Quantized
        terms are {-t, 0, +t} and partial sums k*t with |k| <= workers;
        bfloat16 (8 significand bits) keeps every k*t exact only when t's
        significand is one bit (a power of two) and k <= 256, so outside
        that the merged dtype crosses (the JAX package's rule)."""
        import math
        thr = float(self._compression.get("threshold", 0.5))
        frac = math.frexp(abs(thr))[0] if thr else 0.5
        if self._num_workers <= 256 and frac == 0.5:
            return torch.bfloat16
        return merged_dtype

    def _collective_push_batch(self, keys, values):
        """Sync push on the collective plane: the local reduce per key,
        then ONE all-reduce per dtype bucket over the flattened keys (one
        collective a step instead of one a parameter); the optimizer,
        when set, updates every worker's copy alike.  No gradient byte
        reaches a server."""
        sks, merged, dtypes = [], [], []
        dev = self._store_ctx.torch_device
        for k, vals in zip(keys, values):
            sk = _key(k)
            if sk not in self._store:
                raise MXNetError(f"Key {k} has not been initialized")
            m = self._reduce_compress(sk, vals).data.to(dev)
            if self._compression is not None:
                dtypes.append(m.dtype)
                m = m.to(self._wire_dtype(m.dtype))
            else:
                dtypes.append(None)
            merged.append(m)
            sks.append(sk)
        summed = [NDArray(out if dt is None else out.to(dt),
                          ctx=self._store_ctx)
                  for out, dt in zip(self._collective.allreduce_many(merged),
                                     dtypes)]
        if self._updater is not None:
            # every worker applies the same update to the same gradient
            self._updater.update_multi([_updater_key(sk) for sk in sks],
                                       summed,
                                       [self._store[sk] for sk in sks])
        else:
            self._store.update(zip(sks, summed))

    def push(self, key, value, priority=0):
        keys, values = _normalize_push(key, value)
        if self._collective is not None:
            self._supervised(
                "kvstore.push",
                lambda: self._collective_push_batch(keys, values))
            return
        self._supervised("kvstore.push",
                         lambda: self._socket_push(keys, values))

    def _socket_push(self, keys, values):
        from .compression import pack_2bit
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
        rounds this worker pushed into), into every out array; on the
        collective plane, the local copy the all-reduce left."""
        if out is None:
            raise MXNetError("pull requires out=")
        self._supervised("kvstore.pull", lambda: self._pull_impl(key, out))

    def _pull_impl(self, key, out):
        keys, outs = _normalize_push(key, out)
        if self._collective is not None:
            KVStore.pull(self, keys, out=outs)
            return
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
        runs the update (reference `kvstore.py:535`); everyone barriers.
        On the collective plane no server sees a gradient: every worker
        runs the optimizer alike on the all-reduced gradient."""
        self._optimizer = optimizer
        if self._collective is not None:
            from .. import optimizer as _opt
            self._updater = _opt.get_updater(optimizer)
            self._barrier()
            return
        if self._rank == 0:
            blob = pickle.dumps(optimizer)
            for srv in range(len(self._chans)):
                self._request(srv, {"cmd": "set_optimizer",
                                    "optimizer": blob})
        self._barrier()

    def get_optimizer_states(self, dump_optimizer=False):
        """Every server's optimizer states, one blob (each server owns
        the states of its key ranges); on the collective plane the local
        updater's, which every worker holds alike."""
        if self._updater is not None:
            return self._updater.get_states(dump_optimizer=dump_optimizer)
        blobs = {}
        for srv in range(len(self._chans)):
            reply = self._request(srv, {"cmd": "get_optimizer_states",
                                        "dump_optimizer": dump_optimizer})
            blobs[srv] = reply.get("states")
            if blobs[srv] is None and self._optimizer is not None:
                # this worker shipped an optimizer the server no longer
                # has: it restarted empty, its states are gone
                chan = self._chans[srv]
                self._breakers[srv].record_failure()
                raise ServerLostError(
                    srv, f"{chan.host}:{chan.port}",
                    keys=self._keys_on(srv),
                    reason="server restarted without its optimizer")
        if all(b is None for b in blobs.values()):
            raise MXNetError(
                "get_optimizer_states: no optimizer is installed on any "
                "parameter server (call set_optimizer first)")
        return pickle.dumps({"dist_server_states": blobs}, protocol=4)

    def set_optimizer_states(self, blob):
        """Restore a `get_optimizer_states` blob: rank 0 sends each server
        its states, then everyone barriers; a worker-side blob loads into
        the local updater."""
        payload = loads_port_blob(blob) if isinstance(blob, bytes) \
            else blob
        if isinstance(payload, dict) and "dist_server_states" in payload:
            if self._rank == 0:
                for srv, states in payload["dist_server_states"].items():
                    if states is not None:
                        self._request(int(srv),
                                      {"cmd": "set_optimizer_states",
                                       "states": states})
            self._barrier()
            return
        if self._updater is None:
            raise MXNetError(
                "set_optimizer_states: blob holds worker-side updater "
                "state but this store has no local updater (collective "
                "mode not engaged?)")
        KVStore.set_optimizer_states(self, blob)

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
        self._supervised(
            "kvstore.barrier",
            lambda: _check(self._chan.request({"cmd": "barrier"})))

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


class _CollectivePlane:
    """The all-reduce over one `torch.distributed` group of the worker
    processes (`collective.init_process_group`).  `allreduce` sums a
    tensor across the workers; `allreduce_many` sums a list with ONE
    collective per dtype bucket (flatten, concatenate, all-reduce,
    split), as the reference batches its NCCL pushes (`model.py:125`).
    ``dispatch_count`` counts the collectives issued; ``timings`` keeps
    the last 64 as (bytes, seconds), each timed to its completion."""

    def __init__(self, rank, num_workers):
        from . import collective
        joined = collective.init_process_group(num_processes=num_workers,
                                               process_id=rank)
        if joined[1] != num_workers or joined[2] != rank:
            raise RuntimeError(
                f"joined group {joined} is not rank {rank} of "
                f"{num_workers} (shut the old group down first)")
        self._pg = collective.process_group()
        self.backend = collective.backend()
        self.dispatch_count = 0
        self.timings = []

    def allreduce(self, t):
        """`t` summed over the workers: a new tensor on `t`'s device."""
        import time
        out = t.detach().contiguous().clone()
        cuda = out.is_cuda
        if cuda:
            torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
        self.dispatch_count += 1
        self._pg.allreduce([out]).wait()
        if cuda:
            torch.cuda.synchronize(out.device)
        self.timings.append((out.numel() * out.element_size(),
                             time.perf_counter() - t0))
        del self.timings[:-64]
        return out

    def allreduce_many(self, arrs):
        """Each tensor of `arrs` summed over the workers, one collective
        per dtype: ``[flat_0 | flat_1 | ...]`` all-reduced, then split
        back into the tensors' shapes."""
        if len(arrs) == 1:
            return [self.allreduce(arrs[0])]
        by_dtype = {}
        for i, a in enumerate(arrs):
            by_dtype.setdefault(a.dtype, []).append(i)
        out = [None] * len(arrs)
        for idxs in by_dtype.values():
            dev = arrs[idxs[0]].device
            bucket = torch.cat([arrs[i].detach().reshape(-1).to(dev)
                                for i in idxs])
            summed = self.allreduce(bucket)
            pieces = torch.split(summed, [arrs[i].numel() for i in idxs])
            for i, piece in zip(idxs, pieces):
                out[i] = piece.view(arrs[i].shape)
        return out
