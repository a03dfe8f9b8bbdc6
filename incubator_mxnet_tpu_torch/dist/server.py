"""Parameter-server process (reference `src/kvstore/kvstore_dist_server.h`).

PyTorch port of `incubator_mxnet_tpu/dist/server.py`, on the same wire
(`transport`): it holds the authoritative copy of its keys (or key
ranges), merges sync pushes from every worker into versioned rounds,
applies pushes at once in async mode, runs the optimizer the workers
ship (`set_optimizer`), answers versioned pulls, barriers, the elastic
membership commands (``hb``, ``members``, ``shrink``), the secondary
servers' registration, and the sharded embedding table's
``embed_init`` / ``embed_pull`` / ``embed_push`` (lazy row-sparse
updates of the touched rows only, `optimizer.py`).  The root server
doubles as the scheduler: secondary servers register their address
there and workers fetch the list.

The server is the host tier: its arrays are numpy, its optimizer runs on
the CPU (the port's `optimizer` on CPU tensors that share the numpy
memory).  A pickled optimizer or optimizer state is unpickled through an
allowlist (`transport.loads_port_blob`): the port's optimizer and
schedule classes, its arrays and numpy's; a blob from the JAX package is
refused, never unpickled into it.  ``MXNET_PS_HMAC_KEY`` is the guard
against an untrusted peer.  ``metrics`` answers this process's telemetry
registry (`obs.scrape.metrics_reply`), as the JAX server does; the
server's own counters (pushes, pulls, rounds applied, optimizer updates
and their time) are its producer under ``ps.<port>``, which the JAX
server does not register.  ``profiler`` drives the port's `profiler` in
this process.  Every command runs inside a ``server.<cmd>`` span that
adopts the request frame's trace context, after the ``server.dispatch``
fault site (a ``crash`` clause kills the server in place).

Sync semantics (``dist_sync``): each key carries a version, the number
of completed rounds; a worker's n-th push joins round n, which applies
when every worker's push arrived; a pull waits until the version reaches
the puller's own completed pushes.  Async (``dist_async``): every push
applies at once.
"""
from __future__ import annotations

import os
import pickle
import socket
import socketserver
import threading
import time

import numpy as np

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..obs.scrape import metrics_reply
from ..resilience import faults as _faults
from .membership import MembershipTable
from .transport import loads_port_blob, recv_msg, send_msg

__all__ = ["ParameterServer", "register_with_root", "main"]

# idempotent reads: a resend re-executes them (no reply cache)
_READ_CMDS = frozenset({"pull", "server_list", "get_optimizer_states",
                        "hb", "members", "metrics", "embed_pull"})
_SERVER_WAIT_S = 300


def _writable(a, dtype=None):
    """A C-contiguous writable copy (wire arrays are read-only views)."""
    return np.array(a, dtype=dtype, copy=True, order="C")


class _State:
    def __init__(self, num_workers, num_servers=1):
        self.num_workers = num_workers
        self.num_servers = num_servers
        self.cond = threading.Condition()
        self.store = {}          # key -> np.ndarray (writable, C order)
        self.version = {}        # key -> completed rounds
        # key -> open rounds, each {"sum": array, "got": set(ranks)}: a
        # worker's n-th push joins round n (ps-lite timestamps)
        self.agg = {}
        self.updater = None
        self.barrier_count = 0
        self.barrier_gen = 0
        self.next_rank = 0
        self.stopped = 0
        self.servers = {}        # server id (>= 1) -> (host, port)
        # at-most-once shell: each client's last few (seq -> reply)
        self.client_replies = {}
        self.client_inflight = set()   # (client, seq) being processed
        self.crashed = False
        self.membership = None
        self.epoch = 0
        # sharded embedding tier: table -> {"rows": np [local, dim], the
        # shard's ids ("range": row_start/row_end; "set": ids, id_pos),
        # "version", "pushed", "pulled"}
        self.embed = {}
        self.counters = {"pushes": 0, "pulls": 0, "rounds": 0,
                         "updates": 0, "update_s": 0.0,
                         "embed_pushes": 0, "embed_pulls": 0}


class ParameterServer:
    """Threaded TCP parameter server; one handler thread per connection."""

    def __init__(self, host="127.0.0.1", port=0, num_workers=None,
                 num_servers=None):
        self.num_workers = int(num_workers if num_workers is not None
                               else os.environ.get("DMLC_NUM_WORKER", 1))
        self.num_servers = int(num_servers if num_servers is not None
                               else os.environ.get("DMLC_NUM_SERVER", 1))
        self._state = _State(self.num_workers, self.num_servers)
        state = self._state
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)

            def handle(self):
                while True:
                    try:
                        msg = recv_msg(self.request)
                    except (EOFError, ConnectionError, OSError):
                        break
                    if state.crashed:
                        break     # a "dead" server closes without reply
                    try:
                        reply = outer._handle(msg)
                    except _faults.FaultInjected as exc:
                        if exc.kind == "crash":
                            outer._simulate_crash()
                        break     # the connection dies mid-request
                    except (ConnectionError, OSError):
                        break
                    except Exception as exc:
                        # a dispatch failure becomes an error reply: a
                        # handler dying with no reply would wedge the
                        # worker
                        reply = {"error": f"server dispatch failed: "
                                          f"{exc!r}",
                                 "seq": msg.get("seq")}
                    try:
                        send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        break
                    if msg.get("cmd") == "stop":
                        break

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        try:
            self._server = Server((host, port), Handler)
        except OSError as e:
            # never widen the bind surface on our own: the transport
            # carries pickle
            raise OSError(
                f"parameter server cannot bind {host}:{port} ({e}). Set "
                "DMLC_PS_ROOT_URI to an address bindable on this machine, "
                "or 0.0.0.0 explicitly if you mean all interfaces.") from e
        self.port = self._server.server_address[1]
        self._thread = None
        self.namespace = f"ps.{self.port}"
        _obs_metrics.register_producer(self.namespace, self.stats)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mx-ps-server")
        self._thread.start()
        return self

    def serve_forever(self):
        """Serve until every worker has sent ``stop``."""
        if self._thread is None:
            self.start()
        st = self._state
        with st.cond:
            st.cond.wait_for(lambda: st.stopped >= st.num_workers)
        self.shutdown()

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        _obs_metrics.unregister_producer(self.namespace)

    def _simulate_crash(self):
        """Die in place: refuse new connections and close every live one
        at its next request (the process-kill failure mode, in-process)."""
        st = self._state
        with st.cond:
            if st.crashed:
                return
            st.crashed = True
            st.cond.notify_all()
        threading.Thread(target=self.shutdown, daemon=True,
                         name="mx-ps-crash-shutdown").start()

    def stats(self):
        """The server's counters (what ``metrics`` answers)."""
        st = self._state
        with st.cond:
            out = dict(st.counters)
            out["keys"] = len(st.store)
            out["tables"] = len(st.embed)
        out["update_ms"] = 1e3 * out["update_s"] / max(out["updates"], 1)
        return out

    # -- request dispatch ----------------------------------------------------
    def _handle(self, msg):
        """The at-most-once shell around `_dispatch`: a resent (client,
        seq) replays its cached reply, and `seq` is echoed."""
        st = self._state
        client, seq = msg.get("client"), msg.get("seq")
        cmd = msg.get("cmd")

        def _cached():
            cache = st.client_replies.get(client)
            if cache is not None and seq in cache:
                return dict(cache[seq], seq=seq, duplicate=True)
            return None

        dedup = client is not None and seq is not None \
            and cmd not in _READ_CMDS
        if dedup:
            with st.cond:
                dup = _cached()
                if dup is not None:
                    return dup
                if (client, seq) in st.client_inflight:
                    # the dropped connection's handler still runs it
                    from .. import config as _config
                    st.cond.wait_for(
                        lambda: (client, seq) not in st.client_inflight,
                        timeout=float(
                            _config.get("MXNET_PS_REQUEST_TIMEOUT")))
                    dup = _cached()
                    if dup is not None:
                        return dup
                    return {"error": f"request seq {seq} is still in "
                                     "flight on another connection",
                            "seq": seq}
                st.client_inflight.add((client, seq))
        reply = None
        try:
            # the cross-process trace edge: the handling span adopts the
            # frame's ``tr`` context
            _faults.fire("server.dispatch", cmd=cmd)
            with _obs_trace.server_span(msg, f"server.{cmd}",
                                        cat="kvstore"):
                reply = self._dispatch(msg)
        finally:
            if dedup:
                with st.cond:
                    if reply is not None:
                        cache = st.client_replies.setdefault(client, {})
                        cache[seq] = reply
                        while len(cache) > 4:
                            del cache[min(cache)]
                    st.client_inflight.discard((client, seq))
                    st.cond.notify_all()
        if isinstance(reply, dict) and seq is not None:
            reply["seq"] = seq
        return reply

    def _membership(self):
        st = self._state
        with st.cond:
            if st.membership is None:
                from .. import config as _config
                st.membership = MembershipTable(
                    st.num_workers,
                    deadline_s=float(
                        _config.get("MXNET_SUPERVISOR_DEADLINE_S")))
                st.membership.epoch = st.epoch
            return st.membership

    def _reset_world(self, result):
        """Shrink commit: the new epoch starts from a clean store."""
        st = self._state
        with st.cond:
            st.epoch = result["epoch"]
            st.num_workers = result["world_size"]
            st.store.clear()
            st.version.clear()
            st.agg.clear()
            st.barrier_count = 0
            st.barrier_gen += 1
            st.next_rank = 0
            st.client_replies.clear()
            st.cond.notify_all()

    def _dispatch(self, msg):
        cmd = msg.get("cmd")
        handler = getattr(self, "_cmd_" + str(cmd), None)
        if handler is None:
            return {"error": f"unknown command {cmd!r}"}
        return handler(msg)

    # -- membership and control ----------------------------------------------
    def _cmd_register(self, msg):
        st = self._state
        if st.membership is not None:
            stale = st.membership.check_epoch(msg.get("epoch", 0))
            if stale is not None and msg.get("role") == "worker":
                return stale
        with st.cond:
            rank = msg.get("rank")
            if rank is None:
                rank = st.next_rank
            st.next_rank = max(st.next_rank, rank + 1)
        return {"rank": rank, "num_workers": st.num_workers,
                "num_servers": st.num_servers, "epoch": st.epoch}

    def _cmd_hb(self, msg):
        return self._membership().heartbeat(
            msg["rank"], msg.get("epoch", 0), step=msg.get("step"),
            step_time=msg.get("step_time"))

    def _cmd_metrics(self, msg):
        # the scrape plane: this process's registry snapshot, this
        # server's counters under its ``ps.<port>`` namespace among them
        return metrics_reply()

    def _cmd_members(self, msg):
        return {"ok": True, "view": self._membership().view()}

    def _cmd_shrink(self, msg):
        from .. import config as _config
        # the barrier outlasts a peer whose collective watchdog has not
        # fired yet
        deadline = max(
            float(_config.get("MXNET_SUPERVISOR_SHRINK_BARRIER_S")),
            float(_config.get("MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S"))
            + 2 * float(_config.get("MXNET_SUPERVISOR_DEADLINE_S")))
        return self._membership().propose_shrink(
            msg["rank"], msg.get("epoch", 0), deadline_s=deadline,
            on_commit=self._reset_world)

    def _cmd_register_server(self, msg):
        st = self._state
        with st.cond:
            st.servers[int(msg["server_id"])] = (msg["host"],
                                                 int(msg["port"]))
            st.cond.notify_all()
        return {"ok": True}

    def _cmd_server_list(self, msg):
        st = self._state
        want = set(range(1, st.num_servers))
        with st.cond:
            if not st.cond.wait_for(lambda: want <= set(st.servers),
                                    timeout=_SERVER_WAIT_S):
                missing = sorted(want - set(st.servers))
                return {"error": "timed out waiting for secondary "
                                 f"server id(s) {missing} to register "
                                 "(launch them with DMLC_SERVER_ID in "
                                 f"1..{st.num_servers - 1})"}
            return {"servers": [list(st.servers[i])
                                for i in range(1, st.num_servers)],
                    "num_servers": st.num_servers}

    def _cmd_barrier(self, msg):
        st = self._state
        with st.cond:
            st.barrier_count += 1
            gen = st.barrier_gen
            if st.barrier_count >= st.num_workers:
                st.barrier_count = 0
                st.barrier_gen += 1
                st.cond.notify_all()
            elif not st.cond.wait_for(lambda: st.barrier_gen > gen,
                                      timeout=_SERVER_WAIT_S):
                # withdraw, and fail loudly: a missing worker must not
                # let the others pass
                st.barrier_count -= 1
                return {"error": "barrier timed out waiting for all "
                                 "workers"}
        return {"ok": True}

    def _cmd_stop(self, msg):
        st = self._state
        with st.cond:
            st.stopped += 1
            st.cond.notify_all()
        return {"ok": True}

    # -- dense keys ------------------------------------------------------------
    def _cmd_init(self, msg):
        st = self._state
        with st.cond:
            for k, v in zip(msg["keys"], msg["values"]):
                if k not in st.store:
                    st.store[k] = _writable(v)
                    st.version[k] = 0
            st.cond.notify_all()
        return {"ok": True}

    def _cmd_push(self, msg):
        from .compression import is_packed, unpack_2bit
        st = self._state
        raw = msg["value"]
        v = unpack_2bit(raw) if is_packed(raw) else np.asarray(raw)
        k, rank = msg["key"], msg.get("rank", 0)
        with st.cond:
            if k not in st.store:
                return {"error": f"Key {k} has not been initialized"}
            st.counters["pushes"] += 1
            if msg["sync"]:
                rounds = st.agg.setdefault(k, [])
                ent = next((r for r in rounds if rank not in r["got"]),
                           None)
                if ent is None:
                    ent = {"sum": np.zeros_like(st.store[k],
                                                dtype=v.dtype),
                           "got": set()}
                    rounds.append(ent)
                ent["sum"] = ent["sum"] + v
                ent["got"].add(rank)
                # apply the completed rounds in order from the head
                while rounds and len(rounds[0]["got"]) >= st.num_workers:
                    self._apply(k, rounds.pop(0)["sum"])
                    st.version[k] += 1
                    st.cond.notify_all()
                if not rounds:
                    del st.agg[k]
            else:
                self._apply(k, v)
                st.version[k] += 1
                st.cond.notify_all()
            return {"version": st.version[k]}

    def _cmd_pull(self, msg):
        st = self._state
        k = msg["key"]
        min_version = msg.get("min_version", 0)
        with st.cond:
            if k not in st.store:
                return {"error": f"Key {k} has not been initialized"}
            epoch0 = st.epoch
            ok = st.cond.wait_for(
                lambda: st.version.get(k, 0) >= min_version
                or st.epoch != epoch0, timeout=_SERVER_WAIT_S)
            if st.epoch != epoch0:
                return {"error": f"epoch fenced: pull({k}) was waiting "
                                 f"across a shrink commit (epoch {epoch0} "
                                 f"-> {st.epoch}); re-register and resume "
                                 "from the checkpoint"}
            if not ok:
                return {"error": f"pull({k}) timed out waiting for "
                                 f"version {min_version}"}
            st.counters["pulls"] += 1
            # a copy: the reply is serialized after the lock is released,
            # while a later round may update the stored array in place
            return {"value": st.store[k].copy(), "version": st.version[k]}

    def _apply(self, k, merged):
        """Apply one completed round (lock held): the optimizer step on
        the stored weight in place, or store the sum for a worker-side
        update."""
        st = self._state
        st.counters["rounds"] += 1
        if st.updater is None:
            st.store[k] = _writable(merged)
            return
        import torch
        from ..ndarray.ndarray import NDArray
        stored = st.store[k]
        weight = NDArray(torch.from_numpy(stored))
        grad = NDArray(torch.from_numpy(_writable(merged, stored.dtype)))
        t0 = time.perf_counter()
        st.updater(int(k) if str(k).isdigit() else k, grad, weight)
        st.counters["update_s"] += time.perf_counter() - t0
        st.counters["updates"] += 1
        if weight.data.data_ptr() != stored.ctypes.data:
            st.store[k] = _writable(weight.asnumpy())

    # -- optimizer ----------------------------------------------------------
    def _cmd_set_optimizer(self, msg):
        from .. import optimizer as opt
        try:
            optimizer = loads_port_blob(msg["optimizer"])
        except pickle.UnpicklingError as e:
            return {"error": f"set_optimizer: {e}"}
        st = self._state
        with st.cond:
            st.updater = opt.get_updater(optimizer)
        return {"ok": True}

    def _cmd_get_optimizer_states(self, msg):
        st = self._state
        with st.cond:
            if st.updater is None:
                return {"states": None}
            return {"states": st.updater.get_states(
                dump_optimizer=bool(msg.get("dump_optimizer")))}

    def _cmd_set_optimizer_states(self, msg):
        st = self._state
        with st.cond:
            if st.updater is None:
                return {"error": "set_optimizer_states: no optimizer "
                                 "installed on this server (send "
                                 "set_optimizer first)"}
            try:
                states = loads_port_blob(msg["states"])
            except pickle.UnpicklingError as e:
                return {"error": f"set_optimizer_states: {e}"}
            st.updater.set_states(states)
        return {"ok": True}

    def _cmd_profiler(self, msg):
        """The port's `profiler` in this process (reference kvstore.py
        set_server_profiler_state/dump, forwarded by
        `KVStoreDist.server_profiler_command`): ``set_config``,
        ``set_state`` ("run"/"stop"), ``dump`` (its chrome trace to the
        configured file)."""
        from .. import profiler as _profiler
        action = msg.get("action")
        try:
            if action == "set_config":
                _profiler.set_config(**msg.get("config", {}))
            elif action == "set_state":
                _profiler.set_state(msg.get("state", "stop"))
            elif action == "dump":
                _profiler.dump()
            else:
                return {"error": f"unknown profiler action {action!r}"}
        except Exception as e:
            # every command replies: a raise would leave the worker
            # without an answer
            return {"error": f"server profiler {action} failed: {e!r}"}
        return {"ok": True, "state": _profiler.state()}

    # -- sharded embedding tier ----------------------------------------------
    def _cmd_embed_init(self, msg):
        """One row shard of a table: the rows this server owns (a range or
        an explicit id set), from values or a (seed, scale) recipe."""
        st = self._state
        table = msg["table"]
        with st.cond:
            dim = int(msg["dim"])
            dtype = np.dtype(msg.get("dtype", "float32"))
            if msg.get("ids") is not None:
                ids = np.asarray(msg["ids"], dtype=np.int64)
                ent = {"mode": "set", "ids": ids,
                       "id_pos": {int(i): p for p, i in enumerate(ids)}}
                n, seed_salt = len(ids), int(ids[0]) if len(ids) else 0
            else:
                lo, hi = int(msg["row_start"]), int(msg["row_end"])
                ent = {"mode": "range", "row_start": lo, "row_end": hi}
                n, seed_salt = hi - lo, lo
            old = st.embed.get(table)
            if old is not None:
                if (old["mode"] != ent["mode"]
                        or old["rows"].shape != (n, dim)
                        or (ent["mode"] == "range"
                            and (old["row_start"], old["row_end"])
                            != (ent["row_start"], ent["row_end"]))
                        or (ent["mode"] == "set"
                            and not np.array_equal(old["ids"],
                                                   ent["ids"]))):
                    return {"error": f"embed_init: table {table!r} "
                                     "already exists on this server "
                                     "with a different shard spec — "
                                     "refusing to keep stale rows "
                                     f"(have {old['rows'].shape}, "
                                     f"init asked for {(n, dim)})"}
                if msg.get("values") is None:
                    # same spec, no payload: an idempotent re-init
                    return {"ok": True, "rows": len(old["rows"]),
                            "version": old["version"]}
                # explicit values over an existing table: a restore
                old["rows"][...] = np.asarray(
                    msg["values"], dtype=old["rows"].dtype).reshape(n, dim)
                old["version"] += 1
                st.cond.notify_all()
                return {"ok": True, "rows": n, "version": old["version"]}
            if msg.get("values") is not None:
                rows = _writable(msg["values"], dtype)
            else:
                rng = np.random.default_rng(
                    [int(msg.get("seed", 0)), seed_salt])
                rows = (rng.standard_normal((n, dim))
                        * float(msg.get("scale", 0.01))).astype(dtype)
            ent.update(rows=rows, version=0, pushed=0, pulled=0)
            st.embed[table] = ent
            st.cond.notify_all()
        return {"ok": True, "rows": n, "version": 0}

    def _embed_local(self, table, ids):
        """(entry, local row positions) or an error reply."""
        ent = self._state.embed.get(table)
        if ent is None:
            return None, {"error": f"embedding table {table!r} has not "
                                   "been initialized on this server"}
        ids = np.asarray(ids, dtype=np.int64)
        if ent["mode"] == "range":
            local = ids - ent["row_start"]
            bad = (local < 0) | (local >= len(ent["rows"]))
            if bad.any():
                return None, {
                    "error": f"embedding table {table!r}: row "
                             f"{int(ids[bad][0])} is outside this shard's "
                             f"range [{ent['row_start']}, "
                             f"{ent['row_end']}) (worker/server partition "
                             "rules disagree)"}
            return ent, local
        pos = ent["id_pos"]
        try:
            return ent, np.fromiter((pos[int(i)] for i in ids),
                                    dtype=np.int64, count=len(ids))
        except KeyError as e:
            return None, {"error": f"embedding table {table!r}: row "
                                   f"{e.args[0]} is not owned by this "
                                   "shard (worker/server partition rules "
                                   "disagree)"}

    def _cmd_embed_pull(self, msg):
        st = self._state
        with st.cond:
            ent, local = self._embed_local(msg["table"], msg["ids"])
            if ent is None:
                return local
            ent["pulled"] += len(local)
            st.counters["embed_pulls"] += 1
            return {"values": ent["rows"][local], "version": ent["version"]}

    def _cmd_embed_push(self, msg):
        """Rows for unique ids: ``op="assign"`` overwrites them, else the
        installed optimizer's lazy row-sparse step updates only them.  The
        reply carries the rows after the update (the worker's cache
        refreshes from it)."""
        st = self._state
        table = msg["table"]
        with st.cond:
            ent, local = self._embed_local(table, msg["ids"])
            if ent is None:
                return local
            vals = np.asarray(msg["values"], dtype=ent["rows"].dtype)
            if msg.get("op") == "assign":
                ent["rows"][local] = vals
            elif st.updater is None:
                return {"error": f"embed_push({table!r}): no optimizer "
                                 "installed on this server (send "
                                 "set_optimizer first, or push with "
                                 "op='assign')"}
            else:
                import torch
                from ..ndarray.ndarray import NDArray
                from ..ndarray.sparse import RowSparseNDArray
                weight = NDArray(torch.from_numpy(ent["rows"]))
                grad = RowSparseNDArray(vals, local, ent["rows"].shape)
                t0 = time.perf_counter()
                st.updater(f"embed:{table}", grad, weight)
                st.counters["update_s"] += time.perf_counter() - t0
                st.counters["updates"] += 1
                if weight.data.data_ptr() != ent["rows"].ctypes.data:
                    ent["rows"] = _writable(weight.asnumpy())
            ent["pushed"] += len(local)
            ent["version"] += 1
            st.counters["embed_pushes"] += 1
            st.cond.notify_all()
            return {"ok": True, "version": ent["version"],
                    "values": ent["rows"][local]}


def register_with_root(root_host, root_port, server_id, host, port):
    """Announce a secondary server's address to the root server."""
    from .transport import Channel
    chan = Channel(root_host, root_port)
    try:
        reply = chan.request({"cmd": "register_server",
                              "server_id": int(server_id),
                              "host": host, "port": int(port)})
        if "error" in reply:
            raise RuntimeError(reply["error"])
    finally:
        chan.close()


def main():
    """``python -m incubator_mxnet_tpu_torch.dist.server``: the root
    server (``DMLC_SERVER_ID`` 0) on ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``,
    or a secondary one on any port, registered with the root."""
    server_id = int(os.environ.get("DMLC_SERVER_ID", 0))
    root_host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    root_port = int(os.environ.get("DMLC_PS_ROOT_PORT", 9091))
    if server_id == 0:
        server = ParameterServer(host=root_host, port=root_port)
    else:
        host = os.environ.get("DMLC_SERVER_HOST", "127.0.0.1")
        server = ParameterServer(
            host=host, port=int(os.environ.get("DMLC_SERVER_PORT", 0)))
        server.start()
        register_with_root(root_host, root_port, server_id, host,
                           server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
