"""Fleet host daemon: one agent process per serving host.

PyTorch port of `incubator_mxnet_tpu/serving/hostd.py`.
``python -m incubator_mxnet_tpu_torch.serving.hostd --host-id host-a``
prints ``HOSTD_PORT <n>`` and ``HOSTD_READY`` on stdout and serves the
fleet host protocol over the parameter server's length-prefixed frames:

* ``hb`` — host liveness and load (live worker count, pid).  The
  `FleetManager` feeds these beats into its membership table; silence
  past the deadline is host death.
* ``spawn`` — launch one `serving.worker` ON THIS HOST from a
  `ReplicaSpec` message (binding this daemon's address) and wait for its
  READY line; the reply carries the worker's port and its READY
  evidence (``programs``, ``builds``).  Idempotent by replica id: a
  resent spawn answers with the live worker's endpoint.
* ``stop`` — kill every worker, then exit.

``--ctx`` (``gpu``, the default, or ``cpu``) is the device every worker
it spawns serves on; the `ReplicaSpec` wire dict stays the JAX
package's.  `AgentHost.launch_local` starts the daemon in its own
session, so a SIGKILL of its process group powers off the daemon and its
workers together.  ``metrics`` answers this process's telemetry registry
(the ``hostd`` producer: live workers, spawns); a ``spawn`` runs inside a
``hostd.spawn`` span that adopts the frame's trace context; ``stop``
flushes the buffered spans before the exit, as in the JAX package.
"""
from __future__ import annotations

import argparse
import os
import socketserver
import sys
import threading

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..obs.scrape import metrics_reply

__all__ = ["HostDaemon", "main"]


class HostDaemon:
    """The serving loop around one host's worker population."""

    def __init__(self, host_id, host="127.0.0.1", port=0, ctx="gpu"):
        self.host_id = str(host_id)
        self.host = str(host)
        self.ctx = str(ctx)
        self._lock = threading.Lock()
        self._workers = {}    # replica_id -> {"proc", "port", "ready"}
        self._spawning = {}   # replica_id -> Event (first spawn running)
        self.spawns = 0
        _obs_metrics.register_producer("hostd", self._obs_stats)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                from ..dist.transport import recv_msg, send_msg
                while True:
                    try:
                        msg = recv_msg(self.request)
                    except (EOFError, ConnectionError, OSError):
                        break
                    try:
                        reply = outer._handle(msg)
                    except Exception as exc:
                        reply = {"error": f"hostd dispatch failed: {exc}",
                                 "seq": msg.get("seq")}
                    try:
                        send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        break
                    if msg.get("cmd") == "stop":
                        outer._kill_workers()
                        # os._exit skips atexit: flush buffered spans
                        _obs_trace.flush()
                        os._exit(0)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((self.host, int(port)), Handler)
        self.port = self._server.server_address[1]

    # -- command dispatch ----------------------------------------------------
    def _reap_locked(self):
        for rid in list(self._workers):
            if self._workers[rid]["proc"].poll() is not None:
                del self._workers[rid]

    def _obs_stats(self):
        with self._lock:
            self._reap_locked()
            return {"workers": len(self._workers), "spawns": self.spawns}

    def _handle(self, msg):
        cmd = msg.get("cmd")
        seq = msg.get("seq")
        if cmd == "hb":
            with self._lock:
                self._reap_locked()
                return {"ok": True, "host_id": self.host_id,
                        "workers": len(self._workers),
                        "pid": os.getpid(), "seq": seq}
        if cmd == "metrics":
            return metrics_reply(seq=seq)
        if cmd == "spawn":
            with _obs_trace.server_span(msg, "hostd.spawn", cat="fleet",
                                        replica=msg.get("replica_id")):
                return dict(self._spawn(msg), seq=seq)
        if cmd == "stop":
            return {"ok": True, "seq": seq}
        return {"error": f"hostd: unknown cmd {cmd!r}", "seq": seq}

    def _worker_reply(self, rec):
        return {"ok": True, "port": rec["port"], "ready": rec["ready"],
                "pid": rec["proc"].pid}

    def _spawn(self, msg):
        from .fleet import ReplicaSpec
        from . import replica as _replica
        spec = ReplicaSpec.from_msg(msg["spec"])
        rid = msg.get("replica_id") or spec.name
        # idempotent by replica id: a lost reply makes the channel resend
        # the spawn, and a second worker for one rid would be an orphan.
        # A resend racing the first spawn waits for it.
        while True:
            with self._lock:
                self._reap_locked()
                rec = self._workers.get(rid)
                if rec is not None:
                    return self._worker_reply(rec)
                pending = self._spawning.get(rid)
                if pending is None:
                    self._spawning[rid] = threading.Event()
                    break
            pending.wait(600)
        try:
            # the worker binds this host's address: the router's channels
            # cross the network
            cmd = _replica.worker_argv(
                prefix=spec.prefix, epoch=spec.epoch,
                symbol_file=spec.symbol_file,
                checkpoint_dir=spec.checkpoint_dir,
                data_shapes=spec.data_shapes, buckets=spec.buckets,
                name=spec.name, host=self.host, ctx=self.ctx)
            proc, port, ready = _replica.launch_worker(
                cmd, env=spec.env, name=spec.name, tag=rid)
            with self._lock:
                rec = self._workers[rid] = {"proc": proc, "port": port,
                                            "ready": ready}
                self.spawns += 1
        finally:
            with self._lock:
                ev = self._spawning.pop(rid, None)
            if ev is not None:
                ev.set()
        return self._worker_reply(rec)

    def _kill_workers(self):
        with self._lock:
            workers, self._workers = dict(self._workers), {}
        for rec in workers.values():
            try:
                rec["proc"].kill()
            except Exception:
                pass

    def serve_forever(self):
        self._server.serve_forever(poll_interval=0.1)

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="mx-hostd-server")
        self._thread.start()
        return self

    def shutdown(self):
        self._kill_workers()
        self._server.shutdown()
        self._server.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="serving.hostd", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host-id", required=True,
                    help="this host's fleet registry name")
    ap.add_argument("--host", default="127.0.0.1",
                    help="address the daemon AND its workers bind")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                    help="the device its workers serve on "
                         "(default: the card)")
    args = ap.parse_args(argv)
    daemon = HostDaemon(args.host_id, host=args.host, port=args.port,
                        ctx=args.ctx)
    print("HOSTD_PORT %d" % daemon.port, flush=True)
    print("HOSTD_READY host_id=%s" % daemon.host_id, flush=True)
    daemon.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
