"""Replica worker process: one served model behind a transport endpoint.

PyTorch port of `incubator_mxnet_tpu/serving/worker.py`.
``python -m incubator_mxnet_tpu_torch.serving.worker --prefix model
--epoch 3 --data-shapes data=1,784 --buckets 1,4,16`` loads the model on
the card (``--ctx cpu`` asks for the CPU; the JAX worker has no such
flag), runs the bucket ladder once, prints ``REPLICA_PORT <n>`` and
``REPLICA_READY programs=N builds=B load_ms=L warmup_ms=W`` on stdout
(the milliseconds of the model's load and of its ladder's first run),
and serves the replica control protocol over the parameter server's
length-prefixed frames:

* ``infer`` — run one request through the bucket ladder.  Deduplicated
  by the router's request id: a resend of an rid this worker already
  executed replays the cached outputs instead of executing twice.
* ``hb`` — cheap liveness and load (``outstanding``, weight ``version``).
* ``probe`` — deepcheck: a real bucket-1 inference.
* ``swap`` — reload the parameters from the newest valid checkpoint
  under a directory; same shapes, same programs.
* ``stats`` — counters and the executed rids (bounded); its ``cache`` is
  ``{"builds": B, "k1_launches": L}``, the ``nvcc`` runs of this process
  and its K1 launches (`fused_ops.fc_relu.launches`), where the JAX
  worker reports its XLA program cache.
* ``metrics`` — this process's telemetry registry
  (`obs.scrape.metrics_reply`), the ``worker`` producer among it.
* ``stop`` — reply, flush the buffered trace spans, then exit.

``builds`` counts the kernel builds this process ran
(`kernels/_build.build_log`): 0 when the parent built the kernels into
``build/`` before spawning.  An ``infer`` runs inside a ``worker.infer``
span that adopts the frame's trace context (``MXNET_OBS_TRACE``, which a
spawned worker inherits); plain `threading` locks stand in for
`analysis.locks`.  Thread-per-connection
(`ThreadingTCPServer`): the router owns spreading and batching, a worker
just executes.
"""
from __future__ import annotations

import argparse
import collections
import os
import socketserver
import sys
import threading
import time

import numpy as _np

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..obs.scrape import metrics_reply
from .model import ServedModel

__all__ = ["ReplicaWorker", "main"]


def kernel_counters():
    """``{"builds", "k1_launches"}`` of this process."""
    from ..kernels import _build
    from ..subgraph import fused_ops
    return {"builds": len(_build.build_log),
            "k1_launches": fused_ops.fc_relu.launches}


class ReplicaWorker:
    """The serving loop around one `ServedModel`."""

    def __init__(self, model, host="127.0.0.1", port=0, dedup_window=16384):
        self.model = model
        self.version = 0
        self._lock = threading.Lock()
        # telemetry plane: this worker's counters under 'worker', served
        # by the 'metrics' frame
        _obs_metrics.register_producer("worker", self._obs_stats)
        self._outstanding = 0
        self._executed = 0
        self._probes = 0
        self._dedup_hits = 0
        # rid -> outputs, bounded: the idempotency window covers the
        # router's failover horizon
        self._done = collections.OrderedDict()
        self._done_cap = int(dedup_window)
        self._executed_rids = collections.deque(maxlen=self._done_cap)
        # rid -> Event of executions in flight: a resend of an rid being
        # executed waits and replays instead of executing again
        self._running = {}
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
                        reply = {"error": f"replica dispatch failed: "
                                          f"{exc}", "seq": msg.get("seq")}
                    try:
                        send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        break
                    if msg.get("cmd") == "stop":
                        # os._exit skips atexit: flush buffered spans
                        # first or the merged trace loses this worker
                        _obs_trace.flush()
                        os._exit(0)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = None

    def _obs_stats(self):
        with self._lock:
            return {"executed": self._executed,
                    "dedup_hits": self._dedup_hits,
                    "outstanding": self._outstanding,
                    "version": self.version,
                    "programs": self.model.program_count()}

    # -- command dispatch ----------------------------------------------------
    def _handle(self, msg):
        cmd = msg.get("cmd")
        seq = msg.get("seq")
        if cmd == "infer":
            # the cross-process trace edge: this execution is a child of
            # the dispatch that sent it
            with _obs_trace.server_span(msg, "worker.infer",
                                        cat="serving", rid=msg.get("rid")):
                return dict(self._infer(msg), seq=seq)
        if cmd == "hb":
            with self._lock:
                return {"ok": True, "outstanding": self._outstanding,
                        "version": self.version, "seq": seq}
        if cmd == "probe":
            model = self.model
            model.infer([_np.zeros((1,) + model._sample_shapes[n],
                                   model._host_dtype)
                         for n in model.data_names])
            with self._lock:
                self._probes += 1
                version = self.version
            return {"ok": True, "programs": model.program_count(),
                    "version": version, "seq": seq}
        if cmd == "swap":
            # the `replica.swap` fault site fires on the router's side
            from .replica import _load_checkpoint_params
            args, auxs = _load_checkpoint_params(msg["checkpoint_dir"])
            self.model.set_params(args, auxs)
            with self._lock:
                self.version += 1
                version = self.version
            return {"ok": True, "version": version,
                    "programs": self.model.program_count(), "seq": seq}
        if cmd == "stats":
            with self._lock:
                return {"ok": True, "executed": self._executed,
                        "probes": self._probes,
                        "dedup_hits": self._dedup_hits,
                        "version": self.version,
                        "programs": self.model.program_count(),
                        "executed_rids": list(self._executed_rids),
                        "cache": kernel_counters(),
                        "seq": seq}
        if cmd == "metrics":
            return metrics_reply(seq=seq)
        if cmd == "stop":
            return {"ok": True, "seq": seq}
        return {"error": f"replica worker: unknown cmd {cmd!r}", "seq": seq}

    def _infer(self, msg):
        rid = msg.get("rid")
        while True:
            with self._lock:
                if rid is not None and rid in self._done:
                    # idempotent resend: replay, never re-execute
                    self._dedup_hits += 1
                    return {"ok": True, "outs": self._done[rid],
                            "deduped": True}
                running = self._running.get(rid) \
                    if rid is not None else None
                if running is None:
                    if rid is not None:
                        self._running[rid] = threading.Event()
                    self._outstanding += 1
                    break
            # a resend raced the first copy: wait for it and replay its
            # result (if the first attempt failed, this one executes)
            running.wait(timeout=600)
        try:
            outs = [o.asnumpy() for o in self.model.infer(msg["inputs"])]
        except Exception:
            with self._lock:
                self._outstanding -= 1
                ev = self._running.pop(rid, None)
            if ev is not None:
                ev.set()
            raise
        with self._lock:
            self._outstanding -= 1
            self._executed += 1
            ev = None
            if rid is not None:
                self._executed_rids.append(rid)
                self._done[rid] = outs
                while len(self._done) > self._done_cap:
                    self._done.popitem(last=False)
                ev = self._running.pop(rid, None)
        if ev is not None:
            ev.set()
        return {"ok": True, "outs": outs}

    def serve_forever(self):
        self._server.serve_forever(poll_interval=0.1)

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="mx-replica-worker-server")
        self._thread.start()
        return self

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


def _parse_shapes(spec):
    shapes = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, dims = part.partition("=")
        shapes.append((name, tuple(int(d) for d in dims.split(",") if d)))
    if not shapes:
        raise SystemExit("worker: --data-shapes required "
                         "(name=d0,d1[;name=...])")
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="serving.worker", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", default="model")
    ap.add_argument("--prefix", default=None,
                    help="classic checkpoint pair prefix")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--symbol-file", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="elastic checkpoint dir (needs --symbol-file)")
    ap.add_argument("--data-shapes", required=True,
                    metavar="name=d0,d1[;name=...]")
    ap.add_argument("--buckets", default="1,2,4,8")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                    help="the device the model runs on (default: the card)")
    args = ap.parse_args(argv)

    from ..context import cpu, gpu
    t0 = time.perf_counter()
    shapes = _parse_shapes(args.data_shapes)
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    common = dict(data_shapes=shapes, buckets=buckets, name=args.name,
                  ctx=cpu() if args.ctx == "cpu" else gpu(0))
    if args.prefix is not None:
        model = ServedModel.load(args.prefix, args.epoch, **common)
    elif args.checkpoint_dir is not None:
        if args.symbol_file is None:
            raise SystemExit("worker: --checkpoint-dir needs --symbol-file")
        model = ServedModel.from_checkpoint_dir(
            args.symbol_file, args.checkpoint_dir, **common)
    else:
        raise SystemExit("worker: --prefix or --checkpoint-dir required")

    worker = ReplicaWorker(model, host=args.host, port=args.port)
    print("REPLICA_PORT %d" % worker.port, flush=True)
    t1 = time.perf_counter()
    # the ladder runs after the port is known, so a spawning router can
    # already connect; the kernels load from build/ (builds=0) when the
    # parent built them first
    model.warmup()
    print("REPLICA_READY programs=%d builds=%d load_ms=%d warmup_ms=%d"
          % (model.program_count(), kernel_counters()["builds"],
             (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3),
          flush=True)
    worker.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
