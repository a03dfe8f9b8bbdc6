"""The scrape plane: ``metrics`` frames over the dist transport.

PyTorch port of `incubator_mxnet_tpu/obs/scrape.py`: the same records,
fields and wire frames, so `tools/mxtrace.py` and `tools/mxtop.py` read
the port's output unchanged.

Every long-lived process in the system already speaks the
length-prefixed transport frames (replica workers, host daemons, the
parameter server); each of their handlers answers a ``{"cmd":
"metrics"}`` frame with this process's registry snapshot:

    {"ok": True, "values": {dotted.name: number, ...},
     "prom": "<Prometheus text exposition>"}

This module is the shared implementation: `metrics_reply()` builds
that reply (the handlers call it), `scrape(endpoint)` fetches one
process's snapshot over a short-lived channel, and `MetricsEndpoint`
is a standalone server for processes that have no other listener (a
training job under a supervisor, a bench harness) — point
``tools/mxtop.py`` at any of them.

`FleetManager.scrape()` composes these into the fleet-wide view: its
own process's registry plus every host daemon's and every remote
replica's.
"""
from __future__ import annotations

import socketserver
import threading

from . import metrics as _metrics

__all__ = ["metrics_reply", "scrape", "MetricsEndpoint"]


def metrics_reply(seq=None):
    """The one ``metrics``-frame reply shape every handler serves —
    ONE producer sweep renders both forms of the same snapshot."""
    reg = _metrics.registry()
    values = reg.collect()
    return {"ok": True, "values": values,
            "prom": reg.render_prometheus(values=values), "seq": seq}


def scrape(endpoint, timeout=5.0):
    """One process's snapshot: ``{"values": ..., "prom": ...}`` from a
    ``host:port`` / ``:port`` / ``port`` endpoint answering the
    transport ``metrics`` frame.  Raises on unreachable/refusing peers
    — the caller (mxtop, the fleet) decides how dead peers render."""
    from ..dist.transport import Channel, parse_endpoint
    host, port = parse_endpoint(endpoint)
    chan = Channel(host, port, timeout=timeout, connect_wait=timeout)
    try:
        reply = chan.request({"cmd": "metrics"})
    finally:
        chan.close()
    if "error" in reply:
        raise RuntimeError(f"scrape {endpoint}: {reply['error']}")
    return {"values": dict(reply.get("values") or {}),
            "prom": reply.get("prom", "")}


class MetricsEndpoint:
    """A standalone transport listener answering ONLY ``metrics`` (and
    ``hb``) frames from this process's registry — observability for
    processes with no other server (trainers, benches, tests)."""

    def __init__(self, host="127.0.0.1", port=0):
        outer_reply = metrics_reply

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                from ..dist.transport import recv_msg, send_msg
                while True:
                    try:
                        msg = recv_msg(self.request)
                    except (EOFError, ConnectionError, OSError):
                        break
                    cmd = msg.get("cmd")
                    seq = msg.get("seq")
                    if cmd == "metrics":
                        try:
                            reply = outer_reply(seq=seq)
                        except Exception as exc:
                            reply = {"error": f"scrape failed: {exc}",
                                     "seq": seq}
                    elif cmd == "hb":
                        reply = {"ok": True, "seq": seq}
                    else:
                        reply = {"error": f"metrics endpoint: unknown "
                                          f"cmd {cmd!r}", "seq": seq}
                    try:
                        send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        break

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, int(port)), Handler)
        self.port = self._server.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True,
            name="mx-obs-metrics-endpoint")
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start() if self._thread is None else self

    def __exit__(self, *exc):
        self.close()
