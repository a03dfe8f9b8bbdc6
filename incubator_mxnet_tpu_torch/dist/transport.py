"""Framed message transport for the parameter-server protocol.

PyTorch port of `incubator_mxnet_tpu/dist/transport.py`, wire-compatible
with it: a message is one frame on a TCP stream,

    [8-byte big-endian payload length][8-byte buffer count][payload]
    ([8-byte length][buffer]) per out-of-band buffer  [32-byte HMAC tag]

where the payload is a pickle (protocol 5) whose large arrays travel as
out-of-band buffers.  With ``MXNET_PS_HMAC_KEY`` set (the same value on
every node) an HMAC-SHA256 tag over the payload and every buffer is
checked before anything is unpickled: the tag is the fence against an
untrusted peer on a shared network.  Without it, the unpickler still
resolves only an allowlist of globals (`SafeUnpickler`: numpy arrays and
dtypes, a few builtin containers), so a frame cannot name an arbitrary
callable; `loads_port_blob` adds the port's optimizers, learning-rate
schedules and arrays for the pickled optimizer and its states a
``set_optimizer`` carries, and refuses the JAX package's, whose module
it never imports.  A port worker talks to a JAX
server, and the reverse, through the commands whose payloads are numpy
arrays and plain types.

`Channel` is the worker side: sequence-numbered, client-tagged requests;
connect retries under a deadline (the startup race); a timed-out request
leaves the channel usable (its late reply is dropped by sequence number);
a dropped connection resends the same frame, which the server answers
from its (client, seq) cache instead of applying it twice.  The JAX
package's tracing spans, sanitizer hooks and fault-injection sites are
not ported.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import io
import os
import pickle
import random as _random
import socket
import struct
import time

from ..obs import trace as _obs_trace

__all__ = ["Channel", "send_msg", "recv_msg", "SafeUnpickler",
           "loads_port_blob", "parse_endpoint"]

_LEN = struct.Struct(">Q")
_TAG_LEN = 32


_NUMPY_GLOBALS = {(np_mod + sub, name)
                  for np_mod in ("numpy._core", "numpy.core")
                  for sub, name in ((".multiarray", "_reconstruct"),
                                    (".multiarray", "scalar"),
                                    (".numeric", "_frombuffer"))}
_SAFE_GLOBALS = _NUMPY_GLOBALS | {
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "bytearray"), ("builtins", "complex"),
    ("builtins", "slice"), ("builtins", "range"),
    ("collections", "OrderedDict")}


class SafeUnpickler(pickle.Unpickler):
    """Resolves only the globals of `_SAFE_GLOBALS`: the numpy arrays and
    plain types the protocol's frames carry, in either package."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu"):
            raise pickle.UnpicklingError(
                f"{module}.{name} belongs to another package; this "
                "process takes the port's (incubator_mxnet_tpu_torch) "
                "optimizers and states only")
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed on the parameter-server wire")


def _load_storage(b):
    import torch
    return torch.load(io.BytesIO(b), weights_only=True)


class _PortBlobUnpickler(SafeUnpickler):
    """`SafeUnpickler` plus the port's optimizer and learning-rate
    schedule classes, its NDArray and the CPU tensor a bfloat16 NDArray
    pickles as (its storage loaded with ``weights_only``)."""

    def find_class(self, module, name):
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _load_storage
        if (module, name) in (("torch._utils", "_rebuild_tensor_v2"),
                              ("incubator_mxnet_tpu_torch.ndarray.ndarray",
                               "_unpickle")):
            return pickle.Unpickler.find_class(self, module, name)
        if module in ("incubator_mxnet_tpu_torch.optimizer",
                      "incubator_mxnet_tpu_torch.lr_scheduler"):
            from ..lr_scheduler import LRScheduler
            from ..optimizer import Optimizer
            obj = pickle.Unpickler.find_class(self, module, name)
            if isinstance(obj, type) and issubclass(obj, (Optimizer,
                                                          LRScheduler)):
                return obj
        return super().find_class(module, name)


def loads_port_blob(blob):
    """Unpickle a pickled optimizer or optimizer state of the port."""
    return _PortBlobUnpickler(io.BytesIO(blob)).load()


def _hmac_key():
    k = os.environ.get("MXNET_PS_HMAC_KEY", "")
    return k.encode() if k else None


def parse_endpoint(spec, default_host="127.0.0.1"):
    """``"host:port"`` / ``":port"`` / ``"port"`` -> ``(host, port)``: the
    spellings a serving fleet's host registry names its ``hostd`` agents
    by, as in the JAX package."""
    text = str(spec).strip()
    host, sep, port = text.rpartition(":")
    if not sep:
        host, port = "", text
    host = host or default_host
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(f"invalid endpoint {spec!r} (want host:port)") \
            from None


def send_msg(sock: socket.socket, obj) -> None:
    buffers = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    key = _hmac_key()
    mac = _hmac.new(key, payload, hashlib.sha256) if key is not None else None
    # the same bytes as the JAX package's frame, in fewer writes: a small
    # write waiting on the peer's delayed ACK costs ~40 ms (Nagle)
    head = [_LEN.pack(len(payload)), _LEN.pack(len(raws)), payload]
    for r in raws:
        head.append(_LEN.pack(len(r)))
        if mac is not None:
            mac.update(r)
        if len(r) <= 1 << 16:
            head.append(bytes(r))
        else:
            sock.sendall(b"".join(head))
            sock.sendall(r)
            head = []
    if mac is not None:
        head.append(mac.digest())
    if head:
        sock.sendall(b"".join(head))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise EOFError("peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket):
    plen = _LEN.unpack(_recv_exact(sock, 8))[0]
    nbuf = _LEN.unpack(_recv_exact(sock, 8))[0]
    payload = _recv_exact(sock, plen)
    key = _hmac_key()
    mac = _hmac.new(key, payload, hashlib.sha256) if key is not None else None
    bufs = []
    for _ in range(nbuf):
        blen = _LEN.unpack(_recv_exact(sock, 8))[0]
        buf = _recv_exact(sock, blen)
        if mac is not None:
            mac.update(buf)
        bufs.append(buf)
    if mac is not None:
        tag = _recv_exact(sock, _TAG_LEN)
        if not _hmac.compare_digest(tag, mac.digest()):
            raise ConnectionError(
                "transport: HMAC verification failed — peer does not hold "
                "MXNET_PS_HMAC_KEY; refusing to deserialize")
    return SafeUnpickler(io.BytesIO(payload), buffers=bufs).load()


class Channel:
    """One request/response channel to a server (worker side)."""

    _CLIENT_COUNTER = [0]

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 connect_wait: float | None = None, retry=None):
        from .. import config as _config
        from ..resilience import RetryPolicy
        self.host, self.port = host, int(port)
        # the timeout must exceed the server's longest wait (300 s sync
        # rounds and barriers); it bounds a dead or partitioned server
        self._timeout = float(timeout) if timeout is not None else \
            float(_config.get("MXNET_PS_REQUEST_TIMEOUT"))
        self._connect_wait = float(connect_wait) if connect_wait is not None \
            else float(_config.get("MXNET_PS_CONNECT_WAIT"))
        # a reconnect means the server just died: diagnose it in seconds
        self._reconnect_wait = min(
            self._connect_wait, float(_config.get("MXNET_PS_RECONNECT_WAIT")))
        self._retry = retry or RetryPolicy(
            max_attempts=int(_config.get("MXNET_PS_MAX_RETRIES")),
            base_delay=0.05, max_delay=2.0)
        Channel._CLIENT_COUNTER[0] += 1
        self.client_id = "%d.%d.%d" % (os.getpid(), id(self) & 0xffffff,
                                       Channel._CLIENT_COUNTER[0])
        self._seq = 0
        self.resends = 0           # idempotent resends
        self.discarded_stale = 0   # stale replies dropped by seq
        self.on_reconnect = None   # re-handshake hook (kvstore_dist sets it)
        self._sock = None
        self._closed = False
        self._last_frame = None
        self._connect(self._connect_wait)

    def _connect(self, wait):
        rng = _random.Random(self._retry.seed)
        deadline = time.monotonic() + wait
        attempt = 0
        while True:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=10.0)
                break
            except OSError as exc:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"could not connect to {self.host}:{self.port} "
                        f"within {wait:g}s ({type(exc).__name__}: {exc})"
                        ) from exc
                time.sleep(min(self._retry.delay(attempt, rng),
                               max(deadline - time.monotonic(), 0.0)))
                attempt += 1
        self._sock.settimeout(self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _drop_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _read_reply(self, expect):
        """The reply for sequence number `expect`; frames answering other
        (timed-out) requests are dropped."""
        while True:
            reply = recv_msg(self._sock)
            seq = reply.get("seq") if isinstance(reply, dict) else None
            if seq is None or seq == expect:
                return reply
            self.discarded_stale += 1

    def _frame(self, obj):
        self._seq += 1
        msg = dict(obj)
        msg["seq"] = self._seq
        msg["client"] = self.client_id
        return msg

    def request(self, obj, timeout=None):
        """One round trip.  Connection failures resend under the retry
        policy (the server dedups by client and seq); a timeout raises
        and leaves the channel consistent.  ``timeout`` (seconds)
        replaces the channel's for this request only."""
        msg = self._frame(obj)
        # with tracing on (MXNET_OBS_TRACE) the frame carries a ``tr``
        # span context the server's handling span parents to; a resend
        # reuses the frame, so a deduplicated replay joins the same trace
        sp = _obs_trace.rpc_span(msg, f"{self.host}:{self.port}")
        self._last_frame = msg
        try:
            return self._send_framed(msg, timeout)
        finally:
            sp.end()

    def resend_last(self):
        """Retry the last request with its original sequence number, so
        a server that already applied it replays its cached reply."""
        return self._send_framed(self._last_frame)

    def _send_framed(self, msg, timeout=None):
        if self._closed:
            raise ConnectionError(
                f"channel to {self.host}:{self.port} is closed")
        wait = self._timeout if timeout is None else float(timeout)
        delays = self._retry.delays()
        while True:
            try:
                if self._sock is None:
                    self._connect(self._reconnect_wait)
                    if self.on_reconnect is not None:
                        self.on_reconnect(self)
                self._sock.settimeout(wait)
                try:
                    send_msg(self._sock, msg)
                    return self._read_reply(msg["seq"])
                finally:
                    if self._sock is not None:
                        self._sock.settimeout(self._timeout)
            except socket.timeout:
                # the timeout may have fired mid-frame: drop the socket;
                # the next request reconnects and resends stay safe
                self._drop_sock()
                raise TimeoutError(
                    f"request {msg.get('cmd')!r} to {self.host}:{self.port} "
                    f"timed out after {wait:g}s; the server is "
                    "slow or wedged")
            except (ConnectionError, EOFError, OSError):
                self._drop_sock()
                delay = next(delays, None)
                if delay is None:
                    raise
                self.resends += 1
                time.sleep(delay)

    def bare_request(self, obj):
        """One round trip on the live socket with no retry (re-handshake
        hooks run inside the retry loop)."""
        msg = self._frame(obj)
        if self._closed or self._sock is None:
            raise ConnectionError(
                f"channel to {self.host}:{self.port} is closed")
        sp = _obs_trace.rpc_span(msg, f"{self.host}:{self.port}")
        try:
            send_msg(self._sock, msg)
            return self._read_reply(msg["seq"])
        finally:
            sp.end()

    def close(self):
        """Close for good: later requests fail fast."""
        self._closed = True
        self._drop_sock()
