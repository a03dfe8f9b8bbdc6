"""Cross-process distributed tracing: trace-id/span-id context over
the transport frames, spans as shared-file JSONL.

PyTorch port of `incubator_mxnet_tpu/obs/trace.py`: the same records,
fields and wire frames, so `tools/mxtrace.py` and `tools/mxtop.py` read
the port's output unchanged.

The profiler's chrome trace answers "what did THIS process spend time
on"; it cannot answer "where did this request/step spend its time
ACROSS processes" — a routed request crosses router -> transport ->
subprocess worker -> batcher -> fused execute, and a training step
crosses fit -> kvstore push -> parameter server.  This module adds the
missing correlation:

* a **span** is one timed operation with a ``trace`` id (the whole
  request/step), its own ``span`` id, and a ``parent`` span id — ids
  are ``pid``-prefixed counters, unique across every process of a run
  with zero coordination;
* the current span rides a ``contextvars`` context; `span()` opens a
  child of whatever is current (or a new root);
* **propagation**: the dist transport injects the current span as a
  ``tr`` frame field on every request (`rpc_span`), and every server
  handler (replica worker, host daemon, parameter server) adopts it
  (`server_span`) — so the worker-side execute span is a CHILD of the
  router-side dispatch span, in another process;
* finished spans append to a **shared JSONL file** (`obs.jsonl_sink`
  — O_APPEND line-atomic, pid/thread-stamped), one line per span, so
  every process of a run writes the same file and
  ``tools/mxtrace.py`` merges them into one Perfetto-loadable chrome
  trace where a single request reads as one connected tree with flow
  arrows across process lanes.

Enabled by pointing ``MXNET_OBS_TRACE`` at the shared span file (the
env propagates to spawned workers/daemons) or `enable(path)`.  Off,
every hook is a single global read returning a shared no-op span.  The
in-memory buffer is bounded (``MXNET_OBS_TRACE_BUFFER``, drop-oldest
with a ``dropped`` counter surfaced as a metric); it auto-flushes
every ``_FLUSH_EVERY`` spans and at exit, and explicitly via
`flush()`.
"""
from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import os
import threading
import time

from . import jsonl_sink as _jsonl

__all__ = ["enabled", "enable", "disable", "flush", "stats",
           "span", "start_span", "record_span", "current_frame",
           "activate", "rpc_span", "server_span", "NULL_SPAN"]

_ctx = contextvars.ContextVar("mx_obs_trace", default=None)

_FLUSH_EVERY = 512

_lock = threading.Lock()
_enabled = None            # tri-state: None = read MXNET_OBS_TRACE lazily
_path = None
_buffer = []
_cap = None
_dropped = 0
_flushed = 0
_ended = 0
_atexit_armed = False
_flush_event = threading.Event()
_flusher = [None]
# observability of the observability: nanoseconds the background
# flusher spent serializing + writing spans (the increment races are
# benign — it is a counter).  Exposed as 'trace.self_time_ms' in the
# metrics scrape; the obs CI gate pairs it with a single-threaded
# calibration of the per-span hook cost (`calibrate_span_cost`) —
# in-hook wall timing under thread contention would count GIL waits
# as telemetry cost.
_self_ns = [0]
# pid-prefixed ids: unique across processes with zero coordination (the
# pid is cached — a syscall per span id would tax the hot path — and
# refreshed after fork so a forked child's ids diverge)
_ids = itertools.count(1)
_PID = [os.getpid()]
_id_prefix = ["%x-" % _PID[0]]


def _refresh_pid():
    _PID[0] = os.getpid()
    _id_prefix[0] = "%x-" % _PID[0]


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


def _id(kind):
    return kind + _id_prefix[0] + str(next(_ids))


# span timestamps are wall-clock us (time.time_ns() // 1000), not
# perf_counter: spans from DIFFERENT processes must land on one
# comparable timeline in the merged trace


def enabled():
    global _enabled, _path, _cap
    if _enabled is None:
        with _lock:
            if _enabled is None:
                from .. import config as _config
                path = str(_config.get("MXNET_OBS_TRACE") or "")
                _path = path or None
                _cap = max(int(_config.get("MXNET_OBS_TRACE_BUFFER")), 16)
                _enabled = bool(path)
        if _enabled:
            _arm_atexit()
            _ensure_flusher()
    return _enabled


def enable(path=None):
    """Turn tracing on programmatically; `path` (optional) is the
    shared span JSONL file — without one, spans stay in the bounded
    in-memory buffer (tests read them via `buffered()`)."""
    global _enabled, _path, _cap
    enabled()   # resolve knobs first so this override wins
    with _lock:
        _enabled = True
        if path is not None:
            _path = str(path)
        has_path = _path is not None
    _arm_atexit()
    if has_path:
        _ensure_flusher()


def disable():
    global _enabled
    enabled()
    with _lock:
        _enabled = False


def _arm_atexit():
    global _atexit_armed
    if _atexit_armed:
        return
    _atexit_armed = True
    atexit.register(flush)
    # the span plane's own counters join the scrape ('trace.dropped'
    # is how silent span loss becomes visible)
    from . import metrics as _metrics
    _metrics.register_producer("trace", stats)


def stats():
    """Span-plane counters (registered as the ``trace`` metrics
    namespace when tracing is enabled)."""
    with _lock:
        return {"buffered": len(_buffer), "dropped": _dropped,
                "flushed": _flushed, "ended": _ended,
                "self_time_ms": _self_ns[0] / 1e6,
                "enabled": bool(_enabled)}


def self_time_ns():
    """Nanoseconds the flusher spent serializing + writing spans."""
    return _self_ns[0]


def calibrate_span_cost(n=8192, scratch=None):
    """Measured ALL-IN cost of one span in seconds — open + close +
    buffering + its share of serialization and write IO — from a
    single-threaded loop in this process (no thread preemption to
    inflate the numbers).  The obs CI gate multiplies this by the
    spans-per-request observed in the traced run to compute the
    hot-path overhead ratio deterministically; requires tracing to be
    enabled with a file.

    The synthetic spans land in a SCRATCH file (a throwaway temp file
    unless `scratch` names one), never the run's shared span file —
    merged traces and their orphan/span-count gates must see only real
    workload spans."""
    global _path
    if not enabled() or _path is None:
        return None
    flush()
    if scratch is None:
        import tempfile
        fd, scratch = tempfile.mkstemp(prefix="mxobs_cal_",
                                       suffix=".jsonl")
        os.close(fd)
    saved, _path = _path, str(scratch)
    try:
        t0 = time.perf_counter_ns()
        done = 0
        while done < n:
            # emit in sub-threshold batches then flush synchronously,
            # so the background flusher never interleaves the timing
            for i in range(256):
                sp = start_span("calibrate.span", cat="calibrate",
                                rid=f"c-{done + i}",
                                priority="interactive")
                sp.end(outcome="ok")
            flush()
            done += 256
        return (time.perf_counter_ns() - t0) / done / 1e9
    finally:
        flush()
        _path = saved


def _as_dict(rec):
    tr, sp, pa, name, cat, ts, dur, args, thread = rec
    return {"k": "span", "tr": tr, "sp": sp, "pa": pa, "name": name,
            "cat": cat, "ts": ts, "dur": dur, "args": args,
            "thread": thread, "pid": _PID[0]}


def buffered():
    """Unflushed span records as dicts (tests; file-less mode)."""
    with _lock:
        return [_as_dict(r) for r in _buffer[:len(_buffer)]]


_SAFE_DUMPS = _jsonl._dumps


def _render(rec):
    """One span tuple -> its JSONL line.  Hand-rendered: the generic
    json encoder costs ~4us per span dict at flush rate, which the
    calibrated overhead gate charges straight to the hot path.  Ids,
    cats, and our span names are controlled identifiers (no escaping);
    anything potentially carrying quotes (args values, thread names,
    caller-supplied names) goes through the real encoder."""
    tr, sp, pa, name, cat, ts, dur, args, thread = rec
    return (
        '{"k":"span","tr":"%s","sp":"%s","pa":%s,"name":%s,"cat":"%s",'
        '"ts":%d,"dur":%d,"pid":%d,"thread":%s,"args":%s}'
        % (tr, sp,
           '"%s"' % pa if pa else "null",
           '"%s"' % name if '"' not in name and "\\" not in name
           else _SAFE_DUMPS(name),
           cat, ts, dur, _PID[0],
           '"%s"' % thread if '"' not in thread and "\\" not in thread
           else _SAFE_DUMPS(thread),
           _SAFE_DUMPS(args) if args else "{}"))


def reset():
    """Drop buffered spans and counters; keep enablement (tests)."""
    global _dropped, _flushed, _ended
    with _lock:
        _buffer.clear()
        _dropped = _flushed = _ended = 0
        _self_ns[0] = 0


def flush():
    """Write every buffered span to the shared file, one line each.
    The lock serializes FLUSHERS only — recorders append lock-free
    (GIL-atomic), and taking the first n elements then deleting them
    cannot race appends, which only ever extend the tail."""
    global _flushed
    t0 = time.perf_counter_ns()
    with _lock:
        n = len(_buffer)
        path = _path
        if not n or path is None:
            return 0
        batch = _buffer[:n]
        del _buffer[:n]
    lines = []
    for rec in batch:
        try:
            lines.append(_render(rec))
        except (TypeError, ValueError):
            continue   # unserializable args: drop the span, not the run
    _jsonl.sink(path).write_rendered(lines)
    _flushed += n
    _self_ns[0] += time.perf_counter_ns() - t0
    return n


def _flush_loop():
    """The background flusher: serialization + the write syscall are
    paid HERE, never on the traced hot path (`_record` only appends to
    the in-memory buffer).  Wakes on the threshold signal or every
    0.5s, whichever first; the atexit flush drains the tail."""
    while True:
        _flush_event.wait(timeout=0.5)
        _flush_event.clear()
        try:
            flush()
        except Exception:
            pass    # the flusher must never die mid-run


def _ensure_flusher():
    t = _flusher[0]
    if t is not None and t.is_alive():
        return
    t = threading.Thread(target=_flush_loop, daemon=True,
                         name="mx-obs-trace-flush")
    _flusher[0] = t
    t.start()


def _record(tr, sp, pa, name, cat, ts, dur, args):
    """Buffer one finished span as a TUPLE (rendered to JSON by the
    flusher).  LOCK-FREE on the hot path: a list append is atomic
    under the GIL, and a contended lock here costs a futex syscall per
    span across every serving/dispatch thread (measured ~3x the span's
    own cost).  The cap trim takes the lock only when actually over
    cap (file-less buffering — the flusher normally drains long
    before).  The emitting thread is captured HERE: stamping at flush
    time would attribute every span to the flusher thread."""
    global _dropped, _ended
    _buffer.append((tr, sp, pa, name, cat, ts, dur, args,
                    threading.current_thread().name))
    _ended += 1                      # benign race: it is a counter
    n = len(_buffer)
    cap = _cap or 65536
    if n > cap:
        with _lock:
            while len(_buffer) > cap:
                _buffer.pop(0)
                _dropped += 1
    elif n >= _FLUSH_EVERY and _path is not None \
            and not _flush_event.is_set():
        _flush_event.set()


class SpanHandle:
    """One live span; `end()` exactly once buffers the record."""

    __slots__ = ("trace", "span", "parent", "name", "cat", "t0", "args",
                 "_done")

    def __init__(self, name, trace, parent, cat, args):
        self.name = name
        self.trace = trace
        self.span = _id("s")
        self.parent = parent
        self.cat = cat
        self.t0 = time.time_ns() // 1000
        self.args = args
        self._done = False

    def frame(self):
        """The wire form carried in a transport frame's ``tr`` field."""
        return {"t": self.trace, "s": self.span}

    def note(self, **args):
        self.args.update(args)
        return self

    def end(self, **args):
        if self._done:
            return
        self._done = True
        if args:
            self.args.update(args)
        _record(self.trace, self.span, self.parent, self.name, self.cat,
                self.t0, time.time_ns() // 1000 - self.t0, self.args)


class _NullSpan:
    """The shared off-switch: every hook returns this when tracing is
    disabled — no allocation, no time reads."""

    __slots__ = ()
    trace = span = parent = None

    def frame(self):
        return None

    def note(self, **args):
        return self

    def end(self, **args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL_SPAN = _NullSpan()


def current_frame():
    """The current span's wire form ({"t","s"}) or None."""
    return _ctx.get()


def start_span(name, parent=None, cat="span", **args):
    """Open a span (manual end).  ``parent`` is a wire frame
    ({"t","s"}) — defaults to the current context; None there starts a
    new trace.  Does NOT touch the context (async owners like the
    router hold the handle and `activate()` it where child work
    happens)."""
    if not enabled():
        return NULL_SPAN
    if parent is None:
        parent = _ctx.get()
    if parent:
        return SpanHandle(name, parent["t"], parent["s"], cat, args)
    return SpanHandle(name, _id("t"), None, cat, args)


def record_span(name, ts_us, dur_us, parent=None, cat="span", **args):
    """Buffer an already-timed span (post-hoc instrumentation sites)."""
    if not enabled():
        return
    if parent is None:
        parent = _ctx.get()
    trace = parent["t"] if parent else _id("t")
    _record(trace, _id("s"), parent["s"] if parent else None, str(name),
            cat, int(ts_us), int(dur_us), args)


class _Activation:
    """Tiny context manager making a frame current (class-based: this
    sits on the router dispatch hot path, where a contextlib generator
    costs real microseconds under the GIL)."""

    __slots__ = ("_frame", "_token")

    def __init__(self, frame):
        self._frame = frame
        self._token = None

    def __enter__(self):
        if self._frame is not None:
            self._token = _ctx.set(self._frame)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _ctx.reset(self._token)


def activate(handle_or_frame):
    """Make a span (or wire frame) the current context for the body —
    children opened inside parent to it, transport requests inject it."""
    frame = handle_or_frame.frame() \
        if isinstance(handle_or_frame, (SpanHandle, _NullSpan)) \
        else handle_or_frame
    return _Activation(frame)


@contextlib.contextmanager
def span(name, cat="span", parent=None, **args):
    """Timed child span of the current context, active for the body."""
    if not enabled():
        yield NULL_SPAN
        return
    sp = start_span(name, parent=parent, cat=cat, **args)
    token = _ctx.set(sp.frame())
    try:
        yield sp
    finally:
        _ctx.reset(token)
        sp.end()


def rpc_span(msg, peer):
    """Transport-client hook (`dist.transport.Channel`): open a span
    for this request and inject its context as the frame's ``tr``
    field.  An explicit ``tr`` already on the message (a submit-time
    capture from another thread, e.g. `RemoteReplica`) becomes the
    PARENT — the rpc span slots under the request that queued it."""
    if not enabled():
        return NULL_SPAN
    parent = msg.get("tr") or _ctx.get()
    sp = start_span(f"rpc.{msg.get('cmd')}", parent=parent, cat="rpc",
                    peer=str(peer))
    msg["tr"] = sp.frame()
    return sp


@contextlib.contextmanager
def server_span(msg, name, cat="server", **args):
    """Server-handler hook: adopt the frame's ``tr`` as parent, open
    the handling span, and keep it current for the body — the
    cross-process edge of the span tree."""
    if not enabled():
        yield NULL_SPAN
        return
    parent = msg.get("tr") if isinstance(msg, dict) else None
    sp = start_span(name, parent=parent, cat=cat, **args)
    token = _ctx.set(sp.frame())
    try:
        yield sp
    finally:
        _ctx.reset(token)
        sp.end()
