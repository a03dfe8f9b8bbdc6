"""One tested O_APPEND JSONL writer for every event sink in the tree.

PyTorch port of `incubator_mxnet_tpu/obs/jsonl_sink.py`: the same records,
fields and wire frames, so `tools/mxtrace.py` and `tools/mxtop.py` read
the port's output unchanged.

Three subsystems grew hand-rolled newline-delimited JSON appenders —
the resilience fault log (``MXNET_FAULTS_LOG``), the concurrency
sanitizer dump (``MXNET_TSAN_LOG``), and the training guardian's
quarantine file — each re-implementing the same two invariants:

* **line atomicity** — the file is opened ``O_APPEND`` and each entry
  is ONE ``os.write`` of one ``\\n``-terminated line, so every process
  of a multi-host chaos run can share a single log file without
  interleaving or clobbering each other's events (POSIX makes each
  append atomic);
* **provenance stamping** — every entry names its emitting process
  (pid), its DMLC rank when the launcher set one (read per write — the
  shrink-and-resume path re-ranks a live process mid-run), and its
  thread name, so an artifact line is attributable to the router
  health loop vs a dispatch thread vs a supervisor heartbeat, not just
  to "the process".

This module is that one implementation.  `sink(path)` returns a
process-wide shared `JsonlSink` per path (the fd is opened lazily and
cached); `JsonlSink.write(entry)` stamps and appends, swallowing
``OSError`` — an observability sink must never take the instrumented
code path down.  Stamps use ``setdefault``: an entry that already
carries a field (a pre-stamped event forwarded from another layer)
keeps its own value.

The distributed-tracing span stream (`obs.trace`) writes through this
sink too, which is what makes ``tools/mxtrace.py``'s cross-process
merge trivial: every process of a run appends spans to one shared
file, one line per span.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["JsonlSink", "sink", "stamp", "read_jsonl", "close_all"]

# one shared compact encoder: the span flusher serializes thousands of
# events per flush, and the default encoder's whitespace costs real
# time at that rate
_dumps = json.JSONEncoder(separators=(",", ":"), default=str).encode

_sinks = {}
_sinks_lock = threading.Lock()   # plain: this module must stay import-light

# getpid is a real syscall on hardened containers (measured ~8us under
# seccomp) and stamping is per event: cache it, refreshed after fork
_PID = [os.getpid()]
if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _PID.__setitem__(0, os.getpid()))


def stamp(entry):
    """Add pid / rank / thread / time provenance to `entry` in place
    (pre-stamped fields win — producers that capture their emitting
    thread before handing records to a background writer keep it) and
    return it.  Field work is lazy: this runs once per event."""
    if "pid" not in entry:
        entry["pid"] = _PID[0]
    if "thread" not in entry:
        entry["thread"] = threading.current_thread().name
    if "rank" not in entry:
        rank = os.environ.get("DMLC_RANK")
        entry["rank"] = int(rank) if rank is not None \
            and rank.isdigit() else None
    if "time" not in entry:
        entry["time"] = round(time.time(), 3)
    return entry


class JsonlSink:
    """Append-only JSONL file: one stamped, line-atomic write per entry."""

    def __init__(self, path):
        self.path = str(path)
        self._fd = None
        self._open_lock = threading.Lock()
        self.written = 0
        self.errors = 0

    def _ensure_fd(self):
        """The one fd per sink, opened exactly once (two threads of a
        shared process-wide sink racing the lazy open must not leak a
        second fd).  O_APPEND: every write() lands atomically, so all
        processes/threads of a chaos run share one file without
        interleaving mid-line."""
        if self._fd is None:
            with self._open_lock:
                if self._fd is None:
                    self._fd = os.open(
                        self.path,
                        os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        return self._fd

    def write(self, entry):
        """Stamp and append one entry as a single line.  Returns the
        stamped entry (callers that also keep an in-memory trace reuse
        it).  IO errors are counted, never raised."""
        stamp(entry)
        try:
            os.write(self._ensure_fd(), (_dumps(entry) + "\n").encode())
            self.written += 1
        except OSError:
            self.errors += 1
        return entry

    def write_many(self, entries):
        """Append a batch of stamped entries with ONE write: each line
        is still intact (the single append lands atomically), and the
        per-entry syscall cost amortizes — this is the span flusher's
        path, where a write per span would tax the traced hot path."""
        # batch-level stamping: the rank env read and the wall-clock
        # round cost microseconds EACH at per-entry rate; one value per
        # batch is exact for rank and coarse-but-unused for time on
        # span records (they carry their own ts)
        rank = os.environ.get("DMLC_RANK")
        rank = int(rank) if rank is not None and rank.isdigit() else None
        now = round(time.time(), 3)
        pid = _PID[0]
        thread = threading.current_thread().name
        blob = bytearray()
        n = 0
        for e in entries:
            if "pid" not in e:
                e["pid"] = pid
            if "thread" not in e:
                e["thread"] = thread
            if "rank" not in e:
                e["rank"] = rank
            if "time" not in e:
                e["time"] = now
            try:
                blob += (_dumps(e) + "\n").encode()
                n += 1
            except (TypeError, ValueError):
                self.errors += 1
        if not n:
            return
        try:
            os.write(self._ensure_fd(), bytes(blob))
            self.written += n
        except OSError:
            self.errors += 1

    def write_rendered(self, lines):
        """Append pre-rendered JSON lines (no trailing newline) with
        ONE write — the span flusher's fast path: its records have a
        fixed schema it renders itself (`obs.trace._render`), skipping
        the generic encoder."""
        if not lines:
            return
        try:
            os.write(self._ensure_fd(),
                     ("\n".join(lines) + "\n").encode())
            self.written += len(lines)
        except OSError:
            self.errors += 1

    def close(self):
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


def sink(path):
    """The process-wide shared sink for `path` (one fd per file, every
    subsystem appending to the same log shares it)."""
    path = str(path)
    with _sinks_lock:
        s = _sinks.get(path)
        if s is None:
            s = _sinks[path] = JsonlSink(path)
        return s


def read_jsonl(path):
    """Every parseable entry in a JSONL file, oldest first (damaged
    lines — a process killed mid-append on a non-POSIX fs — are
    skipped, not fatal)."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def close_all():
    """Close every cached fd (tests that rotate tmp dirs)."""
    with _sinks_lock:
        sinks = list(_sinks.values())
        _sinks.clear()
    for s in sinks:
        s.close()
