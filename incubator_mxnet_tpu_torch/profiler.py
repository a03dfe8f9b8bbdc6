"""Profiler (reference `python/mxnet/profiler.py`, C++ `src/profiler/`).

PyTorch port of `incubator_mxnet_tpu/profiler.py`, the same API
(set_config/set_state/dump/dumps, pause/resume, the Task/Frame/Counter/
Marker custom objects, the ``record_*`` hooks) over `torch.profiler`:

* ``set_state("run")`` starts a `torch.profiler.profile` session with
  the CPU activity and, when a card is present, the CUDA one (the JAX
  package starts `jax.profiler.start_trace`); ``set_state("stop")`` ends
  it and exports its chrome trace into ``<filename stem>_trace/``, where
  the JAX package writes its XLA trace directory.
* `dumps` gives the aggregate table of the custom events and then the
  last stopped session's per-op table (`key_averages`).
* `dump` writes ``filename`` as one chrome trace: the custom events
  (tasks, frames, counters, markers, serving batches, fault and kvstore
  instants, per-op and memory samples) followed by the events of the
  last stopped `torch.profiler` session, kernels included.  The custom
  events keep the JAX package's clock (`time.perf_counter` in us); the
  torch events keep the profiler's own, so the two are not aligned on
  one time axis.
* `Task` and `Frame` open a `torch.profiler.record_function` range (the
  JAX package's `TraceAnnotation`), so they show in the torch trace too.
* eager ops are timed only while a session runs with
  ``profile_imperative`` (or ``profile_all``): `ndarray.invoke`
  synchronizes the op's card before reading the clock, the counterpart
  of the JAX package's `block_until_ready`.
* `record_memory` samples `storage.memory_stats` (PyTorch's caching
  allocator on the card; ``{}`` on the CPU, where nothing is recorded).

The custom-event buffer is bounded (``MXNET_PROFILER_MAX_EVENTS``,
drop-oldest, counted) and registered as the ``profiler`` telemetry
producer; ``profile_process='server'`` forwards to the parameter servers
through the kvstore registered with `set_kvstore_handle`.
``MXNET_PROFILER_AUTOSTART`` starts a session at import.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "Task", "Frame", "Counter", "Marker",
           "record_memory", "record_serving", "record_supervisor",
           "record_guardian"]

_config = {"profile_all": False, "profile_symbolic": False,
           "profile_imperative": False, "profile_memory": False,
           "profile_api": False, "filename": "profile.json",
           "aggregate_stats": False}
_state = {"running": False, "dir": None, "session": None,
          "last": None, "trace_file": None}
# BOUNDED event buffer: past MXNET_PROFILER_MAX_EVENTS the OLDEST events
# drop (the newest window is the one being debugged), counted in _dropped
# and surfaced as the 'profiler.dropped_events' metric
_custom_events = collections.deque()
_dropped = [0]
_cap = [None]     # resolved lazily from config (tests re-point it)
_lock = threading.Lock()


def _event_cap():
    if _cap[0] is None:
        from . import config as _config_mod
        _cap[0] = max(int(_config_mod.get("MXNET_PROFILER_MAX_EVENTS")), 1)
    return _cap[0]


def set_event_cap(n):
    """Override the in-memory event-buffer cap (tests; None re-reads
    MXNET_PROFILER_MAX_EVENTS on the next emit)."""
    _cap[0] = None if n is None else max(int(n), 1)


def buffer_stats():
    """{"events", "dropped_events", "cap", "running"} — registered as
    the 'profiler' namespace in the obs metrics registry."""
    with _lock:
        return {"events": len(_custom_events),
                "dropped_events": _dropped[0],
                "cap": _event_cap(),
                "running": _state["running"]}


_kvstore_handle = [None]
_atexit_armed = []


def set_kvstore_handle(kv):
    """Register the dist kvstore used to forward `profile_process=
    'server'` commands (reference `profiler.py:29 set_kvstore_handle`;
    KVStoreDist registers itself on creation)."""
    _kvstore_handle[0] = kv


def _forward_to_servers(action, **kw):
    kv = _kvstore_handle[0]
    if kv is None or not hasattr(kv, "server_profiler_command"):
        raise RuntimeError(
            "profile_process='server' requires a dist kvstore "
            "(create one before driving the server profiler)")
    kv.server_profiler_command(action, **kw)


def set_config(**kwargs):
    """Reference `profiler.py:33 set_config`."""
    if kwargs.pop("profile_process", "worker") == "server":
        _forward_to_servers("set_config", config=kwargs)
        return
    _config.update(kwargs)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def set_state(state_="stop", profile_process="worker"):
    """'run' starts a torch.profiler session; 'stop' ends it and writes
    its chrome trace (reference `profiler.py set_state` →
    `MXSetProcessProfilerState`); profile_process='server' drives the
    dist parameter servers' profilers instead."""
    if profile_process == "server":
        _forward_to_servers("set_state", state=state_)
        return
    if state_ == "run" and not _state["running"]:
        import torch.profiler as _tp
        trace_dir = os.path.splitext(_config["filename"])[0] + "_trace"
        os.makedirs(trace_dir, exist_ok=True)
        session = _tp.profile(
            activities=_activities(),
            profile_memory=bool(_config.get("profile_memory")
                                or _config.get("profile_all")))
        session.__enter__()
        _state.update(running=True, dir=trace_dir, session=session)
        if not _atexit_armed:
            # a session still running when the interpreter exits is
            # ended (and its trace written) first: torch's profiler
            # must not be torn down while it records
            _atexit_armed.append(True)
            atexit.register(pause)
    elif state_ == "stop" and _state["running"]:
        session, _state["session"] = _state["session"], None
        _state.update(running=False)
        if session is not None:
            session.__exit__(None, None, None)
            path = os.path.join(_state["dir"], "torch_trace.json")
            session.export_chrome_trace(path)
            _state.update(last=session, trace_file=path)


def state():
    return "run" if _state["running"] else "stop"


def pause(profile_process="worker"):
    set_state("stop", profile_process=profile_process)


def resume(profile_process="worker"):
    set_state("run", profile_process=profile_process)


def _torch_events():
    """The events of the last stopped torch.profiler session ([] before
    one ended or when its file is gone)."""
    path = _state["trace_file"]
    if not path:
        return []
    try:
        with open(path, encoding="utf-8") as f:
            return list(json.load(f).get("traceEvents", []))
    except (OSError, ValueError):
        return []


def dump(finished=True, profile_process="worker"):
    """Write the custom events and the last torch.profiler session's
    events as one chrome trace (reference `MXDumpProfile`);
    profile_process='server' makes each parameter server write ITS
    profile file."""
    if profile_process == "server":
        _forward_to_servers("dump")
        return
    with _lock:
        events = list(_custom_events)
    events.extend(_torch_events())
    with open(_config["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def dumps(reset=False):
    """Aggregate stats string (reference `MXAggregateProfileStatsPrint`)."""
    lines = ["Profile Statistics:"]
    with _lock:
        by_name = {}
        for ev in _custom_events:
            if ev.get("ph") == "X":
                by_name.setdefault(ev["name"], []).append(ev["dur"])
        for name, durs in sorted(by_name.items()):
            lines.append(f"  {name}: count={len(durs)} "
                         f"total_us={sum(durs):.1f} avg_us={sum(durs)/len(durs):.1f}")
        if reset:
            _custom_events.clear()
    session = _state["last"]
    if session is not None:
        # the per-op table of the last stopped torch.profiler session
        # (the reference's aggregate table of operators and kernels)
        lines.append("torch.profiler (last session):")
        lines.append(session.key_averages().table(
            sort_by="self_device_time_total" if _has_device(session)
            else "self_cpu_time_total", row_limit=40))
        if reset:
            _state["last"] = None
    return "\n".join(lines)


def _has_device(session):
    from torch.profiler import ProfilerActivity
    return ProfilerActivity.CUDA in session.activities


def _emit(event):
    cap = _event_cap()
    with _lock:
        _custom_events.append(event)
        while len(_custom_events) > cap:
            # drop-oldest, counted: memory stays bounded and the loss
            # is visible in the scrape plane instead of silent
            _custom_events.popleft()
            _dropped[0] += 1


def _tid():
    """Stable small int for the chrome-trace tid lane (trace viewers
    reject non-int tids; the thread NAME rides in args['thread'])."""
    return threading.get_ident() & 0xFFFF


def _tname():
    return threading.current_thread().name


def _imperative_active():
    """True when eager ops should be timed (reference
    `profile_imperative` config, `MXSetProcessProfilerConfig`)."""
    return _state["running"] and (_config.get("profile_imperative", True)
                                  or _config.get("profile_all", False))


def record_op(name, dur_us):
    """Record one eager operator execution (feeds the per-op aggregate
    table, reference `profiler.cc` ProfileOperator)."""
    _emit({"name": name, "cat": "operator", "ph": "X",
           "dur": float(dur_us), "ts": 0, "pid": 0, "tid": 0})
    if _config.get("profile_memory") or _config.get("profile_all"):
        record_memory(name)


def record_memory(tag="memory", ctx=None):
    """Record a device-memory sample (reference memory profiler:
    `src/profiler/storage_profiler.h`, aggregated as `Memory:<device>`
    counters in DumpProfile) from `storage.memory_stats`: PyTorch's
    caching allocator on the card; on the CPU nothing is recorded and
    None returned."""
    from .storage import memory_stats
    stats = memory_stats(ctx)
    if not stats:
        return None
    ev = {"name": f"Memory:{tag}", "cat": "memory", "ph": "C",
          "ts": time.perf_counter() * 1e6, "pid": 0, "tid": 0,
          "args": {"bytes_in_use": int(stats.get("bytes_in_use", 0)),
                   "peak_bytes_in_use":
                       int(stats.get("peak_bytes_in_use", 0))}}
    _emit(ev)
    return ev["args"]


def record_serving(name, dur_us, **args):
    """Record one serving batch execution (serving.metrics feeds this per
    executed bucket) into the chrome trace next to the custom-object
    events.  A no-op unless a profile is running, so the serving hot path
    never accumulates events nobody will dump."""
    if not _state["running"]:
        return
    _emit({"name": name, "cat": "serving", "ph": "X",
           "ts": time.perf_counter() * 1e6 - float(dur_us),
           "dur": float(dur_us), "pid": 0, "tid": _tid(),
           "args": dict(args, thread=_tname())})


def _record_instant(cat, name, **args):
    """One global instant event in the chrome trace with the emitting
    thread's lane — the shared emitter behind the supervisor/guardian/
    fault event lanes.  A no-op unless a profile is running."""
    if not _state["running"]:
        return
    _emit({"name": f"{cat}:{name}", "cat": cat, "ph": "i", "s": "g",
           "ts": time.perf_counter() * 1e6, "pid": 0, "tid": _tid(),
           "args": dict(args, thread=_tname())})


def record_supervisor(event, **args):
    """Record one elastic-supervisor event (host lost, straggler flagged,
    collective watchdog timeout, shrink commit)."""
    _record_instant("supervisor", event, **args)


def record_guardian(event, **args):
    """Record one training-guardian event (skip-batch, rollback,
    quarantine, divergence)."""
    _record_instant("guardian", event, **args)


def record_kvstore(event, **args):
    """Record one bucketed-communication event (the kvstore feeds this per
    batched push), so the gradient exchange lines up against the train
    steps it served."""
    _record_instant("kvstore", event, **args)


def record_fault(site, kind, **args):
    """Record one fired fault / resilience event (resilience.faults feeds
    this), so chaos-run failure injections line up against the serving
    batches and device work they disrupted."""
    _record_instant("fault", site, kind=kind, **args)


class _Named:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Task(_Named):
    """Reference `profiler.py:257 Task`."""

    def __init__(self, name, domain=None):
        super().__init__(name)
        self._t0 = None
        self._ann = None

    def start(self):
        self._t0 = time.perf_counter_ns()
        self._ann = None
        if _state["running"]:
            import torch.profiler as _tp
            self._ann = _tp.record_function(self.name)
            self._ann.__enter__()

    def stop(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._t0 is not None:
            dur = (time.perf_counter_ns() - self._t0) / 1000.0
            _emit({"name": self.name, "ph": "X", "cat": "task",
                   "ts": self._t0 / 1000.0, "dur": dur, "pid": 0, "tid": 0})


class Frame(Task):
    """Reference `profiler.py Frame`."""


class Counter:
    """Reference `profiler.py Counter`."""

    def __init__(self, name, domain=None, value=None):
        self.name = name
        self.value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self.value = value
        _emit({"name": self.name, "ph": "C", "ts": time.perf_counter_ns() / 1e3,
               "pid": 0, "args": {self.name: value}})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    """Reference `profiler.py Marker` (instant event)."""

    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        _emit({"name": self.name, "ph": "i", "ts": time.perf_counter_ns() / 1e3,
               "pid": 0, "tid": 0, "s": scope[0]})


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Deprecated reference API kept for compatibility."""
    set_config(filename=filename)


def profiler_set_state(state_="stop"):
    set_state(state_)


# telemetry plane: the buffer economy under the 'profiler' namespace
from .obs import metrics as _obs_metrics  # noqa: E402

_obs_metrics.register_producer("profiler", buffer_stats)


def _autostart():
    """``MXNET_PROFILER_AUTOSTART``: start a session at import (JAX
    `config.apply_startup_knobs`)."""
    from . import config as _config_mod
    if _config_mod.get("MXNET_PROFILER_AUTOSTART"):
        set_state("run")


_autostart()
