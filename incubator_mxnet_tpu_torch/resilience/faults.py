"""Deterministic fault injection.

PyTorch port of `incubator_mxnet_tpu/resilience/faults.py`: the same
registry, spec grammar, firing controls, trace and log.  Failure modes
are injected at NAMED SITES on the failure-prone paths; a site is one
`fire(site, **ctx)` call, which costs a function call and one global
read when no fault is configured.  The port wires the ``serving.execute``
site (the micro-batcher's batch execution), the router's
``router.dispatch``, ``replica.health`` and ``replica.swap``, the fleet's
``fleet.spawn`` and ``host.down``, the checkpoint writer's
``checkpoint.commit`` (a ``torn`` clause commits a directory without its
manifest), the training guardian's ``grad.nonfinite`` and ``loss.spike``
(fired once a fused train step; an ``error`` clause becomes a NaN or a
1e6 gradient multiplier for that step), the record readers'
``io.corrupt_record`` payload site, and the train-to-serve loop's
``publish.commit`` and ``canary.eval``; the transport's and the parameter
server's sites come with ROADMAP item 14-dist.

Faults come from the ``MXNET_FAULTS`` environment spec or the
programmatic `inject()` API.  Spec grammar (clauses joined with ``;``)::

    MXNET_FAULTS = clause (';' clause)*
    clause       = 'seed=' INT
                 | site ':' kind [ '(' key '=' value (',' key '=' value)* ')' ]
    kind         = refuse | drop | slow | crash | torn | error | hang | kill
                 | corrupt

Firing controls (any clause):

* ``at=N`` / ``at=N-M``  — fire on the Nth (or Nth..Mth) matching hit only
* ``n=N``                — fire on the first N matching hits
* ``p=F``                — fire with probability F from the SEEDED stream
* ``cmd=NAME``           — only hits whose context carries ``cmd=NAME``
* ``record=N``           — only hits whose context carries ``record=N``

A ``corrupt`` clause damages a payload: it fires only through
`mutate(site, payload)`, the hook of a site that holds bytes, which
returns a bit-flipped copy (``bytes=N`` positions, seeded by the
schedule's seed, the site and the hit; ``offset=K`` flips N bytes from
K instead); `fire` skips ``corrupt`` clauses.  Every fired fault appends
an event to an in-process trace (`trace()`), and, when
``MXNET_FAULTS_LOG`` names a file, one JSON line per event, stamped with
the process id, the ``DMLC_RANK``, the thread and the time and written
through the shared line-atomic sink (`obs.jsonl_sink`), so the processes
of one run share a log; each event is also a `profiler.record_fault`
instant while a profile runs, as in the JAX package.  The same seed
always gives the same schedule.
"""
from __future__ import annotations

import os
import random
import re
import threading
import time

from .. import profiler as _profiler
from ..obs import jsonl_sink as _jsonl

from ..base import MXNetError

__all__ = ["FaultInjected", "TornWrite", "configure", "inject", "clear",
           "reset", "trace", "fire", "mutate", "note", "active",
           "parse_spec"]


class FaultInjected(Exception):
    """Base of every injected failure that surfaces as an exception."""

    def __init__(self, site, kind, message=""):
        self.site = site
        self.kind = kind
        super().__init__(message or f"fault-injected {kind} at {site}")


class TornWrite(FaultInjected):
    """Checkpoint writer 'died' mid-commit (see checkpoint/snapshot.py)."""


_KINDS = ("refuse", "drop", "slow", "crash", "torn", "error", "hang",
          "kill", "corrupt")
_CLAUSE_RE = re.compile(
    r"^(?P<site>[\w.]+):(?P<kind>\w+)(?:\((?P<args>[^)]*)\))?$")


class _Clause:
    """One parsed fault clause with its own deterministic hit counter."""

    def __init__(self, site, kind, args, seed):
        if kind not in _KINDS:
            raise MXNetError(f"MXNET_FAULTS: unknown fault kind {kind!r} "
                             f"(one of {', '.join(_KINDS)})")
        self.site = site
        self.kind = kind
        self.args = args
        self.hits = 0          # matching-site hits observed
        self.fired = 0         # faults actually fired
        at = args.get("at")
        if at is not None and "-" in str(at):
            lo, hi = str(at).split("-", 1)
            self.at = (int(lo), int(hi))
        elif at is not None:
            self.at = (int(at), int(at))
        else:
            self.at = None
        self.limit = int(args["n"]) if "n" in args else None
        self.prob = float(args["p"]) if "p" in args else None
        self.cmd = args.get("cmd")
        self.record = int(args["record"]) if "record" in args else None
        # each probabilistic clause draws from its OWN seeded stream so
        # adding a clause never perturbs another clause's schedule
        self._rng = random.Random((seed, site, kind, repr(sorted(
            args.items()))).__repr__()) if self.prob is not None else None

    def matches(self, site, ctx):
        if site != self.site:
            return False
        if self.cmd is not None and ctx.get("cmd") != self.cmd:
            return False
        if self.record is not None and ctx.get("record") != self.record:
            return False
        return True

    def evaluate(self):
        """Advance this clause's hit counter (and Bernoulli stream) and
        report whether it WOULD fire.  The caller increments `fired` only
        for the clause actually executed, so a clause shadowed by an
        earlier one on the same hit does not silently burn its n= budget."""
        self.hits += 1
        draw = self._rng.random() if self._rng is not None else None
        if self.at is not None and not (self.at[0] <= self.hits <= self.at[1]):
            return False
        if self.limit is not None and self.fired >= self.limit:
            return False
        if draw is not None and draw >= self.prob:
            return False
        return True


def _parse_args(text):
    args = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            raise MXNetError(f"MXNET_FAULTS: bad clause arg {part!r} "
                             "(want key=value)")
        args[key.strip()] = value.strip()
    return args


def parse_spec(spec, seed=0):
    """Parse an ``MXNET_FAULTS`` spec string -> (clauses, seed)."""
    clauses = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("seed="):
            seed = int(raw[5:])
            continue
        m = _CLAUSE_RE.match(raw)
        if m is None:
            raise MXNetError(f"MXNET_FAULTS: cannot parse clause {raw!r} "
                             "(want site:kind(key=val,...))")
        clauses.append((m.group("site"), m.group("kind"),
                        _parse_args(m.group("args"))))
    return clauses, seed


# -- global state -------------------------------------------------------------
# ACTIVE is the hot-path gate: False means fire() returns after ONE global
# read.  None means "MXNET_FAULTS not parsed yet" (first fire parses it).
ACTIVE = None
_lock = threading.Lock()   # taken only while faults are configured
_clauses = []
_trace = []
_seed = 0
_log_path = None


def _load_env():
    global ACTIVE, _seed, _log_path
    spec = os.environ.get("MXNET_FAULTS", "")
    _log_path = os.environ.get("MXNET_FAULTS_LOG") or None
    clauses, _seed = parse_spec(spec, 0)
    for site, kind, args in clauses:
        _clauses.append(_Clause(site, kind, args, _seed))
    ACTIVE = bool(_clauses)


def active():
    """Whether any fault clause is configured."""
    if ACTIVE is None:
        with _lock:
            if ACTIVE is None:
                _load_env()
    return bool(ACTIVE)


def configure(spec, seed=None):
    """Install a full fault schedule from a spec string (replaces any
    previous schedule; counters and trace reset)."""
    global ACTIVE, _seed
    clauses, parsed_seed = parse_spec(spec, seed if seed is not None else 0)
    with _lock:
        _clauses.clear()
        _trace.clear()
        _seed = parsed_seed if seed is None else seed
        for site, kind, args in clauses:
            _clauses.append(_Clause(site, kind, args, _seed))
        ACTIVE = bool(_clauses)


def inject(site, kind, **args):
    """Add one fault clause programmatically, e.g.
    ``inject('transport.send', 'drop', at=2, cmd='push')``."""
    global ACTIVE
    active()   # fold in any env-configured clauses first
    with _lock:
        _clauses.append(_Clause(site, kind,
                                {k: str(v) for k, v in args.items()}, _seed))
        ACTIVE = True


def clear():
    """Remove every fault clause and the trace (ACTIVE goes False —
    the hot path returns to its one-global-read cost)."""
    global ACTIVE
    with _lock:
        _clauses.clear()
        _trace.clear()
        ACTIVE = False


def reset():
    """Reset hit counters and the trace, keeping the configured clauses
    (reruns of a schedule start from hit 1 again)."""
    with _lock:
        _trace.clear()
        for c in _clauses:
            c.hits = 0
            c.fired = 0
            if c._rng is not None:
                c._rng = random.Random((_seed, c.site, c.kind, repr(sorted(
                    c.args.items()))).__repr__())


def trace():
    """Every fired fault so far: [{site, kind, hit, seq, ctx}]."""
    with _lock:
        return [dict(e) for e in _trace]


def _record(event):
    # every event names its process, rank and thread (the shared sink's
    # stamping), and lands in the log through the sink: O_APPEND and one
    # write() a line, so every process of a run appends to one file
    _jsonl.stamp(event)
    _trace.append(event)
    if _log_path is not None:
        _jsonl.sink(_log_path).write(event)
    try:
        _profiler.record_fault(event.get("site"), event.get("kind"),
                               **event.get("ctx", {}))
    except Exception:
        pass   # a fault event must never take the injected code path down


def note(event, **ctx):
    """Log a non-fault event (retry, reconnect, recovery) into the same
    trace/log stream so chaos artifacts can count them next to the
    faults that caused them.  No-op when no schedule is configured."""
    if not active():
        return
    with _lock:
        _record({"event": event, "site": ctx.pop("site", None), "kind": None,
                 "ctx": {k: v for k, v in ctx.items()
                         if isinstance(v, (str, int, float, bool))}})


def fire(site, **ctx):
    """The site hook.  Returns instantly when no faults are configured;
    otherwise evaluates each matching clause's deterministic schedule and
    executes the first fault that fires (raise / sleep / socket close).
    ``corrupt`` clauses never fire here — they need bytes to damage — so
    they neither advance nor consume hits at a `fire()` site."""
    if not ACTIVE:
        if ACTIVE is None:
            active()
            if not ACTIVE:
                return
        else:
            return
    clause = None
    with _lock:
        # every matching clause's hit counter and Bernoulli stream
        # advance on every hit — whether another clause fired first or
        # not — so one clause's schedule never perturbs another's; only
        # the clause actually executed consumes its n= budget
        for c in _clauses:
            if c.kind == "corrupt":
                continue
            if c.matches(site, ctx) and c.evaluate() and clause is None:
                clause = c
        if clause is None:
            return
        clause.fired += 1
        event = {"event": "fault", "site": site, "kind": clause.kind,
                 "hit": clause.hits, "seq": len(_trace) + 1,
                 "ctx": {k: v for k, v in ctx.items()
                         if isinstance(v, (str, int, float, bool))}}
        _record(event)
    _execute(clause, site, ctx)


def mutate(site, payload, **ctx):
    """The payload-site hook: `fire` plus the ``corrupt`` kind.

    Returns `payload` untouched when nothing fires; a firing ``corrupt``
    clause returns a deterministic bit-flipped copy (seeded by the
    schedule's seed, the site and the hit, so the same spec damages the
    same bytes of the same record); any other kind runs as in `fire`."""
    if not ACTIVE:
        if ACTIVE is None:
            active()
            if not ACTIVE:
                return payload
        else:
            return payload
    clause = None
    with _lock:
        for c in _clauses:
            if c.matches(site, ctx) and c.evaluate() and clause is None:
                clause = c
        if clause is None:
            return payload
        clause.fired += 1
        event = {"event": "fault", "site": site, "kind": clause.kind,
                 "hit": clause.hits, "seq": len(_trace) + 1,
                 "ctx": {k: v for k, v in ctx.items()
                         if isinstance(v, (str, int, float, bool))}}
        _record(event)
        hit = clause.hits
    if clause.kind != "corrupt":
        _execute(clause, site, ctx)
        return payload
    data = bytearray(payload)
    if not data:
        return payload
    n = min(int(clause.args.get("bytes", 16)), len(data))
    rng = random.Random((_seed, site, hit).__repr__())
    if "offset" in clause.args:
        start = int(clause.args["offset"]) % len(data)
        positions = [(start + i) % len(data) for i in range(n)]
    else:
        positions = rng.sample(range(len(data)), n)
    for pos in positions:
        # a non-zero seeded byte: every chosen position changes
        data[pos] ^= rng.randint(1, 255)
    return bytes(data)


def _execute(clause, site, ctx):
    kind = clause.kind
    if kind == "slow":
        time.sleep(float(clause.args.get("ms", 100)) / 1e3)
        return
    if kind == "refuse":
        raise ConnectionRefusedError(
            f"fault-injected connection refused at {site}")
    if kind == "drop":
        # mid-message drop: tear the socket down under the caller so the
        # peer sees a half-frame + EOF, then surface the reset locally
        sock = ctx.get("sock")
        if sock is not None:
            try:
                sock.sendall(b"\x00\x00\x00")   # torn length prefix
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        raise ConnectionResetError(
            f"fault-injected mid-message connection drop at {site}")
    if kind == "crash":
        raise FaultInjected(site, "crash",
                            f"fault-injected server crash at {site}")
    if kind == "torn":
        raise TornWrite(site, "torn",
                        f"fault-injected torn write at {site}")
    if kind == "error":
        raise MXNetError(f"fault-injected error at {site}")
    if kind == "hang":
        # the lost-host stall: the call never returns on its own (default
        # 1h — far past any watchdog deadline); ms= bounds it for tests
        # that want the hang to eventually clear
        time.sleep(float(clause.args.get("ms", 3_600_000)) / 1e3)
        return
    if kind == "kill":
        # whole-host death: no atexit, no flush, no unwinding — the
        # SIGKILL-grade loss the membership deadline must detect (the
        # default code is the conventional 128+SIGKILL)
        os._exit(int(clause.args.get("code", 137)))
