"""Continuous-batching autoregressive decode engine.

PyTorch port of `incubator_mxnet_tpu/serving/decode.py`.  The stateless
serving plane (`ServedModel` + `MicroBatcher`) answers a request with
one dispatch.  An LM request holds STATE (its KV cache) across hundreds
of dispatches.  Waiting for a full batch and decoding it in lockstep
("static batching") leaves every finished-early slot idle until the
longest sequence completes.  This engine decodes continuously instead:

* a fixed pool of **slots** (rows of the fixed-shape KV cache);
* every tick runs ONE decode step advancing all occupied slots by one
  token;
* finished sequences (EOS / token budget / cache full) are evicted
  between ticks and their slots re-admitted from the queue via a
  bucketed **prefill** (one signature per prompt bucket of the ladder);
* admission is budgeted per tick (`MXNET_DECODE_ADMIT_PER_TICK`), so a
  burst of long prefills never stalls the decode tick for the sequences
  already running.

Prompts are padded onto the bucket ladder and the step's shape is fixed,
so after `warmup` the programs see no new signature however requests
arrive or finish (`DecodePrograms.program_count`).  The KV cache is
written in place by both programs: one copy on the card.

`DecodeReplica` wraps the engine in the `Replica` contract: a killed
engine fails its queued and in-flight futures with `ReplicaLostError`,
the router's failover trigger.  Declared divergences from the JAX
package: plain `threading` locks for `analysis.locks`; the signature
counts of `DecodePrograms` for the recompile auditor; the
``decode.prefill`` and ``decode.step`` spans are stamped on the wall
clock, as every other span, where the JAX engine stamps them with
`time.monotonic` (ROADMAP.md, Queue 3).  `stats()` is the
``decode.<name>`` telemetry producer.  ``swap`` takes ``arg_params`` or an elastic
``checkpoint_dir`` (the newest valid checkpoint's ``arg:`` arrays).
"""
from __future__ import annotations

import threading
import time

from concurrent.futures import Future

import numpy as _np

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace

from ..base import MXNetError
from .metrics import ServingMetrics
from .replica import Replica, ReplicaLostError
from .router import PRIORITIES

__all__ = ["DecodeEngine", "DecodeReplica", "DEFAULT_PROMPT_BUCKETS"]

DEFAULT_PROMPT_BUCKETS = (8, 16, 32)

_RANK_TO_CLASS = dict(enumerate(PRIORITIES))


def _knob(name, default):
    from .. import config as _config
    v = _config.get(name)
    return default if v in (None, "") else v


def _wall_start_us(dur_s):
    """The wall-clock start (us) of work that took `dur_s` and just ended:
    spans of every process share the wall clock's time axis."""
    return time.time_ns() // 1000 - int(dur_s * 1e6)


def _norm_priority(priority):
    """Router dispatch passes PRIORITY_RANK ints; direct callers pass
    class names.  Normalize to the class string."""
    if isinstance(priority, str):
        if priority not in PRIORITIES:
            raise MXNetError(f"decode: unknown priority {priority!r}")
        return priority
    return _RANK_TO_CLASS.get(int(priority), "batch")


class _Slot:
    """Host-side state of one cache row."""
    __slots__ = ("rid", "generated", "remaining", "future", "cls",
                 "t_submit", "pos", "last_token")

    def __init__(self, rid, first_token, prompt_len, max_new, future,
                 cls, t_submit):
        self.rid = rid
        self.generated = [int(first_token)]
        self.remaining = int(max_new) - 1
        self.future = future
        self.cls = cls
        self.t_submit = t_submit
        self.pos = int(prompt_len)      # where the NEXT K/V row lands
        self.last_token = int(first_token)


class _Pending:
    __slots__ = ("rid", "tokens", "max_new", "cls", "future", "t_submit",
                 "seq")

    def __init__(self, rid, tokens, max_new, cls, future, t_submit, seq):
        self.rid = rid
        self.tokens = tokens
        self.max_new = max_new
        self.cls = cls
        self.future = future
        self.t_submit = t_submit
        self.seq = seq


class DecodeEngine:
    """Continuous batching over one LM's decode programs.

    Parameters
    ----------
    cfg : llm.LMConfig
    arg_params : dict name -> array (the trained Module/gluon params;
        NDArray, torch or numpy values, e.g. ``nd.load(path)``)
    slots : cache rows decoded per tick (MXNET_DECODE_SLOTS)
    buckets : prompt-length ladder (MXNET_DECODE_BUCKETS)
    ctx : where the parameters and the cache live (default: the card)
    """

    def __init__(self, cfg, arg_params, slots=None, buckets=None,
                 name="lm", metrics=None, admit_per_tick=None,
                 max_new_default=None, start=True, ctx=None):
        from ..context import current_context
        from ..llm import DecodePrograms, stack_lm_params
        self.cfg = cfg
        self.name = name
        self.ctx = ctx if ctx is not None else current_context()
        self.slots = int(slots if slots is not None
                         else _knob("MXNET_DECODE_SLOTS", 8))
        if buckets is None:
            raw = _knob("MXNET_DECODE_BUCKETS", "")
            buckets = tuple(int(x) for x in str(raw).split(",") if x) \
                or DEFAULT_PROMPT_BUCKETS
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if self.buckets[-1] > cfg.max_len:
            raise MXNetError(
                "decode: largest prompt bucket %d exceeds max_len %d"
                % (self.buckets[-1], cfg.max_len))
        self.admit_per_tick = int(
            admit_per_tick if admit_per_tick is not None
            else _knob("MXNET_DECODE_ADMIT_PER_TICK", 2))
        self.max_new_default = int(
            max_new_default if max_new_default is not None
            else _knob("MXNET_DECODE_MAX_NEW", 32))
        self.metrics = metrics or ServingMetrics(name)
        self.programs = DecodePrograms(
            cfg, stack_lm_params(arg_params, cfg, ctx=self.ctx), label=name)
        # telemetry plane: this engine's stats() under 'decode.<name>'
        # (weakly held: a closed engine drops out)
        _obs_metrics.register_producer("decode.%s" % name, self.stats)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue = []            # sorted pending list (rank, seq)
        self._seq = 0
        self._slots = [None] * self.slots   # _Slot | None
        self._ck = self._cv = None
        self._dead = False
        self._draining = False
        self._executed_rids = []
        self.ticks = 0
        self.tokens_generated = 0
        self.admitted = 0
        self.evicted = 0
        self.rejected = 0
        self._tick_s_ewma = None
        self.warmed = False
        self._thread = None
        if start:
            self.warmup()
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def warmup(self):
        """Call every signature of the ladder up front (one prefill per
        bucket and the step) and stand up the live cache; returns the
        number of new signatures."""
        from ..llm import init_kv_cache
        compiles = self.programs.warmup(self.slots, self.buckets)
        self._ck, self._cv = init_kv_cache(self.cfg, self.slots, self.ctx)
        self.warmed = True
        return compiles

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="mx-decode-%s" % self.name,
                                        daemon=True)
        self._thread.start()

    def close(self, drain=True):
        with self._lock:
            if self._dead:
                return
            if drain:
                self._draining = True
                self._work.notify_all()
        if drain and self._thread is not None:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._queue and not any(self._slots):
                        break
                time.sleep(0.01)
        self._shutdown(ReplicaLostError(self.name, reason="engine closed"))

    def kill(self):
        """SIGKILL semantics: every queued and in-flight sequence fails
        with `ReplicaLostError` NOW — the router's failover trigger."""
        self._shutdown(ReplicaLostError(self.name,
                                        reason="decode engine killed"))

    def _shutdown(self, exc):
        with self._lock:
            if self._dead:
                return
            self._dead = True
            pending = list(self._queue)
            self._queue.clear()
            active = [s for s in self._slots if s is not None]
            self._slots = [None] * self.slots
            self._work.notify_all()
        for p in pending:
            if not p.future.done():
                p.future.set_exception(
                    ReplicaLostError(self.name, rid=p.rid,
                                     reason=str(exc)))
        for s in active:
            if not s.future.done():
                s.future.set_exception(
                    ReplicaLostError(self.name, rid=s.rid,
                                     reason=str(exc)))
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(10.0)

    # -- intake --------------------------------------------------------------
    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def submit(self, tokens, max_new_tokens=None, rid=None,
               priority="interactive", timeout_ms=None):
        """Queue one sequence; returns a Future resolving to
        ``{"rid", "tokens"}`` (the generated continuation)."""
        del timeout_ms   # admission control is the router's job
        cls = _norm_priority(priority)
        tokens = [int(t) for t in _np.asarray(tokens).reshape(-1)]
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_default)
        bucket = self.bucket_for(len(tokens))
        fut = Future()
        if not tokens or bucket is None \
                or len(tokens) + max_new > self.cfg.max_len:
            self.rejected += 1
            self.metrics.record_reject()
            fut.set_exception(MXNetError(
                "decode '%s': prompt of %d tokens (+%d new) does not fit "
                "the ladder (buckets %s, max_len %d)"
                % (self.name, len(tokens), max_new, self.buckets,
                   self.cfg.max_len)))
            return fut
        with self._lock:
            if self._dead:
                raise ReplicaLostError(self.name, rid=rid,
                                       reason="decode engine is down")
            if self._draining:
                raise MXNetError(
                    "decode '%s': draining, not accepting" % self.name)
            self._seq += 1
            if rid is None:
                rid = "%s/seq-%d" % (self.name, self._seq)
            p = _Pending(rid, tokens, max_new, cls, fut, time.monotonic(),
                         self._seq)
            rank = PRIORITIES.index(cls)
            at = len(self._queue)
            for i, q in enumerate(self._queue):
                if (PRIORITIES.index(q.cls), q.seq) > (rank, p.seq):
                    at = i
                    break
            self._queue.insert(at, p)
            self.metrics.record_request(
                len(self._queue) + sum(1 for s in self._slots if s))
            self._work.notify_all()
        return fut

    # -- engine loop ---------------------------------------------------------
    def _loop(self):
        while True:
            with self._lock:
                while not self._dead and not self._queue \
                        and not any(s is not None for s in self._slots):
                    self._work.wait(0.5)
                if self._dead:
                    return
            try:
                self.step()
            except Exception as exc:   # a broken program is engine death
                self._shutdown(ReplicaLostError(
                    self.name, reason="decode tick failed: %r" % (exc,)))
                return

    def step(self):
        """One engine tick: admit into free slots, then advance every
        occupied slot one token and evict the finished."""
        t0 = time.monotonic()
        self._admit()
        n = self._decode_tick()
        dt = time.monotonic() - t0
        if n:
            self._tick_s_ewma = dt if self._tick_s_ewma is None \
                else 0.9 * self._tick_s_ewma + 0.1 * dt
        self.ticks += 1
        return n

    def _admit(self):
        admitted = 0
        while admitted < self.admit_per_tick:
            with self._lock:
                if self._dead or not self._queue:
                    return
                free = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
                if free is None:
                    return
                p = self._queue.pop(0)
            bucket = self.bucket_for(len(p.tokens))
            padded = _np.zeros((1, bucket), _np.int32)
            padded[0, :len(p.tokens)] = p.tokens
            t0 = time.monotonic()
            _, _, tok, _ = self.programs.prefill(
                self.programs.params, self._ck, self._cv, padded, free,
                len(p.tokens))
            slot = _Slot(p.rid, int(tok), len(p.tokens), p.max_new,
                         p.future, p.cls, p.t_submit)
            dur = time.monotonic() - t0
            if _obs_trace.enabled():
                _obs_trace.record_span(
                    "decode.prefill", _wall_start_us(dur), dur * 1e6,
                    cat="serving", rid=p.rid, bucket=bucket,
                    prompt_len=len(p.tokens))
            with self._lock:
                if self._dead:
                    if not p.future.done():
                        p.future.set_exception(ReplicaLostError(
                            self.name, rid=p.rid, reason="killed"))
                    return
                self._slots[free] = slot
                self.admitted += 1
            self.metrics.record_batch(1, bucket, dur)
            admitted += 1
            if slot.remaining <= 0 or slot.last_token == self.cfg.eos_id \
                    or slot.pos + 1 >= self.cfg.max_len:
                self._evict(free)

    def _decode_tick(self):
        with self._lock:
            live = [(i, s) for i, s in enumerate(self._slots)
                    if s is not None]
        if not live:
            return 0
        tokens = _np.zeros((self.slots,), _np.int32)
        positions = _np.zeros((self.slots,), _np.int32)
        for i, s in live:
            tokens[i] = s.last_token
            positions[i] = s.pos
        t0 = time.monotonic()
        _, _, next_tokens, _ = self.programs.step(
            self.programs.params, self._ck, self._cv, tokens, positions)
        next_tokens = next_tokens.cpu().numpy()
        dur = time.monotonic() - t0
        if _obs_trace.enabled():
            _obs_trace.record_span(
                "decode.step", _wall_start_us(dur), dur * 1e6,
                cat="serving", slots_active=len(live),
                slots_total=self.slots)
        self.metrics.record_batch(len(live), self.slots, dur)
        produced = 0
        for i, s in live:
            tok = int(next_tokens[i])
            s.generated.append(tok)
            s.last_token = tok
            s.pos += 1
            s.remaining -= 1
            produced += 1
            if s.remaining <= 0 or tok == self.cfg.eos_id \
                    or s.pos + 1 >= self.cfg.max_len:
                self._evict(i)
        self.tokens_generated += produced
        return produced

    def _evict(self, idx):
        with self._lock:
            s = self._slots[idx]
            self._slots[idx] = None
            if s is None:
                return
            self.evicted += 1
            self._executed_rids.append(s.rid)
            del self._executed_rids[:-4096]
        if not s.future.done():
            s.future.set_result({"rid": s.rid, "tokens": s.generated})
        self.metrics.record_response(time.monotonic() - s.t_submit,
                                     cls=s.cls)

    # -- load signals (router dispatch + fleet autoscaler) -------------------
    def outstanding(self):
        with self._lock:
            return len(self._queue) + sum(1 for s in self._slots if s)

    def estimated_wait_s(self):
        """Queue drain time at the measured tick rate — what a fleet
        autoscaler compares against its SLO."""
        with self._lock:
            queued = len(self._queue)
            active = sum(1 for s in self._slots if s)
            tick = self._tick_s_ewma
        if tick is None or not (queued or active):
            return 0.0
        # a queued sequence waits for a slot (~avg remaining budget of
        # the active set) plus its own generation
        per_seq_ticks = float(self.max_new_default)
        backlog_ticks = per_seq_ticks * (queued / max(1, self.slots))
        return tick * backlog_ticks

    def stats(self):
        with self._lock:
            return {
                "name": self.name,
                "slots": self.slots,
                "slots_active": sum(1 for s in self._slots if s),
                "queue_depth": len(self._queue),
                "ticks": self.ticks,
                "tokens_generated": self.tokens_generated,
                "admitted": self.admitted,
                "evicted": self.evicted,
                "rejected": self.rejected,
                "programs": self.programs.program_count(),
                "compiles": self.programs.compile_count(),
                "tick_s_ewma": self._tick_s_ewma,
                "executed_rids": list(self._executed_rids),
                "dead": self._dead,
            }


class DecodeReplica(Replica):
    """`Replica`-contract face of one `DecodeEngine`, so a router (with
    its priority classes, shed thresholds, health loop and autoscaler)
    can drive LM decode like stateless serving.  Requests are
    ``{"tokens": ..., "max_new_tokens": ...}``."""

    def __init__(self, cfg, arg_params, replica_id="decode0", **engine_kw):
        self.replica_id = str(replica_id)
        self.version = 0
        self._cfg = cfg
        self.engine = DecodeEngine(cfg, arg_params,
                                   name=self.replica_id, **engine_kw)
        self.ready_info = {"compiles": self.engine.programs.compile_count(),
                           "programs": self.engine.programs.program_count()}

    def submit(self, inputs, timeout_ms=None, rid=None, priority=1):
        if isinstance(inputs, dict):
            tokens = inputs.get("tokens")
            max_new = inputs.get("max_new_tokens")
        else:
            tokens, max_new = inputs, None
        return self.engine.submit(tokens, max_new_tokens=max_new, rid=rid,
                                  priority=priority, timeout_ms=timeout_ms)

    def heartbeat(self):
        if self.engine._dead:
            raise ReplicaLostError(self.replica_id, reason="engine dead")
        return True

    def probe(self, timeout_s=None):
        """Deepcheck: a real single-token decode through the prepared
        ladder (prefill + step + eviction), waited on for ``timeout_s``
        (30 s by default)."""
        fut = self.engine.submit([1], max_new_tokens=1,
                                 priority="best_effort")
        return fut.result(30.0 if timeout_s is None else timeout_s)

    def swap(self, arg_params=None, aux_params=None, checkpoint_dir=None):
        from ..llm import stack_lm_params
        from .replica import _load_checkpoint_params
        if checkpoint_dir is not None:
            arg_params, _ = _load_checkpoint_params(checkpoint_dir)
        if arg_params is None:
            raise MXNetError("DecodeReplica.swap: no parameter source")
        stacked = stack_lm_params(arg_params, self._cfg, ctx=self.engine.ctx)
        # same shapes, same programs: the signature is unchanged, so the
        # swap adds no program (params are call arguments)
        self.engine.programs.params = stacked
        self.version += 1
        return self.version

    def outstanding(self):
        return self.engine.outstanding()

    def estimated_wait_s(self):
        return self.engine.estimated_wait_s()

    def stats(self):
        st = self.engine.stats()
        st["version"] = self.version
        return st

    def kill(self):
        self.engine.kill()

    def close(self, drain=True):
        self.engine.close(drain=drain)
