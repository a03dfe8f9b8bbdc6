"""MetricsRegistry: counters, gauges, histograms, and a scrape plane.

PyTorch port of `incubator_mxnet_tpu/obs/metrics.py`, the same names,
bucket ladder, quantile rule and Prometheus text; plain `threading`
locks stand in for `analysis.locks`.

Before this module the framework had seven unrelated ``stats()``
shapes — KVStore, ReplicaRouter, FleetManager, JobSupervisor,
ServingMetrics, the program cache, the guardian — each invented its
own dict and its own reader.  The registry gives them one product:

* **instruments** — `Counter`, `Gauge`, `Histogram` with a lock-cheap
  hot path (one small per-instrument lock; no registry lock is ever
  taken on a record).  Histograms are fixed-bucket (Prometheus
  semantics: cumulative ``le`` buckets + sum + count), so a week of
  observations costs the same memory as a minute.
* **producers** — every existing ``stats()`` dict registers under a
  stable dotted namespace (``kvstore``, ``router``, ``fleet``,
  ``supervisor``, ``guardian``, ``cache``, ``serving.<model>``,
  ``worker``, ``profiler``, ``io`` — the data plane's h2d ring:
  prefetch depth, occupancy, stalls, bytes, decode queue depth...)
  via `register_producer(ns, fn)`.  The
  callable is only invoked at scrape time, so a registered subsystem
  pays NOTHING between scrapes; bound methods are held weakly, so
  registration can never leak a router or a kvstore.
* **export** — `collect()` flattens instruments + producer dicts into
  one ``{dotted.name: number}`` snapshot; `render_prometheus()` emits
  the Prometheus text exposition format (``mx_`` prefix, sanitized
  names, ``# TYPE`` headers); `parse_prometheus()` is the strict
  parser the CI gate validates scrape output with.

The transport scrape frame (``{"cmd": "metrics"}`` answered by the
replica worker, the host daemon, and the parameter server) serves this
registry's snapshot, `FleetManager.scrape()` aggregates it fleet-wide,
and ``tools/mxtop.py`` renders it live.

The ``MXNET_OBS_METRICS`` knob (default on) gates producer invocation:
off, `collect()` returns instruments only — the paranoid-hot-path
escape hatch.
"""
from __future__ import annotations

import bisect
import re
import threading
import weakref

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "counter", "gauge", "histogram",
           "register_producer", "unregister_producer",
           "render_prometheus", "parse_prometheus", "flatten"]

# default latency-shaped bucket ladder (ms); +Inf is implicit
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


class Counter:
    """Monotonic counter.  ``inc()`` is one lock + one add."""

    __slots__ = ("name", "_value", "_lock")
    kind = "counter"

    def __init__(self, name):
        self.name = str(name)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def sample(self):
        return {self.name: self.value}


class Gauge:
    """Point-in-time value; ``set``/``inc``/``dec``."""

    __slots__ = ("name", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name):
        self.name = str(name)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def sample(self):
        return {self.name: self.value}


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics).

    ``observe()`` is one lock + a bisect + two adds — O(log buckets),
    O(buckets) memory forever.  `quantile(q)` interpolates from the
    bucket counts (coarse by design; the reservoirs in serving.metrics
    stay the precise per-model source)."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_lock")
    kind = "histogram"

    def __init__(self, name, buckets=DEFAULT_BUCKETS):
        self.name = str(name)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name!r}: empty bucket ladder")
        self._counts = [0] * (len(self.bounds) + 1)   # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self):
        """{"buckets": {le: cumulative}, "sum": s, "count": n}."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum, out = 0, {}
        for bound, c in zip(self.bounds, counts):
            cum += c
            out[bound] = cum
        out[float("inf")] = cum + counts[-1]
        return {"buckets": out, "sum": s, "count": n}

    def quantile(self, q):
        """Approximate q-quantile (0..1) from the bucket counts, or
        None before the first observation."""
        snap = self.snapshot()
        n = snap["count"]
        if not n:
            return None
        target = q * n
        prev_bound, prev_cum = 0.0, 0
        for bound, cum in snap["buckets"].items():
            if cum >= target:
                if bound == float("inf"):
                    return prev_bound
                span = cum - prev_cum
                if span <= 0:
                    return bound
                frac = (target - prev_cum) / span
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, prev_cum = bound, cum
        return prev_bound

    def sample(self):
        snap = self.snapshot()
        out = {f"{self.name}.sum": snap["sum"],
               f"{self.name}.count": snap["count"]}
        for bound, cum in snap["buckets"].items():
            le = "+Inf" if bound == float("inf") else f"{bound:g}"
            out[f"{self.name}.bucket.le={le}"] = cum
        return out


def flatten(namespace, obj, out=None):
    """Flatten a stats() dict into dotted numeric leaves: nested dicts
    recurse, bools become 0/1, numbers pass through, everything else
    (strings, lists, None) is dropped — a scrape is numbers."""
    if out is None:
        out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            flatten(f"{namespace}.{k}" if namespace else str(k), v, out)
    elif isinstance(obj, bool):
        out[namespace] = int(obj)
    elif isinstance(obj, (int, float)):
        out[namespace] = obj
    return out


class MetricsRegistry:
    """Instruments + producers under stable dotted names (module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}      # name -> instrument
        self._producers = {}        # namespace -> callable | WeakMethod

    # -- instruments ---------------------------------------------------------
    def _get(self, name, factory, kind):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif inst.kind != kind:
                raise TypeError(
                    f"metric {name!r} is a {inst.kind}, not a {kind}")
            return inst

    def counter(self, name):
        return self._get(name, lambda: Counter(name), "counter")

    def gauge(self, name):
        return self._get(name, lambda: Gauge(name), "gauge")

    def histogram(self, name, buckets=DEFAULT_BUCKETS):
        return self._get(name, lambda: Histogram(name, buckets),
                         "histogram")

    # -- producers -----------------------------------------------------------
    def register_producer(self, namespace, fn):
        """Register ``fn() -> dict`` under `namespace` (replaces any
        previous producer there — the newest subsystem instance wins).
        Bound methods are held via `weakref.WeakMethod`, so the
        registry never keeps a dead router/kvstore/guardian alive; a
        collected producer silently drops out of scrapes."""
        if hasattr(fn, "__self__"):
            fn = weakref.WeakMethod(fn)
        with self._lock:
            self._producers[str(namespace)] = fn
        return namespace

    def unregister_producer(self, namespace):
        with self._lock:
            return self._producers.pop(str(namespace), None) is not None

    def producers(self):
        with self._lock:
            return sorted(self._producers)

    def _resolve_producers(self):
        with self._lock:
            items = list(self._producers.items())
        out, dead = [], []
        for ns, fn in items:
            call = fn() if isinstance(fn, weakref.WeakMethod) else fn
            if call is None:
                dead.append(ns)
            else:
                out.append((ns, call))
        if dead:
            with self._lock:
                for ns in dead:
                    self._producers.pop(ns, None)
        return out

    # -- export --------------------------------------------------------------
    def collect(self):
        """One flat {dotted.name: number} snapshot: every instrument
        plus every producer's flattened stats dict.  A producer that
        raises is skipped (and its failure counted) — a broken stats()
        must never take the scrape plane down."""
        from .. import config as _config
        out = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            out.update(inst.sample())
        if not _config.get("MXNET_OBS_METRICS"):
            return out
        for ns, call in self._resolve_producers():
            try:
                flatten(ns, call(), out)
            except Exception:
                self.counter("obs.producer_errors").inc()
                out[f"obs.producer_errors.{ns}"] = \
                    out.get(f"obs.producer_errors.{ns}", 0) + 1
        return out

    def render_prometheus(self, values=None):
        """The Prometheus text exposition format over `collect()` plus
        native histogram series for registered Histogram instruments.
        Pass an already-collected ``values`` dict to avoid invoking
        every producer a second time (the scrape reply carries both
        forms of one snapshot)."""
        with self._lock:
            instruments = dict(self._instruments)
        if values is None:
            values = self.collect()
        lines = []
        emitted_hist = set()
        for name, inst in sorted(instruments.items()):
            if inst.kind != "histogram":
                continue
            emitted_hist.add(name)
            prom = _prom_name(name)
            lines.append(f"# TYPE {prom} histogram")
            snap = inst.snapshot()
            for bound, cum in snap["buckets"].items():
                le = "+Inf" if bound == float("inf") else f"{bound:g}"
                lines.append(f'{prom}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{prom}_sum {_prom_value(snap['sum'])}")
            lines.append(f"{prom}_count {snap['count']}")
        for name in sorted(values):
            if any(name == h or name.startswith(h + ".")
                   for h in emitted_hist):
                continue   # rendered as a native histogram series above
            inst = instruments.get(name)
            kind = inst.kind if inst is not None else "gauge"
            prom = _prom_name(name)
            lines.append(f"# TYPE {prom} {kind}")
            lines.append(f"{prom} {_prom_value(values[name])}")
        return "\n".join(lines) + "\n"


def _prom_name(name):
    sanitized = _NAME_SANITIZE.sub("_", str(name))
    return "mx_" + sanitized


def _prom_value(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


_METRIC_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)(?:\s+\d+)?$")
_LABEL = re.compile(r'^\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*$')


def parse_prometheus(text):
    """Strict parser for the text exposition format: returns
    ``{(name, ((label, value), ...)): float}``.  Raises ``ValueError``
    on any malformed line — this is the validity gate the obs CI stage
    runs over scrape output, so it must reject, not guess."""
    out = {}
    for lineno, raw in enumerate(str(text).splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] not in ("HELP", "TYPE"):
                raise ValueError(
                    f"line {lineno}: unknown comment form {line!r}")
            if len(parts) >= 2 and parts[1] == "TYPE" and (
                    len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped")):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            continue
        m = _METRIC_LINE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a metric line {line!r}")
        labels = ()
        if m.group("labels"):
            pairs = []
            for part in m.group("labels").split(","):
                lm = _LABEL.match(part)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: bad label {part!r}")
                pairs.append((lm.group(1), lm.group(2)))
            labels = tuple(pairs)
        val = m.group("value")
        if val in ("+Inf", "-Inf", "NaN"):
            num = float(val.replace("Inf", "inf").replace("NaN", "nan"))
        else:
            try:
                num = float(val)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: non-numeric value {val!r}") from None
        out[(m.group("name"), labels)] = num
    return out


# -- the process-wide default registry ----------------------------------------
_default = MetricsRegistry()


def registry():
    """The process-wide registry every subsystem registers into and
    every scrape frame serves."""
    return _default


def counter(name):
    return _default.counter(name)


def gauge(name):
    return _default.gauge(name)


def histogram(name, buckets=DEFAULT_BUCKETS):
    return _default.histogram(name, buckets)


def register_producer(namespace, fn):
    return _default.register_producer(namespace, fn)


def unregister_producer(namespace):
    return _default.unregister_producer(namespace)


def render_prometheus():
    return _default.render_prometheus()
