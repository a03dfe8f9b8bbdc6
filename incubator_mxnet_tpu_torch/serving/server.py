"""ModelServer: the multi-model serving front end.

PyTorch port of `incubator_mxnet_tpu/serving/server.py`.  Owns a registry
of ``name -> (ServedModel, MicroBatcher, ServingMetrics)``.  Models load
from classic checkpoint pairs, a symbol file + an elastic ``checkpoint/``
directory (the newest valid snapshot under a root), an in-memory symbol
+ params, or pre-built `ServedModel`s; every load warms the bucket ladder
by default.  The batcher's knobs (``breaker_threshold``,
``breaker_reset_s``, ``retry_policy``, the batching ones) pass through
per model.  Loading over an existing name hot-swaps: the new model
starts taking requests first, then the old batcher drains — none are
dropped.  `install_monitor` puts a `monitor.Monitor` on a model's
request path.  `shutdown(drain=True)` drains every model.  `stats()` is the
``server`` telemetry producer, as in the JAX package (each model's
`ServingMetrics` also registers under ``serving.<name>``).
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from .batcher import MicroBatcher
from .metrics import ServingMetrics
from .model import ServedModel, DEFAULT_BUCKETS

__all__ = ["ModelServer"]


class ModelServer:
    """Dynamic-batching inference server over named models."""

    def __init__(self, max_batch_size=None, max_queue_latency_ms=2.0,
                 max_queue=256, ctx=None):
        self._defaults = {"max_batch_size": max_batch_size,
                          "max_queue_latency_ms": max_queue_latency_ms,
                          "max_queue": max_queue}
        self._ctx = ctx
        self._models = {}
        self._lock = threading.Lock()
        self._closed = False
        # telemetry plane: the whole-server view under 'server'
        from ..obs import metrics as _obs_metrics
        _obs_metrics.register_producer("server", self.stats)

    # -- model lifecycle -----------------------------------------------------
    def load_model(self, name, model=None, *, prefix=None, epoch=0,
                   symbol_file=None, checkpoint_dir=None, symbol=None,
                   arg_params=None, aux_params=None, data_shapes=None,
                   buckets=DEFAULT_BUCKETS, warmup=True, **knobs):
        """Register `name`.  Exactly one source: a `ServedModel`, a classic
        ``prefix``/``epoch`` pair, a ``symbol_file`` + ``checkpoint_dir``,
        or an in-memory ``symbol`` + params.  ``knobs`` override the
        server's batching defaults for this model (`MicroBatcher`)."""
        if self._closed:
            raise MXNetError("serving: server is shut down")
        if model is None:
            common = dict(data_shapes=data_shapes, buckets=buckets,
                          ctx=self._ctx, name=name)
            if prefix is not None:
                model = ServedModel.load(prefix, epoch, **common)
            elif checkpoint_dir is not None:
                if symbol_file is None:
                    raise MXNetError(
                        "serving: checkpoint_dir loading needs symbol_file")
                model = ServedModel.from_checkpoint_dir(
                    symbol_file, checkpoint_dir, **common)
            elif symbol is not None:
                model = ServedModel(symbol, arg_params, aux_params, **common)
            else:
                raise MXNetError(
                    "serving: load_model needs model=, prefix=, "
                    "checkpoint_dir=, or symbol=")
        if warmup and not model.warmed:
            model.warmup()
        cfg = dict(self._defaults)
        cfg.update(knobs)
        metrics = ServingMetrics(name)
        batcher = MicroBatcher(model, metrics, **cfg)
        with self._lock:
            # re-checked under the SAME lock shutdown() empties the dict
            # under: a load racing shutdown must not register a batcher
            # nobody will ever close
            closed = self._closed
            old = None
            if not closed:
                old = self._models.get(name)
                self._models[name] = (model, batcher, metrics)
        if closed:
            batcher.close(drain=False)
            raise MXNetError("serving: server is shut down")
        if old is not None:
            # hot swap: the new batcher is already live; the old one
            # finishes its in-flight work before dying
            old[1].close(drain=True)
        return model

    def unload_model(self, name, drain=True, drain_timeout=None):
        """Remove `name`; with ``drain`` all queued requests complete
        first (none dropped).  ``drain_timeout`` bounds the wait: when a
        wedged request keeps the drain from finishing, the batcher stops
        anyway and a structured `MXNetError` lists the still-pending
        request ids instead of blocking the unload forever."""
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is None:
            raise MXNetError(f"serving: no model named '{name}'")
        entry[1].close(drain=drain, timeout=drain_timeout)

    def models(self):
        with self._lock:
            return sorted(self._models)

    def _entry(self, name):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise MXNetError(f"serving: no model named '{name}'")
        return entry

    def model(self, name):
        return self._entry(name)[0]

    def batcher(self, name):
        return self._entry(name)[1]

    # -- request path --------------------------------------------------------
    def submit(self, name, inputs, timeout_ms=None, priority=1):
        """Async request: returns a `concurrent.futures.Future` resolving
        to the per-output NDArray list for exactly this request's rows.
        ``priority`` is the dispatch rank (0 first, 2 last; see
        `MicroBatcher.submit`)."""
        return self._entry(name)[1].submit(inputs, timeout_ms=timeout_ms,
                                           priority=priority)

    def predict(self, name, inputs, timeout_ms=None, priority=1):
        """Sync request through the batching path."""
        wait = None if timeout_ms is None else timeout_ms / 1e3 + 60
        return self.submit(name, inputs, timeout_ms=timeout_ms,
                           priority=priority).result(wait)

    # -- observability / lifecycle -------------------------------------------
    def stats(self):
        """{model: metrics snapshot} (see `ServingMetrics.snapshot`)."""
        with self._lock:
            entries = dict(self._models)
        return {name: m.snapshot() for name, (_, _, m) in entries.items()}

    def install_monitor(self, name, mon):
        """Per-layer monitoring on `name`'s request path."""
        self._entry(name)[1].install_monitor(mon)
        return mon

    def shutdown(self, drain=True):
        """Stop every model; with ``drain`` in-flight work completes."""
        with self._lock:
            entries, self._models = dict(self._models), {}
            self._closed = True
        for _, batcher, _m in entries.values():
            batcher.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
