"""Serving path: embedding fan-out in front of the dense tower.

PyTorch port of `incubator_mxnet_tpu/embedding/serving.py`.  A
recommender request arrives as an id-set plus dense features.  The path
fans the ids out to the embedding shards through the hot-row cache on
the card (hot ids never touch the network), assembles the dense input
and submits it to the `ReplicaRouter` fleet serving the tower.

Failure composition: a dense replica dying is the router's problem (it
fails queued work over).  An embedding SHARD dying surfaces here as
`ServerLostError` during the fan-out; every admitted request retries
through the ``on_shard_lost`` recovery hook (respawn + `replace_shard`,
or a standby address) until its deadline, so a shard kill mid-traffic
loses no admitted request.  Each request is an ``embedding.serve`` span
(the router's ``router.request`` parents into it), and the path's own
counters are the ``embedding.serve.<table>`` producer, as in the JAX
package.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import metrics as _obs_metrics
from ..obs import trace as _trace
from ..resilience import ServerLostError

__all__ = ["EmbeddingServingPath"]


class EmbeddingServingPath:
    """Fan ids out to embedding shards, then the tower through a router."""

    def __init__(self, table, router, embed_input="emb",
                 on_shard_lost=None, retry_deadline_s=30.0):
        self.table = table
        self.router = router
        self.embed_input = str(embed_input)
        # called with the ServerLostError; returns True when the shard is
        # re-attached (replace_shard) and the fan-out should retry
        self.on_shard_lost = on_shard_lost
        self.retry_deadline_s = float(retry_deadline_s)
        self._lock = threading.Lock()   # counters of concurrent callers
        self.requests = 0
        self.completed = 0
        self.shard_failovers = 0
        # the path-local counters only: the table and the router register
        # their own producers
        self._name = getattr(table, "name", "table")
        self._ns = f"embedding.serve.{self._name}"
        _obs_metrics.register_producer(self._ns, self._scrape)

    def _fan_out(self, ids):
        """The looked-up vectors of the request's ids (host numpy),
        surviving a shard death when a recovery hook is installed."""
        deadline = time.monotonic() + self.retry_deadline_s
        while True:
            try:
                return self.table.lookup(ids, out_np=True)
            except ServerLostError as e:
                if self.on_shard_lost is None:
                    raise
                with self._lock:
                    self.shard_failovers += 1
                if not self.on_shard_lost(e) \
                        or time.monotonic() > deadline:
                    raise
                # recovered: the retry pulls from the re-attached shard

    def submit(self, ids, dense=None, timeout_ms=None,
               priority="interactive", request_id=None):
        """One request: ids (B,) or (B, slots) and optional extra dense
        inputs (a dict); returns the router's Future."""
        ids = np.asarray(ids, dtype=np.int64)
        with self._lock:
            self.requests += 1
        with _trace.span("embedding.serve", cat="embedding",
                         table=self._name, rows=int(ids.size)):
            vecs = self._fan_out(ids)
            inputs = {self.embed_input: vecs.reshape(ids.shape[0], -1)}
            if dense:
                inputs.update(dense)
            fut = self.router.submit(inputs, timeout_ms=timeout_ms,
                                     priority=priority,
                                     request_id=request_id)
        with self._lock:
            self.completed += 1
        return fut

    def predict(self, ids, dense=None, timeout_ms=None):
        """Synchronous submit: the per-output array list."""
        fut = self.submit(ids, dense=dense, timeout_ms=timeout_ms)
        budget = (timeout_ms / 1e3) if timeout_ms else 30.0
        return fut.result(budget)

    def _scrape(self):
        with self._lock:
            return {"requests": self.requests, "completed": self.completed,
                    "shard_failovers": self.shard_failovers}

    def stats(self):
        return dict(self._scrape(), table=self.table.stats(),
                    router=self.router.stats())

    def close(self):
        _obs_metrics.unregister_producer(self._ns)
