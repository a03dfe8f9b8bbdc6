"""Environment knobs the port reads.

PyTorch port of the part of `incubator_mxnet_tpu/config.py` that the
ported modules use.  A knob is read from the environment at call time,
so a caller (a test, `chip_smoke.py`) can set it for one call.

``MXNET_FLASH_VMEM_MB`` (float, default 10.0) keeps the JAX package's
routing rule for flash attention: a call whose K and V of one head take
more than this many MiB (``2 * kv_len * D * itemsize``) runs the
split-KV kernel (`ops.flash_attention.flash_fwd_stream`), else the
whole-KV kernel (`flash_fwd`), so a shape takes the same route in both
packages.  On the TPU it was the VMEM the whole-KV kernel could hold; on
the card nothing is held whole, and the knob only names the KV length
past which the split-KV kernel runs.

``MXNET_SUBGRAPH_BACKEND`` (str, default empty) names the subgraph
backend `Symbol.simple_bind` partitions the graph with at bind time
(``TPU_PALLAS`` fuses FullyConnected+bias+ReLU into kernel K1), as the
JAX package's `simple_bind` does.

``MXNET_FUSED_TRAIN_STEP`` (bool, default on) lets `Module.fit` run its
fused train step (`fused.FusedTrainStep`) where the module allows it;
``0`` keeps every batch on the per-batch path, as in the JAX package.

``MXNET_DECODE_SLOTS`` (int, 8), ``MXNET_DECODE_BUCKETS`` (str,
"8,16,32"), ``MXNET_DECODE_ADMIT_PER_TICK`` (int, 2) and
``MXNET_DECODE_MAX_NEW`` (int, 32) are `serving.decode.DecodeEngine`'s
defaults, as in the JAX package: the KV-cache rows a decode tick
advances, the prompt-length ladder, the sequences admitted per tick and
the generation budget of a request that sets none.

The data plane's knobs, as in the JAX package: ``MXNET_CPU_WORKER_NTHREADS``
(int, 4) is `ImageRecordIter`'s default ``preprocess_threads``;
``MXNET_USE_NATIVE_IO`` (bool, on) lets the iterators use the native IO
library (`native.py`); ``MXNET_IO_RING`` (bool, on) makes `Module.fit`
wrap its training iterator in the h2d staging ring
(`io_plane.DevicePrefetchIter`), ``MXNET_IO_PREFETCH`` (int, 3) is the
ring's device-resident depth (floor 2) and ``MXNET_IO_STAGING`` (bool, on)
stages each batch in a reusable pinned buffer before its copy;
``MXNET_IO_UINT8_WIRE`` (bool, on) resolves `ImageRecordIter(
device_augment="auto")` to uint8 NHWC batches; ``MXNET_IO_AUTO_SHARD``
(bool, on) lets an explicit ``num_parts="auto"`` shard by
``DMLC_RANK``/``DMLC_NUM_WORKER``.

The kvstore's and the parameter server's knobs, with the JAX package's
defaults: ``MXNET_KVSTORE_BIGARRAY_BOUND`` (int, 1000000)
is the element count past which a dist key splits into one range per
server; ``MXNET_KVSTORE_COLLECTIVE`` (bool, on) sends a ``dist_sync``
store's gradients through the collective data plane (an all-reduce over
a `torch.distributed` group of the workers, `dist/collective.py`),
``0`` through
the parameter server; ``MXNET_KVSTORE_BUCKET_MB`` (32) caps a bucket of
the batched reduce over several contexts.
``MXNET_PS_REQUEST_TIMEOUT`` (330 s), ``MXNET_PS_CONNECT_WAIT`` (90 s),
``MXNET_PS_RECONNECT_WAIT`` (5 s), ``MXNET_PS_MAX_RETRIES`` (3),
``MXNET_PS_BREAKER_THRESHOLD`` (2) and ``MXNET_PS_BREAKER_RESET_S`` (30 s)
drive `dist.transport.Channel` and the per-server circuit breakers;
``MXNET_SUPERVISOR`` (on) starts a `resilience.supervisor.JobSupervisor`
in a multi-worker dist `Module.fit`, which restarts at most
``MXNET_FIT_MAX_RESTARTS`` (2) times after a lost server or host;
``MXNET_SUPERVISOR_HEARTBEAT_S`` (2 s) is its heartbeat interval and
``MXNET_SUPERVISOR_STRAGGLER_K`` (3) its straggler rule's k;
``MXNET_SUPERVISOR_EPOCH`` (0) is the membership epoch a worker registers
at, ``MXNET_SUPERVISOR_DEADLINE_S`` (10 s) the membership table's
heartbeat deadline, and the shrink barrier's deadline is the larger of
``MXNET_SUPERVISOR_SHRINK_BARRIER_S`` (30 s) and
``MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S`` (120 s) plus two heartbeat
deadlines.  ``MXNET_EMBED_PARTITION`` ("range"),
``MXNET_EMBED_CACHE_ROWS`` (4096), ``MXNET_EMBED_HBM_BUDGET_MB`` (64),
``MXNET_EMBED_PULL_CHUNK`` (65536), ``MXNET_EMBED_BREAKER_THRESHOLD`` (2)
and ``MXNET_EMBED_BREAKER_RESET_S`` (30 s) are `embedding`'s.

The serving fleet's knobs, with the JAX package's defaults:
``MXNET_SERVING_BREAKER_THRESHOLD`` (5) and ``_RESET_S`` (30 s) are a
served model's circuit breaker (the batcher's, and a router's per replica
and a fleet's per host); ``MXNET_ROUTER_HEALTH_INTERVAL_S`` (0.5 s),
``_HEALTH_DEADLINE_S`` (5 s), ``_DEEPCHECK_EVERY`` (8),
``_MAX_DISPATCHES`` (3) and the shed thresholds
``MXNET_ROUTER_SHED_{BEST_EFFORT,BATCH,INTERACTIVE}_MS`` (25, 100, 1000)
are `serving.router.ReplicaRouter`'s; ``MXNET_FLEET_TICK_S`` (0.5 s),
``_SLO_MS`` (100), ``_UP_AFTER_S`` (3 s), ``_DOWN_AFTER_S`` (30 s),
``_IDLE_FRACTION`` (0.1), ``_COOLDOWN_S`` (10 s), ``_MIN_REPLICAS`` (1),
``_MAX_REPLICAS`` (8), ``_HOST_HEARTBEAT_S`` (1 s) and
``_HOST_DEADLINE_S`` (5 s) are `serving.fleet.FleetManager`'s.

The telemetry plane's knobs, with the JAX package's defaults:
``MXNET_OBS_TRACE`` (str, empty) names the shared span file and turns
tracing on (`obs.trace`), ``MXNET_OBS_TRACE_BUFFER`` (65536) caps each
process's span buffer and ``MXNET_OBS_METRICS`` (on) lets a scrape call
the registered producers; ``MXNET_PROFILER_AUTOSTART`` (off) starts
`profiler` at import, ``MXNET_PROFILER_MAX_EVENTS`` (250000) caps its
custom-event buffer and ``MXNET_PROFILER_MODE`` (0) is accepted and
ignored, as in the JAX package.

The training guardian's knobs, with the JAX package's defaults:
``MXNET_GUARDIAN`` (on) arms `resilience.guardian.TrainingGuardian` in
every `Module.fit`; ``MXNET_GUARDIAN_INTERVAL`` (8) trained steps between
the polls of the health word, ``_SPIKE_WINDOW`` (16) the spike
detector's EWMA window and warm-up, ``_SPIKE_K`` (6.0) its k-sigma,
``_MAX_FAILURES`` (3) consecutive unhealthy steps and ``_MAX_ROLLBACKS``
(2) rollbacks before `TrainingDivergedError`, and ``_QUARANTINE``
(empty: ``<checkpoint_dir>/quarantine.jsonl``) the quarantine file.
The train-to-serve loop's (`loop/`): ``MXNET_LOOP_PUBLISH_STEPS`` (100)
and ``MXNET_LOOP_PUBLISH_SECS`` (0: off) the publisher's cadence,
``MXNET_LOOP_CANARY_TOL`` (0.02) the canary gate's tolerance,
``MXNET_LOOP_POLL_S`` (2.0) the controller's poll interval and
``MXNET_LOOP_FRESHNESS_SLO_S`` (600.0) the freshness SLO.

The engine's and the mesh's, as in the JAX package:
``MXNET_ENGINE_TYPE`` (``ThreadedEnginePerDevice``; ``NaiveEngine``
synchronizes after every op, `engine.py`) and ``MXNET_MESH`` (empty: the
composed mesh `Module` lays over its contexts).

``MXNET_FLASH_INTERPRET`` is not carried over: in the port the tensor's
device decides.  A CPU tensor takes a kernel's plain PyTorch version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import logging
import os

__all__ = ["KNOBS", "get"]

_LOG = logging.getLogger(__name__)

_BOOL = lambda s: s not in ("0", "false", "False", "")  # noqa: E731

# name -> (parser, default, doc)
KNOBS = {
    "MXNET_ENGINE_TYPE": (str, "ThreadedEnginePerDevice",
                          "engine.py: NaiveEngine synchronizes after "
                          "every op and names the op that failed"),
    "MXNET_MESH": (str, "",
                   "composed mesh spec for Module over its contexts, "
                   "e.g. 'dp=2' or 'dp=2,tp=2' (the dp axis splits the "
                   "batch); the fit/init_optimizer mesh= argument wins"),
    "MXNET_FLASH_VMEM_MB": (float, 10.0,
                            "MiB of one head's K and V past which flash "
                            "attention runs the split-KV kernel"),
    "MXNET_SUBGRAPH_BACKEND": (str, "",
                               "subgraph backend Symbol.simple_bind "
                               "partitions the graph with"),
    "MXNET_FUSED_TRAIN_STEP": (_BOOL, True,
                               "Module.fit runs the fused train step "
                               "(fused.py) where it can"),
    "MXNET_DECODE_SLOTS": (int, 8,
                           "KV-cache rows the continuous-batching "
                           "DecodeEngine advances per tick (the decode "
                           "step's fixed batch dimension)"),
    "MXNET_DECODE_BUCKETS": (str, "8,16,32",
                             "prompt-length bucket ladder for decode "
                             "prefill: one signature per bucket, prompts "
                             "padded up"),
    "MXNET_DECODE_ADMIT_PER_TICK": (int, 2,
                                    "most sequences admitted (prefilled) "
                                    "per decode tick, so a burst of long "
                                    "prefills never stalls the running "
                                    "slots' decode step"),
    "MXNET_DECODE_MAX_NEW": (int, 32,
                             "default generation budget of a sequence "
                             "whose request sets no max_new_tokens"),
    "MXNET_CPU_WORKER_NTHREADS": (int, 4,
                                  "default preprocess_threads of "
                                  "ImageRecordIter"),
    "MXNET_USE_NATIVE_IO": (_BOOL, True,
                            "the iterators use the native IO library "
                            "(native.py) where it builds"),
    "MXNET_IO_RING": (_BOOL, True,
                      "Module.fit wraps its training iterator in the h2d "
                      "staging ring (io_plane.DevicePrefetchIter)"),
    "MXNET_IO_PREFETCH": (int, 3,
                          "device-resident depth of the h2d ring (floor "
                          "2)"),
    "MXNET_IO_STAGING": (_BOOL, True,
                         "the ring stages each batch in a reusable pinned "
                         "host buffer (with the dtype cast) before its "
                         "copy; 0 copies from the producer's arrays"),
    "MXNET_IO_UINT8_WIRE": (_BOOL, True,
                            "ImageRecordIter(device_augment='auto') ships "
                            "uint8 NHWC batches (normalize_symbol does the "
                            "rest on the device)"),
    "MXNET_IO_AUTO_SHARD": (_BOOL, True,
                            "an explicit num_parts='auto' shards by "
                            "DMLC_RANK/DMLC_NUM_WORKER; 0 keeps one part"),
    "MXNET_KVSTORE_BIGARRAY_BOUND": (int, 1000000,
                                     "dist keys with more elements split "
                                     "into one contiguous range per server"),
    "MXNET_KVSTORE_COLLECTIVE": (_BOOL, True,
                                 "dist_sync gradients all-reduce over a "
                                 "torch.distributed group of the workers "
                                 "(dist/collective.py); 0: through the "
                                 "parameter server"),
    "MXNET_KVSTORE_BUCKET_MB": (float, 32,
                                "size cap of a bucket of the batched "
                                "multi-context reduce (priority order: the "
                                "last key first); fractions allowed"),
    "MXNET_PS_REQUEST_TIMEOUT": (float, 330.0,
                                 "dist transport per-request timeout; "
                                 "exceeds the server's 300 s waits"),
    "MXNET_PS_CONNECT_WAIT": (float, 90.0,
                              "dist transport initial-connect window"),
    "MXNET_PS_RECONNECT_WAIT": (float, 5.0,
                                "dist transport mid-request reconnect "
                                "window"),
    "MXNET_PS_MAX_RETRIES": (int, 3, "dist transport request attempts"),
    "MXNET_PS_BREAKER_THRESHOLD": (int, 2,
                                   "consecutive failures before a "
                                   "parameter server is declared lost"),
    "MXNET_PS_BREAKER_RESET_S": (float, 30.0,
                                 "open -> half-open window of a "
                                 "server's circuit breaker"),
    "MXNET_FIT_MAX_RESTARTS": (int, 2,
                               "Module.fit restarts from the last "
                               "checkpoint after ServerLostError or "
                               "CollectiveTimeoutError at most this many "
                               "times"),
    "MXNET_SUPERVISOR": (_BOOL, True,
                         "JobSupervisor around a multi-worker dist "
                         "Module.fit: heartbeats, the hung-collective "
                         "watchdog, stragglers, shrink-and-resume"),
    "MXNET_SUPERVISOR_HEARTBEAT_S": (float, 2.0,
                                     "heartbeat interval to the pod "
                                     "coordinator (the root server)"),
    "MXNET_SUPERVISOR_STRAGGLER_K": (float, 3.0,
                                     "k-sigma divergence of a host's "
                                     "step-time EWMA from the pod median "
                                     "flagged as a straggler"),
    "MXNET_SUPERVISOR_EPOCH": (int, 0,
                               "membership epoch a worker registers at"),
    "MXNET_SUPERVISOR_DEADLINE_S": (float, 10.0,
                                    "heartbeat silence before a host is "
                                    "dead in the membership view"),
    "MXNET_SUPERVISOR_SHRINK_BARRIER_S": (float, 30.0,
                                          "least deadline of the shrink "
                                          "barrier"),
    "MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S": (float, 120.0,
                                              "a hung collective's "
                                              "deadline, which the shrink "
                                              "barrier outlasts"),
    "MXNET_EMBED_PARTITION": (str, "range",
                              "ShardedEmbedding's row partition: 'range' "
                              "or 'hash'"),
    "MXNET_EMBED_CACHE_ROWS": (int, 4096,
                               "hot-row cache capacity in rows (0: no "
                               "cache)"),
    "MXNET_EMBED_HBM_BUDGET_MB": (int, 64,
                                  "modelled one-device budget a sharded "
                                  "table is measured against"),
    "MXNET_EMBED_PULL_CHUNK": (int, 65536,
                               "rows per embed_pull when a whole table "
                               "streams back"),
    "MXNET_EMBED_BREAKER_THRESHOLD": (int, 2,
                                      "consecutive failures before an "
                                      "embedding shard is declared lost"),
    "MXNET_EMBED_BREAKER_RESET_S": (float, 30.0,
                                    "open -> half-open window of a "
                                    "shard's circuit breaker"),
    "MXNET_SERVING_BREAKER_THRESHOLD": (int, 5,
                                        "consecutive failed batches before "
                                        "a served model's breaker opens"),
    "MXNET_SERVING_BREAKER_RESET_S": (float, 30.0,
                                      "serving breaker open -> half-open "
                                      "probe window"),
    "MXNET_ROUTER_HEALTH_INTERVAL_S": (float, 0.5,
                                       "router health probe interval per "
                                       "replica (every k-th a deepcheck)"),
    "MXNET_ROUTER_HEALTH_DEADLINE_S": (float, 5.0,
                                       "probe silence before a replica is "
                                       "declared dead and its in-flight "
                                       "requests fail over"),
    "MXNET_ROUTER_DEEPCHECK_EVERY": (int, 8,
                                     "every Nth health probe is a real "
                                     "bucket-1 inference (0: never)"),
    "MXNET_ROUTER_MAX_DISPATCHES": (int, 3,
                                    "dispatch attempts per request across "
                                    "replica deaths"),
    "MXNET_ROUTER_SHED_BEST_EFFORT_MS": (float, 25.0,
                                         "estimated fleet wait beyond which "
                                         "best_effort requests are shed"),
    "MXNET_ROUTER_SHED_BATCH_MS": (float, 100.0,
                                   "estimated fleet wait beyond which "
                                   "batch requests are shed"),
    "MXNET_ROUTER_SHED_INTERACTIVE_MS": (float, 1000.0,
                                         "estimated fleet wait beyond which "
                                         "interactive requests are shed"),
    "MXNET_FLEET_TICK_S": (float, 0.5,
                           "FleetManager control-loop tick"),
    "MXNET_FLEET_SLO_MS": (float, 100.0,
                           "the autoscaler's SLO on the router's "
                           "estimated wait"),
    "MXNET_FLEET_UP_AFTER_S": (float, 3.0,
                               "breach of the SLO sustained this long "
                               "before a scale-up"),
    "MXNET_FLEET_DOWN_AFTER_S": (float, 30.0,
                                 "idleness sustained this long before a "
                                 "scale-down through the drain"),
    "MXNET_FLEET_IDLE_FRACTION": (float, 0.1,
                                  "idle threshold as a fraction of the SLO "
                                  "(between it and the SLO: the dead band)"),
    "MXNET_FLEET_COOLDOWN_S": (float, 10.0,
                               "least spacing between scale events"),
    "MXNET_FLEET_MIN_REPLICAS": (int, 1,
                                 "scale-down floor and default target"),
    "MXNET_FLEET_MAX_REPLICAS": (int, 8, "scale-up ceiling"),
    "MXNET_FLEET_HOST_HEARTBEAT_S": (float, 1.0,
                                     "interval of the fleet's host "
                                     "heartbeats"),
    "MXNET_FLEET_HOST_DEADLINE_S": (float, 5.0,
                                    "heartbeat silence before a host is "
                                    "declared dead with all its replicas"),
    "MXNET_OBS_TRACE": (str, "",
                        "shared span JSONL file; set, every process of a "
                        "run (router, workers, host daemons, parameter "
                        "servers) appends its finished spans there "
                        "(obs/trace.py)"),
    "MXNET_OBS_TRACE_BUFFER": (int, 65536,
                               "in-memory span buffer cap per process "
                               "(drop-oldest past it, counted in "
                               "'trace.dropped')"),
    "MXNET_OBS_METRICS": (_BOOL, True,
                          "collect() invokes the registered stats() "
                          "producers; off: the instruments only"),
    "MXNET_PROFILER_AUTOSTART": (_BOOL, False,
                                 "profiler.py starts a trace at import"),
    "MXNET_PROFILER_MODE": (int, 0, "accepted, no effect (as in the JAX "
                                    "package)"),
    "MXNET_PROFILER_MAX_EVENTS": (int, 250000,
                                  "profiler.py custom-event buffer cap "
                                  "(drop-oldest past it, counted in "
                                  "'profiler.dropped_events')"),
    "MXNET_GUARDIAN": (_BOOL, True,
                       "training health guardian in Module.fit: the "
                       "fused step's health word, skip-batch, rollback "
                       "to the last healthy checkpoint, quarantine"),
    "MXNET_GUARDIAN_INTERVAL": (int, 8,
                                "trained steps between health-word polls "
                                "(one host read an interval)"),
    "MXNET_GUARDIAN_SPIKE_WINDOW": (int, 16,
                                    "EWMA window and warm-up steps of the "
                                    "loss-spike detector"),
    "MXNET_GUARDIAN_SPIKE_K": (float, 6.0,
                               "k-sigma of log(signal) over its EWMA "
                               "diagnosed as a loss spike"),
    "MXNET_GUARDIAN_MAX_FAILURES": (int, 3,
                                    "consecutive unhealthy steps before "
                                    "TrainingDivergedError"),
    "MXNET_GUARDIAN_MAX_ROLLBACKS": (int, 2,
                                     "rollbacks a fit may take before a "
                                     "spike raises TrainingDivergedError"),
    "MXNET_GUARDIAN_QUARANTINE": (str, "",
                                  "quarantine JSONL path (default "
                                  "<checkpoint_dir>/quarantine.jsonl)"),
    "MXNET_LOOP_PUBLISH_STEPS": (int, 100,
                                 "trained steps between registry publishes "
                                 "(0 disables the step cadence)"),
    "MXNET_LOOP_PUBLISH_SECS": (float, 0.0,
                                "wall-clock publish cadence in seconds "
                                "(0 disables)"),
    "MXNET_LOOP_CANARY_TOL": (float, 0.02,
                              "how far below the incumbent a canary may "
                              "score on the holdout and still promote"),
    "MXNET_LOOP_POLL_S": (float, 2.0,
                          "LoopController registry poll interval"),
    "MXNET_LOOP_FRESHNESS_SLO_S": (float, 600.0,
                                   "freshness SLO on loop.freshness_lag_s"),
}


def get(name):
    """The knob's value from the environment, or its default when unset
    or unparsable."""
    if name not in KNOBS:
        raise KeyError(f"unknown config knob {name}; register it in "
                       "config.KNOBS")
    parse, default, _ = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return parse(raw)
    except (TypeError, ValueError):
        _LOG.warning("could not parse %s=%r; using default", name, raw)
        return default
