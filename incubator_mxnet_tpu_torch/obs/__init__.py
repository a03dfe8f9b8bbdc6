"""obs — the unified telemetry plane (metrics, tracing, event sinks).

PyTorch port of `incubator_mxnet_tpu/obs/`: the same modules, names,
namespaces, span records and frames; it imports nothing of the JAX
package.

One package, three products, each replacing a grown-per-subsystem
answer with a shared one:

* **metrics.py** — `MetricsRegistry`: counters/gauges/fixed-bucket
  histograms with a lock-cheap hot path; every subsystem's ``stats()``
  registers as a producer under a stable dotted namespace; exported in
  Prometheus text format through a ``metrics`` frame on the dist
  transport (workers, host daemons, and the parameter server answer
  scrapes; `FleetManager.scrape()` aggregates fleet-wide;
  ``tools/mxtop.py`` renders it live).
* **trace.py** — distributed tracing: trace/span ids propagated
  through transport frames (router dispatch -> worker execute, kvstore
  push/pull, supervisor control), spans appended to one shared JSONL
  file across every process of a run; ``tools/mxtrace.py`` merges them
  (plus the fault/quarantine JSONL sinks) into one Perfetto-loadable
  chrome trace with cross-process flow arrows.
* **jsonl_sink.py** — THE O_APPEND line-atomic JSONL writer with
  pid/rank/thread stamping, shared by the fault log, the sanitizer
  dump, the guardian quarantine, and the span stream.

Knobs: ``MXNET_OBS_TRACE`` (span file; enables tracing),
``MXNET_OBS_TRACE_BUFFER`` (span buffer cap), ``MXNET_OBS_METRICS``
(producer collection master switch).  See the README's
"Observability" section for the namespace table and tooling.
"""
from __future__ import annotations

from . import jsonl_sink  # noqa: F401
from . import metrics  # noqa: F401
from . import trace  # noqa: F401
from .metrics import (registry, counter, gauge, histogram,  # noqa: F401
                      register_producer, unregister_producer,
                      render_prometheus, parse_prometheus)

__all__ = ["jsonl_sink", "metrics", "trace", "scrape", "registry",
           "counter", "gauge", "histogram", "register_producer",
           "unregister_producer", "render_prometheus",
           "parse_prometheus"]


def __getattr__(name):
    # scrape imports the transport lazily; keep `import obs` light.
    # import_module, not ``from . import scrape``: the from-import asks
    # this package for the attribute first and would recurse here
    if name == "scrape":
        import importlib
        return importlib.import_module(__name__ + ".scrape")
    raise AttributeError(name)
