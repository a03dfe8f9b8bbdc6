"""Multi-process collective bootstrap over `torch.distributed`.

PyTorch port of `incubator_mxnet_tpu/dist/collective.py`.  Where the JAX
package joins `jax.distributed` so that XLA collectives span the worker
processes, this module forms one `torch.distributed` process group of
the workers: a `TCPStore` at the coordinator's address (rank 0 hosts
it) and a gloo or NCCL process group built on it.  The dist kvstore's
collective data plane (`kvstore_dist._CollectivePlane`) all-reduces the
gradients over that group; the parameter server keeps the control
plane (registration, init, barriers, membership).

Backend rule:

* **gloo** on the CPU, and whenever two ranks share a card (gloo
  all-reduces and broadcasts CUDA tensors through the host);
* **NCCL** only where every rank has a card of its own
  (``torch.cuda.device_count() >= world_size``; rank r drives card r):
  NCCL refuses two ranks on one device.

The group is built directly from `ProcessGroupGloo` / `ProcessGroupNCCL`
and not registered as torch's default group, so it can be torn down and
re-formed at a smaller world size inside one process: the
shrink-and-resume path after a host loss.  `shutdown` forgets the group
without waiting on it (a gloo group whose peer was SIGKILLed can block
in its teardown); the abandoned group and its store are kept alive, so
their destructors never run mid-training.

Env: ``DMLC_PS_ROOT_URI`` and ``DMLC_PS_ROOT_PORT`` name the coordinator
unless the caller does: its port is the root server's plus 1 plus the
membership epoch (``MXNET_SUPERVISOR_EPOCH``), so every epoch of an
elastic run forms its group on a fresh port.
`init_process_group` returns the ``(coordinator, world_size, rank)``
tuple actually joined.
"""
from __future__ import annotations

import datetime
import os

__all__ = ["init_process_group", "initialized", "group", "process_group",
           "backend", "shutdown", "finalize"]

# the live group's (coordinator, world_size, rank), or None
_group = None
_pg = None          # the torch process group (None for one process)
_backend = None     # "gloo" | "nccl" | None
_store = None
# groups left behind by shutdown: referenced so that their teardown
# (which can wait on a dead peer) never runs while the process trains
_abandoned = []


def _default_coordinator():
    from .. import config as _config
    port = int(os.environ.get("DMLC_PS_ROOT_PORT", 9091)) + 1 + \
        int(_config.get("MXNET_SUPERVISOR_EPOCH"))
    return "%s:%d" % (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"), port)


def _pick_backend(world_size):
    import torch
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_process_group(coordinator=None, num_processes=None,
                       process_id=None, timeout=300.0):
    """Idempotent group bootstrap from the dmlc-style environment.

    Returns the ``(coordinator, world_size, rank)`` tuple joined (while a
    group is live, the live group's: call `shutdown` first to re-form at
    another world size).  ``timeout`` (seconds) bounds the store's
    rendezvous and every collective of the group."""
    global _group, _pg, _backend, _store
    if _group is not None:
        return _group
    coordinator = coordinator or _default_coordinator()
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("DMLC_NUM_WORKER", 1))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("DMLC_RANK", 0))
    if num_processes <= 1:
        # one process: nothing to form, but its identity is still real
        _group = (coordinator, 1, 0)
        return _group
    import torch.distributed as dist
    host, _, port = coordinator.rpartition(":")
    wait = datetime.timedelta(seconds=float(timeout))
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          process_id == 0, timeout=wait)
    kind = _pick_backend(num_processes)
    if kind == "nccl":
        # one card a rank: rank r drives cuda:r
        import torch
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = wait
        pg = dist.ProcessGroupNCCL(store, process_id, num_processes, opts)
    else:
        pg = dist.ProcessGroupGloo(store, process_id, num_processes, wait)
    _store, _pg, _backend = store, pg, kind
    _group = (coordinator, num_processes, process_id)
    return _group


def initialized():
    """Whether a process group is live."""
    return _group is not None


def group():
    """The live group's (coordinator, world_size, rank), or None."""
    return _group


def process_group():
    """The live torch process group (None with no group or one process)."""
    return _pg


def backend():
    """The live group's backend: ``"gloo"``, ``"nccl"`` or None."""
    return _backend


def shutdown():
    """Forget the process group so a new one can form: the epoch boundary
    of shrink-and-resume (the survivors re-form at the smaller world
    size, on the next epoch's port).  Nothing waits on the old group."""
    global _group, _pg, _backend, _store
    if _group is None:
        return
    if _pg is not None:
        _abandoned.append((_pg, _store))
    _group = _pg = _backend = _store = None


# the historical name; shutdown() is the re-init-capable spelling
finalize = shutdown
