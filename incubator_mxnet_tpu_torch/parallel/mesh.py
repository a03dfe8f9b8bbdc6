"""Device meshes over ranks or over contexts.

PyTorch port of `incubator_mxnet_tpu/parallel/mesh.py`.  A JAX mesh is
one program's view of many devices; here every rank runs its own
program, so a `Mesh` is one of two things:

* a mesh of **ranks**: one process a rank, all of them in torch's
  default process group (`initialize_distributed`), laid out as a
  `torch.distributed.device_mesh.DeviceMesh` whose named dimensions are
  the axes.  DTensors live on it (`tensor_parallel.shard_params`,
  `gluon_bridge.shard_block`), and each axis has its own subgroup for
  the collective verbs (`collectives`).  Several ranks may share one
  card: the group is gloo then, whose point-to-point verbs are staged
  through the host (`verbs`).
* a **grid of contexts** in one process, where no group spans the
  devices: `Module`'s case (``mesh=`` over the module's contexts, as
  `module/module.py:244-251` builds it in the JAX package).  Only its
  axis names, sizes and devices mean anything; an API that needs ranks
  raises `MXNetError` on it.

`PartitionSpec` (``P``) is the JAX package's: one entry a tensor
dimension, an axis name (or None) each.  The spec grammar and its error
texts are the JAX package's.  A mesh is a context manager, as a JAX
mesh is: ``with mesh:`` binds its axes for the calling thread, so ops
that reduce over a named axis (BatchNorm's ``sync``) find its group.
The JAX ``compat_shard_map`` has no counterpart: each rank runs its own
program, so there is nothing to map.
"""
from __future__ import annotations

import threading

import numpy as np

from ..base import MXNetError

__all__ = ["Mesh", "P", "PartitionSpec", "NamedSharding", "make_mesh",
           "parse_spec", "mesh_from_spec", "dp_axis_of", "local_mesh",
           "mesh_axes", "rebuild", "initialize_distributed", "bound_group"]

DEFAULT_AXES = ("dp", "tp")


class PartitionSpec(tuple):
    """Per-dimension axis names of a sharded tensor (the JAX
    `PartitionSpec`): ``P("tp", None)`` shards dim 0 over ``tp``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over ranks (`device_mesh` set) or over a grid of
    contexts (`devices` set)."""

    def __init__(self, axis_names, sizes, device_mesh=None, devices=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self._device_mesh = device_mesh
        self.devices = devices

    def __repr__(self):
        kind = "ranks" if self.is_ranks else "contexts"
        return f"Mesh({self.shape}, {kind})"

    @property
    def is_ranks(self):
        return self._device_mesh is not None

    @property
    def device_mesh(self):
        """The `DeviceMesh` of the ranks; raises on a grid of contexts."""
        if self._device_mesh is None:
            raise MXNetError(
                f"{self!r} is a grid of contexts in one process; this API "
                "needs a mesh of ranks (initialize_distributed, then "
                "make_mesh)")
        return self._device_mesh

    @property
    def device_type(self):
        return self.device_mesh.device_type

    def group(self, axis):
        """The process group of this rank's slice along `axis`."""
        self._check_axis(axis)
        return self.device_mesh.get_group(axis)

    def coordinate(self):
        """{axis: this rank's index along it}."""
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def axis_index(self, axis):
        self._check_axis(axis)
        return self.coordinate()[axis]

    def _check_axis(self, axis):
        if axis not in self.shape:
            raise MXNetError(f"mesh axis {axis!r} is not one of "
                             f"{self.axis_names}")

    def __enter__(self):
        _bound().append(self)
        return self

    def __exit__(self, *exc):
        _bound().pop()


class NamedSharding:
    """A mesh and a `PartitionSpec` (the JAX `NamedSharding`), with the
    DTensor placements they make on a mesh of ranks."""

    def __init__(self, mesh, spec=P()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self):
        return placements_of(self.mesh, self.spec)


def placements_of(mesh, spec):
    """DTensor placements of `spec` on `mesh`: Shard(d) on each mesh
    dimension that names tensor dim d, Replicate elsewhere.  Axes that
    shard one dimension must follow the mesh's axis order (DTensor
    splits in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [mesh.axis_names.index(a) for a in axes if a is not None]
        if order != sorted(order):
            raise MXNetError(f"spec {spec!r}: axes {axes} of dim {d} must "
                             f"follow the mesh's order {mesh.axis_names}")
        for a in axes:
            if a is not None:
                mesh._check_axis(a)
                where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.axis_names)


_tls = threading.local()


def _bound():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def bound_group(axis):
    """The process group of `axis` of the innermost bound mesh of ranks
    that has it (the port's reading of "the axis is bound in this
    trace"), or None."""
    for mesh in reversed(_bound()):
        if mesh.is_ranks and axis in mesh.shape:
            return mesh.group(axis)
    return None


def _device_type(devices):
    """The device type of a mesh of ranks: the caller's ("cpu" or
    "cuda", or a Context's), else the card's when there is one."""
    import torch
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(devices, str):
        return "cuda" if devices in ("gpu", "cuda") else devices
    return devices.torch_device.type


def make_mesh(shape=None, axis_names=None, devices=None):
    """A `Mesh`.

    shape: dict axis->size (e.g. {'dp': 4, 'tp': 2}) or tuple of sizes.
    Unspecified → every rank (or device) on one 'dp' axis.  `devices`: a
    list of Contexts makes a grid of contexts; else the mesh spans the
    ranks of torch's default process group, on the card unless
    `devices` is ``"cpu"`` (or ``mx.cpu()``).  With no process group
    and no list, the grid holds the current context alone.
    """
    import torch
    import torch.distributed as dist
    from ..context import Context, current_context
    ranks = not isinstance(devices, (list, tuple))
    if ranks and not (dist.is_available() and dist.is_initialized()):
        devices = [devices if isinstance(devices, Context)
                   else current_context()]
        ranks = False
    n = dist.get_world_size() if ranks else len(devices)
    if shape is None:
        shape = {"dp": n}
    if isinstance(shape, dict):
        axis_names = tuple(shape.keys())
        sizes = tuple(shape.values())
    else:
        sizes = tuple(shape)
        axis_names = tuple(axis_names or DEFAULT_AXES[:len(sizes)])
    total = int(np.prod(sizes))
    if total != n:
        raise MXNetError(f"mesh shape {sizes} needs {total} devices, "
                         f"have {n}")
    if not ranks:
        grid = np.empty(n, dtype=object)
        grid[:] = list(devices)
        return Mesh(axis_names, sizes, devices=grid.reshape(sizes))
    from torch.distributed.device_mesh import DeviceMesh
    kind = _device_type(devices)
    if kind == "cuda" and dist.get_backend() == "gloo":
        from . import verbs
        verbs.install()
    dm = DeviceMesh(kind, torch.arange(n).reshape(sizes),
                    mesh_dim_names=axis_names)
    return Mesh(axis_names, sizes, device_mesh=dm,
                devices=np.arange(n).reshape(sizes))


# the accepted spec grammar, quoted by every parse error so a bad
# MXNET_MESH / Module.fit(mesh=) value is self-explaining
_SPEC_GRAMMAR = ("mesh spec grammar: comma-separated 'axis=size' "
                 "tokens, each axis a nonempty name and each size a "
                 "positive integer, e.g. 'dp=8' or 'dp=4,tp=2'")


def parse_spec(spec):
    """Parse a mesh spec string — ``'dp=8'``, ``'dp=4,tp=2'`` — into an
    ordered axis->size dict (the `MXNET_MESH` / ``Module.fit(mesh=)``
    currency).  A malformed spec raises `MXNetError` naming the
    offending token and the accepted grammar."""
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError(
                f"bad token {part!r} in mesh spec {spec!r}: missing "
                f"'='; {_SPEC_GRAMMAR}")
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        if not k:
            raise MXNetError(
                f"bad token {part!r} in mesh spec {spec!r}: empty axis "
                f"name; {_SPEC_GRAMMAR}")
        try:
            size = int(v)
        except ValueError:
            raise MXNetError(
                f"bad token {part!r} in mesh spec {spec!r}: size {v!r} "
                f"is not an integer; {_SPEC_GRAMMAR}")
        if size <= 0:
            raise MXNetError(
                f"bad token {part!r} in mesh spec {spec!r}: size must "
                f"be a positive integer; {_SPEC_GRAMMAR}")
        if k in out:
            raise MXNetError(
                f"bad token {part!r} in mesh spec {spec!r}: axis {k!r} "
                f"appears twice; {_SPEC_GRAMMAR}")
        out[k] = size
    return out


def mesh_from_spec(spec=None, devices=None):
    """Build a Mesh from a spec (string or axis->size dict); with
    ``spec=None`` reads `MXNET_MESH`.  Returns None when nothing is
    configured — callers fall back to their default 1-D dp mesh.  Any
    other value raises `MXNetError` quoting the grammar."""
    if spec is None or spec == "":
        from .. import config as _config
        spec = _config.get("MXNET_MESH")
    if not spec:
        return None
    if isinstance(spec, str):
        spec = parse_spec(spec)
    elif not isinstance(spec, dict):
        raise MXNetError(f"mesh {spec!r} is neither a Mesh nor a mesh "
                         f"spec; {_SPEC_GRAMMAR}")
    if not spec:
        return None
    return make_mesh(spec, devices=devices)


def dp_axis_of(mesh):
    """The data-parallel axis of a composed mesh: 'dp' when present,
    else the first axis (the convention every consumer shares)."""
    names = tuple(mesh.axis_names)
    return "dp" if "dp" in names else names[0]


def local_mesh(n=None, axis_names=("dp",)):
    """A grid over the first n cards of this process (the CPU when there
    is none); a testing convenience."""
    import torch
    from ..context import cpu, gpu
    devs = [gpu(i) for i in range(torch.cuda.device_count())] or [cpu()]
    n = n or len(devs)
    return make_mesh({axis_names[0]: n}, devices=devs[:n])


def mesh_axes(mesh):
    return tuple(mesh.axis_names)


def rebuild(axis_names=("dp",), per_host=None):
    """The 1-axis data-parallel mesh over the ranks of the live default
    group: after a shrink the survivors re-form it at the smaller world
    size (`initialize_distributed` again), and every older mesh is stale.
    Each process is one rank, so ``per_host`` (the JAX package's cap of
    devices a process) can only be 1 or None."""
    if per_host not in (None, 1):
        raise MXNetError(f"rebuild: per_host={per_host}; a rank is one "
                         "process here, so at most 1")
    return make_mesh({axis_names[0]: _world()})


def _world():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, timeout=300.0):
    """Form the ranks' group (replaces ps-lite bootstrapping, reference
    `tools/launch.py` + DMLC_PS_ROOT_URI wiring): the port's collective
    group (`dist.collective.init_process_group`, the same environment and
    rendezvous), then torch's default process group on a prefix of its
    store, which `make_mesh` lays the DeviceMesh over.  Gloo when ranks
    share a card, NCCL with a card a rank.  Returns the ``(coordinator,
    world_size, rank)`` joined."""
    import datetime
    import torch.distributed as dist
    from ..dist import collective
    joined = collective.init_process_group(coordinator_address,
                                           num_processes, process_id,
                                           timeout)
    _, world, rank = joined
    if world > 1 and not dist.is_initialized():
        store = dist.PrefixStore("mesh", collective._store)
        dist.init_process_group(collective.backend(), store=store,
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
    return joined
