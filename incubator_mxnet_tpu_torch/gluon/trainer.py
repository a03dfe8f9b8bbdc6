"""Gluon Trainer (reference `python/mxnet/gluon/trainer.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/trainer.py`.
`step(batch_size)` sets the optimizer's ``rescale_grad`` to the scale the
trainer was given (``optimizer_params["rescale_grad"]``, default 1)
over `batch_size`, exactly as the JAX package does, sums the gradients
of parameters held on several contexts through the kvstore, then updates
every parameter that takes a gradient, context by context, with one
`Updater.update_multi` call each (the multi-tensor SGD, with fp32
master weights for bf16 parameters under ``multi_precision``), reading
the gradient arrays `autograd` filled.  The update runs in place on the
parameters' autograd leaves, outside the graph, so the next
`autograd.record()` sees the new values.

Parameters on several contexts (``[gpu(0), gpu(0)]`` on one card) get a
kvstore (``device`` by default) and one updater a context, as in the JAX
package (`trainer.py:105-118`): `allreduce_grads` hands the store every
such gradient in ONE batched push and pull (`:139-170`), which the
``device`` store reduces in size-capped buckets (`kvstore.KVStoreDevice`)
and writes back into every context's gradient.  A ``dist_*`` kvstore is
created and its keys initialized at the first step, with the compression
asked for; on one context it pushes nothing, as in the JAX package, and
without ``dist`` one context needs no kvstore.  On a mesh of ranks
(`parallel.shard_block`) the parameters and gradients are DTensors: the
backward leaves each gradient in its parameter's layout (the dp
all-reduce is DTensor's redistribution of the partial sums), each
sharded weight is updated on each rank's local shards
(`parallel.gluon_bridge.update_on_shards`), and each optimizer state
takes its weight's layout, or with ``zero=mesh`` (or
``(mesh, axis)``, or ``zero=True`` with ``mesh=`` or ``MXNET_MESH``) a
layout sharded over the mesh's data-parallel axis: ZeRO state
partitioning, each dp rank holding 1/N of every state whose leading
dimension the axis divides.  `save_states` / `load_states` pickle the updater's states and
the optimizer in the port's own format.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import kvstore as kvs
from .. import optimizer as opt
from ..optimizer import states_on_ctx as _on_ctx
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters (reference
    `gluon/trainer.py:27`)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, zero=None, mesh=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._update_on_kvstore = False
        self._kv_initialized = False
        self._zero = _resolve_zero(zero, mesh)

    def _init_kvstore(self):
        """A store (a name, or a store) with every live parameter's key
        initialized, for parameters on several contexts or a ``dist``
        store; else none."""
        kind = self._kvstore_type
        if len(self._contexts) > 1 or "dist" in str(kind):
            kv = kvs.create(kind) if isinstance(kind, str) else kind
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    kv.init(i, param.list_data()[0])
            self._kvstore = kv
        self._kv_initialized = True

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError("All Parameters must be initialized on the "
                                 "same set of contexts")
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        # one updater a context, sharing the optimizer (the JAX Trainer's)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in range(max(1, len(self._contexts)))]

    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr if o.lr_scheduler is None else o.lr_scheduler(
            o.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """`allreduce_grads`, then `update` (reference `trainer.py:254`)."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum through the kvstore the gradients held on several contexts
        (on one context, none): one batched push and pull where the store
        prefers it, so the step costs O(buckets) reductions."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        live = [(i, p.list_grad()) for i, p in enumerate(self._params)
                if p.grad_req != "null" and len(p.list_grad()) > 1]
        if not live:
            return
        if getattr(self._kvstore, "prefers_batched_push", False):
            keys = [i for i, _ in live]
            grads = [g for _, g in live]
            self._kvstore.push(keys, grads)
            self._kvstore.pull(keys, grads)
            return
        for i, grads in live:
            self._kvstore.push(i, grads, priority=-i)
            self._kvstore.pull(i, grads, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """Set ``rescale_grad`` to the trainer's scale over `batch_size`
        and update every parameter that takes a gradient."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if live:
            from ..parallel import gluon_bridge as gb
            for k, updater in enumerate(self._updaters):
                for i, p in live:
                    if i not in updater.states:
                        w = p.list_data()[k]
                        updater.states[i] = self._optimizer. \
                            create_state_multi_precision(i, w)
                        self._place_state(updater.states[i], w)
                sharded = [(i, p) for i, p in live
                           if gb.is_sharded(p.list_data()[k].data)]
                plain = [(i, p) for i, p in live if (i, p) not in sharded]
                if plain:
                    updater.update_multi(
                        [i for i, _ in plain],
                        [p.list_grad()[k] for _, p in plain],
                        [p.list_data()[k] for _, p in plain])
                for i, p in sharded:
                    gb.update_on_shards(updater.optimizer, i,
                                        p.list_data()[k], p.list_grad()[k],
                                        updater.states[i])

    def _place_state(self, state, weight):
        """Lay a fresh optimizer state out as its weight's residency asks:
        ZeRO-sharded when ``zero=`` was given, else as a mesh-sharded
        weight is laid out (`incubator_mxnet_tpu/gluon/trainer.py:207`)."""
        from ..parallel import gluon_bridge as gb
        if self._zero is not None:
            gb.shard_state_for_zero(state, *self._zero)
        elif gb.is_sharded(weight.data):
            gb.place_state_like(state, weight.data)

    def get_checkpoint_state(self):
        """The updater's states (host arrays) and the pickled optimizer
        (update counts, learning-rate schedule) as one bytes blob, what an
        elastic checkpoint stores per Trainer (`checkpoint/state.py`)."""
        return self._updaters[0].get_states(dump_optimizer=True)

    def set_checkpoint_state(self, blob):
        """Restore a `get_checkpoint_state` blob: every context's updater
        takes its states, each on that context, and the one restored
        optimizer replaces the trainer's."""
        for k, updater in enumerate(self._updaters):
            updater.set_states(blob)
            for i, state in updater.states.items():
                updater.states[i] = _on_ctx(state,
                                            self._params[i].list_ctx()[k])
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def save_states(self, fname):
        """`get_checkpoint_state` to `fname`."""
        with open(fname, "wb") as f:
            f.write(self.get_checkpoint_state())

    def load_states(self, fname):
        """Restore `save_states`' file."""
        with open(fname, "rb") as f:
            self.set_checkpoint_state(f.read())


def _resolve_zero(zero, mesh):
    """The ZeRO layout of ``zero=``, (mesh, axis) or None: False and None
    are nothing; True takes `mesh` (a `Mesh` or a spec) or, without it,
    the ``MXNET_MESH`` spec's mesh, and raises with neither; a mesh
    alone shards over its data-parallel axis, found by name
    (`dp_axis_of`), never by position.  A mesh is built only for
    ``zero=True`` (over ranks that is a collective); a `mesh` that is
    not a mesh spec raises either way."""
    from ..parallel.mesh import Mesh, dp_axis_of, mesh_from_spec, parse_spec
    if isinstance(mesh, str):
        parse_spec(mesh)
    elif mesh is not None and not isinstance(mesh, (Mesh, dict)):
        raise MXNetError(f"Trainer(mesh={mesh!r}): neither a Mesh nor a "
                         f"mesh spec")
    if zero is True:
        if not isinstance(mesh, Mesh):
            mesh = mesh_from_spec(mesh)
        if mesh is None:
            raise MXNetError(
                "Trainer(zero=True) needs a mesh: pass mesh= (or set "
                "MXNET_MESH), or hand zero= the mesh directly")
        zero = mesh
    elif zero is False:
        zero = None
    if zero is not None and not isinstance(zero, tuple):
        zero = (zero, dp_axis_of(zero))
    return zero
