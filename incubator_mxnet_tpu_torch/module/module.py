"""Module: symbolic training (reference `python/mxnet/module/module.py`).

PyTorch port of `incubator_mxnet_tpu/module/module.py`.  Divergences
(README "Declared divergences"): the default context is the card,
``gpu(0)``, where the JAX `Module` defaults to ``cpu()``, and
constructing one on a machine without the card raises unless
``context=mx.cpu()``.  Several contexts (data parallelism, one executor
each; a context may repeat, so two executors can share one card) train
through a kvstore with the JAX wiring (`init_optimizer`,
`module.py:254-310`): ``rescale_grad`` over the batch times the workers
of a ``dist_*sync`` store, the update on the store (its optimizer, or
the server's) or on each device's copy (``update_on_kvstore``), 2-bit
``compression_params``.  `init_optimizer` builds the fused train step
(`fused.FusedTrainStep`) when `_fusable` allows it — one context, no
kvstore but ``local``/``device``, no compression — and `fit_step` runs a
batch through it, else through `forward_backward`, `update` and
`update_metric`; with several contexts the port takes that unfused path
where the JAX package builds its fused mesh step.  The fused step writes
every array in place, so there is nothing to flush before the arrays are
read.  ``state_names`` name inputs that are neither parameters nor data
(an RNN's carried state, reference `module.py`): they are bound, never
initialized or updated, take no gradient and keep what the user writes
with `set_states` across forwards; the fused step declines a module that
has them, as the JAX one does (`module.py:341`).  The JAX `Module` keeps
the name but counts such inputs among the parameters (ROADMAP.md,
Queue 3).  The parameters the module holds between steps (`get_params`) live
on the CPU; the executors' copies on their devices.  `fit_step` is one
``fit.step`` trace span, as in the JAX package (the kvstore's rpc spans
parent into it); the port has no K-step block dispatch, so no
``fit.step_block`` span.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..obs import trace as _obs_trace
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt
from ..optimizer import states_on_ctx as _on_ctx
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from .. import ndarray as nd
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        if not context:
            raise MXNetError("Module: no context")
        for ctx in context:
            ctx.torch_device         # raises when the card is missing
        self._context = list(context)
        self._work_load_list = list(work_load_list or [1] * len(context))
        self._compression_params = compression_params
        self._kvstore = None
        self._update_on_kvstore = False
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        self._state_names = list(state_names or [])
        inputs = data_names + label_names + self._state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in inputs]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._fused_step = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a saved checkpoint pair (reference `module.py
        load`); bind it before use."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` (the unpartitioned graph) and
        ``prefix-%04d.params``, plus the optimizer states if asked."""
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties ------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """(name, shape) of each output over the whole batch: from the
        last forward, or before the first from `infer_shape` of the
        bound shapes (what `SequentialModule.bind` chains on)."""
        assert self.binded
        execs = self._exec_group.execs
        if not execs[0].outputs:
            group = self._exec_group
            _, shapes, _ = self._symbol.infer_shape(**{
                d.name: d.shape for d in group.data_shapes +
                group.label_shapes})
            return list(zip(self._output_names, shapes))
        shapes = [(sum(e.outputs[i].shape[0] for e in execs),) +
                  tuple(o.shape[1:])
                  for i, o in enumerate(execs[0].outputs)]
        return list(zip(self._output_names, shapes))

    # -- params ----------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill every parameter and aux state, in sorted name order, from
        `arg_params`/`aux_params` or `initializer` (which sees each
        variable's attrs through `InitDesc`), then copy them to the
        executor (reference `module.py init_params`)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        exe = self._exec_group.execs[0]
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(exe.arg_dict[n].shape, ctx=cpu(),
                            dtype=exe.arg_dict[n].data.dtype)
                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                n: nd.zeros(exe.aux_dict[n].shape, ctx=cpu(),
                            dtype=exe.aux_dict[n].data.dtype)
                for n in self._aux_names}

        def _impl(desc, arr, cache):
            if cache is not None and str(desc) in cache:
                if cache[str(desc)] is not arr:
                    arr._set_data(cache[str(desc)])
            elif cache is not None and not allow_missing:
                raise RuntimeError(f"{desc} is not presented")
            elif initializer is not None:
                initializer(desc, arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(InitDesc(name, attrs.get(name)), arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- bind ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind one executor for the given shapes (`Symbol.simple_bind`,
        which partitions by ``MXNET_SUBGRAPH_BACKEND``).  With a bound,
        initialized `shared_module` (a `BucketingModule`'s default
        bucket), the executor binds that module's parameter, gradient
        and aux arrays themselves wherever this graph has the same name,
        so an update through either module is seen by both, with no
        copy; a parameter the shared module lacks (a bucket's own begin
        state: the cells name them per unroll) gets arrays of its own,
        initialized as the JAX package's `switch_bucket` initializes it
        (`Uniform(0.01)` under the variable's ``__init__``)."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._fused_step = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        shared_group = None
        if shared_module is not None:
            if not (shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("bind: the shared module must be bound "
                                 "and its parameters initialized")
            # the updater's states are keyed by position: a shared
            # parameter must sit where it sits in the shared module
            moved = [n for i, n in enumerate(self._param_names)
                     if n in shared_module._param_names and
                     shared_module._param_names.index(n) != i]
            if moved:
                raise MXNetError(f"bind: parameters {moved} are not where "
                                 "the shared module has them")
            shared_group = shared_module._exec_group
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, for_training, inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            shared_group=shared_group, work_load_list=self._work_load_list,
            state_names=self._state_names)
        if shared_module is not None:
            self._init_unshared(shared_module)
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _init_unshared(self, shared_module):
        """Host copies of every parameter and aux state (read from the
        device at the next `get_params`), and the initial values of those
        the shared module lacks, in sorted name order."""
        exe = self._exec_group.execs[0]
        self._arg_params = {n: nd.zeros(exe.arg_dict[n].shape, ctx=cpu(),
                                        dtype=exe.arg_dict[n].data.dtype)
                            for n in self._param_names}
        self._aux_params = {n: nd.zeros(exe.aux_dict[n].shape, ctx=cpu(),
                                        dtype=exe.aux_dict[n].data.dtype)
                            for n in self._aux_names}
        attrs = self._symbol.attr_dict()
        initializer = Uniform(0.01)
        for params, table, known in (
                (self._arg_params, exe.arg_dict, shared_module._param_names),
                (self._aux_params, exe.aux_dict, shared_module._aux_names)):
            for name in sorted(set(params) - set(known)):
                initializer(InitDesc(name, attrs.get(name)), params[name])
                for e in self._exec_group.execs:
                    (e.arg_dict if table is exe.arg_dict
                     else e.aux_dict)[name]._set_data(params[name].data)
        self._params_dirty = True
        self.params_initialized = True

    # -- optimizer -------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False, mesh=None):
        """The kvstore, the optimizer (by name, with ``rescale_grad = 1 /
        (batch * workers of a dist sync store)`` unless given, or an
        instance) and where it runs: on the store (`set_optimizer`) or in
        the module's updater, whose states are per device (index ``i *
        n_contexts + k``) (reference `module.py init_optimizer`).

        ``mesh`` (a spec, ``'dp=2'`` or ``'dp=2,tp=2'``, or a `Mesh`; else
        ``MXNET_MESH``) lays a mesh over the module's contexts: its
        data-parallel axis (`parallel.dp_axis_of`) sets the split, so the
        module rebinds over the first context of each dp slice when the
        mesh has other axes (a composed ``dp=2,tp=2`` over four contexts
        trains on two).  The other axes hold no sharded parameters here:
        `Module` has no sharding rules, as in the JAX package."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        self._set_mesh(mesh)
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        if self._fusable(kvstore):
            update_on_kvstore = False
        ndev = len(self._context)
        names = self._exec_group.param_names
        if update_on_kvstore:
            idx2name = dict(enumerate(names))
        else:
            idx2name = {i * ndev + k: n for k in range(ndev)
                        for i, n in enumerate(names)}
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError(f"init_optimizer: expects an optimizer name or "
                             f"an Optimizer, got {type(optimizer).__name__}")
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size/num_workers "
                f"({optimizer.rescale_grad} vs. {rescale_grad}). Is this "
                "intended?")
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self._fused_step = None
        if self._fusable(kvstore):
            from ..fused import FusedTrainStep
            self._fused_step = FusedTrainStep(self, self._updater)
        self.optimizer_initialized = True
        preload = getattr(self, "_preload_opt_states", None)
        if preload is not None:
            self.load_optimizer_states(preload)
            self._preload_opt_states = None

    def _set_mesh(self, mesh):
        """Resolve ``mesh=`` over the contexts (`init_optimizer`) and
        rebind over its dp axis's contexts when they are fewer."""
        from ..parallel.mesh import Mesh, dp_axis_of, mesh_from_spec
        if mesh is None or not isinstance(mesh, Mesh):
            mesh = mesh_from_spec(mesh, devices=self._context)
        self._mesh = mesh
        if mesh is None:
            self._dp_size = len(self._context)
            return
        axis = dp_axis_of(mesh)
        self._dp_size = mesh.shape[axis]
        grid = mesh.devices.reshape(tuple(mesh.shape.values()))
        lead = np.moveaxis(grid, mesh.axis_names.index(axis), 0)
        dp_ctxs = list(lead.reshape(self._dp_size, -1)[:, 0])
        if dp_ctxs != self._context:
            self._context = dp_ctxs
            self._work_load_list = [1] * len(dp_ctxs)
            self.bind(self._data_shapes, self._label_shapes,
                      self.for_training, self.inputs_need_grad,
                      force_rebind=True)

    def _share_optimizer(self, src):
        """Take `src`'s optimizer and updater (its states included), and
        build this module's fused train step around them: a
        `BucketingModule`'s buckets update one set of states."""
        self._optimizer = src._optimizer
        self._updater = src._updater
        self._fused_step = None
        if self._fusable():
            from ..fused import FusedTrainStep
            self._fused_step = FusedTrainStep(self, self._updater)
        self.optimizer_initialized = True

    def _fusable(self, kvstore=None):
        """Whether `fit` may run the fused train step: the knob
        ``MXNET_FUSED_TRAIN_STEP`` is on, one context, no state inputs,
        the module trains, its inputs take no gradient, no compression,
        no kvstore but ``local``/``device``, and every gradient is
        written, not added (the JAX `Module._fusable` on one device)."""
        from .. import config as _config
        if not _config.get("MXNET_FUSED_TRAIN_STEP") or self._state_names:
            return False
        if len(self._context) != 1 or self._compression_params:
            return False
        if self.inputs_need_grad or not self.for_training:
            return False
        if kvstore is not None and \
                getattr(kvstore, "type", "") not in ("local", "device",
                                                     "tpu"):
            return False
        return all(v in ("write", "null")
                   for v in self._exec_group.grad_req.values())

    def fit_step(self, data_batch, eval_metric):
        """One training step and its metric update: the fused step when
        it takes the batch, else the per-batch path.  One trace span:
        the kvstore's push and pull rpc spans parent into it."""
        with _obs_trace.span("fit.step", cat="train"):
            if self._fused_step is not None and \
                    self._fused_step(data_batch, eval_metric):
                self._params_dirty = True
                return
            super().fit_step(data_batch, eval_metric)

    # -- forward/backward ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to the gradients of the last backward
        (reference `module.py:644 update`): through the kvstore when the
        update runs there, else the gradients summed through the kvstore
        (when there is one) and one `Updater.update_multi` over every
        device's parameters (the multi-tensor update the fused step runs
        too)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, group.param_names)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def get_states(self, merge_multi_context=True):
        """The state inputs' arrays (reference `module.py get_states`)."""
        assert self.binded and self.params_initialized
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        """Write the state inputs: `states` (one array per state name,
        or per state a list per context) or every element to the number
        `value` (reference `module.py set_states`)."""
        assert self.binded and self.params_initialized
        self._exec_group.set_states(states, value)

    def install_monitor(self, mon):
        """Install `mon` (a `Monitor`) on every executor."""
        assert self.binded
        for exe in self._exec_group.execs:
            mon.install(exe)

    def _sync_params_from_devices(self):
        if self._exec_group is None or not self._params_dirty:
            return
        self._exec_group.get_params(self._arg_params, self._aux_params)
        if self._kvstore and self._update_on_kvstore:
            for name, value in sorted(self._arg_params.items()):
                self._kvstore.pull(name, value)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        with open(fname, "wb") as fout:
            fout.write(self.get_optimizer_states_blob())

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as fin:
            self.set_optimizer_states_blob(fin.read())

    def get_optimizer_states_blob(self):
        """The updater's states and the pickled optimizer (update counts,
        the learning-rate schedule's position) as one bytes blob, the
        states as host arrays; with the update on the kvstore, its
        states (a dist store pulls them back from its servers)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            return self._kvstore.get_optimizer_states(dump_optimizer=True)
        return self._updater.get_states(dump_optimizer=True)

    def set_optimizer_states_blob(self, blob):
        """Restore a `get_optimizer_states_blob` blob: each state moves to
        its parameter's device, the optimizer it carries becomes the
        module's, and the fused step is rebuilt around it."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.set_optimizer_states(blob)
            return
        self._updater.set_states(blob)
        group = self._exec_group
        ndev = len(self._context)
        for i, state in self._updater.states.items():
            self._updater.states[i] = _on_ctx(
                state, group.param_arrays[i // ndev][i % ndev].context)
        restored = self._updater.optimizer
        if isinstance(restored, opt.Optimizer):
            self._optimizer = restored
        if self._fused_step is not None:
            from ..fused import FusedTrainStep
            self._fused_step = FusedTrainStep(self, self._updater)
