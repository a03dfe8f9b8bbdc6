"""Module: symbolic training on one device (reference
`python/mxnet/module/module.py`).

PyTorch port of `incubator_mxnet_tpu/module/module.py`.  Divergences
(README "Declared divergences"): the default context is the card,
``gpu(0)``, where the JAX `Module` defaults to ``cpu()``, and
constructing one on a machine without the card raises unless
``context=mx.cpu()``; one context only, since the port has no kvstore
yet.  `init_optimizer` builds the fused train step
(`fused.FusedTrainStep`) when `_fusable` allows it, and `fit_step` runs
a batch through it, else through `forward_backward`, `update` and
`update_metric`.  The fused step writes every array in place, so there
is nothing to flush before the arrays are read.  The parameters the
module holds between steps (`get_params`) live on the CPU; the
executor's copies on the device.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt
from ..optimizer import states_on_ctx as _on_ctx
from ..model import _create_kvstore, load_checkpoint, save_checkpoint
from .. import ndarray as nd
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError(f"Module: the port trains on one context, got "
                             f"{len(context)} (data parallelism needs a "
                             "kvstore, not ported yet)")
        context[0].torch_device      # raises when the card is missing
        if state_names:
            raise MXNetError("Module: state_names are not ported")
        self._context = list(context)
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        inputs = data_names + label_names
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
        assert self.binded
        outs = self._exec_group.execs[0].outputs
        return list(zip(self._output_names, [o.shape for o in outs]))

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
        which partitions by ``MXNET_SUBGRAPH_BACKEND``)."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._fused_step = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            self._param_names, for_training, inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer -------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (by name, with ``rescale_grad = 1 / batch``
        unless given, or an instance) and its updater (reference
        `module.py init_optimizer`)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        _create_kvstore(kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        idx2name = dict(enumerate(self._exec_group.param_names))
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
                f"is not normalized to 1.0/batch_size ({optimizer.rescale_grad}"
                f" vs. {rescale_grad}). Is this intended?")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._fused_step = None
        if self._fusable():
            from ..fused import FusedTrainStep
            self._fused_step = FusedTrainStep(self, self._updater)
        self.optimizer_initialized = True
        preload = getattr(self, "_preload_opt_states", None)
        if preload is not None:
            self.load_optimizer_states(preload)
            self._preload_opt_states = None

    def _fusable(self):
        """Whether `fit` may run the fused train step: the knob
        ``MXNET_FUSED_TRAIN_STEP`` is on, the module trains, its inputs
        take no gradient and every gradient is written, not added (the
        JAX `Module._fusable` on one device)."""
        from .. import config as _config
        if not _config.get("MXNET_FUSED_TRAIN_STEP"):
            return False
        if self.inputs_need_grad or not self.for_training:
            return False
        return all(v in ("write", "null")
                   for v in self._exec_group.grad_req.values())

    def fit_step(self, data_batch, eval_metric):
        """One training step and its metric update: the fused step when
        it takes the batch, else the per-batch path."""
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
        """Apply the optimizer to the gradients of the last backward: one
        `Updater.update_multi` over every parameter that has one (the
        multi-tensor update the fused step runs too)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        group = self._exec_group
        rows = [(i, g[0], w[0]) for i, (w, g) in
                enumerate(zip(group.param_arrays, group.grad_arrays))
                if g[0] is not None]
        if rows:
            self._updater.update_multi(*(list(c) for c in zip(*rows)))

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        if self._exec_group is None or not self._params_dirty:
            return
        self._exec_group.get_params(self._arg_params, self._aux_params)
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
        states as host arrays."""
        assert self.optimizer_initialized
        return self._updater.get_states(dump_optimizer=True)

    def set_optimizer_states_blob(self, blob):
        """Restore a `get_optimizer_states_blob` blob: each state moves to
        its parameter's device, the optimizer it carries becomes the
        module's, and the fused step is rebuilt around it."""
        assert self.optimizer_initialized
        self._updater.set_states(blob)
        group = self._exec_group
        for i, state in self._updater.states.items():
            self._updater.states[i] = _on_ctx(
                state, group.param_arrays[i][0].context)
        restored = self._updater.optimizer
        if isinstance(restored, opt.Optimizer):
            self._optimizer = restored
        if self._fused_step is not None:
            from ..fused import FusedTrainStep
            self._fused_step = FusedTrainStep(self, self._updater)
