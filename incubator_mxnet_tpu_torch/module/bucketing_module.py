"""BucketingModule: one bound Module per bucket key, all sharing one set
of parameters (reference `python/mxnet/module/bucketing_module.py:36`).

PyTorch port of `incubator_mxnet_tpu/module/bucketing_module.py`.  Each
bucket's Module binds the default bucket's parameter, gradient and aux
tensors themselves (`Module.bind(shared_module=)`), as the reference's
executors share their arrays, and every bucket updates through the
default bucket's optimizer and updater, so a parameter's momentum is one
tensor whichever bucket ran.  The JAX package gives each bucket arrays
of its own and copies every parameter into every other bucket after
each `update` (a host round trip a step); the numbers are the same.
Each bucket's `fit_step` runs its own fused train step
(`fused.FusedTrainStep`).  ``state_names`` pass to every bucket's
Module (`Module` says what they are).  `fit(checkpoint_dir=, resume=)`
is `BaseModule.fit`'s elastic path: a snapshot
(`_checkpoint_capture`) holds each shared array once, each
bucket's own arrays (its begin states), the buckets bound so far, the
shared optimizer's states, the iterator's position and order and the
random streams; resume binds those buckets again in their order, writes
their arrays, rebuilds every bucket's fused step around the restored
optimizer, and only then restores the random streams, so a resumed fit
is bit for bit the uninterrupted one.
"""
from __future__ import annotations

import logging
import pickle

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule: default_bucket_key is "
                             "required")
        self._state_names = state_names
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    # -- params ----------------------------------------------------------------
    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- bind ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's Module; the others bind on first use
        (`switch_bucket`)."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("BucketingModule.bind: shared_module is not "
                             "supported")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make `bucket_key`'s Module the current one, binding it first
        (on the default bucket's arrays, with its optimizer) when the key
        is new."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            if not default.params_initialized:
                raise MXNetError("switch_bucket: initialize the parameters "
                                 "before binding another bucket")
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes, default.for_training,
                        default.inputs_need_grad, shared_module=default)
            if self.optimizer_initialized:
                module._share_optimizer(default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                mod._share_optimizer(default)
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------------
    def _switch_to(self, data_batch):
        if data_batch.bucket_key is not None:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._switch_to(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self._switch_to(data_batch)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        """The current bucket's update, in place on the shared tensors."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def fit_step(self, data_batch, eval_metric):
        """The batch's bucket's training step: its fused train step when
        it takes the batch, else the per-batch path."""
        self._switch_to(data_batch)
        self._params_dirty = True
        self._curr_module.fit_step(data_batch, eval_metric)

    # -- state inputs ----------------------------------------------------------
    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states, value)

    # -- elastic checkpoints -----------------------------------------------------
    @property
    def _default(self):
        return self._buckets[self._default_bucket_key]

    @property
    def _optimizer(self):
        return self._default._optimizer if self.binded else None

    def _checkpoint_capture(self, data_iter=None):
        """The default bucket's capture (its arrays are the shared ones,
        its updater the shared optimizer's), each other bucket's own
        arrays, and every bound bucket's (key, data shapes, label shapes)
        in binding order (the ``buckets`` blob)."""
        from ..checkpoint import state as _state
        arrays, blobs, staged = self._default._checkpoint_capture(data_iter)
        layout = []
        for key, mod in self._buckets.items():
            group = mod._exec_group
            for prefix, names, blocks in (
                    ("arg:", group.param_names, group.param_arrays),
                    ("aux:", group.aux_names, group.aux_arrays)):
                for n, blk in zip(names, blocks):
                    arrays.setdefault(prefix + n, blk[0])
            layout.append((key, [(d.name, tuple(d.shape))
                                 for d in group.data_shapes],
                           [(d.name, tuple(d.shape))
                            for d in group.label_shapes]))
        blobs[_state.BUCKETS_BLOB] = pickle.dumps(layout, protocol=4)
        return arrays, blobs, staged

    def _restore_checkpoint_layout(self, ckpt):
        """Bind the buckets a checkpoint had bound, in its order, and
        write each one's own arrays from it (the shared ones are the
        default bucket's, already written)."""
        from ..checkpoint import state as _state
        blob = ckpt.blobs.get(_state.BUCKETS_BLOB)
        if not blob:
            return
        arg_params, aux_params = _state.split_params(ckpt.arrays)
        default = self._default
        for key, data_shapes, label_shapes in pickle.loads(blob):
            if key == self._default_bucket_key:
                continue
            self.switch_bucket(key, data_shapes, label_shapes or None)
            mod = self._buckets[key]
            for names, known, params, table in (
                    (mod._param_names, default._param_names, arg_params,
                     "arg_dict"),
                    (mod._aux_names, default._aux_names, aux_params,
                     "aux_dict")):
                for name in set(names) - set(known):
                    for e in mod._exec_group.execs:
                        getattr(e, table)[name]._set_data(params[name])
            mod._params_dirty = True
        self.switch_bucket(self._default_bucket_key, None, None)

    def set_optimizer_states_blob(self, blob):
        """Restore the shared optimizer's states, then rebuild every other
        bucket's fused step around the restored optimizer."""
        default = self._default
        default.set_optimizer_states_blob(blob)
        for mod in self._buckets.values():
            if mod is not default:
                mod._share_optimizer(default)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install `mon` on every bucket's Module, and on those bound
        later."""
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
