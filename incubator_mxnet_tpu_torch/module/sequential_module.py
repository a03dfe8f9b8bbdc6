"""SequentialModule: a chain of modules, each taking the previous one's
outputs as its data (reference `python/mxnet/module/sequential_module.py`).

PyTorch port of `incubator_mxnet_tpu/module/sequential_module.py`.
``add(module, take_labels=True)`` gives a module the batch's labels;
``auto_wiring=True`` renames the incoming data to the module's own
data names.  Every module after the first binds with
``inputs_need_grad``, so `backward` hands each one's input gradients to
the module before it as its output gradients.  Training runs the
per-batch path (`BaseModule.fit_step`: forward, backward, update,
metric); the modules' outputs cross between them as the card's tensors.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {x for x in dir(self) if x.startswith("META_")}

    def add(self, module, **kwargs):
        """Append `module` (metas: ``take_labels``, ``auto_wiring``);
        returns self, so adds chain."""
        self._modules.append(module)
        for key in kwargs:
            assert f"META_{key.upper()}" in self._meta_keys, \
                f"Unknown meta {key}"
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=allow_missing or
                               (arg_params is not None),
                               force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert self._modules, "SequentialModule: no module added"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_needs_label = False
        for i, module in enumerate(self._modules):
            meta = self._metas[i]
            if meta.get(self.META_TAKE_LABELS):
                my_label_shapes = label_shapes
                anybody_needs_label = True
            else:
                my_label_shapes = None
            if meta.get(self.META_AUTO_WIRING, False):
                names = module.data_names
                assert len(names) == len(my_data_shapes)
                my_data_shapes = [
                    DataDesc(new, s.shape if isinstance(s, DataDesc)
                             else s[1])
                    for new, s in zip(names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=inputs_need_grad or (
                            for_training and i > 0),
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = [DataDesc(name, shape)
                              for name, shape in module.output_shapes]
        if not anybody_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The same optimizer settings for every module (each its own
        optimizer and updater)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            takes = self._metas[i + 1].get(self.META_TAKE_LABELS)
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label if takes else None,
                              pad=data_batch.pad, index=data_batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        """Each module that takes the labels updates the metric with its
        outputs."""
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
