"""Modules written in Python (reference `python/mxnet/module/
python_module.py`).

PyTorch port of `incubator_mxnet_tpu/module/python_module.py`:
`PythonModule` gives a module without a Symbol the BaseModule API as
no-ops (no parameters to bind, initialise or update), and
`PythonLossModule` is a loss head whose forward keeps the incoming
scores and whose backward asks ``grad_func(scores, labels)`` for the
gradient, e.g. as the last module of a `SequentialModule`.  Both run
host code by design.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module whose API is implemented as no-ops; a subclass
    overrides what it needs (`_compute_output_shapes` at least)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names) if isinstance(
            data_names, tuple) else data_names
        self._label_names = list(label_names) if isinstance(
            label_names, tuple) else label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        """No parameters to update."""

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """The metric of the outputs against `labels`, when the module
        was bound with labels."""
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Record the shapes; there is nothing to allocate."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Nothing to optimise."""
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss head in Python: forward keeps the scores (its output),
    backward sets the input gradient to ``grad_func(scores, labels)``
    (an NDArray, or an array that becomes one on the scores' context)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        shape = self._data_shapes[0]
        shape = shape.shape if hasattr(shape, "shape") else shape[1]
        return [(self._name + "_output", tuple(shape))]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "For a loss module, out_grads should be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError(
                "PythonLossModule: pass grad_func or override "
                "_backward_impl")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
