"""Custom operators in Python (reference `python/mxnet/operator.py`, backend
`src/operator/custom/custom.cc` CustomOperator).

PyTorch port of `incubator_mxnet_tpu/operator.py`.  `CustomOp` /
`CustomOpProp` + `register` keep the reference API: the user's
``forward``/``backward`` callbacks run in Python on the port's NDArrays,
which stay on their device.  In the reference they run on a dedicated
worker pool so engine threads never block (`custom-inl.h:50-148`); here
they run at dispatch, and the op goes on the autograd tape as one
`autograd.Function` (a `torch.autograd.Function` underneath), so
gradients flow through the custom backward.  Like the JAX package, the
port adds no ``sym.Custom``: custom ops run imperatively (``nd.Custom``).
"""
from __future__ import annotations

from .base import MXNetError
from .ndarray.ndarray import NDArray
from . import ndarray as nd
from . import autograd

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base custom operator (reference `operator.py:CustomOp`)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write `src` into `dst` as `req` says: ``write``/``inplace``
        overwrite, ``add`` accumulates, ``null`` leaves it."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst._set_data(src._data if isinstance(src, NDArray) else src)
        elif req == "add":
            dst._set_data(dst._data + (src._data if isinstance(src, NDArray)
                                       else src))


class CustomOpProp:
    """Operator properties (reference `operator.py:CustomOpProp`)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Register a CustomOpProp class (reference `operator.py register`)."""
    def do_register(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators():
    return list(_CUSTOM_REGISTRY)


class _CustomFunction(autograd.Function):
    """Bridge a CustomOp instance onto the autograd tape."""

    def __init__(self, op, prop, is_train=False):
        super().__init__()
        self._op = op
        self._prop = prop
        self._is_train = is_train

    def forward(self, *inputs):
        out_shapes = self._prop.infer_shape([list(i.shape) for i in inputs])[1]
        outputs = [nd.zeros(tuple(s), ctx=inputs[0].context)
                   for s in out_shapes]
        self._op.forward(is_train=self._is_train,
                         req=["write"] * len(outputs),
                         in_data=list(inputs), out_data=outputs, aux=[])
        self.save_for_backward(list(inputs), outputs)
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def backward(self, *out_grads):
        inputs, outputs = self.saved_tensors
        in_grads = [nd.zeros(i.shape, ctx=i.context) for i in inputs]
        self._op.backward(req=["write"] * len(in_grads),
                          out_grad=list(out_grads), in_data=inputs,
                          out_data=outputs, in_grad=in_grads, aux=[])
        return in_grads[0] if len(in_grads) == 1 else tuple(in_grads)


def invoke_custom(op_type, *inputs, **kwargs):
    """Run a registered custom op eagerly (`mx.nd.Custom` equivalent)."""
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(f"Custom operator {op_type} is not registered "
                         f"(available: {get_all_registered_operators()})")
    prop = _CUSTOM_REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})
    op = prop.create_operator(inputs[0].context,
                              [list(i.shape) for i in inputs],
                              [i.dtype for i in inputs])
    fn = _CustomFunction(op, prop, is_train=autograd.is_training())
    return fn(*inputs)


def _attach_nd_custom():
    """Expose nd.Custom(*data, op_type=...) like the reference."""
    def Custom(*data, **kwargs):
        op_type = kwargs.pop("op_type")
        return invoke_custom(op_type, *data, **kwargs)
    nd.Custom = Custom


_attach_nd_custom()
