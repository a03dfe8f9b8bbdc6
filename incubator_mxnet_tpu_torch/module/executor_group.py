"""The executor group of a `Module` (reference
`python/mxnet/module/executor_group.py`).

PyTorch port of `DataParallelExecutorGroup` in
`incubator_mxnet_tpu/module/executor_group.py` for one context: one
`Executor` bound to the whole batch.  The arrays keep the JAX group's
layout, ``[n_params][n_devices]``, with one device.
"""
from __future__ import annotations

import torch

from ..io import DataDesc
from ..ndarray.ndarray import NDArray


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):     # "bfloat16", which numpy may not know
        return dtype
    import numpy as np
    return np.dtype(dtype).name


def _consumers(symbol, name):
    """Names of the ops that read variable `name`."""
    return {node.op.name for node in symbol._topo() if not node.is_variable
            for src, _ in node.inputs if src.is_variable and src.name == name}


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write",
                 shared_group=None):
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                             for l in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]

        if isinstance(grad_req, str):
            self.grad_req = {}
            for name in self.arg_names:
                if name in self.param_names and \
                        name not in self.fixed_param_names:
                    self.grad_req[name] = grad_req if for_training \
                        else "null"
                elif name in self.data_names:
                    self.grad_req[name] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[name] = "null"
        else:
            self.grad_req = dict(grad_req)

        # low-precision lane: when every data input is declared fp16 or
        # bf16, the arguments bind in that dtype; labels keep theirs
        type_dict = None
        data_dtypes = {_dtype_name(d.dtype) for d in self.data_shapes}
        if len(data_dtypes) == 1 and \
                next(iter(data_dtypes)) in ("float16", "bfloat16"):
            low = next(iter(data_dtypes))
            type_dict = {n: low for n in self.arg_names
                         if n not in self.label_names}
            for l in self.label_shapes:
                type_dict[l.name] = _dtype_name(l.dtype)

        # a uint8 image input read only by ImageNormalize binds as uint8,
        # so the bytes that cross to the device are uint8 (the JAX group
        # binds it float32 and the cast happens on the host)
        for d in self.data_shapes:
            if _dtype_name(d.dtype) == "uint8" and \
                    _consumers(symbol, d.name) == {"ImageNormalize"}:
                type_dict = dict(type_dict or {})
                type_dict[d.name] = "uint8"

        shapes = {d.name: d.shape for d in self.data_shapes}
        shapes.update({l.name: l.shape for l in self.label_shapes})
        # with a shared group (`Module.bind(shared_module=)`), the
        # parameters, their gradients and the aux states are its arrays
        shared_exec = shared_group.execs[0] if shared_group else None
        self.execs = [symbol.simple_bind(ctx=contexts[0],
                                         grad_req=self.grad_req,
                                         type_dict=type_dict,
                                         shared_arg_names=param_names,
                                         shared_exec=shared_exec, **shapes)]
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters and aux states into the given dicts
        (new CPU NDArrays for names they lack)."""
        for names, blocks, table in (
                (self.param_names, self.param_arrays, arg_params),
                (self.aux_names, self.aux_arrays, aux_params)):
            for name, block in zip(names, blocks):
                val = block[0].data
                if name in table:
                    table[name]._set_data(val)
                else:
                    table[name] = NDArray(val.detach().to("cpu", copy=True))

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        inputs = dict(zip(self.data_names, data_batch.data))
        inputs.update(zip(self.label_names, data_batch.label or []))
        for e in self.execs:
            e.forward(is_train=is_train, **inputs)

    def backward(self, out_grads=None):
        for e in self.execs:
            e.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        return [self.execs[0].grad_dict.get(n) for n in self.data_names]

    def update_metric(self, eval_metric, labels):
        for e in self.execs:
            eval_metric.update(labels, e.outputs)
