"""The executor group of a `Module` (reference
`python/mxnet/module/executor_group.py`).

PyTorch port of `DataParallelExecutorGroup` in
`incubator_mxnet_tpu/module/executor_group.py`: one `Executor` per
context, each bound to its slice of the batch (`decide_slices`: an even
split, or one by ``work_load_list``).  A context may repeat:
``[gpu(0), gpu(0)]`` binds two executors with arrays of their own on the
one card (the contexts are a list, never a set or a dict key).  The
arrays keep the JAX group's layout, ``[n_params][n_devices]``;
`get_outputs` and `get_input_grads` concatenate the executors' along the
batch, on the first context, and `update_metric` hands each executor its
slice of the labels.  State inputs (``state_names``) are bound like
data, take no gradient, and are written only by `set_states`.
"""
from __future__ import annotations

import torch

from ..io import DataDesc
from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import CSRNDArray


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):     # "bfloat16", which numpy may not know
        return dtype
    import numpy as np
    return np.dtype(dtype).name


def _split_input_slice(batch_size, work_load_list):
    """Batch slices per context, in proportion to the work loads
    (reference `executor_group.py decide_slices`)."""
    total = sum(work_load_list)
    slices, start = [], 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _rows(arr, shard):
    """Rows `shard` of a batch input (NDArray, tensor or numpy array);
    the whole input for a shard of None (one context: a batch of another
    size than the bound one runs at its own size)."""
    if shard is None or (shard.start, shard.stop) == (0, arr.shape[0]):
        return arr
    if isinstance(arr, CSRNDArray):
        return arr._slice_rows(shard.start, shard.stop)
    if isinstance(arr, NDArray):
        return NDArray(arr.data[shard], ctx=arr.context)
    return arr[shard]


def _consumers(symbol, name):
    """Names of the ops that read variable `name`."""
    return {node.op.name for node in symbol._topo() if not node.is_variable
            for src, _ in node.inputs if src.is_variable and src.name == name}


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write",
                 shared_group=None, work_load_list=None, state_names=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = list(work_load_list or [1] * len(self.contexts))
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = list(state_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                             for l in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]
        self.decide_slices()

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

        # with a shared group (`Module.bind(shared_module=)`), the
        # parameters, their gradients and the aux states are its arrays
        shared = shared_group.execs if shared_group else \
            [None] * len(self.contexts)
        self.execs = []
        for ctx, shard, shared_exec in zip(self.contexts, self.slices,
                                           shared):
            n = shard.stop - shard.start
            shapes = {d.name: (n,) + tuple(d.shape[1:])
                      for d in self.data_shapes + self.label_shapes}
            self.execs.append(symbol.simple_bind(
                ctx=ctx, grad_req=self.grad_req, type_dict=type_dict,
                shared_arg_names=param_names, shared_exec=shared_exec,
                **shapes))
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]
        self.state_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.state_names]

    def decide_slices(self):
        """Each context's rows of the batch (``self.slices``)."""
        if len(self.workload) != len(self.contexts):
            raise ValueError("work_load_list must give one load per "
                             "context")
        self.slices = _split_input_slice(self.batch_size, self.workload)
        if any(s.stop <= s.start for s in self.slices):
            raise ValueError(f"batch {self.batch_size} leaves a context "
                             f"no rows: {self.slices}")
        return self.slices

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters and aux states, averaged over the
        contexts, into the given dicts (new CPU NDArrays for names they
        lack)."""
        for names, blocks, table in (
                (self.param_names, self.param_arrays, arg_params),
                (self.aux_names, self.aux_arrays, aux_params)):
            for name, block in zip(names, blocks):
                val = block[0].data
                if len(block) > 1:
                    for b in block[1:]:
                        val = val + b.data.to(val.device)
                    val = val / len(block)
                if name in table:
                    table[name]._set_data(val)
                else:
                    table[name] = NDArray(val.detach().to("cpu", copy=True))

    def get_states(self, merge_multi_context=True):
        return [self._merge(s) for s in self.state_arrays] \
            if merge_multi_context else self.state_arrays

    def set_states(self, states=None, value=None):
        """Each state from `states` (an array, or one per context), or
        every element to `value`."""
        if states is not None:
            assert value is None, "only one of states and value"
            for block, src in zip(self.state_arrays, states):
                srcs = src if isinstance(src, (list, tuple)) else \
                    [_rows(src, shard) for shard in self._shards()]
                for dst, v in zip(block, srcs):
                    dst._set_data(v)
        else:
            assert value is not None, "give states or value"
            for block in self.state_arrays:
                for dst in block:
                    dst.data.fill_(value)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        names = self.data_names + self.label_names
        arrays = list(data_batch.data) + list(data_batch.label or [])
        for e, shard in zip(self.execs, self._shards()):
            e.forward(is_train=is_train,
                      **{n: _rows(a, shard) for n, a in zip(names, arrays)})

    def backward(self, out_grads=None):
        for e in self.execs:
            e.backward(out_grads)

    @staticmethod
    def _merge(parts):
        if len(parts) == 1:
            return parts[0]
        ctx = parts[0].context
        return NDArray(torch.cat([p.data.to(ctx.torch_device)
                                  for p in parts]), ctx=ctx)

    def get_outputs(self, merge_multi_context=True):
        outs = [[e.outputs[i] for e in self.execs]
                for i in range(len(self.execs[0].outputs))]
        return [self._merge(o) for o in outs] if merge_multi_context \
            else outs

    def get_input_grads(self, merge_multi_context=True):
        grads = [[e.grad_dict.get(n) for e in self.execs]
                 for n in self.data_names]
        return [self._merge(g) if g[0] is not None else None
                for g in grads] if merge_multi_context else grads

    def _shards(self):
        return self.slices if len(self.execs) > 1 else [None]

    def update_metric(self, eval_metric, labels):
        for e, shard in zip(self.execs, self._shards()):
            eval_metric.update([_rows(l, shard) for l in labels],
                               e.outputs)
