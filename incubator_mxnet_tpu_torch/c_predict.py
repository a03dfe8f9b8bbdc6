"""Python side of the C predict ABI (`src/c_predict_api.h`).

PyTorch port of `incubator_mxnet_tpu/c_predict.py`.  The reference ships
a standalone inference ABI (`include/mxnet/c_predict_api.h`: create a
predictor from saved symbol JSON and params bytes, set inputs, forward,
read outputs); `csrc/c_predict_api.cc` exports that ABI from a C library
that embeds CPython and calls this module (`native.build_predict`).  A
`Predictor` is a thin adapter over `serving.ServedModel` with one bucket
sized to the declared batch, run at exactly the declared shapes
(`ServedModel.infer_exact`).

``dev_type`` 1 is the CPU and 2 the card (the header's "2 =
accelerator"); any other value raises `MXNetError`, which the C side
returns through `MXTPUGetLastError` (the JAX adapter takes every value
but 1 for its accelerator).  ``programs_dir``, the JAX package's
compiled-program payload, is accepted and ignored: the port compiles no
programs.
"""
from __future__ import annotations

import itertools

import numpy as np

from .base import MXNetError

__all__ = ["Predictor", "create"]

_DEVICES = {1: "cpu", 2: "gpu"}
_seq = itertools.count(1)


class Predictor:
    def __init__(self, symbol_json, param_bytes, dev_type, dev_id,
                 input_shapes, programs_dir=None):
        from . import context as ctx_mod
        from . import symbol as sym_mod
        from .compat.mxnet_params import load_params
        from .serving.model import ServedModel

        del programs_dir
        if dev_type not in _DEVICES:
            raise MXNetError(f"c_predict: dev_type {dev_type} is neither 1 "
                             "(cpu) nor 2 (the CUDA card)")
        ctx = getattr(ctx_mod, _DEVICES[dev_type])(dev_id)
        sym = sym_mod.load_json(symbol_json)
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        input_shapes = {k: tuple(int(d) for d in v)
                        for k, v in dict(input_shapes).items()}
        self._input_shapes = input_shapes
        params = load_params(param_bytes)
        if not isinstance(params, dict):   # a nameless save of no params
            params = {}
        args, auxs = {}, {}
        for k, v in params.items():
            if ":" in k:
                kind, name = k.split(":", 1)
                (args if kind == "arg" else auxs)[name] = v
            elif k in arg_names:
                args[k] = v
            elif k in aux_names:
                auxs[k] = v
        # the ABI declares one exact signature: one bucket, the batch
        batch = max(int(next(iter(input_shapes.values()))[0]), 1) \
            if input_shapes else 1
        self._model = ServedModel(sym, args, auxs,
                                  data_shapes=list(input_shapes.items()),
                                  buckets=(batch,), ctx=ctx,
                                  name=f"c_predict#{next(_seq)}")
        self._inputs = {name: np.zeros(shape, np.float32)
                        for name, shape in input_shapes.items()}
        self._outputs = None

    def output_count(self):
        return len(self._model.output_names)

    def set_input(self, name, flat_f32):
        """Copy a flat float32 input (the caller may reuse its buffer as
        soon as this returns)."""
        if name not in self._input_shapes:
            raise MXNetError(f"c_predict: no input named {name!r}")
        self._inputs[name] = np.array(flat_f32, dtype=np.float32,
                                      copy=True).reshape(
                                          self._input_shapes[name])
        self._outputs = None

    def set_input_bytes(self, name, view):
        """The C path: `view` is a read-only memoryview over float32."""
        self.set_input(name, np.frombuffer(view, dtype=np.float32))

    def forward(self):
        self._outputs = self._model.infer_exact(self._inputs)

    def output_shape(self, index):
        if self._outputs is None:
            self.forward()
        return tuple(self._outputs[index].shape)

    def output(self, index):
        """Output `index` as flat float32 bytes."""
        if self._outputs is None:
            self.forward()
        out = self._outputs[index].asnumpy().astype(np.float32, copy=False)
        return np.ascontiguousarray(out).tobytes()


def create(symbol_json, param_bytes, dev_type, dev_id, input_names,
           input_shapes, programs_dir=None):
    """The ABI's entry: `input_names` a list of str, `input_shapes` a
    list of tuples."""
    return Predictor(symbol_json, param_bytes, dev_type, dev_id,
                     dict(zip(input_names, [tuple(s) for s in input_shapes])),
                     programs_dir=programs_dir)
