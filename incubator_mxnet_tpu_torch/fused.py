"""FusedInference: the request path's evaluator over pinned parameters.

PyTorch port of `FusedInference` in `incubator_mxnet_tpu/fused.py`.  The
JAX class compiles the Symbol into one XLA program per input signature,
keyed in the unified program cache.  PyTorch runs eagerly, so here the
parameters are pinned on the device once (`set_params`) and every
dispatch is one eager pass of the graph interpreter
(`symbol.graph_eval_fn`) under `torch.inference_mode`.  The program cache,
its disk tier, the recompile auditor and scan dedup have no counterpart
here (ROADMAP.md lists what a later slice may bring).
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .symbol.symbol import graph_eval_fn

__all__ = ["FusedInference"]


def _as_tensor(v, device):
    """NDArray / tensor / numpy -> tensor on `device`."""
    if isinstance(v, NDArray):
        v = v.data
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(_np.ascontiguousarray(v))
    return v.to(device=device)


class FusedInference:
    """Inference over a pinned parameter set, one eager graph pass per call.

    Thread-safe for concurrent callers: dispatch state is per call; the
    only mutation, `set_params`, swaps the whole (params, aux) snapshot
    at once, so in-flight calls finish against the snapshot they captured.
    """

    def __init__(self, symbol, ctx, data_names):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        unknown = [n for n in data_names if n not in self._arg_names]
        if unknown:
            raise MXNetError(
                f"FusedInference: data names {unknown} are not arguments "
                f"of the symbol (has {self._arg_names})")
        self._data_names = list(data_names)
        # every non-data argument is a parameter the param dict must fill
        self._param_names = [n for n in self._arg_names
                             if n not in self._data_names]
        self._gfn, _, _ = graph_eval_fn(symbol, False)
        self._state = None   # ({name: tensor}, [aux tensors])

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def device(self):
        return self._device

    def set_params(self, arg_params, aux_params=None):
        """Pin the parameter set on the device; every parameter argument
        and aux state of the symbol must have a value."""
        aux_params = aux_params or {}
        missing = [n for n in self._param_names if n not in arg_params] + \
            [n for n in self._aux_names if n not in aux_params]
        if missing:
            raise MXNetError(f"FusedInference: no value for {missing}")
        params = {n: _as_tensor(arg_params[n], self._device)
                  for n in self._param_names}
        aux = [_as_tensor(aux_params[n], self._device)
               for n in self._aux_names]
        self._state = (params, aux)

    def __call__(self, inputs):
        """Run the graph on `inputs` (arrays ordered like `data_names`);
        returns the output tensors, on the device, possibly still being
        computed."""
        state = self._state
        if state is None:
            raise MXNetError("FusedInference: set_params before calling")
        params, aux = state
        feed = dict(params)
        feed.update(zip(self._data_names,
                        (_as_tensor(v, self._device) for v in inputs)))
        with torch.inference_mode():
            outs, _ = self._gfn([feed[n] for n in self._arg_names], aux)
        return outs
