"""Creation ops (reference `src/operator/tensor/init_op.cc`).

PyTorch port of `_zeros`, `_ones` and `_full` in
`incubator_mxnet_tpu/ops/init_ops.py`, the ones `nd.zeros` and
`Module.init_params` need.  An op with no tensor input cannot take its
device from one: `fn(params, device=None)`, and the symbol interpreter
passes the device its arguments live on.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register, REQUIRED


def _make(params, device, value):
    return torch.full(tuple(params["shape"]), value,
                      dtype=torch_dtype(params["dtype"] or "float32"),
                      device=device)


@register("_zeros", nin=0, params={"shape": (), "dtype": "float32"})
def _zeros(params, device=None):
    return _make(params, device, 0)


@register("_ones", nin=0, params={"shape": (), "dtype": "float32"})
def _ones(params, device=None):
    return _make(params, device, 1)


@register("_full", nin=0,
          params={"shape": (), "dtype": "float32", "value": REQUIRED})
def _full(params, device=None):
    return _make(params, device, params["value"])
