"""Creation ops (reference `src/operator/tensor/init_op.cc`).

PyTorch port of `incubator_mxnet_tpu/ops/init_ops.py`: `_zeros`, `_ones`,
`_full`, `_arange`, `_eye` and `_linspace`.  An op with no tensor input
cannot take its device from one: `fn(params, device=None)`, and the
symbol interpreter passes the device its arguments live on.  `_arange`,
`_eye` and `_linspace` make their values on the host with numpy (what
the JAX ops compute: `jnp.arange` with a step is `np.arange`), so every
device gets the same bits, and copy them to the device.
"""
from __future__ import annotations

import numpy as np
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


def _host(values, params, device):
    """Host values as a tensor of the op's dtype on `device`."""
    dt = torch_dtype(params["dtype"] or "float32")
    return torch.from_numpy(np.asarray(values, np.float64)).to(
        device=device, dtype=dt)


@register("_arange", nin=0,
          params={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                  "infer_range": False, "dtype": "float32"})
def _arange(params, device=None):
    dt = params["dtype"] or "float32"
    np_dt = np.float32 if dt == "bfloat16" else np.dtype(dt)
    out = np.arange(params["start"], params["stop"], params["step"],
                    dtype=np_dt)
    if int(params["repeat"]) > 1:
        out = np.repeat(out, int(params["repeat"]))
    return torch.from_numpy(out).to(device=device, dtype=torch_dtype(dt))


@register("_eye", nin=0,
          params={"N": REQUIRED, "M": 0, "k": 0, "dtype": "float32"})
def _eye(params, device=None):
    n = int(params["N"])
    return _host(np.eye(n, int(params["M"]) or n, k=int(params["k"])),
                 params, device)


@register("_linspace", nin=0,
          params={"start": REQUIRED, "stop": REQUIRED, "num": REQUIRED,
                  "endpoint": True, "dtype": "float32"})
def _linspace(params, device=None):
    return _host(np.linspace(params["start"], params["stop"],
                             int(params["num"]),
                             endpoint=bool(params["endpoint"])),
                 params, device)
