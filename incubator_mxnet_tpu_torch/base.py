"""Base utilities: the error type and stringly-typed param coercion.

PyTorch port of `incubator_mxnet_tpu/base.py`: the pieces that are API
surface — `MXNetError` and the string->python coercion that MXNet-style
op parameters ("(3, 3)", "True", "1e-3") go through — plus the dtype
names the port maps onto torch dtypes.
"""
from __future__ import annotations

import ast

import numpy as _np
import torch

__all__ = ["MXNetError", "py_literal", "torch_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: `python/mxnet/base.py` MXNetError)."""


def py_literal(value):
    """Coerce an MXNet stringly-typed parameter value to a Python value.

    The reference reflects `dmlc::Parameter` structs into Python with string
    round-tripping ("(2, 2)", "True", "1e-3"); both real Python values and
    their string forms are accepted.
    """
    if not isinstance(value, str):
        return value
    s = value.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "none":
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype):
    """Normalize a dtype-ish (str, np.dtype, torch.dtype) to torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None

