"""Device context: `cpu()` and `gpu(i)`, each naming a `torch.device`.

PyTorch port of `incubator_mxnet_tpu/context.py`.  The card is the
default: `current_context()` is `gpu(0)` unless a `with ctx:` block says
otherwise.  Resolving a gpu context on a machine without CUDA raises an
`MXNetError` — the port never carries on quietly on the CPU; a caller who
wants the CPU passes ``ctx=cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    """Device context (reference `python/mxnet/context.py:Context`)."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            try:
                self.device_typeid = Context.devstr2type[device_type]
            except KeyError:
                raise MXNetError(
                    f"unknown device type {device_type!r}; the port knows "
                    f"{sorted(Context.devstr2type)}") from None
            self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The `torch.device` backing this context; raises for a gpu
        context when no CUDA device is present."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.device_id >= n:
            raise MXNetError(
                f"{self}: no such CUDA device ({n} present); pass "
                "ctx=mx.cpu() to run on the CPU")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.stack.pop()


def cpu(device_id=0):
    """Host-memory context (reference `mx.cpu()`)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device context (reference `mx.gpu()`)."""
    return Context("gpu", device_id)


def num_gpus():
    """Number of CUDA devices (reference `mx.context.num_gpus`)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The default context: the innermost `with ctx:` block, else gpu(0)."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)
