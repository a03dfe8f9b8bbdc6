"""Subgraph backend TPU_PALLAS: fused FullyConnected(+bias)+ReLU.

PyTorch port of `incubator_mxnet_tpu/subgraph/fused_ops.py`.  The op and
backend keep their names (`_sg_pallas_fc_relu`, ``TPU_PALLAS``) because
partitioned symbol JSON and ``MXNET_SUBGRAPH_BACKEND`` values carry them.

Kernel K1 — `fc_relu(x, w, b)` = relu(x @ w.T + b) — replaces the Pallas
kernel `_fc_relu_pallas` with the hand-written CUDA kernel in
``csrc/fc_relu.cu`` (see the note there for what bounds it on the card
and what its design does about that).  On a CUDA tensor the wrapper
launches that kernel or raises; only a tensor on the CPU goes to the
plain version `fc_relu_ref`.  `FCRelu` is the autograd Function: its
backward is plain torch, mirroring the jnp backward of the JAX package's
custom VJP (which is not a Pallas kernel either).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..ops import registry as _reg
from .subgraph_property import SubgraphProperty, register_subgraph_property
from .partition import external_inputs

__all__ = ["fc_relu", "fc_relu_ref", "launch_plan", "FCRelu",
           "PallasFCReluProperty"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fc_relu_ref(x, w, b):
    """The plain PyTorch version of K1 (fp32 accumulation, output in x's
    dtype)."""
    return torch.relu(x.float() @ w.float().T + b.float()).to(x.dtype)


def _lib():
    from ..kernels import _build
    lib = _build.load("fc_relu")
    if lib.mx_fc_relu.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.mx_fc_relu_plan.argtypes = [p, p, i, i, i, i, i,
                                        ctypes.POINTER(ll)]
        lib.mx_fc_relu_plan.restype = i
        lib.mx_fc_relu.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
        lib.mx_fc_relu.restype = i
        lib.mx_cuda_error_string.argtypes = [i]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_plan(x, w):
    """The kernel's launch plan for x (M, K) and w (N, K) on their CUDA
    device, as the kernel library computes it: a dict of rows per block,
    K splits, K elements per split, elements per lane load, fp32
    workspace elements, and the SM count it was planned for; None when
    the shape is outside the kernel's range."""
    lib = _lib()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = (ctypes.c_longlong * 5)()
    if lib.mx_fc_relu_plan(x.data_ptr(), w.data_ptr(), x.shape[0],
                           w.shape[0], x.shape[1], _DTYPE_CODE[x.dtype],
                           sms, plan):
        return None
    return dict(zip(("rows", "splits", "k_chunk", "vec", "workspace"), plan),
                sm_count=sms)


def _check(x, w, b):
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise MXNetError(f"fc_relu: expects x (M, K), w (N, K), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]:
        raise MXNetError(f"fc_relu: shape mismatch x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype):
        raise MXNetError(f"fc_relu: x, w, b must share a dtype; got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise MXNetError(f"fc_relu: x, w, b must share a device; got "
                         f"{x.device}, {w.device}, {b.device}")


def fc_relu(x, w, b):
    """K1: relu(x @ w.T + b).  CUDA tensors launch the kernel (counted in
    ``fc_relu.launches``); CPU tensors take `fc_relu_ref`."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return fc_relu_ref(x, w, b)
    if x.device.type != "cuda":
        raise MXNetError(f"fc_relu: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError(f"fc_relu: kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise MXNetError("fc_relu: x, w and b must be contiguous")
    m, k = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = launch_plan(x, w)
    if plan is None:
        raise MXNetError(f"fc_relu: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         "are outside the kernel's range")
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=x.device) if plan["workspace"] else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mx_fc_relu(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), plan["workspace"],
            m, n, k, _DTYPE_CODE[x.dtype], plan["sm_count"],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise MXNetError("fc_relu: kernel launch failed: "
                         + lib.mx_cuda_error_string(err).decode())
    fc_relu.launches += 1
    return out


fc_relu.launches = 0


class FCRelu(torch.autograd.Function):
    """K1 with the JAX package's gradient: g masked by y > 0, then
    (g @ w, g.T @ x, sum of g over rows)."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = fc_relu(x, w, b)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros_like(g))
        return g @ w, g.T @ x, g.sum(dim=0)


def _compute(params, x, w, b):
    if params["flatten"] and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if x.is_meta:                     # shape inference: no data, no kernel
        return fc_relu_ref(x, w, b)
    return FCRelu.apply(x.contiguous(), w, b)


_OP = _reg.OpDef(
    "_sg_pallas_fc_relu", _compute, nin=3,
    params={"num_hidden": _reg.REQUIRED, "flatten": True},
    input_names=["data", "weight", "bias"],
    doc="Fused FC+ReLU kernel K1 (subgraph backend TPU_PALLAS)")
_reg.register_opdef(_OP)


class PallasFCReluProperty(SubgraphProperty):
    """Matches Activation(relu)(FullyConnected(data, w, b)) chains."""

    name = "TPU_PALLAS"

    def match_chain(self, node, get_input):
        if node.is_variable or node.op.name != "Activation":
            return None
        if node.attrs.get("act_type") != "relu":
            return None
        prod = get_input(node)
        if prod is None or prod.is_variable:
            return None
        if prod.op.name != "FullyConnected":
            return None
        if prod.attrs.get("no_bias"):
            return None                      # kernel variant expects bias
        if not prod.attrs.get("flatten", True):
            # flatten=False admits N-D inputs the 2-D kernel can't take
            return None
        return [prod, node]

    def create_fused_op(self, nodes):
        fc = nodes[0]
        params = {"num_hidden": fc.attrs["num_hidden"],
                  "flatten": fc.attrs.get("flatten", True)}
        return _OP, params, external_inputs(nodes)


register_subgraph_property(PallasFCReluProperty())
