"""Subgraph backend TPU_PALLAS: fused FullyConnected(+bias)+ReLU.

PyTorch port of `incubator_mxnet_tpu/subgraph/fused_ops.py`.  The op and
backend keep their names (`_sg_pallas_fc_relu`, ``TPU_PALLAS``) because
partitioned symbol JSON and ``MXNET_SUBGRAPH_BACKEND`` values carry them.

Kernel K1 — `fc_relu(x, w, b)` = relu(x @ w.T + b) — replaces the Pallas
kernel `_fc_relu_pallas` with the hand-written CUDA kernels in
``csrc/fc_relu.cu``: a tensor-core route (``wgmma`` fed by a TMA ring,
3xTF32 in float32) and a CUDA-core route, chosen by the library's launch
plan from the shape and alignment (see the note there for what bounds
them on the card and what their design does about that).  On a CUDA
tensor the wrapper launches a kernel or raises; only a tensor on the CPU
goes to the plain version `fc_relu_ref`.  `FCRelu` is the autograd
Function: its backward is plain torch, mirroring the jnp backward of the
JAX package's custom VJP (which is not a Pallas kernel either).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from ..base import MXNetError
from ..ops import registry as _reg
from .subgraph_property import SubgraphProperty, register_subgraph_property
from .partition import external_inputs

__all__ = ["fc_relu", "fc_relu_ref", "launch_plan", "FCRelu", "ROUTES",
           "PallasFCReluProperty"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel library's routes (mx_fc_relu_plan's route codes)
ROUTES = ("cuda_core", "tensor_core")


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
        lib.mx_fc_relu_plan.argtypes = [p, p, i, i, i, i, i, i,
                                        ctypes.POINTER(ll)]
        lib.mx_fc_relu_plan.restype = i
        lib.mx_fc_relu.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
        lib.mx_fc_relu.restype = i
        lib.mx_cuda_error_string.argtypes = [i]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _route_code(route):
    if route is None:
        return -1
    if route not in ROUTES:
        raise MXNetError(f"fc_relu: route {route!r} is not one of {ROUTES}")
    return ROUTES.index(route)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(x, w, route=None):
    """The kernels' launch plan for x (M, K) and w (N, K) on their CUDA
    device, as the kernel library computes it: a dict of the ``route``
    (one of `ROUTES`; None lets the library choose, else the plan is for
    that route), rows of x per block, K splits, K elements per split, K
    elements per step (a warp step or a ring stage), elements per lane
    load (cuda_core; 0 for tensor_core), fp32 workspace elements, and the
    SM count it was planned for; None when the shape is outside the
    kernels' range (or the route's)."""
    lib = _lib()
    sms = _sm_count(x.device)
    plan = (ctypes.c_longlong * 7)()
    if lib.mx_fc_relu_plan(x.data_ptr(), w.data_ptr(), x.shape[0],
                           w.shape[0], x.shape[1], _DTYPE_CODE[x.dtype],
                           sms, _route_code(route), plan):
        return None
    out = dict(zip(("route", "rows", "splits", "k_chunk", "step", "vec",
                    "workspace"), plan), sm_count=sms)
    out["route"] = ROUTES[out["route"]]
    return out


def _check(x, w, b):
    """Validate the operands; returns the dtype they promote to
    (`torch.promote_types`), one the kernels take."""
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise MXNetError(f"fc_relu: expects x (M, K), w (N, K), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]:
        raise MXNetError(f"fc_relu: shape mismatch x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype), b.dtype)
    if dt not in _DTYPE_CODE:
        raise MXNetError(f"fc_relu: kernel takes float32, bfloat16 or "
                         f"float16; the operand dtypes {x.dtype}, {w.dtype}, "
                         f"{b.dtype} promote to {dt}")
    if not (x.device == w.device == b.device):
        raise MXNetError(f"fc_relu: x, w, b must share a device; got "
                         f"{x.device}, {w.device}, {b.device}")
    return dt


def fc_relu(x, w, b, route=None):
    """K1: relu(x @ w.T + b) in x's dtype.  CUDA tensors launch the
    kernels of the library's plan, or of ``route`` (one of `ROUTES`) when
    given, and count one in ``fc_relu.launches`` per call (and one under
    the launching thread's name in ``fc_relu.by_thread``, so a caller
    running training and serving at once can tell them apart); operands of
    mixed dtypes are cast to the dtype they promote to, whose kernel runs,
    and the result is cast to x's dtype, as the JAX kernel's fp32
    accumulation of promoted operands gives it; non-contiguous operands
    are copied to contiguous ones first.  CPU tensors take
    `fc_relu_ref`."""
    dt = _check(x, w, b)
    if x.device.type == "cpu":
        return fc_relu_ref(x, w, b)
    if x.device.type != "cuda":
        raise MXNetError(f"fc_relu: no kernel for device {x.device}")
    return _launch(x.to(dt), w.to(dt), b.to(dt), route).to(x.dtype)


def _launch(x, w, b, route):
    """K1 on CUDA operands of one dtype."""
    x, w, b = (t.contiguous() for t in (x, w, b))
    m, k = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = launch_plan(x, w, route)
    if plan is None:
        raise MXNetError(f"fc_relu: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"are outside the kernels' range (route {route})")
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=x.device) if plan["workspace"] else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mx_fc_relu(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), plan["workspace"],
            m, n, k, _DTYPE_CODE[x.dtype], plan["sm_count"],
            _route_code(plan["route"]),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise MXNetError("fc_relu: kernel launch failed: "
                         + lib.mx_cuda_error_string(err).decode())
    with _launches_lock:   # replicas launch K1 from several threads
        fc_relu.launches += 1
        fc_relu.by_thread[threading.current_thread().name] += 1
    return out


fc_relu.launches = 0
fc_relu.by_thread = collections.Counter()
_launches_lock = threading.Lock()


class FCRelu(torch.autograd.Function):
    """K1 with the JAX package's gradient: g masked by y > 0, then
    (g @ w, g.T @ x, sum of g over rows)."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = fc_relu(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        """In the operands' promoted dtype; each gradient in its own
        input's dtype."""
        x, w, y = ctx.saved_tensors
        dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                                 ctx.b_dtype)
        g = torch.where(y > 0, g, torch.zeros_like(g)).to(dt)
        return ((g @ w.to(dt)).to(x.dtype), (g.T @ x.to(dt)).to(w.dtype),
                g.sum(dim=0).to(ctx.b_dtype))


def _compute(params, x, w, b):
    if params["flatten"] and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if x.is_meta:                     # shape inference: no data, no kernel
        return fc_relu_ref(x, w, b)
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        # a mesh of ranks (`parallel.shard_block`): K1 on each rank's
        # local shards, column-parallel or data-parallel
        from ..parallel.tensor_parallel import on_local_shards
        return on_local_shards(
            lambda xl, wl, bl: FCRelu.apply(xl.contiguous(), wl, bl),
            x, w, b)
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
