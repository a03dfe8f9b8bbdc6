"""The collective verbs of a mesh of ranks, on the card's tensors.

Two ranks that share one card cannot form an NCCL group, so the port's
mesh runs over gloo there (`dist.collective._pick_backend`).  Probed on
the card (H100, torch 2.11, two gloo ranks sharing it): all-reduce,
broadcast, all-gather (list and ``_into_tensor``), reduce-scatter (list
and tensor), all-to-all, scatter and gather give exact results on CUDA
tensors, while gloo's point-to-point verbs (``send``/``recv``,
``batch_isend_irecv``) write from the card's pointers as if they were
host memory and kill the rank.  So `send_recv` stages its tensors
through pinned host memory on a gloo group; every other verb here runs
the group's own verb on the tensor where it lies.

DTensor's redistributions call torch's functional collectives
(``_c10d_functional``).  Probed on the card the same way, all-reduce,
reduce-scatter, all-to-all and broadcast are exact through them, but
the functional all-gather (``all_gather_into_tensor``) kills both ranks
with SIGSEGV, where ``dist.all_gather_into_tensor`` is exact.  So
`install` registers `all_gather` as the CUDA kernel of the functional
all-gathers, complete when it returns; every other functional verb is
torch's own.  The verbs of `parallel.collectives` call the functions
here directly.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

__all__ = ["install", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "all_to_all", "send_recv",
           "all_reduce_sum",
           "staged_count"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT,
        "avg": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM}
_lib = None
_lock = threading.Lock()
# point-to-point exchanges staged through the host (chip_smoke reads it)
staged_count = {"send_recv": 0}


def _group(group):
    if group is None or isinstance(group, dist.ProcessGroup):
        return group
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group)


def _staged(pg, t):
    """Whether a point-to-point exchange of `t` goes through the host on
    `pg`: a card's tensor on a group whose backend is gloo."""
    return t.is_cuda and dist.get_backend(pg) == "gloo"


def _host(t):
    """A pinned host copy of `t` (contiguous)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _mean(out, op, n):
    if op in ("avg", "mean"):
        return out / n if out.is_floating_point() else out // n
    return out


def all_reduce(t, op="sum", group=None):
    """`t` reduced over `group` (sum, avg/mean, max, min, product): a new
    tensor on `t`'s device."""
    pg = _group(group)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, _OPS[op], group=pg)
    return _mean(out, op, dist.get_world_size(pg))


class _SumOver(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the cotangents (the
    transpose of JAX's psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def all_reduce_sum(x, group=None):
    """`x` summed over `group`, differentiably: the gradient of each
    rank's `x` is the sum of every rank's gradient of the result."""
    return _SumOver.apply(x, group)


def all_gather(t, group=None):
    """The group's `t` concatenated along dim 0 in rank order."""
    pg = _group(group)
    src = t.detach().contiguous()
    n = dist.get_world_size(pg)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=pg)
    return out


def reduce_scatter(t, op="sum", group=None):
    """`t` reduced over the group, rank r keeping the r-th of its equal
    dim-0 chunks."""
    pg = _group(group)
    src = t.detach().contiguous()
    n = dist.get_world_size(pg)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, _OPS[op], group=pg)
    return _mean(out, op, n)


def broadcast(t, src, group=None):
    """Group rank `src`'s `t` on every rank (`src` counts in the
    group)."""
    pg = _group(group)
    root = dist.get_global_rank(pg, src) if pg is not None else src
    out = t.detach().clone().contiguous()
    dist.broadcast(out, root, group=pg)
    return out


def all_to_all(t, out_splits, in_splits, group=None):
    """`all_to_all_single` of `t` along dim 0."""
    pg = _group(group)
    src = t.detach().contiguous()
    rows = sum(out_splits) if out_splits else src.shape[0]
    out = src.new_empty((rows,) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, out_splits or None, in_splits or None,
                           group=pg)
    return out


def send_recv(t, dst, src, group=None):
    """Send `t` to group rank `dst` while receiving the same shape from
    group rank `src` (one ring step); the received tensor.  Staged
    through pinned host memory on a gloo group."""
    pg = _group(group)
    gdst = dist.get_global_rank(pg, dst) if pg is not None else dst
    gsrc = dist.get_global_rank(pg, src) if pg is not None else src
    staged = _staged(pg, t)
    if staged:
        with _lock:
            staged_count["send_recv"] += 1
    send = _host(t) if staged else t.detach().contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, gdst, group=pg),
           dist.P2POp(dist.irecv, recv, gsrc, group=pg)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv.to(t.device) if staged else recv


# -- torch's functional all-gathers on the card ------------------------------

def _f_all_gather(inp, group_size, group_name):
    return all_gather(inp, group_name)


def _f_all_gather_out(inp, group_size, group_name, *, out):
    out.copy_(all_gather(inp, group_name))
    return out


def _f_all_gather_many(inputs, group_size, group_name):
    return [all_gather(t, group_name) for t in inputs]


_KERNELS = {
    "all_gather_into_tensor": _f_all_gather,
    "all_gather_into_tensor_out": _f_all_gather_out,
    "all_gather_into_tensor_coalesced": _f_all_gather_many,
}


def install(dispatch_key="CUDA"):
    """Make `all_gather` the `dispatch_key` kernel of torch's functional
    all-gathers for this process (idempotent).  The results are complete
    when returned, so torch's ``wait_tensor`` finds nothing to wait on."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        import warnings
        lib = torch.library.Library("_c10d_functional", "IMPL")
        with warnings.catch_warnings():
            # replacing the composite kernel for one key warns by design
            warnings.simplefilter("ignore")
            for name, fn in _KERNELS.items():
                if hasattr(torch.ops._c10d_functional, name):
                    lib.impl(name, fn, dispatch_key)
        _lib = lib
