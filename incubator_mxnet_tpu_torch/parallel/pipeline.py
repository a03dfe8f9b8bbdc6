"""Pipeline parallelism over the `pp` axis of a mesh of ranks.

PyTorch port of `incubator_mxnet_tpu/parallel/pipeline.py`, a
GPipe-style microbatch schedule: each pp rank applies its stage function
and passes activations to the next rank, with the JAX package's tick
schedule (``n_microbatches + n_stages - 1`` ticks; rank 0 injects
microbatch t at tick t; the last rank records microbatch t - (n_stages -
1); every rank's output goes to the next around the ring; the outputs
are summed from the last rank to every rank at the end).

The JAX package derives the backward schedule as XLA's transpose of a
`scan` of `ppermute`s.  Here autograd derives it, and the sends of the
backward mirror the forward ticks: the ring exchange is an autograd
Function whose backward sends the gradient of what a rank received back
to the rank it came from, and receives the gradient of what it sent.
Every rank feeds what it received into the next tick (rank 0 through a
`torch.where` that selects the injected microbatch, as the JAX code
does), so each rank's backward runs the exchanges of all ticks, in
reverse tick order, and the ranks meet.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import verbs as _verbs

__all__ = ["pipeline_step", "pipeline_train_step"]


class _RingShift(torch.autograd.Function):
    """y to the next rank of the ring, x from the previous; backward the
    reverse."""

    @staticmethod
    def forward(ctx, y, group, me, n):
        ctx.group, ctx.me, ctx.n = group, me, n
        return _verbs.send_recv(y, (me + 1) % n, (me - 1) % n, group)

    @staticmethod
    def backward(ctx, g):
        me, n = ctx.me, ctx.n
        return (_verbs.send_recv(g.contiguous(), (me - 1) % n,
                                 (me + 1) % n, ctx.group),
                None, None, None)


def _resolve(axis_name, mesh):
    from .collectives import _mesh
    m = _mesh(axis_name, mesh)
    return m.group(axis_name), m.axis_index(axis_name), m.shape[axis_name]


def pipeline_step(stage_fn, n_microbatches, axis_name="pp", mesh=None):
    """Build a pipelined forward over `axis_name` (of `mesh`, else of the
    mesh bound by ``with mesh:``).

    stage_fn(params, x) -> y applies THIS rank's stage.  Input
    microbatches are fed on rank 0; outputs emerge on the last rank and
    are summed to every rank at the end.  Returns fwd(params,
    microbatches) where microbatches has leading dim n_microbatches on
    every rank (only rank 0's values are used).
    """
    def fwd(params, microbatches):
        group, me, n_stages = _resolve(axis_name, mesh)
        total_ticks = n_microbatches + n_stages - 1
        zeros = torch.zeros_like(microbatches[0])
        first = torch.tensor(me == 0, device=microbatches.device)
        last = torch.tensor(me == n_stages - 1, device=microbatches.device)
        buf = zeros
        outputs = [zeros] * n_microbatches
        for t in range(total_ticks):
            inject = microbatches[t] if t < n_microbatches else zeros
            x = torch.where(first, inject, buf)
            y = stage_fn(params, x)
            out_t = t - (n_stages - 1)
            if out_t >= 0:
                outputs[out_t] = torch.where(last, y, zeros)
            buf = _RingShift.apply(y, group, me, n_stages)
        return _verbs.all_reduce_sum(torch.stack(outputs), group)

    return fwd


def pipeline_train_step(stage_fn, loss_fn, n_microbatches, optimizer_update,
                        axis_name="pp", remat=True, mesh=None):
    """GPipe training over `axis_name`: forward all microbatches through
    the stage pipeline, one backward, per-stage parameter update.
    ``remat=True`` recomputes each stage in the backward pass
    (`torch.utils.checkpoint`, GPipe's activation checkpointing).

    stage_fn(stage_params, x) -> y            this rank's stage
    loss_fn(outputs, targets) -> scalar       on the (summed) outputs
    optimizer_update(p, g) -> new_p           per-leaf update

    Returns step(stage_params, microbatches, targets) -> (new_params,
    loss), each rank passing its own stage's parameters.
    """
    if remat:
        from torch.utils.checkpoint import checkpoint

        def staged(p, x):
            return checkpoint(stage_fn, p, x, use_reentrant=False)
    else:
        staged = stage_fn
    fwd = pipeline_step(staged, n_microbatches, axis_name, mesh)

    def step(stage_params, microbatches, targets):
        _, _, n_stages = _resolve(axis_name, mesh)
        leaves, spec = pytree.tree_flatten(stage_params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(fwd(pytree.tree_unflatten(live, spec),
                               microbatches), targets)
            grads = torch.autograd.grad(loss, live)
        # every rank evaluates the same summed loss, and the backward of
        # the outputs' sum adds all ranks' (identical) cotangents:
        # normalise so grads match the non-pipelined composition
        new = [optimizer_update(p.detach(), g / n_stages)
               for p, g in zip(leaves, grads)]
        return pytree.tree_unflatten(new, spec), loss.detach()

    return step
