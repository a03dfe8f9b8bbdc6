"""Data-parallel SPMD train step.

PyTorch port of `incubator_mxnet_tpu/parallel/data_parallel.py`, the
replacement for the reference's data-parallel machinery
(`DataParallelExecutorGroup` batch slicing + kvstore push/pull reduce,
`executor_group.py:281-310` + `comm.h`).  Every rank of a mesh of ranks
calls the step with the same replicated parameters and the whole global
batch; the step takes the rank's dp slice of the batch, the loss and
its gradients (`value_and_grad`, by autograd), averages gradients and loss
over the dp group, and applies the update, so every rank leaves with
the same parameters.  The mesh is bound (``with mesh:``) while the loss
runs, so a ``sync`` BatchNorm inside it reduces over the dp group.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import verbs as _verbs

__all__ = ["data_parallel_step", "replicate", "unreplicate",
           "sgd_tree_update", "local_batch", "value_and_grad"]


def replicate(tree, mesh):
    """Every tensor of `tree` on the mesh's device, holding rank 0's
    values on every rank."""
    dm = mesh.device_mesh
    dev = torch.device(dm.device_type, torch.cuda.current_device()) \
        if dm.device_type == "cuda" else torch.device("cpu")
    return pytree.tree_map(
        lambda x: _verbs.broadcast(torch.as_tensor(x).to(dev), 0), tree)


def unreplicate(tree):
    """Plain tensors of `tree` (a DTensor's whole tensor)."""
    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x
    return pytree.tree_map(whole, tree)


def local_batch(batch, mesh, axis_name):
    """This rank's slice along dim 0 of every tensor of the global
    `batch`: equal chunks by its coordinate on `axis_name`."""
    n, i = mesh.shape[axis_name], mesh.axis_index(axis_name)
    return pytree.tree_map(lambda x: x.chunk(n, 0)[i], batch)


def value_and_grad(loss_fn):
    """``f(params, batch) -> (grads, loss)`` of `loss_fn`: the gradients
    with respect to every tensor of the `params` pytree (autograd from
    detached leaves), in its structure, and the loss, detached."""
    def f(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
            grads = torch.autograd.grad(loss, live)
        return pytree.tree_unflatten(list(grads), spec), loss.detach()
    return f


def _mean_over(tree, group):
    """Each tensor of `tree` averaged over `group`: one all-reduce a
    dtype (flatten, concatenate, reduce, split)."""
    leaves, spec = pytree.tree_flatten(tree)
    out = list(leaves)
    by_dtype = {}
    for k, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(k)
    for idxs in by_dtype.values():
        flat = torch.cat([leaves[k].reshape(-1) for k in idxs])
        flat = _verbs.all_reduce(flat, "mean", group)
        for k, piece in zip(idxs, flat.split([leaves[k].numel()
                                              for k in idxs])):
            out[k] = piece.view(leaves[k].shape)
    return pytree.tree_unflatten(out, spec)


def data_parallel_step(loss_fn, optimizer_update, mesh, axis_name="dp",
                       donate=True):
    """Build a DP train step.

    loss_fn(params, batch) -> scalar loss (per-shard mean)
    optimizer_update(params, grads, opt_state, lr) -> (new_params, new_opt_state)

    Returns step(params, opt_state, batch, lr) -> (params, opt_state, loss):
    params/opt_state replicated; batch the global batch, sliced on dim 0
    over `axis_name`.  ``donate`` is accepted (nothing is compiled).
    """
    grad_fn = value_and_grad(loss_fn)
    group = mesh.group(axis_name)

    def step(params, opt_state, batch, lr):
        with mesh:
            grads, loss = grad_fn(params, local_batch(batch, mesh,
                                                      axis_name))
        grads = _mean_over(grads, group)
        loss = _verbs.all_reduce(loss.detach(), "mean", group)
        new_params, new_opt = optimizer_update(params, grads, opt_state, lr)
        return new_params, new_opt, loss

    return step


def sgd_tree_update(momentum=0.9, wd=0.0):
    """Simple SGD for pytrees (used by the dp step builder)."""
    def update(params, grads, opt_state, lr):
        def upd(p, g, m):
            m2 = momentum * m - lr * (g + wd * p)
            return p + m2, m2
        flat_p, spec = pytree.tree_flatten(params)
        flat_g = pytree.tree_leaves(grads)
        flat_m = pytree.tree_leaves(opt_state)
        new = [upd(p, g, m) for p, g, m in zip(flat_p, flat_g, flat_m)]
        return (pytree.tree_unflatten([a for a, _ in new], spec),
                pytree.tree_unflatten([b for _, b in new], spec))
    return update
