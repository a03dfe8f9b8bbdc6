"""ZeRO-style sharded optimizer state over the data axis.

PyTorch port of `incubator_mxnet_tpu/parallel/zero.py`, the mapping of
the reference's *sharded parameter server*
(`src/kvstore/kvstore_dist_server.h:155`: each server owns a key range
and updates it): every dp rank owns 1/N of every parameter, the push is
a mean reduce-scatter of the flattened gradient (padded to N equal
shards, the JAX `_shard_size`), the update runs on the owned shard with
1/N-sized optimizer state, and the pull is an all-gather.  This is ZeRO
stage 1+2 (sharded states + sharded gradient reduction); parameters
stay replicated between steps.  A state leaf is a DTensor sharded on
dim 0 over the axis: its global shape is the JAX package's, each rank
holds its 1/N.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import verbs as _verbs
from .data_parallel import local_batch, value_and_grad

__all__ = ["zero_init_state", "zero_update", "zero_train_step",
           "adam_shard_update", "sgd_shard_update"]


def _shard_size(size, n):
    return -(-size // n)  # ceil: shards are padded to equal size


def zero_init_state(params, n_shards, state_fn):
    """Global optimizer-state tensors for a ZeRO run: every leaf's state
    is 1-D of global size n*ceil(size/n); `zero_train_step` keeps each
    rank's 1/N slice.  state_fn(global_shape, dtype) -> state pytree for
    one leaf, e.g. lambda s, d: (torch.zeros(s, dtype=d), ...) for (m,
    v)."""
    def per_leaf(p):
        k = _shard_size(p.numel(), n_shards)
        return state_fn((n_shards * k,), p.dtype)
    return pytree.tree_map(per_leaf, params)


def _to_local(s, mesh, axis_name):
    """A state leaf as this rank's slice: a DTensor's local tensor, or
    the rank's chunk of a global tensor."""
    if hasattr(s, "to_local"):
        return s.to_local()
    n, i = mesh.shape[axis_name], mesh.axis_index(axis_name)
    return s.chunk(n, 0)[i].clone()


def _as_sharded(s, mesh, axis_name):
    """A local state slice as a DTensor sharded on dim 0 over the axis
    (replicated over the mesh's other axes)."""
    from torch.distributed.tensor import DTensor
    from .mesh import P, placements_of
    return DTensor.from_local(s, mesh.device_mesh,
                              placements_of(mesh, P(axis_name)),
                              run_check=False)


def zero_update(params, grads, state, update_fn, mesh, axis_name="dp"):
    """One sharded optimizer step.

    update_fn(p_shard, g_shard, s) -> (new_p_shard, new_s); all 1-D
    shards.  grads are LOCAL per-rank gradients: the reduce-scatter here
    replaces the dp all-reduce, so callers must NOT average them first.
    `state` leaves are this rank's slices; so are the returned ones.
    """
    group = mesh.group(axis_name)
    n, idx = mesh.shape[axis_name], mesh.axis_index(axis_name)

    def per_leaf(p, g, s):
        size = p.numel()
        k = _shard_size(size, n)
        pad = k * n - size
        gflat = torch.nn.functional.pad(g.reshape(-1), (0, pad))
        gshard = _verbs.reduce_scatter(gflat, "mean", group)
        pshard = torch.nn.functional.pad(p.reshape(-1), (0, pad))[
            idx * k:(idx + 1) * k]
        new_pshard, new_s = update_fn(pshard, gshard, s)
        full = _verbs.all_gather(new_pshard, group)
        return full[:size].reshape(p.shape), new_s

    # params: a dict, list or tuple of tensors; its states entry by entry
    if isinstance(params, dict):
        new = {k: per_leaf(params[k], grads[k], state[k]) for k in params}
        return ({k: a for k, (a, _) in new.items()},
                {k: b for k, (_, b) in new.items()})
    new = [per_leaf(p, g, s) for p, g, s in zip(params, grads, state)]
    return type(params)(a for a, _ in new), type(params)(b for _, b in new)


def zero_train_step(loss_fn, update_fn, mesh, axis_name="dp", donate=True):
    """DP train step with ZeRO-sharded optimizer state.

    Like `data_parallel.data_parallel_step` but the gradient exchange is
    a reduce-scatter and the optimizer state lives sharded: per-rank
    state memory is 1/N of the replicated version.

    Returns step(params, opt_state, batch) -> (params, opt_state, loss);
    params and batch as in the dp step; opt_state as `zero_init_state`
    made it, or as a previous step returned it: each leaf a DTensor
    sharded on dim 0 over `axis_name`.
    """
    grad_fn = value_and_grad(loss_fn)
    group = mesh.group(axis_name)

    def step(params, opt_state, batch):
        with mesh:
            grads, loss = grad_fn(params, local_batch(batch, mesh,
                                                      axis_name))
        loss = _verbs.all_reduce(loss.detach(), "mean", group)
        local = pytree.tree_map(lambda s: _to_local(s, mesh, axis_name),
                                opt_state)
        new_params, new_state = zero_update(params, grads, local,
                                            update_fn, mesh, axis_name)
        new_state = pytree.tree_map(
            lambda s: _as_sharded(s, mesh, axis_name), new_state)
        return new_params, new_state, loss

    return step


def sgd_shard_update(momentum=0.9, lr=0.01, wd=0.0):
    def update(p, g, s):
        m = s[0] if isinstance(s, (tuple, list)) else s
        m2 = momentum * m - lr * (g + wd * p)
        return p + m2, (m2,) if isinstance(s, (tuple, list)) else m2
    return update


def adam_shard_update(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8):
    """Adam on a parameter shard; state s = (m, v, t), t a (1,) step
    count."""
    def update(p, g, s):
        m, v, t = s
        t = t + 1
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        mhat = m / (1 - beta1 ** t[0])
        vhat = v / (1 - beta2 ** t[0])
        return p - lr * mhat / (torch.sqrt(vhat) + eps), (m, v, t)
    return update
