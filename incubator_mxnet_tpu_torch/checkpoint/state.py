"""Full training-state capture & restore.

PyTorch port of `incubator_mxnet_tpu/checkpoint/state.py`.  What a
resumable checkpoint holds beyond the weights: the optimizer's states
(momentum, Adam's moments) with the pickled optimizer itself, so
`num_update`, the per-index update counts and the learning-rate
schedule's position travel along; the data iterator's position; and
every random stream the port consumes (`random.py`'s host SeedSequence
counter, its torch Generator chain, numpy's global generator, which
`NDArrayIter` shuffles with, and Python's `random`, which
`BucketSentenceIter` shuffles its batch order with).  A
`BucketingModule`'s snapshot also lists the buckets bound so far and
holds each bucket's own arrays beside the shared ones.  Restoring all
of it makes a resumed run bit-for-bit identical to an uninterrupted one on the same device.

A Module's parameters are staged from the executor's arrays on the
device (`capture_module`), not from the host copies `get_params`
refreshes, and its optimizer states are staged the same way and pickled
by the background writer (`stage_updater_states`).  The optimizer blob
is the port's own (`optimizer.dumps_states`: a pickle with its arrays
out of band, which `Updater.set_states` reads as it reads
`Updater.get_states`' plain pickle), not the JAX package's: a declared
divergence.
"""
from __future__ import annotations

import pickle
import random as _pyrandom

import numpy as np

from ..base import MXNetError
from . import snapshot as _snapshot

OPTIMIZER_BLOB = "optimizer"
ITERATOR_BLOB = "iterator"
TRAINER_BLOB = "trainer"
BUCKETS_BLOB = "buckets"
NET_ARRAYS_PREFIX = "param:"


# -- RNG ---------------------------------------------------------------------
def capture_rng():
    """JSON-able snapshot of every random stream training consumes."""
    from .. import random as _random
    state = {}
    for name in ("host_seq", "device_seq"):
        seq = getattr(_random._state, name, None)
        if seq is not None:
            state[name] = [int(x) for x in seq]
    name, keys, pos, has_gauss, cached = np.random.get_state()
    state["numpy"] = [name, np.asarray(keys).tolist(), int(pos),
                      int(has_gauss), float(cached)]
    version, internal, gauss = _pyrandom.getstate()
    state["python"] = [version, list(internal), gauss]
    return state


def restore_rng(state):
    """Restore `capture_rng`'s streams (a JAX package manifest's threefry
    ``key`` has no counterpart here and is ignored)."""
    if not state:
        return
    from .. import random as _random
    for name in ("host_seq", "device_seq"):
        if name in state:
            setattr(_random._state, name, [int(x) for x in state[name]])
    if "numpy" in state:
        name, keys, pos, has_gauss, cached = state["numpy"]
        np.random.set_state((name, np.asarray(keys, dtype=np.uint32),
                             int(pos), int(has_gauss), float(cached)))
    if "python" in state:
        version, internal, gauss = state["python"]
        _pyrandom.setstate((version, tuple(internal), gauss))


# -- data iterators ----------------------------------------------------------
def capture_iterator(data_iter):
    """Pickled native iterator state (``DataIter.checkpoint_state``), or
    None when the iterator has nothing beyond its batch position — resume
    then falls back to ``seek(nbatch)`` (reset + skip)."""
    getter = getattr(data_iter, "checkpoint_state", None)
    if getter is None:
        return None
    state = getter()
    if not state:
        return None
    return pickle.dumps(state, protocol=4)


def restore_iterator(data_iter, blob, nbatch):
    """Native restore when the iterator supports it, reset+skip otherwise."""
    state = pickle.loads(blob) if blob else {}
    setter = getattr(data_iter, "set_checkpoint_state", None)
    if setter is not None:
        setter(state, nbatch=nbatch)
        return
    seek = getattr(data_iter, "seek", None)
    if seek is not None:
        seek(nbatch)
        return
    for _ in range(int(nbatch)):
        next(data_iter)


# -- optimizer ---------------------------------------------------------------
def stage_updater_states(updater):
    """Stage an `optimizer.Updater`'s states into host buffers now and
    return ``(build, staged)``: `build()`, called later by the background
    writer, waits for the copies and returns the blob, as parts, of the
    states and the optimizer at staging time (`optimizer.dumps_states`:
    the arrays' bytes written straight from the staged buffer, never
    copied into a pickle under the GIL)."""
    from ..ndarray.ndarray import NDArray
    from ..optimizer import dumps_states
    flat, ctxs = {}, {}
    for i, s in updater.states.items():
        for j, v in enumerate(s if isinstance(s, (tuple, list)) else (s,)):
            if isinstance(v, NDArray):
                flat[f"{i}/{j}"] = v
                ctxs[f"{i}/{j}"] = v.context
    staged = _snapshot.gather_to_pool(flat)
    opt_bytes = pickle.dumps(updater.optimizer, protocol=4)
    layout = {i: (type(s), len(s)) if isinstance(s, (tuple, list))
              else (None, 1) for i, s in updater.states.items()}

    def build():
        staged.wait()

        def one(key):
            if key not in staged.arrays:
                return None
            # a host copy that pickles under its source's context
            return NDArray(staged.arrays[key], ctx=ctxs[key])
        states = {}
        for i, (kind, n) in layout.items():
            vals = [one(f"{i}/{j}") for j in range(n)]
            states[i] = vals[0] if kind is None else kind(vals)
        return dumps_states((states, pickle.loads(opt_bytes)),
                            staged.payload)
    return build, staged


# -- Module ------------------------------------------------------------------
def capture_module(mod, data_iter=None):
    """(arrays, blobs, staged) for a bound, initialized Module: the
    executor's parameters and aux states under the ``arg:``/``aux:``
    prefixes, the optimizer's states as a staged blob callable (with the
    update on the kvstore, the store's blob from
    `get_optimizer_states_blob`), the iterator's native state when
    given.  `staged` lists the optimizer's staging (its buffers go back
    to the pool once the callable ran).  Modules call it through their
    `_checkpoint_capture`, which `BucketingModule` extends."""
    group = mod._exec_group
    arrays = {f"arg:{n}": blk[0] for n, blk in
              zip(group.param_names, group.param_arrays)}
    arrays.update({f"aux:{n}": blk[0] for n, blk in
                   zip(group.aux_names, group.aux_arrays)})
    blobs, staged = {}, []
    if mod.optimizer_initialized and mod._update_on_kvstore:
        blobs[OPTIMIZER_BLOB] = mod.get_optimizer_states_blob()
    elif mod.optimizer_initialized:
        build, st = stage_updater_states(mod._updater)
        blobs[OPTIMIZER_BLOB] = build
        staged.append(st)
    if data_iter is not None:
        it_blob = capture_iterator(data_iter)
        if it_blob is not None:
            blobs[ITERATOR_BLOB] = it_blob
    return arrays, blobs, staged


def split_params(arrays):
    """{'arg:...'/'aux:...': array} -> (arg_params, aux_params) of CPU
    NDArrays, the shape Module.init_params consumes."""
    from ..ndarray.ndarray import array
    from ..context import cpu
    arg_params, aux_params = {}, {}
    for key, value in arrays.items():
        kind, _, name = key.partition(":")
        dtype = value.dtype if isinstance(value, np.ndarray) else None
        if kind == "arg":
            arg_params[name] = array(value, ctx=cpu(), dtype=dtype)
        elif kind == "aux":
            aux_params[name] = array(value, ctx=cpu(), dtype=dtype)
        else:
            raise MXNetError(f"checkpoint array key {key!r} is neither "
                             "arg: nor aux:")
    return arg_params, aux_params


def restore_module_optimizer(mod, blob):
    if blob:
        mod.set_optimizer_states_blob(blob)


# -- Gluon -------------------------------------------------------------------
def capture_gluon_net(net):
    """{param: first-context value} for every parameter of a gluon block."""
    arrays = {}
    for name, param in net.collect_params().items():
        try:
            arrays[NET_ARRAYS_PREFIX + name] = param.list_data()[0]
        except Exception:
            continue  # deferred-init param with no value yet
    return arrays


def restore_gluon_net(net, arrays):
    from ..ndarray.ndarray import array
    params = net.collect_params()
    for key, value in arrays.items():
        if not key.startswith(NET_ARRAYS_PREFIX):
            continue
        name = key[len(NET_ARRAYS_PREFIX):]
        if name not in params:
            raise MXNetError(
                f"checkpoint has parameter {name!r} the net does not")
        ctx = params[name].list_ctx()[0]
        dtype = value.dtype if isinstance(value, np.ndarray) else None
        params[name].set_data(array(value, ctx=ctx, dtype=dtype))


def capture_trainer(trainer):
    return trainer.get_checkpoint_state() if trainer is not None else None


def restore_trainer(trainer, blob):
    if trainer is not None and blob:
        trainer.set_checkpoint_state(blob)
