"""Training glue and the checkpoint pair.

PyTorch port of part of `incubator_mxnet_tpu/model.py`: `BatchEndParam`;
the kvstore glue `Module` runs, with the JAX rules (`model.py:17-39`):
`_create_kvstore` (no store for one device and a non-dist name; else the
named store, with the update on it unless a ``local`` store holds a
parameter of more than 16M elements), `_initialize_kvstore`,
`_update_params_on_kvstore` (push the gradients, pull the updated
weights) and `_update_params` (push and pull the summed gradients, then
update each device's copy); and `save_checkpoint` / `load_checkpoint`
(reference `model.py:383`, `:413`) for ``prefix-symbol.json`` +
``prefix-%04d.params``.  Both files are committed through a temp file and
``os.replace``, so a crash never leaves a torn checkpoint behind.
"""
from __future__ import annotations

import os
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """-> (kvstore or None, update_on_kvstore) (reference `model.py:67-114
    _create_kvstore`)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(arr.size) for arr in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init every parameter's key with its value; with the update on the
    store, pull it back into every device's copy."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push the gradients and pull the updated weights (reference
    `model.py:145`), every key in one push and one pull."""
    live = [i for i, g in enumerate(grad_arrays) if g[0] is not None]
    if live:
        names = [param_names[i] for i in live]
        kvstore.push(names, [grad_arrays[i] for i in live])
        kvstore.pull(names, [param_arrays[i] for i in live])


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum the gradients through the store (when there is one) into every
    device's gradient, then update each device's copy under the index
    ``i * num_device + k`` (reference `model.py _update_params`): one
    `Updater.update_multi` over every (index, gradient, weight), device
    by device."""
    live = [i for i, g in enumerate(grad_arrays) if g[0] is not None]
    if kvstore is not None and live:
        names = [param_names[i] for i in live]
        kvstore.push(names, [grad_arrays[i] for i in live])
        kvstore.pull(names, [grad_arrays[i] for i in live])
    rows = [(i * num_device + k, grad_arrays[i][k], param_arrays[i][k])
            for k in range(num_device) for i in live]
    if rows:
        updater.update_multi(*(list(c) for c in zip(*rows)))


def _atomic(path, write):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` with the
    reference's ``arg:``/``aux:`` name prefixes."""
    if symbol is not None:
        _atomic(f"{prefix}-symbol.json", symbol.save)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _atomic("%s-%04d.params" % (prefix, epoch),
            lambda tmp: nd.save(tmp, save_dict))


def load_checkpoint(prefix, epoch):
    """-> (symbol, arg_params, aux_params); the arrays are on the CPU."""
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
