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
`FeedForward`, the legacy training API (reference `model.py:451`), is an
adapter over `module.Module`: it moves no arithmetic of its own.
"""
from __future__ import annotations

import os
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

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


class FeedForward:
    """The legacy training API (reference `model.py:451 FeedForward`,
    JAX `model.py:154`) for scripts that predate Module: `fit`,
    `predict`, `score`, `save`, `load` and `create` over one
    `module.Module`.  ``ctx`` defaults to `current_context()`, the card
    (the JAX class defaults to the CPU); ``kwargs`` are the optimizer's
    parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        from .context import current_context
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if not isinstance(self.ctx, (list, tuple)):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _label_names(self):
        # the classic convention: label arguments end in "_label"
        return [n for n in self.symbol.list_arguments()
                if n.endswith("_label")]

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        labels = self._label_names()
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle,
                           label_name=labels[0] if labels
                           else "softmax_label")

    def _build_module(self, data_iter):
        from .module import Module
        self._module = Module(
            self.symbol,
            data_names=tuple(d.name for d in data_iter.provide_data),
            label_names=tuple(self._label_names()), context=self.ctx)
        return self._module

    def _bound_module(self, data, with_labels):
        """The fitted module, or one bound for inference over the held
        parameters (a loss head's label is missing from them: allowed)."""
        if self._module is None or not self._module.binded:
            mod = self._build_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label if with_labels
                     else None, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=True)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train on `X` (a DataIter, or arrays with labels `y`, shuffled
        into batches of ``numpy_batch_size``) through `Module.fit`."""
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._build_module(train)
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1, monitor=monitor,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output over `X` as one numpy array, pad rows dropped
        (a ragged final batch is padded to the bound batch and sliced
        back, `BaseModule.iter_predict`)."""
        import numpy as _np
        data = self._as_iter(X)
        mod = self._bound_module(data, with_labels=False)
        outs = [o[0].asnumpy() for o, _, _ in
                mod.iter_predict(data, num_batch=num_batch, reset=reset)]
        return _np.concatenate(outs, axis=0)

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """The value of `eval_metric` over `X`."""
        from . import metric as metric_mod
        data = self._as_iter(X)
        mod = self._bound_module(data, with_labels=True)
        res = mod.score(data, metric_mod.create(eval_metric),
                        num_batch=num_batch)
        return dict(res).popitem()[1]

    def save(self, prefix, epoch=None):
        """The checkpoint pair of the held symbol and parameters."""
        epoch = epoch if epoch is not None else (self.num_epoch or 0)
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward over a saved checkpoint pair."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, **kwargs):
        """Construct and fit in one call (reference `model.py create`)."""
        fit_kwargs = {k: kwargs.pop(k) for k in
                      ("eval_data", "eval_metric", "epoch_end_callback",
                       "batch_end_callback", "kvstore", "logger")
                      if k in kwargs}
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        model.fit(X, y, **fit_kwargs)
        return model
