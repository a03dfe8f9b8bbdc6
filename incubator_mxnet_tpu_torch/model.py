"""Training glue and the checkpoint pair.

PyTorch port of part of `incubator_mxnet_tpu/model.py`: `BatchEndParam`,
`_create_kvstore` (what `Module` needs on one device), and
`save_checkpoint` / `load_checkpoint` (reference `model.py:383`, `:413`)
for ``prefix-symbol.json`` +
``prefix-%04d.params``.  Both files are committed through a temp file and
``os.replace``, so a crash never leaves a torn checkpoint behind.  The
port has no kvstore yet: on one device ``"local"`` needs none, and a
distributed store raises.
"""
from __future__ import annotations

import os
from collections import namedtuple

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) (reference `model.py _create_kvstore`):
    None and False for one device and a non-distributed store name."""
    if kvstore is None:
        return None, False
    if not isinstance(kvstore, str):
        raise MXNetError("kvstore: the port has no KVStore yet; pass a "
                         "store name or None")
    if "dist" in kvstore:
        raise MXNetError(f"kvstore {kvstore!r}: distributed training is not "
                         "ported yet")
    if num_device != 1:
        raise MXNetError(f"kvstore {kvstore!r}: the port trains on one "
                         f"device, got {num_device}")
    return None, False


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
