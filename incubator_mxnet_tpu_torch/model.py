"""Checkpoint pairs: ``prefix-symbol.json`` + ``prefix-%04d.params``.

PyTorch port of `save_checkpoint` / `load_checkpoint` in
`incubator_mxnet_tpu/model.py` (reference `model.py:383`, `:413`).  Both
files are committed through a temp file and ``os.replace``, so a crash
never leaves a torn checkpoint behind.
"""
from __future__ import annotations

import os

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint"]


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
