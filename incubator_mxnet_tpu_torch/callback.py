"""Training callbacks (reference `python/mxnet/callback.py`).

PyTorch port of `incubator_mxnet_tpu/callback.py`: `module_checkpoint`,
`do_checkpoint`, `elastic_checkpoint`, `log_train_metric`, `Speedometer`
and `ProgressBar`.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "elastic_checkpoint",
           "log_train_metric", "Speedometer", "ProgressBar"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving `mod` every `period` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing the checkpoint pair every `period`
    epochs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def elastic_checkpoint(manager, mod, train_data=None, period=1):
    """Batch-end callback taking an asynchronous full-state snapshot
    every `period` batches through a `checkpoint.CheckpointManager`: the
    wiring for loops that drive `fit_step` themselves (JAX
    `callback.py:30`).  It captures what `Module.fit(checkpoint_dir=)`
    captures (the module's `_checkpoint_capture`: the parameters and aux
    states on the device, the optimizer's states, the iterator's
    position when `train_data` is given), at step = the callback's own
    count and nbatch = the batch after this one."""
    period = int(max(1, period))
    counter = {"step": 0}

    def _callback(param):
        counter["step"] += 1
        if counter["step"] % period:
            return
        arrays, blobs, staged = mod._checkpoint_capture(train_data)
        manager.snapshot(arrays=arrays, blobs=blobs, step=counter["step"],
                         epoch=param.epoch, nbatch=param.nbatch + 1,
                         staged=staged)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every `period`
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback logging samples/s every `frequent` batches
    (reference `callback.py:Speedometer`)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """Batch-end callback logging a text bar of `length` characters,
    ``nbatch`` of `total` (reference `callback.py:ProgressBar`)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
