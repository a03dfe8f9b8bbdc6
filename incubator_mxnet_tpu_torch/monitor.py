"""Monitor: statistics of executor outputs and arguments every
`interval` batches (reference `python/mxnet/monitor.py`).

PyTorch port of `incubator_mxnet_tpu/monitor.py`.  `install` registers
`stat_helper` as an executor's monitor callback (`Executor.
set_monitor_callback`), which sees each output of every forward; `tic`
opens a batch when its step is a multiple of `interval`, and `toc`
adds the statistics of every argument that matches `pattern` and
returns them as (step, name, text) rows, reading them from the device
there.  `Module.fit(monitor=)` installs it and runs each batch through
the per-batch path (forward, backward, update), so the callbacks see the
module's outputs; the fused train step's outputs never leave it.
"""
from __future__ import annotations

import logging
import re

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collect per-output statistics every `interval` batches."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """mean absolute value"""
                return x.abs().sum() / x.size
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, array):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        """Install on anything exposing `set_monitor_callback`."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def _wait_args(self):
        for exe in self.exes:
            for array in getattr(exe, "arg_arrays", ()) or ():
                if array is not None:
                    array.wait_to_read()

    def tic(self):
        if self.step % self.interval == 0:
            self._wait_args()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self._wait_args()
        for exe in self.exes:
            for name, array in (getattr(exe, "arg_dict", None) or {}).items():
                if array is not None and self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                res.append((n, k, str(_np.asarray(v_list)) + "\t"))
                continue
            s = ""
            for v in v_list:
                if not isinstance(v, NDArray):
                    s += str(_np.asarray(v)) + "\t"
                elif v.shape in ((1,), ()):
                    s += str(v.asnumpy().reshape(-1)[0]) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
