"""`LogMetricsCallback`: a batch-end callback that writes the eval
metrics as scalars (reference `python/mxnet/contrib/tensorboard.py`).

PyTorch port of `incubator_mxnet_tpu/contrib/tensorboard.py`, with its
choice of writer: tensorboardX's `SummaryWriter`, then
`torch.utils.tensorboard`'s, then newline-delimited JSON
(``events.jsonl`` in the logging directory, one object per scalar with
its tag, value and step).
"""
from __future__ import annotations

import importlib
import json
import os

__all__ = ["LogMetricsCallback"]


class _JsonlWriter:
    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._f = open(os.path.join(logging_dir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, global_step=None):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": global_step}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logging_dir):
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return importlib.import_module(mod).SummaryWriter(logging_dir)
        except Exception:   # noqa: BLE001 - absent or broken: next sink
            continue
    return _JsonlWriter(logging_dir)


class LogMetricsCallback:
    """Each call (one batch) writes every metric of
    ``param.eval_metric`` at step 1, 2, ..., tagged ``prefix-name``."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self._writer = _make_writer(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        names, values = param.eval_metric.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        for name, value in zip(names, values):
            if self.prefix is not None:
                name = f"{self.prefix}-{name}"
            self._writer.add_scalar(name, value, self.step)

    def close(self):
        self._writer.close()
