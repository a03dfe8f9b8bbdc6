"""`DataLoaderIter`: a gluon `DataLoader` as a `DataIter`, so
`Module.fit` trains from gluon datasets (reference `python/mxnet/contrib/
io.py`).

PyTorch port of `incubator_mxnet_tpu/contrib/io.py`, with its contract:
the first batch is read at construction (for `provide_data` and
`provide_label`), every batch reports ``pad=0`` (a short last batch
comes short, not padded), and `reset` starts the loader anew.  A reset
in mid-epoch closes the running loader iterator, so a threaded loader's
workers stop.  `Module.fit` wraps this iterator in the h2d ring like any
`DataIter`.
"""
from __future__ import annotations

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Batches of a loader of ``(data, label)`` pairs as `DataBatch`es
    named `data_name` and `label_name`."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        self._loader = loader
        self._iter = iter(loader)
        self.data_name = data_name
        self.label_name = label_name
        self._first = next(self._iter)
        data, label = self._first
        super().__init__(batch_size=data.shape[0])
        self.provide_data = [DataDesc(data_name, tuple(data.shape),
                                      data.dtype)]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       label.dtype)]

    def _close_iter(self):
        close = getattr(self._iter, "close", None)
        if close is not None:
            close()

    def reset(self):
        self._close_iter()
        self._iter = iter(self._loader)
        self._first = None

    def close(self):
        self._close_iter()

    def next(self):
        if self._first is not None:
            (data, label), self._first = self._first, None
        else:
            data, label = next(self._iter)
        return DataBatch(data=[data], label=[label], pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
