"""Data iterators (reference `python/mxnet/io.py`).

PyTorch port of `DataDesc`, `DataBatch`, `DataIter` and `NDArrayIter`
from `incubator_mxnet_tpu/io.py`.  Batches are NDArrays
on the CPU; an executor copies them to its device.  `NDArrayIter`
shuffles with the global ``np.random``, as the JAX package's does, so
one numpy seed gives both packages the same batch order.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc:
    """Named shape/type descriptor (reference `io.py:DataDesc`)."""

    def __init__(self, name, shape, dtype=_np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    def __iter__(self):
        # unpacks like the reference's namedtuple
        yield self.name
        yield self.shape

    def __getitem__(self, i):
        return (self.name, self.shape)[i]


class DataBatch:
    """One batch (reference `io.py:DataBatch`)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} " \
               f"label shapes: {label_shapes}"


class DataIter:
    """Base iterator (reference `io.py DataIter`)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError

    # -- checkpoint/resume support (checkpoint/state.py) -----------------------
    def seek(self, nbatch):
        """Position so the next batch is batch `nbatch` of the epoch:
        reset, then skip."""
        self.reset()
        for _ in range(int(nbatch)):
            self.next()

    def checkpoint_state(self):
        """Epoch-internal state a checkpoint must carry beyond the batch
        counter (a shuffle permutation); empty: resume uses `seek`."""
        return {}

    def set_checkpoint_state(self, state, nbatch=0):
        self.seek(nbatch)


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference `io.py NDArrayIter`):
    dict/list inputs, shuffle, pad/discard/roll_over of the last batch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = -(-self.num_data // batch_size)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            self.cursor = self.num_data + self.cursor
        else:
            self.cursor = -self.batch_size
        # batch n of this epoch starts at _epoch_cursor0 + (n + 1) *
        # batch_size: a roll_over epoch begins mid-stride, with the
        # samples the last one carried, and `seek` anchors here
        self._epoch_cursor0 = self.cursor

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _getdata(self, data_source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[self.cursor:end]
        elif self.last_batch_handle == "discard":
            raise StopIteration
        else:
            sel = _np.concatenate([self.idx[self.cursor:],
                                   self.idx[:end - self.num_data]])
        return [array(v[sel], ctx=cpu(), dtype=v.dtype)
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label) if self.label else []

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def seek(self, nbatch):
        """Cursor arithmetic from the epoch-start cursor; no data is
        touched."""
        self.cursor = self._epoch_cursor0 + int(nbatch) * self.batch_size

    def checkpoint_state(self):
        # the shuffle permutation is the epoch's batch order; the
        # epoch-start cursor carries roll_over's alignment
        return {"idx": self.idx.copy(),
                "epoch_cursor0": int(self._epoch_cursor0)}

    def set_checkpoint_state(self, state, nbatch=0):
        idx = state.get("idx")
        if idx is not None:
            idx = _np.asarray(idx)
            if idx.shape != self.idx.shape:
                raise MXNetError(
                    f"checkpoint iterator order has {idx.shape[0]} samples, "
                    f"this iterator has {self.idx.shape[0]} — resuming "
                    "against a different dataset?")
            self.idx = idx
        if "epoch_cursor0" in state:
            self._epoch_cursor0 = int(state["epoch_cursor0"])
        self.seek(nbatch)


def _init_data(data, allow_empty, default_name):
    """Normalize to [(name, np.ndarray)] (reference `io.py _init_data`)."""
    if data is None:
        if not allow_empty:
            raise ValueError("Data must be provided")
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("Data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in data.items()]
