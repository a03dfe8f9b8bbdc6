"""Data iterators (reference `python/mxnet/io.py`).

PyTorch port of `incubator_mxnet_tpu/io.py`: `DataDesc`, `DataBatch`,
`DataIter`, `NDArrayIter`, `ResizeIter`, `PrefetchingIter`, `CSVIter`,
`MNISTIter`, `LibSVMIter`, the `ImageRecordIter` factory (its engine
is `image.ImageRecordIterImpl`) and `pad_to_bucket`, which pads a short
batch up to a bound batch size.  Batches are NDArrays on the CPU; the
h2d ring (`io_plane`) or an executor copies them to its device.
`NDArrayIter` shuffles with the global ``np.random``, as the JAX
package's does, so one numpy seed gives both packages the same batch
order.
"""
from __future__ import annotations

import queue as _queue
import struct
import threading

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "LibSVMIter",
           "ImageRecordIter", "ImageRecordIter_v1", "pad_to_bucket"]


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

    def pad_to_bucket(self, buckets):
        """This batch padded up to the nearest bucket (`pad_to_bucket`)."""
        return pad_to_bucket(self, buckets)


def _pad_rows(arr, pad):
    """`arr` (NDArray or numpy) with `pad` copies of its final row
    appended."""
    if isinstance(arr, NDArray):
        import torch
        t = arr.data
        return NDArray(torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]),
                       ctx=arr.context)
    arr = _np.asarray(arr)
    return _np.concatenate([arr, _np.repeat(arr[-1:], pad, axis=0)])


def pad_to_bucket(batch, buckets):
    """`batch` padded along the batch axis to the smallest of `buckets`
    that holds it, the pad rows (copies of the final sample) counted in
    ``pad`` (JAX `io.py:106`).  A batch that already
    fills a bucket, or exceeds them all, comes back as it is; otherwise
    a new DataBatch (the input is not changed).  `BaseModule.predict`
    pads a ragged final batch to the bound batch this way, so the tail
    runs on the bound executor and its pad rows are sliced off."""
    if not batch.data:
        return batch
    n = int(batch.data[0].shape[0])
    target = next((b for b in sorted(int(x) for x in buckets) if n <= b),
                  None)
    if target is None or target == n:
        return batch
    pad = target - n
    return DataBatch(
        data=[_pad_rows(d, pad) for d in batch.data],
        label=[_pad_rows(l, pad) for l in (batch.label or [])] or None,
        pad=(batch.pad or 0) + pad, index=batch.index,
        bucket_key=batch.bucket_key, provide_data=batch.provide_data,
        provide_label=batch.provide_label)


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

    def record_range(self, nbatch):
        """(source, lo, hi): where batch `nbatch` of this epoch draws its
        records from, the training guardian's shard attribution; None
        when the iterator cannot say (the default)."""
        return None


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
            # wrap to the epoch's start, cyclically: a dataset smaller
            # than the batch still fills it (the JAX iterator wraps once
            # and returns a short batch whose pad exceeds its rows)
            sel = _np.concatenate([self.idx[self.cursor:],
                                   _np.resize(self.idx, end - self.num_data)])
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

    def record_range(self, nbatch):
        """The sample-index window batch `nbatch` of this epoch draws
        from (the shuffle permutation maps it onto rows)."""
        lo = max(self._epoch_cursor0 + (int(nbatch) + 1) * self.batch_size,
                 0)
        return ("ndarray", lo, min(lo + self.batch_size, self.num_data))

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


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches per epoch
    (reference `io.py:ResizeIter`); the inner iterator restarts when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """A producer thread pulls batches from the inner iterators while the
    consumer trains (reference `io.py PrefetchingIter`, C++
    `iter_prefetcher.h`); several iterators' batches join into one."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self._queue = _queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _producer(self, stop):
        while not stop.is_set():
            try:
                batches = [i.next() for i in self.iters]
            except StopIteration:
                self._queue.put(None)
                return
            self._queue.put(batches)

    def _start(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer,
                                        args=(self._stop,), daemon=True,
                                        name="mx-io-prefetch")
        self._thread.start()

    def reset(self):
        self._stop.set()
        # drain until the producer has left (it may be blocked on a full
        # queue, or about to put its end marker)
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except _queue.Empty:
                pass
        while True:
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                break
        for i in self.iters:
            i.reset()
        self._start()

    def next(self):
        batches = self._queue.get()
        if batches is None:
            self._queue.put(None)   # stay exhausted until reset
            raise StopIteration
        data = sum([b.data for b in batches], [])
        label = sum([(b.label or []) for b in batches], [])
        return DataBatch(data=data, label=label, pad=batches[0].pad,
                         index=batches[0].index,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            return False


class CSVIter(DataIter):
    """Reference `src/io/iter_csv.cc`: batches from CSV text."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", ndmin=2, dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", ndmin=2,
                                dtype="float32")
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = _np.zeros(data.shape[0], dtype="float32")
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad" if round_batch
                                  else "discard", label_name="label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """Reference `src/io/iter_mnist.cc`: reads idx-format MNIST files
    (optionally gzipped); pixels scaled to [0, 1]."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=None, **kwargs):
        super().__init__(batch_size)
        imgs = _read_idx_images(image).astype("float32") / 255.0
        lbls = _read_idx_labels(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        self._inner = NDArrayIter(imgs, lbls.astype("float32"), batch_size,
                                  shuffle=shuffle,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _open_maybe_gz(path):
    import gzip
    return (gzip.open if path.endswith(".gz") else open)(path, "rb")


def _read_idx_images(path):
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError(f"bad MNIST image magic {magic}")
        return _np.frombuffer(f.read(n * rows * cols),
                              dtype=_np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError(f"bad MNIST label magic {magic}")
        return _np.frombuffer(f.read(n), dtype=_np.uint8)


def ImageRecordIter(**kwargs):
    """Reference `src/io/iter_image_recordio_2.cc` (param-compatible
    factory) over `image.ImageRecordIterImpl`."""
    from .image import ImageRecordIterImpl
    return ImageRecordIterImpl(**kwargs)


def ImageRecordIter_v1(**kwargs):
    return ImageRecordIter(**kwargs)


class LibSVMIter(DataIter):
    """Reference `src/io/iter_libsvm.cc`: batches from libsvm-format text
    (``label idx:val idx:val ...``).  Data batches are CSR
    (`ndarray.sparse.CSRNDArray`); labels are dense unless a separate
    `label_libsvm` file is given, in which case they are CSR too."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        self._label_shape = tuple(label_shape) \
            if not isinstance(label_shape, int) else (int(label_shape),)
        self._round_batch = round_batch
        vals, idxs, ptr, labels = self._parse(data_libsvm,
                                              self._data_shape[0])
        self._vals, self._idxs, self._ptr = vals, idxs, ptr
        if label_libsvm is not None:
            lv, li, lp, _ = self._parse(label_libsvm, self._label_shape[0])
            self._lvals, self._lidxs, self._lptr = lv, li, lp
            self._labels = None
        else:
            # inline labels: every leading non-feature field, laid out to
            # label_shape's width
            k = 1 if self._label_shape == (1,) else self._label_shape[0]
            lab = _np.zeros((len(labels), k), dtype="float32")
            for i, row in enumerate(labels):
                if row:
                    lab[i, :min(len(row), k)] = row[:k]
            self._labels = lab[:, 0] if k == 1 else lab
            self._lvals = None
        self._n = len(ptr) - 1
        self._cur = 0

    @staticmethod
    def _parse(path, width):
        vals, idxs, ptr, labels = [], [], [0], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                i = 0
                lab = []
                while i < len(parts) and ":" not in parts[i]:
                    lab.append(float(parts[i]))
                    i += 1
                labels.append(lab)
                for tok in parts[i:]:
                    k, v = tok.split(":")
                    if int(k) >= width:
                        raise MXNetError(
                            f"LibSVMIter: feature index {k} >= data_shape "
                            f"width {width}")
                    idxs.append(int(k))
                    vals.append(float(v))
                ptr.append(len(vals))
        return (_np.asarray(vals, "float32"), _np.asarray(idxs, _np.int64),
                _np.asarray(ptr, _np.int64), labels)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._data_shape[0]))]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_shape == (1,) else \
            (self.batch_size,) + self._label_shape
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self._cur = 0

    @staticmethod
    def _csr_rows(vals, idxs, ptr, ranges, width):
        """CSR batch over concatenated [lo, hi) row ranges, never
        densified."""
        from .ndarray.sparse import CSRNDArray
        v_parts, i_parts, new_ptr = [], [], [0]
        n = 0
        for lo, hi in ranges:
            seg = ptr[lo:hi + 1]
            v_parts.append(vals[seg[0]:seg[-1]])
            i_parts.append(idxs[seg[0]:seg[-1]])
            base = new_ptr[-1] - seg[0]
            new_ptr.extend((seg[1:] + base).tolist())
            n += hi - lo
        return CSRNDArray(
            _np.concatenate(v_parts) if v_parts else vals[:0],
            _np.concatenate(i_parts) if i_parts else idxs[:0],
            _np.asarray(new_ptr, _np.int64), (n, width))

    def next(self):
        if self._cur >= self._n:
            raise StopIteration
        lo = self._cur
        hi = min(lo + self.batch_size, self._n)
        pad = self.batch_size - (hi - lo)
        if pad and not self._round_batch:
            raise StopIteration
        self._cur = hi
        # round_batch: the tail wraps rows from the epoch start
        ranges = [(lo, hi)] + ([(0, pad)] if pad else [])
        data = self._csr_rows(self._vals, self._idxs, self._ptr, ranges,
                              self._data_shape[0])
        if self._labels is not None:
            lab = self._labels[lo:hi]
            if pad:
                lab = _np.concatenate([lab, self._labels[:pad]])
            label = array(lab, ctx=cpu())
        else:
            label = self._csr_rows(self._lvals, self._lidxs, self._lptr,
                                   ranges, self._label_shape[0])
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
