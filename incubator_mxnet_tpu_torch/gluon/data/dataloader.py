"""DataLoader (reference `python/mxnet/gluon/data/dataloader.py`).

PyTorch port of `DataLoader` and `default_batchify_fn` of
`incubator_mxnet_tpu/gluon/data/dataloader.py`.  Batches are stacked on
the host (NDArray samples on their own context); the training loop, or
`io_plane.DevicePrefetchLoader`, moves them to the card.

With ``num_workers = 0`` the caller's thread loads each batch.  With
more, as in the JAX package, worker threads (not processes) each fetch
and stack whole batches, and the iterator yields them in the sampler's
order, so the batches equal those of ``num_workers = 0``.  Threads
overlap only the work that releases the GIL: on an 8-core host, an
ImageNet-style random pipeline over JPEG records kept about 3.3 cores
busy at 4 or 8 workers and ran 1.4x the rate of one thread, 8 workers
no faster than 4.  Unlike the JAX loader, which queues the whole
epoch at once and whose consumer waits forever on a worker that raised
(ROADMAP Queue 3), this one keeps at most `prefetch` batches (default
``2 * num_workers``) fetched or being fetched ahead of the consumer,
raises a worker's exception at that batch's turn, and stops its workers
when the iterator is closed or dropped mid-epoch.  Workers never launch
device work: datasets and batchify functions that return host arrays
keep them on the host.
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from ...context import cpu
from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays on their context, tuples
    field by field, anything else through numpy on the CPU (float64
    becomes float32, as in the reference)."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data for d in data]),
                       ctx=data[0].context)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(field)) for field in zip(*data)]
    data = np.asarray(data)
    return array(data, ctx=cpu(), dtype=data.dtype
                 if data.dtype != np.float64 else np.float32)


class DataLoader:
    """Batches of a Dataset (reference `dataloader.py:DataLoader`)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch or 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _load(self, idx):
        return self._batchify_fn([self._dataset[i] for i in idx])

    def __iter__(self):
        # a generator, as the JAX loader's: the sampler draws its order
        # at the first batch asked for
        if self._num_workers == 0:
            for idx in self._batch_sampler:
                yield self._load(idx)
            return
        yield from _threaded(self._load, list(self._batch_sampler),
                             self._num_workers, max(1, self._prefetch))


class _Failed:
    """A worker's exception, handed to the consumer as its batch."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _threaded(load, batches, num_workers, prefetch):
    """Batches `load(idx)` of every index list in `batches`, in order,
    from `num_workers` threads with at most `prefetch` batches ahead of
    the consumer.  The threads start at the first batch asked for and
    leave when the generator is closed, dropped or done."""
    tasks = _queue.Queue()
    results = {}
    ready = threading.Condition()
    stop = threading.Event()

    def worker():
        while True:
            task = tasks.get()
            if task is None or stop.is_set():
                return
            i, idx = task
            try:
                out = load(idx)
            except BaseException as e:   # noqa: BLE001 - raised in order
                out = _Failed(e)
            with ready:
                results[i] = out
                ready.notify_all()

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"mx-dataloader-worker-{k}")
               for k in range(min(num_workers, len(batches)))]
    queued = min(prefetch, len(batches))
    for task in enumerate(batches[:queued]):
        tasks.put(task)
    for t in threads:
        t.start()
    try:
        for i in range(len(batches)):
            with ready:
                ready.wait_for(lambda: i in results)
                out = results.pop(i)
            if queued < len(batches):
                tasks.put((queued, batches[queued]))
                queued += 1
            if isinstance(out, _Failed):
                raise out.exc
            yield out
    finally:
        stop.set()
        for _ in threads:
            tasks.put(None)
