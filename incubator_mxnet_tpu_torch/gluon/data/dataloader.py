"""DataLoader (reference `python/mxnet/gluon/data/dataloader.py`).

PyTorch port of `DataLoader` and `default_batchify_fn` of
`incubator_mxnet_tpu/gluon/data/dataloader.py`, loading in the caller's
thread: batches are stacked on the host (NDArray samples on their own
context) and the training loop moves them to the card
(`Estimator._place`).  Worker threads (``num_workers > 0``) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
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
        if num_workers:
            raise MXNetError("DataLoader: worker threads are not ported "
                             "yet (ROADMAP Queue 1, item 11b); use "
                             "num_workers=0")
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
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        for idx in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in idx])
