"""BucketSentenceIter (reference `python/mxnet/rnn/io.py`): group
variable-length sequences into length buckets; `BucketingModule` binds
one executor per bucket (`module/bucketing_module.py`).

PyTorch port of `incubator_mxnet_tpu/rnn/io.py`: the same buckets,
padding, shuffles (Python's `random` for the batch order, numpy's for
each bucket) and batches; the batches are host arrays.  An elastic
checkpoint carries the epoch's order (`checkpoint_state`)."""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..base import MXNetError
from ..io import DataIter, DataBatch, DataDesc
from ..context import cpu
from ..ndarray.ndarray import array


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Reference `rnn/io.py encode_sentences`: build/extend a vocab."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise MXNetError(f"Unknown token {word}")
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Reference `rnn/io.py:BucketSentenceIter`."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if buckets is None:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
        buckets.sort()
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]

        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.default_bucket_key = max(buckets)

        shape = ((batch_size, self.default_bucket_key)
                 if layout == "NT" else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape, dtype,
                                      layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, dtype,
                                       layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)

    def checkpoint_state(self):
        """The epoch's order, which `reset` draws from Python's and
        numpy's streams: the batch order and each bucket's rows (an
        elastic checkpoint carries them, so resume needs no replay)."""
        return {"idx": [tuple(i) for i in self.idx],
                "data": [b.copy() for b in self.data]}

    def set_checkpoint_state(self, state, nbatch=0):
        """Take a `checkpoint_state` order and stand before batch
        `nbatch` of the epoch; no draw from the random streams."""
        if "idx" not in state:
            self.seek(nbatch)
            return
        if [b.shape for b in state["data"]] != [b.shape for b in self.data]:
            raise MXNetError("checkpoint iterator buckets do not match this "
                             "iterator's — resuming against another corpus?")
        self.idx = [tuple(i) for i in state["idx"]]
        self.data = [np.array(b) for b in state["data"]]
        self.curr_idx = int(nbatch)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j:j + self.batch_size]
        label = np.empty_like(data)
        label[:, :-1] = data[:, 1:]
        label[:, -1] = self.invalid_label
        if self.layout == "TN":
            data = data.T
            label = label.T
        shape = data.shape
        return DataBatch([array(data, ctx=cpu(), dtype=self.dtype)],
                         [array(label, ctx=cpu(), dtype=self.dtype)],
                         pad=0, bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, shape,
                                                self.dtype,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, shape,
                                                 self.dtype,
                                                 layout=self.layout)])
