"""Train a sharded embedding table through `Module.fit`.

PyTorch port of `incubator_mxnet_tpu/embedding/fit.py`: the looked-up
vectors stay on the table's device (the hot-row cache's gather) and enter
the module as that device's NDArray, with no host hop; the input
gradient crosses to the host once, to go on the wire.

The dense tower stays a plain Module program; the embedding rides along
as a DATA input: the adapter wraps the id-carrying iterator so each
batch's id field is replaced by its looked-up vectors (hot rows gather
from the device cache), and the module is bound with
``inputs_need_grad=True`` so the backward pass produces d(loss)/d(vectors)
— which IS the row-sparse embedding gradient.  A `batch_end_callback`
reads it from `get_input_grads`, folds the slot axis, pre-sums duplicate
ids, and pushes to the owning shards where the lazy optimizer applies
it.  `Module.fit`'s guardian, h2d ring, and checkpoint plane all ride
along untouched (binding with input grads selects the per-batch step,
which is what exposes the input gradient).
"""
from __future__ import annotations

import numpy as np

from ..io import DataBatch, DataDesc


class EmbeddingFitAdapter:
    """Wraps an id-carrying iterator + a `ShardedEmbedding` for fit.

    ``base_iter`` yields batches whose ``data[id_field]`` is an int
    array of row ids, shape (B,) or (B, slots); the adapter emits
    batches where that field is the looked-up vectors flattened to
    (B, slots*dim), remembers each batch's ids, and pushes the matching
    input gradient at batch end."""

    def __init__(self, table, base_iter, id_field=0, embed_name=None):
        self.table = table
        self._base = base_iter
        self._idx = int(id_field)
        self.batch_size = getattr(base_iter, "batch_size", 0)
        descs = list(base_iter.provide_data)
        d = descs[self._idx]
        shape = tuple(d.shape)
        self._slots = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        self._name = embed_name or d.name
        descs[self._idx] = DataDesc(
            self._name, (shape[0], self._slots * table.dim))
        self.provide_data = descs
        self.provide_label = base_iter.provide_label
        self._last_ids = None
        self.pushes = 0

    # -- iterator protocol ----------------------------------------------------
    def reset(self):
        self._base.reset()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        batch = self._base.next()
        data = list(batch.data)
        ids = np.asarray(data[self._idx].asnumpy()
                         if hasattr(data[self._idx], "asnumpy")
                         else data[self._idx]).astype(np.int64)
        vecs = self.table.lookup(ids)   # device tensor, no host hop
        from ..ndarray.ndarray import NDArray
        data[self._idx] = NDArray(vecs.reshape(
            ids.shape[0], self._slots * self.table.dim), ctx=self.table.ctx)
        self._last_ids = ids
        return DataBatch(data=data, label=batch.label, pad=batch.pad,
                         index=batch.index,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # -- grad push ------------------------------------------------------------
    def push_from(self, module):
        """Push the embedding gradient of the LAST emitted batch (reads
        `get_input_grads` — the module must be bound with
        ``inputs_need_grad=True`` before fit)."""
        if self._last_ids is None:
            return
        grad = module.get_input_grads()[self._idx].asnumpy()
        ids = self._last_ids.ravel()
        self.table.push_grad(ids, grad.reshape(len(ids), self.table.dim))
        self.pushes += 1

    def make_callback(self, module):
        """The ``batch_end_callback`` for `Module.fit`."""
        def _cb(_param):
            self.push_from(module)
        return _cb
