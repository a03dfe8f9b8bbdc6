"""Gluon block over the sharded sparse-embedding table (reference: the
JAX package's `gluon/nn/sparse.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/nn/sparse.py`.  `nn.Embedding`
holds its table as one dense Parameter; `SparseEmbedding` wraps an
`embedding.ShardedEmbedding` instead: the forward looks rows up through
the table's hot-row cache on its device (a data-plane fetch, not a
Parameter read), the looked-up block is an autograd leaf, and
`push_grads` ships each leaf's gradient row-sparse to the parameter-
server shards that own the rows, where the lazy optimizer applies it.
The dense parameters around it train through `Trainer` as usual.
"""
from __future__ import annotations

import numpy as np

from ..block import Block
from ...ndarray.ndarray import NDArray

__all__ = ["SparseEmbedding"]


class SparseEmbedding(Block):
    """Embedding lookup backed by a `ShardedEmbedding` table::

        table = embedding.ShardedEmbedding("user", rows, dim, servers,
                                           optimizer=opt)
        emb = nn.SparseEmbedding(table)
        with autograd.record():
            loss = loss_fn(net(emb(ids), dense_x), label)
        loss.backward()
        emb.push_grads()        # row-sparse push, shard-side update
        trainer.step(batch)     # the dense parameters
    """

    def __init__(self, table, **kwargs):
        super().__init__(**kwargs)
        self._table = table
        self._pending = []      # (ids, leaf) since the last push

    @property
    def table(self):
        return self._table

    def forward(self, x):
        ids = np.asarray(
            x.asnumpy() if hasattr(x, "asnumpy") else x).astype(np.int64)
        out = NDArray(self._table.lookup(ids), ctx=self._table.ctx)
        # a leaf: backward leaves d(loss)/d(rows) in out.grad
        out.attach_grad()
        self._pending.append((ids, out))
        return out

    def push_grads(self):
        """Push every recorded lookup's gradient to the shards that own
        its rows (duplicate ids summed first; the update runs there)."""
        pending, self._pending = self._pending, []
        for ids, leaf in pending:
            g = leaf.grad
            if g is None:
                continue
            self._table.push_grad(
                ids.ravel(), g.asnumpy().reshape(ids.size, self._table.dim))

    def __repr__(self):
        t = self._table
        return f"SparseEmbedding({t.num_rows} -> {t.dim}, " \
               f"{t.num_shards} shards, {t.partition})"
