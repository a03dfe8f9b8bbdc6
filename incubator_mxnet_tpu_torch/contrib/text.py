"""Token vocabularies and embeddings from local files (reference
`python/mxnet/contrib/text/`).

PyTorch port of `incubator_mxnet_tpu/contrib/text.py`: `Vocabulary`,
`count_tokens_from_str` and `CustomEmbedding`.  Pretrained embeddings
are not downloaded; `CustomEmbedding` reads a local file of ``token v1
v2 ...`` lines.
"""
from __future__ import annotations

import collections

import numpy as np

from .. import ndarray as nd

__all__ = ["Vocabulary", "count_tokens_from_str", "CustomEmbedding"]


class Vocabulary:
    """Index 0 the unknown token, then the reserved tokens, then the
    counter's tokens by falling frequency (ties by token) down to
    `min_freq`, at most `most_freq_count` of them."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be at least 1")
        self._unknown_token = unknown_token
        self._idx_to_token = [unknown_token] + list(reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq >= min_freq and tok not in self._token_to_idx:
                    self._token_to_idx[tok] = len(self._idx_to_token)
                    self._idx_to_token.append(tok)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        out = [self._token_to_idx.get(t, 0)
               for t in ([tokens] if single else tokens)]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        out = [self._idx_to_token[i]
               for i in ([indices] if single else indices)]
        return out[0] if single else out


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """A `collections.Counter` of the tokens of `source_str` (added to
    `counter_to_update` when given)."""
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    for seq in source_str.split(seq_delim):
        counter.update(t for t in seq.split(token_delim) if t)
    return counter


class CustomEmbedding:
    """Vectors of a local ``token v1 v2 ...`` file (the tokens of
    `vocabulary` only, when given); row 0, the unknown token's, is zeros.
    `get_vecs_by_tokens` returns NDArrays on `ctx` (default
    `current_context()`)."""

    def __init__(self, pretrained_file_path, elem_delim=" ", encoding="utf8",
                 vocabulary=None, ctx=None):
        tokens, vecs = [], []
        with open(pretrained_file_path, encoding=encoding) as f:
            for line in f:
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                tokens.append(parts[0])
                vecs.append([float(x) for x in parts[1:]])
        dim = len(vecs[0])
        self._ctx = ctx
        self._token_to_idx = {}
        self._idx_to_token = ["<unk>"]
        rows = [np.zeros(dim, dtype="float32")]
        for tok, vec in zip(tokens, vecs):
            if vocabulary is not None and tok not in vocabulary.token_to_idx:
                continue
            self._token_to_idx[tok] = len(self._idx_to_token)
            self._idx_to_token.append(tok)
            rows.append(np.asarray(vec, dtype="float32"))
        self._mat = np.stack(rows)

    @property
    def vec_len(self):
        return self._mat.shape[1]

    def get_vecs_by_tokens(self, tokens):
        single = isinstance(tokens, str)
        idx = [self._token_to_idx.get(t, 0)
               for t in ([tokens] if single else tokens)]
        out = nd.array(self._mat[idx], ctx=self._ctx)
        return out[0] if single else out
