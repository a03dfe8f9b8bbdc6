"""Attention operators for the transformer LM workload.

PyTorch port of `incubator_mxnet_tpu/ops/attention.py`.  One registered
op, ``BlockwiseAttention``: multi-head scaled-dot-product attention over
packed ``(batch, time, channels)`` activations, lowered through
`parallel.ring_attention.blockwise_attention` (plain torch, no kernel,
as in the JAX package).  The op name, params and input names are the
JAX package's, so saved LM symbol JSON that names the op loads and runs
in the port.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import register, REQUIRED


@register("BlockwiseAttention", nin=3,
          params={"num_heads": REQUIRED, "causal": True,
                  "block_size": None},
          input_names=["query", "key", "value"])
def _blockwise_attention(params, q, k, v):
    """Multi-head attention on (B, T, C) inputs.

    Splits channels into ``num_heads`` heads, runs the blockwise exact-
    softmax recurrence, and re-packs.  ``block_size=None`` takes the
    whole sequence as one block; ``causal`` masks future positions.
    """
    from ..parallel.ring_attention import blockwise_attention
    heads = int(params["num_heads"])
    causal = bool(params.get("causal", True))
    block_size = params.get("block_size")
    if block_size is not None:
        block_size = int(block_size)
    b, t, c = q.shape[-3], q.shape[-2], q.shape[-1]
    if c % heads:
        raise MXNetError(
            "BlockwiseAttention: channels (%d) not divisible by "
            "num_heads (%d)" % (c, heads))
    d = c // heads

    def split(x):
        return x.reshape(b, t, heads, d)

    out = blockwise_attention(split(q), split(k), split(v),
                              block_size=block_size, causal=causal)
    return out.reshape(b, t, c)


def naive_attention(q, k, v, num_heads, causal=True):
    """Reference O(T^2)-memory attention on (B, T, C) packed inputs: the
    full score matrix, then softmax.  The parity oracle for
    `BlockwiseAttention`; not a registered op."""
    b, t, c = q.shape
    d = c // num_heads

    def heads(x):
        return x.reshape(b, t, num_heads, d).permute(0, 2, 1, 3)

    scores = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ heads(v)
    return out.permute(0, 2, 1, 3).reshape(b, t, c)
