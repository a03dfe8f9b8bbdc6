"""Ring attention: sequence parallelism over a `torch.distributed` group.

PyTorch port of `incubator_mxnet_tpu/parallel/ring_attention.py`.  Each
rank holds a sequence shard of Q/K/V; K/V shards rotate around the ring
(point-to-point sends to rank + 1) while a blockwise online softmax
accumulates exact attention, so each rank holds O(T/n) of the sequence.
(Technique: Liu et al., Ring Attention with Blockwise Transformers, 2023.)

The group takes the place of the JAX package's named `shard_map` axis;
without an initialised process group the ring has one rank.
``use_pallas=True`` computes each ring step with
`ops.flash_attention.flash_attention_partial` (kernel K2 or K3 on the
card) instead of a materialised (T_local, T_local) score block; the ring
protocol and the merge are unchanged.  The name of the flag is the JAX
package's.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["blockwise_attention", "ring_attention"]


def _block_attn(q, k, v, bias=None):
    """One (Tq, Tk) attention block returning (out_unnorm, row_max, row_sum).

    q: (B, Tq, H, D), k/v: (B, Tk, H, D)
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
        1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias
    m = scores.amax(dim=-1)                           # (B, H, Tq)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)                                 # (B, H, Tq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)         # (B, Tq, H, D)
    return o, m, l


def _causal_bias(q_pos, k_pos, dtype):
    zero = torch.zeros((), dtype=dtype, device=q_pos.device)
    neg = torch.full((), -1e30, dtype=dtype, device=q_pos.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], zero, neg)[None,
                                                                    None]


def _merge(m, l, o, bm, bl, bo):
    """Fold one block's (bm, bl, bo) into the running (m, l, o)."""
    m_new = torch.maximum(m, bm)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(bm - m_new)
    l = l * alpha + bl * beta
    o = o * alpha.transpose(1, 2)[..., None] + \
        bo * beta.transpose(1, 2)[..., None]
    return m_new, l, o


def blockwise_attention(q, k, v, block_size=None, causal=False):
    """Single-device blockwise (memory-efficient) attention over KV blocks.
    Exact softmax via online accumulation; m and l ride in q's dtype, as
    in the JAX package."""
    B, T, H, D = q.shape
    bs = block_size or T
    m = torch.full((B, H, T), -1e30, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    q_pos = torch.arange(T, device=q.device)
    for i in range(-(-k.shape[1] // bs)):
        ks = k[:, i * bs:(i + 1) * bs]
        vs = v[:, i * bs:(i + 1) * bs]
        bias = None
        if causal:
            k_pos = torch.arange(i * bs, i * bs + ks.shape[1],
                                 device=q.device)
            bias = _causal_bias(q_pos, k_pos, q.dtype)
        bo, bm, bl = _block_attn(q, ks, vs, bias)
        m, l, o = _merge(m, l, o, bm, bl, bo)
    return o / l.transpose(1, 2)[..., None]


def ring_attention(q, k, v, group=None, causal=False, use_pallas=False):
    """Exact attention over sequence shards held by the ranks of `group`.

    q, k, v are this rank's shards, (B, T_local, H, D), in rank order
    along the sequence.  K/V rotate n - 1 times around the ring (each
    send overlapped with the current block's compute); each step
    contributes one block to the online softmax.  Without an initialised
    process group the ring is this process alone.
    """
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size(group)
        my_idx = dist.get_rank(group)
    else:
        n, my_idx = 1, 0
    B, Tl, H, D = q.shape
    nxt, prv = (my_idx + 1) % n, (my_idx - 1) % n
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)

    m = torch.full((B, H, Tl), -1e30, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(n):
        # which rank's shard are we holding? source = my_idx - i
        src = (my_idx - i) % n
        pending = []
        if i < n - 1:
            k_next, v_next = torch.empty_like(k_cur), torch.empty_like(v_cur)
            pending = [dist.isend(k_cur, nxt, group=group),
                       dist.isend(v_cur, nxt, group=group),
                       dist.irecv(k_next, prv, group=group),
                       dist.irecv(v_next, prv, group=group)]
        if use_pallas:
            from ..ops.flash_attention import flash_attention_partial
            bo, bm, bl = flash_attention_partial(
                q, k_cur, v_cur, q_off=my_idx * Tl, k_off=src * Tl,
                causal=causal)
            bm, bl, bo = bm.to(m.dtype), bl.to(l.dtype), bo.to(o.dtype)
        else:
            bias = None
            if causal:
                q_pos = my_idx * Tl + torch.arange(Tl, device=q.device)
                k_pos = src * Tl + torch.arange(Tl, device=q.device)
                bias = _causal_bias(q_pos, k_pos, q.dtype)
            bo, bm, bl = _block_attn(q, k_cur, v_cur, bias)
        m, l, o = _merge(m, l, o, bm, bl, bo)
        for work in pending:
            work.wait()
        if pending:
            k_cur, v_cur = k_next, v_next
    return o / l.transpose(1, 2)[..., None]
