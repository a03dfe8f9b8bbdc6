"""The decode plane of the transformer LM: prefill and decode step.

PyTorch port of `incubator_mxnet_tpu/llm/decode_core.py`.  Training owns
the (B, T) full-sequence graph; serving owns two other programs built
from the SAME parameters:

* **prefill** — one bucketed-length forward of a single new sequence
  that writes its K/V into an assigned cache slot and returns the first
  generated token.  One signature per prompt bucket.
* **decode step** — ONE fixed-shape program advancing every slot by one
  token against the cache.  Its signature never changes (slots, max_len
  and the parameter shapes are fixed), however sequences arrive, finish
  or interleave.

The JAX package compiles both as cached-jit programs that donate the
cache.  Here both run eagerly under `torch.inference_mode()` and write
the cache in place, so the card holds one copy of it, as donation gives.
With no compiler, `program_count()` counts the distinct signatures the
programs were called with (``warmup`` calls each of the ladder's) and
`compile_count()` their first calls: a signature off the ladder after
warmup raises both, which is what the JAX package's recompile auditor
would flag.

`stack_lm_params` turns a trained Module/gluon parameter dict into
per-layer tensors stacked on a leading L axis; both programs loop over
its layers.  The layer math is the ops `llm/model.py` composes:
LayerNorm (eps 1e-5, biased variance), exact gelu, 1/sqrt(D)-scaled
attention.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype

__all__ = ["stack_lm_params", "init_kv_cache", "DecodePrograms"]

_NEG = -1e30

# suffix -> stacked key; every transformer block parameter the decode
# plane needs, in one table so a missing/renamed parameter fails loudly
_LAYER_SUFFIXES = {
    "ln1_gamma": "ln1_gamma", "ln1_beta": "ln1_beta",
    "qkv_weight": "qkv_weight", "qkv_bias": "qkv_bias",
    "out_proj_weight": "out_weight", "out_proj_bias": "out_bias",
    "ln2_gamma": "ln2_gamma", "ln2_beta": "ln2_beta",
    "fc1_weight": "fc1_weight", "fc1_bias": "fc1_bias",
    "fc2_weight": "fc2_weight", "fc2_bias": "fc2_bias",
}


def _tensor_of(a):
    """A parameter value (torch tensor, port NDArray, anything with
    ``asnumpy()``, numpy) as a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    data = getattr(a, "data", None)
    if isinstance(data, torch.Tensor):
        return data.detach()
    if hasattr(a, "asnumpy"):
        a = a.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(a))


def _device(ctx):
    """torch.device of a Context or torch.device (default: the current
    context, the card unless the caller asks for the CPU)."""
    if isinstance(ctx, torch.device):
        return ctx
    if ctx is None:
        from ..context import current_context
        ctx = current_context()
    return ctx.torch_device


def stack_lm_params(arg_params, cfg, ctx=None):
    """Trained parameter dict -> stacked decode parameters on `ctx`.

    Accepts the `Module.get_params()` arg dict (or any name->array
    mapping with the `llm.model` naming scheme; NDArray, torch or numpy
    values, each keeping its dtype).  Returns ``{"embed",
    "final_ln_gamma", "final_ln_beta", "layers": {key: (L, ...)}}`` as
    torch tensors.
    """
    names = dict(arg_params)
    dev = _device(ctx)

    def find(suffix):
        hits = [k for k in names if k.endswith(suffix)]
        if len(hits) != 1:
            raise MXNetError(
                "stack_lm_params: expected exactly one parameter ending "
                "with %r, found %r" % (suffix, sorted(hits)))
        return _tensor_of(names[hits[0]]).to(dev)

    out = {"embed": find("embed_weight"),
           "final_ln_gamma": find("final_ln_gamma"),
           "final_ln_beta": find("final_ln_beta")}
    out["layers"] = {
        key: torch.stack([find("block%d_%s" % (i, suffix))
                          for i in range(cfg.num_layers)])
        for suffix, key in _LAYER_SUFFIXES.items()}
    return out


def init_kv_cache(cfg, slots, ctx=None):
    """Zeroed (cache_k, cache_v), each (L, slots, max_len, H, D) in
    ``cfg.param_dtype`` on `ctx` (a Context or torch.device)."""
    shape = (cfg.num_layers, int(slots), cfg.max_len, cfg.num_heads,
             cfg.head_dim)
    dtype = torch_dtype(cfg.param_dtype)
    dev = _device(ctx)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# layer math (the ops llm/model.py composes: LayerNorm eps 1e-5, exact
# gelu, 1/sqrt(D)-scaled attention)
# ---------------------------------------------------------------------------

def _ln(x, gamma, beta, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def _mlp(h, lp):
    hn = _ln(h, lp["ln2_gamma"], lp["ln2_beta"])
    f = F.gelu(F.linear(hn, lp["fc1_weight"], lp["fc1_bias"]),
               approximate="none")
    return h + F.linear(f, lp["fc2_weight"], lp["fc2_bias"])


def _layer_full(h, lp, heads, attn_block_size):
    """Full-sequence block forward; returns (h_out, (k, v)) with k/v
    shaped (B, T, H, D) for the prefill cache write."""
    from ..parallel.ring_attention import blockwise_attention
    b, t, c = h.shape
    d = c // heads
    hn = _ln(h, lp["ln1_gamma"], lp["ln1_beta"])
    qkv = F.linear(hn, lp["qkv_weight"], lp["qkv_bias"])
    q, k, v = (a.reshape(b, t, heads, d) for a in qkv.split(c, dim=-1))
    attn = blockwise_attention(q, k, v, block_size=attn_block_size,
                               causal=True)
    h = h + F.linear(attn.reshape(b, t, c), lp["out_weight"],
                     lp["out_bias"])
    return _mlp(h, lp), (k, v)


def _layer_step(h, lp, ck, cv, rows, at, hidden, heads):
    """One-token block forward against the slot cache.

    h (S, C) current activations; ck/cv (S, M, H, D) this layer's cache,
    written in place at rows ``(rows, at)`` (each slot's position,
    clamped into the cache as the JAX package's `dynamic_update_slice`
    clamps it); hidden (S, 1, M) is True where a cache row lies past the
    slot's position.  Returns h_out.
    """
    s, c = h.shape
    d = c // heads
    hn = _ln(h, lp["ln1_gamma"], lp["ln1_beta"])
    qkv = F.linear(hn, lp["qkv_weight"], lp["qkv_bias"])
    q, k, v = (a.reshape(s, heads, d) for a in qkv.split(c, dim=-1))
    ck[rows, at] = k
    cv[rows, at] = v
    scores = torch.einsum("shd,smhd->shm", q, ck) * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores.masked_fill(hidden, _NEG), dim=-1)
    attn = torch.einsum("shm,smhd->shd", probs, cv).reshape(s, c)
    h = h + F.linear(attn, lp["out_weight"], lp["out_bias"])
    return _mlp(h, lp)


def _long_on(x, device):
    """Integers (numpy, a torch tensor, a list) as a long tensor on
    `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.int64))
    return x.to(device, torch.long)


def _indices(tokens, embed):
    """Token ids as a long tensor on the embedding's device, normalised
    as the JAX package's ``embed[tokens]`` gather does: a negative id
    counts from the end, and ids are clamped into the vocabulary (an
    index out of range would be a device-side assert on the card)."""
    t = _long_on(tokens, embed.device)
    v = embed.shape[0]
    return torch.where(t < 0, t + v, t).clamp_(0, v - 1)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

class DecodePrograms:
    """The two programs of the decode plane, on the device of `params`.

    ``prefill(params, ck, cv, tokens, slot, length)`` and
    ``step(params, ck, cv, tokens, positions)`` return ``(ck, cv,
    token, logits)`` as the JAX package's do; the caches come back as
    the same tensors, written in place.  `program_count()` is the
    zero-new-signature certification hook (same contract as the JAX
    package's).
    """

    def __init__(self, cfg, params, label="lm"):
        self.cfg = cfg
        self.params = params
        self.label = label
        self._lock = threading.Lock()
        self._signatures = set()
        self._prepared_for = None     # (params, per-layer views, sig)

    def _prepare(self, params, kind, shape, ck):
        """Per-layer views of `params` (cached while the same dict is
        passed) and the call's signature, counted the first time."""
        if self._prepared_for is None or self._prepared_for[0] is not params:
            layers = params["layers"]
            n = next(iter(layers.values())).shape[0]
            views = [{k: v[i] for k, v in layers.items()} for i in range(n)]
            psig = tuple((k, tuple(v.shape), str(v.dtype))
                         for k, v in sorted(layers.items())) + (
                tuple(params["embed"].shape), str(params["embed"].dtype))
            self._prepared_for = (params, views, psig)
        _, views, psig = self._prepared_for
        sig = (kind, shape, tuple(ck.shape), str(ck.dtype), psig)
        with self._lock:
            self._signatures.add(sig)
        return views

    def prefill(self, params, ck, cv, tokens, slot, length):
        """Forward of one padded prompt (1, Tb): its K/V rows written to
        ``[:, slot, :Tb]`` of the caches (the padding's rows too), the
        logits of row ``length - 1`` and their argmax."""
        with torch.inference_mode():
            embed = params["embed"]
            tokens = _indices(tokens, embed)
            views = self._prepare(params, "prefill", tuple(tokens.shape), ck)
            tb = tokens.shape[1]
            if tb > ck.shape[2]:
                raise MXNetError(
                    "prefill: a bucket of %d tokens exceeds the cache's "
                    "%d rows" % (tb, ck.shape[2]))
            # clamped as the JAX package's dynamic slice and index clamp
            # them (a length of 0 reads the last row, as its index wraps)
            slot = min(max(int(slot), 0), ck.shape[1] - 1)
            row = min(int(length), tb) - 1
            h = F.embedding(tokens, embed)                   # (1, Tb, C)
            for l, lp in enumerate(views):
                h, (k, v) = _layer_full(h, lp, self.cfg.num_heads,
                                        self.cfg.attn_block_size)
                ck[l, slot, :tb] = k[0]
                cv[l, slot, :tb] = v[0]
            hn = _ln(h[0, row], params["final_ln_gamma"],
                     params["final_ln_beta"])
            logits = F.linear(hn, embed)                     # (V,)
            return ck, cv, torch.argmax(logits).to(torch.int32), logits

    def step(self, params, ck, cv, tokens, positions):
        """Every slot one token further: slot s reads token ``tokens[s]``
        at row ``positions[s]`` and sees the cache rows up to it."""
        with torch.inference_mode():
            embed = params["embed"]
            tokens = _indices(tokens, embed)
            positions = _long_on(positions, embed.device)
            views = self._prepare(params, "step", tuple(tokens.shape), ck)
            m = ck.shape[2]
            rows = torch.arange(positions.shape[0], device=embed.device)
            at = positions.clamp(0, m - 1)
            # visibility: row j of slot s is seen when j <= positions[s]
            hidden = (torch.arange(m, device=embed.device)[None, :]
                      > positions[:, None])[:, None, :]
            h = F.embedding(tokens, embed)                   # (S, C)
            for l, lp in enumerate(views):
                h = _layer_step(h, lp, ck[l], cv[l], rows, at, hidden,
                                self.cfg.num_heads)
            hn = _ln(h, params["final_ln_gamma"], params["final_ln_beta"])
            logits = F.linear(hn, embed)                     # (S, V)
            return ck, cv, torch.argmax(logits, dim=-1).to(torch.int32), \
                logits

    def program_count(self):
        """Distinct signatures the programs were called with."""
        with self._lock:
            return len(self._signatures)

    def compile_count(self):
        """First calls of a signature: what would compile under a JIT
        (with nothing compiled here, always `program_count()`)."""
        return self.program_count()

    def warmup(self, slots, buckets):
        """Call every signature the engine will dispatch: one prefill per
        bucket plus the decode step, against a scratch cache (the
        engine's live cache is made after).  Returns the number of new
        signatures."""
        before = self.compile_count()
        ck, cv = init_kv_cache(self.cfg, slots, self.params["embed"].device)
        for b in sorted(set(int(x) for x in buckets)):
            self.prefill(self.params, ck, cv, np.zeros((1, b), np.int32),
                         0, 1)
        s = ck.shape[1]
        self.step(self.params, ck, cv, np.zeros((s,), np.int32),
                  np.zeros((s,), np.int32))
        del ck, cv
        return self.compile_count() - before
