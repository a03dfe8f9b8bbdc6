"""Gluon Transformer LM and its `Module.fit` training symbol.

PyTorch port of `incubator_mxnet_tpu/llm/model.py`.  Architecture
(pre-norm GPT):

    tokens (B, T) --Embedding--> (B, T, C)
      N x [ LN -> qkv FC -> BlockwiseAttention -> out_proj FC -> +res
            LN -> fc1 FC -> gelu -> fc2 FC -> +res ]
      final LN -> tied head (FullyConnected against the embedding
      weight, no bias) -> logits (B, T, V)

Parameter, block and op names are the JAX package's (``lm_embed_weight``,
``lm_block0_qkv_weight``, ...), so a network composed in either package
gives the same symbol JSON and parameters cross between them by name.
The JAX package groups the N graph-identical blocks into one scanned
body when it compiles; the port's interpreter runs them one after
another.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["LMConfig", "TransformerBlock", "TransformerLM", "lm_symbol",
           "lm_block_op_count"]


@dataclass
class LMConfig:
    """Static LM shape shared by training, serving and the bench."""
    vocab_size: int = 256
    num_layers: int = 2
    num_heads: int = 2
    hidden: int = 32
    ffn_mult: int = 4
    max_len: int = 64            # KV-cache capacity per decode slot
    attn_block_size: int = None  # None: the whole sequence is one block
    eos_id: int = 0
    param_dtype: str = "float32"

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


# ops emitted per transformer block by TransformerBlock.hybrid_forward:
# ln1, qkv FC, 3x slice_axis, attention, out_proj FC, residual add,
# ln2, fc1 FC, gelu, fc2 FC, residual add
_BLOCK_OPS = 13


def lm_block_op_count():
    """Symbol nodes per transformer block (the repetition period of the
    stack in the graph)."""
    return _BLOCK_OPS


class TransformerBlock(HybridBlock):
    """One pre-norm transformer block (attention + MLP)."""

    def __init__(self, hidden, num_heads, ffn_mult=4, attn_block_size=None,
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._hidden = int(hidden)
        self._heads = int(num_heads)
        self._attn_block_size = attn_block_size
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=hidden, prefix="ln1_")
            self.qkv = nn.Dense(3 * hidden, flatten=False, in_units=hidden,
                                dtype=dtype, prefix="qkv_")
            self.out_proj = nn.Dense(hidden, flatten=False, in_units=hidden,
                                     dtype=dtype, prefix="out_proj_")
            self.ln2 = nn.LayerNorm(in_channels=hidden, prefix="ln2_")
            self.fc1 = nn.Dense(ffn_mult * hidden, flatten=False,
                                in_units=hidden, dtype=dtype, prefix="fc1_")
            self.fc2 = nn.Dense(hidden, flatten=False,
                                in_units=ffn_mult * hidden, dtype=dtype,
                                prefix="fc2_")

    def hybrid_forward(self, F, x):
        c = self._hidden
        h = self.ln1(x)
        qkv = self.qkv(h)
        q = F.slice_axis(qkv, axis=-1, begin=0, end=c)
        k = F.slice_axis(qkv, axis=-1, begin=c, end=2 * c)
        v = F.slice_axis(qkv, axis=-1, begin=2 * c, end=3 * c)
        attn = F.BlockwiseAttention(q, k, v, num_heads=self._heads,
                                    causal=True,
                                    block_size=self._attn_block_size)
        x = x + self.out_proj(attn)
        h = self.ln2(x)
        h = self.fc1(h)
        h = F.LeakyReLU(h, act_type="gelu")
        return x + self.fc2(h)


class TransformerLM(HybridBlock):
    """Embedding -> N identical blocks -> final LN -> tied head."""

    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self.cfg = cfg
        with self.name_scope():
            # one parameter serves both faces: Embedding lookup on the
            # way in, FullyConnected weight (tied head) on the way out
            self.embed_weight = self.params.get(
                "embed_weight", shape=(cfg.vocab_size, cfg.hidden),
                dtype=cfg.param_dtype, allow_deferred_init=True)
            self.blocks = nn.HybridSequential(prefix="")
            for i in range(cfg.num_layers):
                self.blocks.add(TransformerBlock(
                    cfg.hidden, cfg.num_heads, ffn_mult=cfg.ffn_mult,
                    attn_block_size=cfg.attn_block_size,
                    dtype=cfg.param_dtype, prefix="block%d_" % i))
            self.final_ln = nn.LayerNorm(in_channels=cfg.hidden,
                                         prefix="final_ln_")

    def hybrid_forward(self, F, tokens, embed_weight):
        cfg = self.cfg
        h = F.Embedding(tokens, embed_weight, input_dim=cfg.vocab_size,
                        output_dim=cfg.hidden)
        h = self.blocks(h)
        h = self.final_ln(h)
        return F.FullyConnected(h, embed_weight,
                                num_hidden=cfg.vocab_size,
                                no_bias=True, flatten=False)


def lm_symbol(cfg, prefix="lm_"):
    """`Module.fit`-ready training graph: next-token cross-entropy.

    data (B, T) tokens; softmax_label (B, T) targets (the caller
    shifts).  Logits flatten to (B*T, V) through `SoftmaxOutput`.
    """
    from .. import symbol as sym
    model = TransformerLM(cfg, prefix=prefix)
    data = sym.Variable("data")
    logits = model(data)                     # (B, T, V)
    pred = sym.Reshape(logits, shape=(-1, cfg.vocab_size))
    label = sym.Variable("softmax_label")
    label = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(pred, label, name="softmax")
