"""Transformer language model: the flagship attention workload.

PyTorch port of `incubator_mxnet_tpu/llm/`.  `model.py` defines the gluon
`TransformerLM` (embedding, N identical pre-norm blocks over the
``BlockwiseAttention`` op, tied output head) and `lm_symbol`, its
`Module.fit`-ready training graph.  `decode_core.py` holds the decode
plane: parameters stacked per layer, one fixed-shape decode step and a
prefill per prompt bucket, with the KV cache written in place — what
`serving.decode.DecodeEngine` runs.
"""
from .model import (LMConfig, TransformerBlock, TransformerLM, lm_symbol,
                    lm_block_op_count)
from .decode_core import (DecodePrograms, stack_lm_params, init_kv_cache)

__all__ = ["LMConfig", "TransformerBlock", "TransformerLM", "lm_symbol",
           "lm_block_op_count", "DecodePrograms", "stack_lm_params",
           "init_kv_cache"]
