"""Parallelism: ring attention over a `torch.distributed` group (port of
`incubator_mxnet_tpu/parallel/`; the dp/tp/pp meshes are not ported
yet)."""
from .ring_attention import blockwise_attention, ring_attention

__all__ = ["blockwise_attention", "ring_attention"]
