"""Environment knobs the port reads.

PyTorch port of the part of `incubator_mxnet_tpu/config.py` that the
ported modules use.  A knob is read from the environment at call time,
so a caller (a test, `chip_smoke.py`) can set it for one call.

``MXNET_FLASH_VMEM_MB`` (float, default 10.0) keeps the JAX package's
routing rule for flash attention: a call whose K and V of one head take
more than this many MiB (``2 * kv_len * D * itemsize``) runs the
split-KV kernel (`ops.flash_attention.flash_fwd_stream`), else the
whole-KV kernel (`flash_fwd`), so a shape takes the same route in both
packages.  On the TPU it was the VMEM the whole-KV kernel could hold; on
the card nothing is held whole, and the knob only names the KV length
past which the split-KV kernel runs.

``MXNET_SUBGRAPH_BACKEND`` (str, default empty) names the subgraph
backend `Symbol.simple_bind` partitions the graph with at bind time
(``TPU_PALLAS`` fuses FullyConnected+bias+ReLU into kernel K1), as the
JAX package's `simple_bind` does.

``MXNET_FUSED_TRAIN_STEP`` (bool, default on) lets `Module.fit` run its
fused train step (`fused.FusedTrainStep`) where the module allows it;
``0`` keeps every batch on the per-batch path, as in the JAX package.

``MXNET_FLASH_INTERPRET`` is not carried over: in the port the tensor's
device decides.  A CPU tensor takes a kernel's plain PyTorch version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import logging
import os

__all__ = ["KNOBS", "get"]

_LOG = logging.getLogger(__name__)

_BOOL = lambda s: s not in ("0", "false", "False", "")  # noqa: E731

# name -> (parser, default, doc)
KNOBS = {
    "MXNET_FLASH_VMEM_MB": (float, 10.0,
                            "MiB of one head's K and V past which flash "
                            "attention runs the split-KV kernel"),
    "MXNET_SUBGRAPH_BACKEND": (str, "",
                               "subgraph backend Symbol.simple_bind "
                               "partitions the graph with"),
    "MXNET_FUSED_TRAIN_STEP": (_BOOL, True,
                               "Module.fit runs the fused train step "
                               "(fused.py) where it can"),
}


def get(name):
    """The knob's value from the environment, or its default when unset
    or unparsable."""
    if name not in KNOBS:
        raise KeyError(f"unknown config knob {name}; register it in "
                       "config.KNOBS")
    parse, default, _ = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return parse(raw)
    except (TypeError, ValueError):
        _LOG.warning("could not parse %s=%r; using default", name, raw)
        return default
