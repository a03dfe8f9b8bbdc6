"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The port sits beside the JAX package and computes with torch tensors on a
CUDA device; it reads and writes the same symbol JSON and reference-binary
`.params` files, and keeps the JAX package's module layout.  The card is
the default context (`gpu(0)`); pass ``ctx=mx.cpu()`` to run on the CPU.

Slice 1 covers serving: Symbol graphs, the checkpoint pair, the
``TPU_PALLAS`` subgraph backend with its fused FC+bias+ReLU CUDA kernel,
and `serving.ModelServer`.  Slice 2 covers attention: `ops.flash_attention`
(`flash_attention`, `flash_attention_partial`) with the flash-attention
forward as CUDA kernels (whole-KV and split-KV), `parallel.ring_attention`
over a `torch.distributed` group, and the ``BlockwiseAttention`` op.
Slice 4 covers symbolic training: `mod.Module.fit` over an eager
`executor.Executor` (the ops' backward by autograd, ``SoftmaxOutput``'s
implicit gradient), `optimizer.SGD`, `initializer`, `metric`, `io`,
`callback` and `lr_scheduler`.  Slice 5 trains ResNet-50 v1: the
`BatchNorm` op, `gluon` (Parameter, Block, HybridBlock, the layers and
`model_zoo` ResNet/VGG composed on a Symbol), and `Module.fit`'s fused
train step (`fused.FusedTrainStep`: a multi-tensor SGD update and
metrics accumulated on the device).  Slice 6 trains gluon networks
imperatively: `autograd` (`record`, `backward`, `grad`, `Function`, on
torch's autograd), one ``nd.<Op>`` per registered op through
`ndarray.invoke`, eager and hybridized `HybridBlock` calls, `gluon.loss`,
`gluon.Trainer`, `gluon.data`, `gluon.utils` and
`gluon.contrib.estimator.Estimator.fit` with its fused step.  Slice 7
serves the transformer LM: `llm` (the gluon `TransformerLM`,
`lm_symbol`, the decode plane's prefill and step over a KV cache), the
``LayerNorm``, ``Embedding`` and ``slice_axis`` ops, and
`serving.DecodeEngine`, continuous batching over the decode plane.
Slice 8 trains the LM through `Module.fit` with elastic checkpoints:
`checkpoint` (async snapshots through the pinned host pool of
`storage`, atomic manifests, mid-epoch resume, the SIGTERM hook),
`optimizer.Adam`, and the optimizer, iterator and random-stream state a
resumed fit restores.

    import incubator_mxnet_tpu_torch as mx
"""
from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import autograd
from . import ops
from . import symbol
from . import symbol as sym
from . import ndarray
from . import ndarray as nd
from . import subgraph
from . import model
from .model import save_checkpoint, load_checkpoint
from . import serving
from . import model_zoo
from . import parallel
from . import random
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import io
from . import callback
from . import executor
from . import module
from . import module as mod
from . import gluon
from . import llm
from . import storage
from . import checkpoint
from . import test_utils

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "autograd", "ops", "symbol", "sym", "ndarray", "nd", "subgraph",
           "model", "save_checkpoint", "load_checkpoint", "serving",
           "model_zoo", "parallel", "random", "initializer", "init",
           "lr_scheduler", "optimizer", "metric", "io", "callback",
           "executor", "module", "mod", "gluon", "llm", "storage",
           "checkpoint", "test_utils"]
