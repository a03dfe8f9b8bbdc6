"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The port sits beside the JAX package and computes with torch tensors on a
CUDA device; it reads and writes the same symbol JSON and reference-binary
`.params` files, and keeps the JAX package's module layout.  The card is
the default context (`gpu(0)`); pass ``ctx=mx.cpu()`` to run on the CPU.

Slice 1 covers serving: Symbol graphs, the checkpoint pair, the
``TPU_PALLAS`` subgraph backend with its fused FC+bias+ReLU CUDA kernel,
and `serving.ModelServer`.

    import incubator_mxnet_tpu_torch as mx
"""
from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
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

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "ops", "symbol", "sym", "ndarray", "nd", "subgraph",
           "model", "save_checkpoint", "load_checkpoint", "serving",
           "model_zoo"]
