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
resumed fit restores.  Slice 9 trains the bucketed LSTM language
model (BASELINE config #4) through `mod.BucketingModule.fit`: the
control-flow ops (`_foreach`, `_while_loop`, `_cond`; `sym.contrib`,
`nd.contrib`), the ``RNN`` op (cuDNN's on the card), `rnn` (the symbolic
cells, `BucketSentenceIter`), `gluon.rnn`, `initializer.LSTMBias` and
`metric.Perplexity`.  Slice 10 trains BASELINE config #2
(train_imagenet.py's ResNet-50) from a RecordIO pack: `recordio`, the
native IO library (`native`, built from ``src/io_native.cc``), `image`
(the augmenters, `ImageIter`, `ImageRecordIter`'s engine), the `io`
iterators, the ``ImageNormalize`` op, `io_plane` (the h2d staging ring
`Module.fit` wraps its training iterator in) and
`metric.TopKAccuracy`.  Slice 12 trains data-parallel: `kvstore`
(``local``, ``device`` and the dist stores, 2-bit compression),
`Module` over several contexts, the parameter server (`dist`: the socket
data plane, the server, the launcher), `resilience`'s retry and breaker,
row-sparse gradients with lazy optimizer updates (`ndarray.sparse`),
and `embedding` (the sharded table and its hot-row cache on the card).
Slice 13 completes the op registry (every JAX op but the quantization
ones: `ops/matrix.py`, `nn.py`, `linalg_ops.py`, `random_ops.py`,
`ctc.py`, `contrib_ops.py`, `contrib_tail.py`, `optimizer_ops.py` as
registry ops; `nd.random`, `nd.linalg`, `sym.random`, `sym.linalg`) and
the training API: every optimizer, metric and initializer of the JAX
package, `monitor.Monitor`, `attribute.AttrScope`,
`mod.SequentialModule`, `mod.PythonModule` and `mod.PythonLossModule`.
Slice 14 adds the training API's stragglers (`model.FeedForward`,
`callback.ProgressBar`, `callback.elastic_checkpoint`,
`io.pad_to_bucket`, the `test_utils` checks, ``state_names`` and
`BucketingModule.fit(checkpoint_dir=)`) and the serving path's edges
(`resilience.faults`, the batcher's circuit breaker and retries,
checkpoint-directory serving, a `Monitor` on the request path, and the
C predict ABI: `c_predict` and the shim ``csrc/c_predict_api.cc``).
Slice 15 adds gluon's remaining layers and the model zoo.  Slice 16 adds
gluon's data plane (`DataLoader`'s worker threads, `RecordFileDataset`,
`gluon.data.vision`, `nd.image`, `io_plane.DevicePrefetchLoader`) and
`contrib`: `DataLoaderIter`, `SVRGModule`, the legacy autograd names,
`text` and `tensorboard`.  Slice 17 adds sparse storage (`nd.sparse`:
CSR and row_sparse `NDArray`s, sparse `dot`, both in `.params`, LibSVM
batches through `Module`), the quantization ops with
`contrib.quantization.quantize_model`, and `contrib.onnx`.  Slice 18
adds the serving fleet (`serving.ReplicaRouter`, worker processes, host
daemons, `serving.fleet.FleetManager`).  Slice 19 adds the telemetry
plane: `obs` (metrics, cross-process trace spans, the ``metrics`` scrape
frame, the shared JSONL sink) and `profiler` over `torch.profiler`.
Slice 20 adds the training guardian (`resilience.guardian`, armed by
`Module.fit`: skip-batch, rollback to the last healthy checkpoint,
quarantine, `TrainingDivergedError`) and the train-to-serve loop
(`loop`: `ModelRegistry`, `CheckpointPublisher`, `LoopController`).
Slice 21 adds the elastic supervisor, the collective data plane and
`fit`'s failover.  Slice 22 adds the small public modules (`operator`'s
`CustomOp` with ``nd.Custom``, `viz`, `engine`, `libinfo`) and
`parallel`'s meshes: DTensor layouts over a mesh of ranks
(`shard_block`, `put`, `shard_params`), the collective verbs, the
data-parallel, ZeRO and pipeline steps, ``Trainer(zero=, mesh=)``,
``Module.fit(mesh=)`` and ``SyncBatchNorm`` across ranks.

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
from . import rnn
from . import recordio
from . import native
from . import image
from . import io_plane
from . import kvstore
from . import kvstore as kv
from . import kvstore_server
from . import resilience
from . import embedding
from . import test_utils
from . import monitor
from .monitor import Monitor
from . import attribute
from .attribute import AttrScope
from . import contrib
from . import obs
from . import profiler
from . import loop
from . import engine
from . import operator
from . import visualization
from . import visualization as viz
from . import libinfo

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "autograd", "ops", "symbol", "sym", "ndarray", "nd", "subgraph",
           "model", "save_checkpoint", "load_checkpoint", "serving",
           "model_zoo", "parallel", "random", "initializer", "init",
           "lr_scheduler", "optimizer", "metric", "io", "callback",
           "executor", "module", "mod", "gluon", "llm", "storage",
           "checkpoint", "rnn", "recordio", "native", "image", "io_plane",
           "kvstore", "kv", "kvstore_server", "resilience", "embedding",
           "test_utils", "monitor", "Monitor", "attribute", "AttrScope",
           "contrib", "obs", "profiler", "loop", "engine", "operator",
           "visualization", "viz", "libinfo"]
