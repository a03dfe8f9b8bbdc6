"""`mx.contrib` (reference `python/mxnet/contrib/`): `io`
(`DataLoaderIter`), `svrg_optimization` (`SVRGModule`), `autograd` (the
legacy aliases), `text` (`Vocabulary`, `CustomEmbedding`), `tensorboard`
(`LogMetricsCallback`), `quantization` (`quantize_model`) and `onnx`
(`export_model`, `import_model`).

PyTorch port of `incubator_mxnet_tpu/contrib/`.  `onnx` reads and writes
the wire format with its own codec (`onnx/_wire.py`), so neither package
needs `google.protobuf`.
"""
from . import autograd  # noqa: F401
from . import io  # noqa: F401
from . import onnx  # noqa: F401
from . import quantization  # noqa: F401
from . import svrg_optimization  # noqa: F401
from . import tensorboard  # noqa: F401
from . import text  # noqa: F401

__all__ = ["autograd", "io", "onnx", "quantization", "svrg_optimization",
           "tensorboard", "text"]
