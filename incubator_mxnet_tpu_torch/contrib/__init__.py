"""`mx.contrib` (reference `python/mxnet/contrib/`): `io`
(`DataLoaderIter`), `svrg_optimization` (`SVRGModule`), `autograd` (the
legacy aliases), `text` (`Vocabulary`, `CustomEmbedding`) and
`tensorboard` (`LogMetricsCallback`).

PyTorch port of `incubator_mxnet_tpu/contrib/`.  `quantization` and
`onnx` are not ported: asking for either raises `MXNetError` naming
ROADMAP item 14, where they wait.
"""
from ..base import MXNetError
from . import autograd  # noqa: F401
from . import io  # noqa: F401
from . import svrg_optimization  # noqa: F401
from . import tensorboard  # noqa: F401
from . import text  # noqa: F401

__all__ = ["autograd", "io", "svrg_optimization", "tensorboard", "text"]


def __getattr__(name):
    if name in ("quantization", "onnx"):
        raise MXNetError(f"mx.contrib.{name} is not ported to the PyTorch "
                         "package yet (ROADMAP Queue 1, item 14)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
