"""ONNX interchange (reference `python/mxnet/contrib/onnx/`).

PyTorch port of `incubator_mxnet_tpu/contrib/onnx/`: `export_model` and
`import_model` over the public ONNX schema's field numbers (opset 13).
The wire format is the port's own encoder and decoder (`_wire`), so
neither the `onnx` package nor `google.protobuf` is needed; files
interchange with the JAX package's and with any ONNX runtime.
"""
from .export_onnx import export_model
from .import_onnx import import_model

__all__ = ["export_model", "import_model"]
