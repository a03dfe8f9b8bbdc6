"""Library/build information (reference `python/mxnet/libinfo.py`).

PyTorch port of `incubator_mxnet_tpu/libinfo.py`.  The reference locates
libmxnet.so; the port's native components are the kernel libraries it
builds from ``csrc/`` (K1 ``fc_relu``, K2/K3 ``flash_attn``) and the
native IO library built from ``src/io_native.cc``, each in ``build/`` at
the root of the checkout, so this reports which of them are built and
what the runtime offers.
"""
from __future__ import annotations

import os

__version__ = "0.1.0"

__all__ = ["find_lib_path", "find_include_path", "features"]


def find_lib_path():
    """Paths of the port's built native libraries (reference
    `find_lib_path`): each kernel library of ``csrc/`` already built for
    the current sources, and the native IO library when it is built;
    an empty list before any build (a kernel library builds at its first
    launch)."""
    from .kernels import _build
    from . import native
    out = [str(_build._lib_path(n)) for n in _build.SOURCES
           if _build._lib_path(n).exists()]
    io = native.lib_path()
    if os.path.exists(io):
        out.append(str(io))
    return out


def find_include_path():
    """Reference `find_include_path`: headers for native extensions."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    return src if os.path.isdir(src) else ""


def features():
    """Runtime feature flags (the role of `libinfo.cc`'s feature list):
    the card and its name, the CUDA torch was built with, whether the
    native IO library is built (asking builds nothing), the backends of
    `torch.distributed` and the kernel sources."""
    import torch
    import torch.distributed as dist
    from . import native
    from .kernels import _build
    cuda = torch.cuda.is_available()
    backends = [b for b, ok in (("gloo", dist.is_gloo_available()),
                                ("nccl", dist.is_nccl_available()),
                                ("mpi", dist.is_mpi_available()))
                if dist.is_available() and ok]
    return {
        "CUDA": cuda,
        "DEVICE": torch.cuda.get_device_name(0) if cuda else None,
        "CUDA_VERSION": torch.version.cuda,
        "TORCH_VERSION": torch.__version__,
        "NATIVE_IO": os.path.exists(native.lib_path()),
        "BACKENDS": sorted(backends),
        "KERNELS": list(_build.SOURCES),
    }
