"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, for ``sm_90a``.  Libraries go to
``build/kernels/`` at the root of the checkout (listed in `.gitignore`),
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  `build_all` starts one ``nvcc`` per
source, all at once.  Nothing is fetched: only the repository's sources
are compiled, with the CUDA toolkit found via ``CUDA_HOME``,
``/usr/local/cuda`` or ``PATH``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["build_all", "load", "SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_lock = threading.Lock()
_libs = {}
# nvcc's diagnostics (ptxas registers / spills) of builds this process ran
build_log = {}


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                         "the port's CUDA kernels build on a machine with "
                         "the CUDA toolkit")
    return found


def _lib_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES):
    """Build every library of `names` that is missing, one nvcc process per
    source, all started together; raise naming the sources that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        if failed:
            raise MXNetError("kernel build failed: " + "\n".join(failed))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
