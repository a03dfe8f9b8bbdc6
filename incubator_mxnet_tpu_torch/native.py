"""ctypes loader for the native IO library (`src/io_native.cc`).

PyTorch port of `incubator_mxnet_tpu/native.py`.  The C++ source is the
JAX package's own, read in place; the port compiles it at first use with
the host C++ compiler into ``build/native/`` at the root of the checkout
(listed in `.gitignore`), named by a hash of the source and the flags, so
an edited source rebuilds.  The prebuilt ``src/libmxtpu_io.so`` is never
loaded: git does not carry it, and it is built ``-march=native`` for the
machine that built it.  It is built without OpenMP (see `CXX_FLAGS`).

`lib()` returns None when ``MXNET_USE_NATIVE_IO=0`` or the build fails
(no compiler, a compile error); `unavailable_reason()` then says why, and
callers take their numpy route.  A caller that must not run without the
library checks `unavailable_reason()` and raises.

`build_predict()` builds the port's C predict ABI
(``csrc/c_predict_api.cc`` against the header ``src/c_predict_api.h``,
read in place) into ``build/predict/<hash>/libmxtpu_predict.so``, linked
against this interpreter's shared libpython, whose paths come from
`sysconfig` (``INCLUDEPY``, ``LIBDIR``, ``LDLIBRARY``); it raises when
there is no compiler or no shared libpython.  A C program compiles with
``-I src`` and links ``-L <dir> -lmxtpu_predict -Wl,-rpath,<dir>``
(`predict_flags`), and runs with ``PYTHONPATH`` at the checkout's root.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["lib", "unavailable_reason", "SOURCE", "BUILD_DIR",
           "build_predict", "predict_flags", "PREDICT_SOURCE",
           "PREDICT_HEADER_DIR"]

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "src" / "io_native.cc"
BUILD_DIR = _ROOT / "build" / "native"
# no -fopenmp (the JAX package's Makefile has it): the card's machine has
# no OpenMP runtime, and the iterator's workers already build one batch
# per core, so the batch loops' `omp parallel for` runs serially
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
             "-Wno-unknown-pragmas")

PREDICT_SOURCE = _ROOT / "incubator_mxnet_tpu_torch" / "csrc" / \
    "c_predict_api.cc"
# a C program over the ABI: one input, "data", printed outputs
PREDICT_EXAMPLE = _ROOT / "incubator_mxnet_tpu_torch" / "csrc" / \
    "c_predict_main.c"
PREDICT_HEADER_DIR = _ROOT / "src"
PREDICT_BUILD_DIR = _ROOT / "build" / "predict"

_lock = threading.Lock()
_lib = None
_tried = False
_reason = None


def _configure(lib):
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mxtpu_recordio_index.restype = i64
    lib.mxtpu_recordio_index.argtypes = [
        ctypes.c_void_p, i64, i64p, i64p, ctypes.POINTER(ctypes.c_int32),
        i64]
    lib.mxtpu_augment_to_chw.restype = None
    lib.mxtpu_augment_to_chw.argtypes = [
        ctypes.c_void_p, i64, i64, i64, i64, i64, i64, i64, ctypes.c_int,
        f32p, f32p, f32p, ctypes.c_int]
    lib.mxtpu_augment_batch.restype = None
    lib.mxtpu_augment_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64p, i64p, i64, i64p, i64p, i64,
        i64, ctypes.POINTER(ctypes.c_int), f32p, f32p, f32p, i64,
        ctypes.c_int]
    lib.mxtpu_crop_batch_u8.restype = None
    lib.mxtpu_crop_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64p, i64p, i64, i64p, i64p, i64,
        i64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
        i64, ctypes.c_int]
    return lib


def _cxx():
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def lib_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmxtpu_io-{h.hexdigest()[:16]}.so"


def build():
    """Compile the library if it is missing; return its path.  Raises
    RuntimeError naming the compiler's complaint."""
    out = lib_path()
    if out.exists():
        return out
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++, c++, clang++) on "
                           "PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cxx).name} exit {proc.returncode}: "
                               f"{(proc.stderr or proc.stdout)[-2000:]}")
        os.replace(tmp, out)     # atomic: concurrent builds agree
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def lib():
    """The loaded native library, built if needed; None if unavailable
    (`unavailable_reason()` says why)."""
    global _lib, _tried, _reason
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        from . import config as _config
        if not _config.get("MXNET_USE_NATIVE_IO"):
            _reason = "MXNET_USE_NATIVE_IO=0"
        else:
            try:
                _lib = _configure(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError,
                    AttributeError) as e:
                _reason = f"{type(e).__name__}: {e}"
        _tried = True
        return _lib


def unavailable_reason():
    """Why `lib()` is None (None when it loaded or was not asked yet)."""
    lib()
    return _reason



def _libpython():
    """(include dir, shared libpython path) of this interpreter; raises
    RuntimeError when it has no shared libpython to embed."""
    import sysconfig
    inc = sysconfig.get_config_var("INCLUDEPY")
    name = sysconfig.get_config_var("LDLIBRARY") or ""
    dirs = [sysconfig.get_config_var(k) for k in ("LIBDIR", "LIBPL")]
    if not name.endswith(".so"):   # a static build: look for the .so
        name = f"libpython{sysconfig.get_config_var('LDVERSION')}.so"
    for d in dirs:
        if d and (Path(d) / name).exists():
            return inc, Path(d) / name
    raise RuntimeError(f"no shared libpython ({name}) in {dirs}: this "
                       "Python cannot be embedded")


def build_predict():
    """Compile the C predict ABI library if it is missing; return its
    path.  Raises RuntimeError naming what failed."""
    import sys
    inc, libpython = _libpython()
    flags = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall",
             f'-DMXTPU_PYTHON="{sys.executable}"', f"-I{PREDICT_HEADER_DIR}",
             f"-I{inc}", str(libpython),
             f"-Wl,-rpath,{libpython.parent}")
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (PREDICT_SOURCE, PREDICT_HEADER_DIR / "c_predict_api.h"):
        h.update(src.read_bytes())
    out = PREDICT_BUILD_DIR / h.hexdigest()[:16] / "libmxtpu_predict.so"
    if out.exists():
        return out
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++, c++, clang++) on "
                           "PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    try:
        proc = subprocess.run([cxx, "-o", str(tmp), str(PREDICT_SOURCE),
                               *flags], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cxx).name} exit {proc.returncode}: "
                               f"{(proc.stderr or proc.stdout)[-2000:]}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def predict_flags(lib_path):
    """The compiler flags a C program needs to include the ABI's header
    and link `lib_path` (a `build_predict` library)."""
    d = str(Path(lib_path).parent)
    return [f"-I{PREDICT_HEADER_DIR}", f"-L{d}", "-lmxtpu_predict",
            f"-Wl,-rpath,{d}"]
