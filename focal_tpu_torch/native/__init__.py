"""The bulk ``.npz`` loader (``npz_loader.cpp``, the port's copy of the JAX
package's ``native/`` loader), built with g++ and loaded with ctypes.

The library is compiled on first use into ``build/focal_tpu_torch/`` beside
the package, named by a content hash of the source and flags (a changed
source builds anew, an unchanged one is reused), through a temporary file
renamed into place, so that processes building at once agree. A failed
build raises with g++'s output. Nothing here runs at import time.

``load_batch_f32`` and ``load_scalar_i64`` read one member from every
archive on a pool of threads and say which archives they read: a
compressed, zip64 or unreadable archive is left to the caller
(``data.Split.from_index_file`` reads those with numpy, and logs them).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from focal_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "npz_loader.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnpz_loader_{h.hexdigest()[:16]}.so")


def build():
    """The library's path, compiling it first when it is not built."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on npz_loader.cpp (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            paths, ok = ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ubyte)
            lib.load_npz_batch_f32.restype = ctypes.c_int
            lib.load_npz_batch_f32.argtypes = [paths, ctypes.c_longlong, ctypes.c_char_p,
                                               ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                                               ok, ctypes.c_int]
            lib.load_npz_scalar_i64.restype = ctypes.c_int
            lib.load_npz_scalar_i64.argtypes = [paths, ctypes.c_longlong, ctypes.c_char_p,
                                                ctypes.POINTER(ctypes.c_longlong), ok,
                                                ctypes.c_int]
            _lib = lib
    return _lib


def _paths(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _threads(n_threads):
    return n_threads or min(16, os.cpu_count() or 1)


def load_batch_f32(paths, key, sample_shape, n_threads=0):
    """(float32 [n, *sample_shape], bool [n]): member ``key`` of every
    archive stacked, and which archives were read (the other rows are
    uninitialised)."""
    out = np.empty((len(paths),) + tuple(sample_shape), np.float32)
    ok = np.zeros(len(paths), np.uint8)
    _library().load_npz_batch_f32(
        _paths(paths), len(paths), key.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(np.prod(sample_shape)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _threads(n_threads))
    return out, ok.astype(bool)


def load_scalar_i64(paths, key, n_threads=0):
    """(int64 [n], bool [n]): the integer scalar ``key`` of every archive,
    and which archives were read."""
    out = np.empty(len(paths), np.int64)
    ok = np.zeros(len(paths), np.uint8)
    _library().load_npz_scalar_i64(
        _paths(paths), len(paths), key.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _threads(n_threads))
    return out, ok.astype(bool)
